"""mace [arXiv:2206.07697]: higher-order E(3)-equivariant message passing,
2 layers, 128 channels, l_max=2, correlation order 3, n_rbf=8."""
from ..models.gnn.mace import MACEConfig

from .base import GNN_SHAPES

ARCH_ID = "mace"
FAMILY = "gnn"
SHAPES = GNN_SHAPES


def model_config(reduced: bool = False) -> MACEConfig:
    if reduced:
        return MACEConfig(name=ARCH_ID + "-smoke", n_layers=1, channels=8,
                          l_max=2, correlation=3, n_rbf=4)
    return MACEConfig(name=ARCH_ID, n_layers=2, channels=128, l_max=2,
                      correlation=3, n_rbf=8, cutoff=5.0)
