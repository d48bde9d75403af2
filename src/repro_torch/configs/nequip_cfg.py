"""nequip [arXiv:2101.03164]: O(3)-equivariant interatomic potential,
5 layers, 32 channels, l_max=2, n_rbf=8, cutoff=5."""
from ..models.gnn.nequip import NequIPConfig

from .base import GNN_SHAPES

ARCH_ID = "nequip"
FAMILY = "gnn"
SHAPES = GNN_SHAPES


def model_config(reduced: bool = False) -> NequIPConfig:
    if reduced:
        return NequIPConfig(name=ARCH_ID + "-smoke", n_layers=2, channels=8,
                            l_max=2, n_rbf=4)
    return NequIPConfig(name=ARCH_ID, n_layers=5, channels=32, l_max=2,
                        n_rbf=8, cutoff=5.0)
