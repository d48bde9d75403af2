"""dimenet [arXiv:2003.03123]: directional message passing, 6 blocks,
d_hidden=128, n_bilinear=8, n_spherical=7, n_radial=6."""
from ..models.gnn.dimenet import DimeNetConfig

from .base import GNN_SHAPES

ARCH_ID = "dimenet"
FAMILY = "gnn"
SHAPES = GNN_SHAPES


def model_config(reduced: bool = False) -> DimeNetConfig:
    if reduced:
        return DimeNetConfig(name=ARCH_ID + "-smoke", n_blocks=2,
                             d_hidden=16, n_bilinear=4, n_spherical=4,
                             n_radial=4)
    return DimeNetConfig(name=ARCH_ID, n_blocks=6, d_hidden=128,
                         n_bilinear=8, n_spherical=7, n_radial=6, cutoff=5.0)
