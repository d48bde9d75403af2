"""graphcast [arXiv:2212.12794]: encoder-processor-decoder mesh GNN,
16 processor layers, d_hidden=512, sum aggregation, n_vars=227.

mesh_refinement=6 belongs to the weather-pipeline graph generator; the
benchmark cells supply generic graphs (configs/base.GNN_SHAPES), which the
architecture consumes unchanged.
"""
from ..models.gnn.graphcast import GraphCastConfig

from .base import GNN_SHAPES

ARCH_ID = "graphcast"
FAMILY = "gnn"
SHAPES = GNN_SHAPES


def model_config(reduced: bool = False, d_feat: int = 227,
                 edge_chunks: int = 1) -> GraphCastConfig:
    if reduced:
        return GraphCastConfig(name=ARCH_ID + "-smoke", n_layers=2,
                               d_hidden=32, n_vars=8, d_feat=d_feat, d_edge=8)
    return GraphCastConfig(name=ARCH_ID, n_layers=16, d_hidden=512,
                           n_vars=227, d_feat=d_feat, d_edge=8,
                           aggregator="sum", dtype="bfloat16",
                           edge_chunks=edge_chunks)
