"""din [arXiv:1706.06978]: target-attention CTR model, embed_dim=18,
behavior seq 100, attn MLP 80-40, MLP 200-80; 2^20-row item table.
retrieval_cand is the paper's ANN workload: an exact L2 shortlist over
the item embeddings (`kernels.l2_topk`), then a full DIN re-rank."""
from ..models.recsys.din import DINConfig
from .base import RECSYS_SHAPES

ARCH_ID = "din"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES


def model_config(reduced: bool = False) -> DINConfig:
    if reduced:
        return DINConfig(name=ARCH_ID + "-smoke", embed_dim=8, seq_len=12,
                         attn_mlp=(16, 8), mlp=(32, 16), n_items=2048,
                         n_cates=64, rerank_k=32)
    return DINConfig(name=ARCH_ID, embed_dim=18, seq_len=100,
                     attn_mlp=(80, 40), mlp=(200, 80), n_items=1_048_576,
                     n_cates=1024, rerank_k=1024)
