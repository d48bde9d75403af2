"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d=2048 16H (kv=16),
MoE: 60 routed top-4 (d_ff 1408) + 4 shared experts (fused 5632),
vocab=151936.

The 60 routed experts are stored padded to 64 (`pad_multiple` 16) with
dead experts whose router logits are -1e30 (models/moe.py): 30.3 GB of
bf16 weights on one card, where the MoE layer runs every padded expert's
fixed-capacity product.
"""
from ..models.moe import MoEConfig
from ..models.transformer import LMConfig
from .base import LM_SHAPES

ARCH_ID = "qwen2-moe-a2.7b"
FAMILY = "lm"
SHAPES = LM_SHAPES
TRAIN_ACCUM = 2  # microbatches for train_4k (memory lever)


def model_config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(name=ARCH_ID + "-smoke", n_layers=2, d_model=128,
                        n_heads=4, n_kv_heads=4, d_head=32, d_ff=0,
                        vocab=512, remat="none", loss_chunks=2,
                        dtype="float32",
                        moe=MoEConfig(n_experts=6, top_k=2, d_ff_expert=64,
                                      n_shared=1, d_ff_shared=128,
                                      pad_multiple=8, groups=2))
    return LMConfig(
        name=ARCH_ID, n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_head=128, d_ff=0, vocab=151936, norm="rmsnorm", activation="silu",
        remat="full", loss_chunks=64,
        moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408, n_shared=4,
                      d_ff_shared=5632, pad_multiple=16, groups=16))
