"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]: 48L d=2048 16H
(kv=16), MoE: 64 routed top-6 (d_ff 1408) + 2 shared experts, v=163840.

On one card: 57.8 GB of bf16 weights, so the KV cache has about 20 GB
beside them (393,216 bytes a token in bf16).
"""
from ..models.moe import MoEConfig
from ..models.transformer import LMConfig
from .base import LM_SHAPES

ARCH_ID = "moonshot-v1-16b-a3b"
FAMILY = "lm"
SHAPES = LM_SHAPES
TRAIN_ACCUM = 8  # microbatches for train_4k (memory lever)


def model_config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(name=ARCH_ID + "-smoke", n_layers=2, d_model=128,
                        n_heads=4, n_kv_heads=4, d_head=32, d_ff=0,
                        vocab=512, remat="none", loss_chunks=2,
                        dtype="float32",
                        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64,
                                      n_shared=1, d_ff_shared=64,
                                      pad_multiple=8, groups=2))
    return LMConfig(
        name=ARCH_ID, n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_head=128, d_ff=0, vocab=163840, norm="rmsnorm", activation="silu",
        remat="full", loss_chunks=64,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                      d_ff_shared=2816, pad_multiple=16, groups=16))
