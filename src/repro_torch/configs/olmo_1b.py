"""olmo-1b [arXiv:2402.00838; hf]: 16L d=2048 16H (kv=16) ff=8192
vocab=50304, non-parametric LayerNorm, SwiGLU, untied head."""
from ..models.transformer import LMConfig
from .base import LM_SHAPES

ARCH_ID = "olmo-1b"
FAMILY = "lm"
SHAPES = LM_SHAPES
TRAIN_ACCUM = 2  # microbatches for train_4k (memory lever)


def model_config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(name=ARCH_ID + "-smoke", n_layers=2, d_model=128,
                        n_heads=4, n_kv_heads=4, d_head=32, d_ff=256,
                        vocab=512, norm="nonparam_ln", remat="none",
                        loss_chunks=2, dtype="float32")
    return LMConfig(
        name=ARCH_ID, n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_head=128, d_ff=8192, vocab=50304, norm="nonparam_ln",
        activation="silu", remat="full", loss_chunks=64)
