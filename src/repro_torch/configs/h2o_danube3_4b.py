"""h2o-danube-3-4b [arXiv:2401.16818]: llama+mistral-style dense decoder
with sliding-window attention.  24L d=3840 32H (GQA kv=8) ff=10240 v=32000.

On one card: 7.9 GB of bf16 weights.  The KV cache is a ring buffer of
`sliding_window` = 4,096 positions (slot = position % 4,096), so decode
at 32k or at 500k positions reads 4,096 positions a row, and long_500k
runs under kv_mode "local".  Decode attention is the flash-decode kernel
at G = 4, Dh = 120.
"""
from ..models.transformer import LMConfig
from .base import LM_SHAPES

ARCH_ID = "h2o-danube-3-4b"
FAMILY = "lm"
SHAPES = LM_SHAPES
TRAIN_ACCUM = 4  # microbatches for train_4k (memory lever)


def model_config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(name=ARCH_ID + "-smoke", n_layers=2, d_model=128,
                        n_heads=8, n_kv_heads=2, d_head=16, d_ff=320,
                        vocab=512, sliding_window=64, remat="none",
                        loss_chunks=2, dtype="float32")
    return LMConfig(
        name=ARCH_ID, n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
        d_head=120, d_ff=10240, vocab=32000, sliding_window=4096,
        norm="rmsnorm", activation="silu", rope_theta=10000.0,
        remat="full", loss_chunks=64)
