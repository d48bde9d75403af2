"""gemma-7b [arXiv:2403.08295; hf]: 28L d=3072 16H (kv=16, head_dim=256),
GeGLU ff=24576, vocab=256000, tied embeddings, (1+w) RMSNorm, embeddings
scaled by sqrt(d).

On one card: 17.1 GB of bf16 weights; full attention, so the KV cache
grows 458,752 bytes a token (bf16) and decode at 32k positions fits two
rows beside the weights.  Decode attention is the flash-decode kernel at
Dh = 256, G = 1.
"""
from ..models.transformer import LMConfig
from .base import LM_SHAPES

ARCH_ID = "gemma-7b"
FAMILY = "lm"
SHAPES = LM_SHAPES
TRAIN_ACCUM = 4  # microbatches for train_4k (memory lever)


def model_config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(name=ARCH_ID + "-smoke", n_layers=2, d_model=128,
                        n_heads=4, n_kv_heads=4, d_head=32, d_ff=256,
                        vocab=512, norm="rmsnorm_gemma",
                        activation="gelu_tanh", tie_embeddings=True,
                        embed_scale=True, remat="none", loss_chunks=2,
                        dtype="float32")
    return LMConfig(
        name=ARCH_ID, n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
        d_head=256, d_ff=24576, vocab=256000, norm="rmsnorm_gemma",
        activation="gelu_tanh", tie_embeddings=True, embed_scale=True,
        rope_theta=10000.0, remat="full", loss_chunks=128)
