"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import numpy as np
import torch

# the JAX package's TPU backend names -> their Hopper counterpart here
TPU_BACKENDS = {"pallas": "cuda", "interpret": "ref",
                "fused_pallas": "fused", "fused_interpret": "fused_ref",
                "fused_stream": "fused", "fused_stream_interpret": "fused_ref"}


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA device.  A CUDA device without a card raises:
    the port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is present; "
            f"pass device='cpu' to run the plain PyTorch versions")
    return dev


def to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """A numpy array (copied) or tensor as a contiguous tensor on
    `device`, cast to `dtype` when given."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype).contiguous()


def to_numpy(a, dtype=None) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def reject_tpu_backend(backend: str, valid) -> None:
    """Raise a ValueError for a TPU backend name of the JAX package whose
    Hopper counterpart is one of `valid`, naming that counterpart."""
    if TPU_BACKENDS.get(backend) in valid:
        raise ValueError(
            f"backend {backend!r} is a TPU backend of the JAX package; its "
            f"Hopper counterpart is {TPU_BACKENDS[backend]!r}")
