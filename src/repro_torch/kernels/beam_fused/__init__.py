from .ops import beam_hops
from .ref import beam_hops_ref

__all__ = ["beam_hops", "beam_hops_ref"]
