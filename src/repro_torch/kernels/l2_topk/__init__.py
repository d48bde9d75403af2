from .ops import l2_topk, l2_topk_rowwise, sq_l2_rowwise
from .ref import l2_topk_ref

__all__ = ["l2_topk", "l2_topk_ref", "l2_topk_rowwise", "sq_l2_rowwise"]
