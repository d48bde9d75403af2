from .ops import l2_topk_rowwise, sq_l2_rowwise

__all__ = ["l2_topk_rowwise", "sq_l2_rowwise"]
