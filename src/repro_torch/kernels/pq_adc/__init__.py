from .ops import pq_adc, pq_adc_rowwise
from .ref import pq_adc_ref, pq_adc_rowwise_ref

__all__ = ["pq_adc", "pq_adc_rowwise", "pq_adc_ref", "pq_adc_rowwise_ref"]
