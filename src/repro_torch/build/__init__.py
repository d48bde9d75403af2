"""Batched construction primitives (port): the (B, L) candidate pool."""
