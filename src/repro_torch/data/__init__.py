"""Deterministic synthetic corpora (port)."""
