"""Roofline of the dry run's cells (port of `repro.roofline`)."""
