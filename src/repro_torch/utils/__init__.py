"""Utilities of the port: the shared fault-injection taxonomy."""
