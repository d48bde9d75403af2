"""Model configurations of the port (one module per architecture)."""
