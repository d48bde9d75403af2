"""Core numerics of the port: distances, PQ, and the index interchange."""
