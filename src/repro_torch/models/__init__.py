"""Models of the port: the recsys workload (DIN) so far."""
