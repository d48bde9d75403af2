"""Models of the port: the recsys workload (DIN) and LM serving."""
