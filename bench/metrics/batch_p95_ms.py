"""95th percentile of every call of the window, from submitting the batch
to holding its answers on the host (host clock), in ms."""
import numpy as np


def read(run: dict):
    return float(np.percentile(np.asarray(run["latencies_s"]) * 1e3, 95))
