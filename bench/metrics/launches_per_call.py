"""CUDA kernels a call in the traced stretch (the profiler's kernel
events over the calls traced)."""


def read(run: dict):
    t = run.get("trace")
    if not t or not t["kernels"]:
        return None
    return t["kernels"] / t["calls"]
