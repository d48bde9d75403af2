"""Queries answered in the window over the window's seconds (host
clock)."""


def read(run: dict):
    return run["queries"] / run["window_s"]
