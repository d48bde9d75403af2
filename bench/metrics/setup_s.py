"""Seconds from the process's start to the window's: imports, the kernel
library, the index (built on a checkout's first run), the queries and the
warm-up calls."""


def read(run: dict):
    return run["setup_s"]
