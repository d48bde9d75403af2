"""Share of the traced window in which no kernel, copy or set runs on
the card, in %."""


def read(run: dict):
    t = run.get("trace")
    if not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
