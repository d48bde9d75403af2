"""The bytes a search needs (`bench.roofline.search_bytes`) at the card's
HBM rate, over the device time of every kernel inside a call, in %."""


def read(run: dict):
    t, peak = run.get("trace"), run.get("peak")
    if not t or not peak or not t["kernel_s"]:
        return None
    least_s = run["bytes_per_call"] / peak["hbm_bytes_per_s"]
    return 100.0 * least_s / (t["kernel_s"] / t["calls"])
