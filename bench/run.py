"""One run of one cell of the benchmark of `repro_torch`.

    python3 bench/run.py --workload sift-batch10k --seed 7 --seconds 10 \
        --trace 0

`BENCHMARK.json` at the root names the cell; its configuration
(`bench/configs/<name>.json`), traffic mix (`bench/traffic/<name>.json`),
limits (`bench/limits/<cell>.json`) and metric readers
(`bench/metrics/<metric>.py`) are found by name.  The configuration names
its system under test (`bench/systems/<system>.py`) and its plain
reference (`bench/references/<reference>.py`).

A run: set-up (imports, the kernel library, the index, the seed's
queries, warm-up calls of the one batch shape), then a closed loop of
calls for `--seconds` on the host clock; with `--trace 1` a traced
stretch follows.  Then, with the memory peak read and the system's state
freed, the reference judges a sample of the window's answers drawn from
the seed.  The last line of standard output is the result as one JSON
object; the numbers compared, each beside its limit, are the last lines
of standard error and the result's last key.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"
# whole top-level module names that no run may have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A benchmark file by path: metric names may hold '.' and '-'."""
    spec = importlib.util.spec_from_file_location(
        f"bench_file_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(spec: dict, name: str):
    """(cell, configuration, traffic, limits) of workload `name`."""
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return (cell, load_json(ROOT / entry["file"]),
            load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
            load_json(BENCH / "limits" / f"{name}.json")["limits"])


def cell_metrics(spec: dict, name: str, trace: bool) -> list:
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


class Sample:
    """The window's answers kept for the check: `size` calls drawn
    uniformly from the seed (reservoir sampling), and the last call."""

    def __init__(self, seed: int, size: int):
        self.rng = random.Random(seed)
        self.size, self.seen, self.kept, self.last = size, 0, [], None

    def add(self, answer) -> None:
        if len(self.kept) < self.size:
            self.kept.append(answer)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.kept[j] = answer
        self.seen += 1
        self.last = answer

    def answers(self) -> list:
        return self.kept + [self.last]


def judge(ref, x, q, answers: list):
    """The numbers compared over `answers` (each (ids, dists)) of the
    queries `q` on the corpus `x`, at their worst: rows summed, the
    others at their largest; and the mean recall@k."""
    gt = ref.exact_search(x, q, answers[0][0].shape[1])
    each = [ref.judge(x, q, gt, ids, dists) for ids, dists in answers]
    worst = {name: (sum if name == "bad_rows" else max)(
        numbers[name] for numbers, _ in each) for name in each[0][0]}
    return worst, sum(recall for _, recall in each) / len(each)


def run_cell(cfg: dict, traffic: dict, limits: dict, seed: int,
             seconds: float, trace: bool, device, t0: float,
             system=None, cache_dir: Path = CACHE / "index") -> dict:
    """Set up, measure, check: the run's record (see `main`).  `system`
    replaces the configuration's system under test where given."""
    import torch
    from bench import data, roofline
    from bench import trace as tracing

    cuda = torch.device(device).type == "cuda"
    ref = load_module(BENCH / "references" / f"{cfg['reference']}.py")
    t_sys = time.perf_counter()
    if system is None:
        system = load_module(BENCH / "systems" / f"{cfg['system']}.py"
                             ).System(cfg, device, cache_dir, log)
    k, batch, kw = traffic["k"], traffic["batch"], traffic["search"]
    t_q = time.perf_counter()
    q = data.queries(cfg, batch, seed, device)

    def call():
        return system.search(q, k, **kw)

    t_warm = time.perf_counter()
    for _ in range(traffic["warmup_calls"]):
        call()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    run = {"setup_s": time.perf_counter() - t0,
           "built_s": getattr(system, "built_s", None)}
    log(f"set-up {run['setup_s']:.3f} s: imports {t_sys - t0:.3f}, system "
        f"{t_q - t_sys:.3f}, queries {t_warm - t_q:.3f}, warm-up "
        f"{t0 + run['setup_s'] - t_warm:.3f}")

    sample = Sample(seed, traffic["check_calls"])
    lat = []
    start = end = time.perf_counter()
    while not lat or end - start < seconds:
        a = time.perf_counter()
        sample.add(call())
        end = time.perf_counter()
        lat.append(end - a)
    run.update(latencies_s=lat, window_s=end - start,
               queries=len(lat) * batch, attempted=len(lat) * batch)
    if trace:
        last, run["trace"] = tracing.profile_calls(
            call, traffic["trace_seconds"])
        sample.add(last)
        run["attempted"] += run["trace"]["calls"] * batch
        run["bytes_per_call"] = roofline.search_bytes(
            system.call_shape(kw), batch, k)
        log(f"traced stretch: {run['trace']['calls']} calls in "
            f"{run['trace']['window_s']:.4f} s; untraced window: "
            f"{len(lat)} calls in {run['window_s']:.4f} s")
    run["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if cuda else 0)

    x = data.corpus(cfg, device)
    if not system.corpus_equals(x):
        raise RuntimeError("the cached index does not hold this corpus")
    system.close()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers, recall = judge(ref, x, q, sample.answers())
    run["recall"] = (k, recall)
    log(f"reference and check {time.perf_counter() - t_ref:.3f} s")
    checks = {name: {"value": numbers[name], "limit": limits[name]}
              for name in numbers}
    run["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    run["checks"] = checks
    return run


def result_line(spec: dict, name: str, run: dict, trace: bool,
                device) -> dict:
    import torch

    from bench import roofline
    kind = torch.cuda.get_device_name(device)
    run["peak"] = roofline.PEAKS.get(kind)
    metrics = {}
    for m in cell_metrics(spec, name, trace):
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": kind, "count": 1,
           "memory_peak_bytes": run["memory_peak_bytes"]}
    out = {"correct": run["correct"], "attempted": run["attempted"],
           "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        t = run["trace"]
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["checks"] = run["checks"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every cache of the program and its libraries inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    spec = load_json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic, limits = load_cell(spec, args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    device = torch.device("cuda", 0)
    run = run_cell(cfg, traffic, limits, args.seed, args.seconds,
                   bool(args.trace), device, _T0)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        log(f"forbidden modules loaded in this process: {loaded}")
        return 4
    out = result_line(spec, args.workload, run, bool(args.trace), device)
    if run["built_s"] is not None:
        log(f"this run built the index: {run['built_s']:.3f} s of its "
            f"set-up")
    print(json.dumps(out), flush=True)
    for name, c in run["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
