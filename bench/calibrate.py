"""Readings that a cell's limits are set from (`bench/limits/<cell>.json`).

    python3 bench/calibrate.py --workload sift-batch10k \
        --seeds 101,102,... --control-seeds 201,202,203 \
        --fault-seeds 301,302,303 --out readings.json

In one process, on the card: the cell's system is set up once; for each
seed the seed's queries go through `1 + check_calls` calls of the
traffic's batch, and the reference judges them as a run would.  The
control (`Control`, the reference one precision down in the system's
place) and each planted fault (`bench/faults.py`) are read the same way
on their seeds.  Prints and writes every reading.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import data, faults
    from bench import run as harness

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, required=True)
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--fault-seeds", type=_seeds, default=[])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    _, cfg, traffic, _ = harness.load_cell(spec, args.workload)
    device = torch.device("cuda", 0)
    ref = harness.load_module(harness.BENCH / "references"
                              / f"{cfg['reference']}.py")
    system = harness.load_module(harness.BENCH / "systems"
                                 / f"{cfg['system']}.py").System(
        cfg, device, harness.CACHE / "index", harness.log)
    x = data.corpus(cfg, device)
    if not system.corpus_equals(x):
        raise RuntimeError("the cached index does not hold this corpus")
    k, batch, kw = traffic["k"], traffic["batch"], traffic["search"]
    out = {"workload": args.workload, "calls": 1 + traffic["check_calls"],
           "program": {}, "control": {}, "faults": {}}

    def read(sys_, seed):
        q = data.queries(cfg, batch, seed, device)
        t = time.perf_counter()
        answers = [sys_.search(q, k, **kw) for _ in range(out["calls"])]
        numbers, recall = harness.judge(ref, x, q, answers)
        numbers.update(recall=recall, seconds=time.perf_counter() - t)
        harness.log(f"{args.workload} seed {seed}: {numbers}")
        return numbers

    for seed in args.seeds:
        out["program"][seed] = read(system, seed)
    control = ref.Control(x)
    for seed in args.control_seeds:
        out["control"][seed] = read(control, seed)
    for name, fault in faults.FAULTS.items():
        with fault():
            out["faults"][name] = {s: read(system, s)
                                   for s in args.fault_seeds}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
