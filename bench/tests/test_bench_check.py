"""The check that decides `correct`, driven through the harness on the
CPU at a test's size: a sound run passes; the control (the reference one
precision down in the program's place) and each planted fault fail, under
each cell's limits."""
import json
import time

import pytest

from bench import data, faults, run
from bench.references import exact_l2

CELLS = [w["name"] for w in json.loads(
    (run.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _limits(cell):
    return run.load_json(run.BENCH / "limits" / f"{cell}.json")["limits"]


def _run(tiny, cell, seed, **kw):
    cfg, traffic, cache = tiny
    return run.run_cell(cfg, traffic, _limits(cell), seed, 0.2, False,
                        "cpu", time.perf_counter(), cache_dir=cache, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    r = _run(tiny, cell, 2**31 + 17)
    assert r["correct"], r["checks"]
    assert r["recall"][1] > 0.9


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    cfg = tiny[0]
    control = exact_l2.Control(data.corpus(cfg, "cpu"))
    r = _run(tiny, cell, 23, system=control)
    assert not r["correct"]
    assert r["checks"]["dist_gap"]["value"] > \
        r["checks"]["dist_gap"]["limit"]


@pytest.mark.parametrize("fault", ["hop_loop_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(tiny, cell, fault):
    with faults.FAULTS[fault]():
        r = _run(tiny, cell, 29)
    assert not r["correct"], r["checks"]


def test_traced_run_reads_its_stretch(tiny):
    cfg, traffic, cache = tiny
    r = run.run_cell(cfg, traffic, _limits(CELLS[0]), 31, 0.2, True, "cpu",
                     time.perf_counter(), cache_dir=cache)
    t = r["trace"]
    assert t["calls"] >= 1 and t["window_s"] > 0
    assert r["bytes_per_call"] > 0
    # no device here: the device readers find nothing and return nothing
    for name in ("launches_per_call", "search_roofline_pct",
                 "device_idle_pct"):
        assert run.load_module(run.BENCH / "metrics" / f"{name}.py"
                               ).read(r) is None
