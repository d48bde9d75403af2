"""The harness on the card at a test's size: the kernels' path is
correct, a planted fault in the fused hop loop is caught, and a traced
stretch reads the per-layer metrics.  Skips without a CUDA device."""
import time

import pytest
import torch

from bench import faults, run


@pytest.fixture
def card(tiny, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, traffic, _ = tiny
    return dict(cfg, engine={}), traffic, tmp_path


def _limits():
    return run.load_json(run.BENCH / "limits" / "sift-batch10k.json")["limits"]


@pytest.mark.cuda
def test_card_run_and_fault(card):
    cfg, traffic, cache = card
    dev = torch.device("cuda", 0)
    r = run.run_cell(cfg, traffic, _limits(), 41, 0.5, True, dev,
                     time.perf_counter(), cache_dir=cache)
    assert r["correct"], r["checks"]
    r["peak"] = {"hbm_bytes_per_s": 3.35e12}
    for name in ("launches_per_call", "search_roofline_pct",
                 "device_idle_pct"):
        v = run.load_module(run.BENCH / "metrics" / f"{name}.py").read(r)
        assert v is not None and v >= 0, name
    with faults.hop_loop_unchanged():
        r = run.run_cell(cfg, traffic, _limits(), 43, 0.2, False, dev,
                         time.perf_counter(), cache_dir=cache)
    assert not r["correct"]
