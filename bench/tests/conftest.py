import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """A configuration cut to a CPU test's size (n 2,000 in 32 dims, a
    200-query batch), its traffic, and an index cache of its own.  The
    engine runs "fused_ref", the fused hop loop's plain version, so the
    hop-loop fault reaches it as it reaches the kernel on a card."""
    from bench import run
    cfg = run.load_json(run.BENCH / "configs" / "sift-128-euclidean.json")
    cfg.update(n=2000, dim=32, clusters=8, latent_dim=6)
    cfg["engine"] = {"backend": "fused_ref"}
    traffic = run.load_json(run.BENCH / "traffic" / "batch10k.json")
    traffic.update(batch=200, warmup_calls=1, trace_seconds=0.2)
    return cfg, traffic, tmp_path_factory.mktemp("index")
