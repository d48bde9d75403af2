"""The port's train and serve launchers (`launch/train.py`, `launch/serve.py`)
on the CPU, at the reduced configs: a run ends, writes a checkpoint in the
reference's format and resumes from it; without `--device` and without a
card the launchers raise rather than fall back to the CPU."""
import json
import math
import os

import pytest
import torch

from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.train import checkpoint as ckpt


@pytest.mark.parametrize("arch", ["olmo-1b", "din"])
def test_train_runs_checkpoints_and_resumes(arch, tmp_path, capsys):
    d = str(tmp_path / arch)
    base = ["--arch", arch, "--device", "cpu", "--batch", "4", "--seq", "16",
            "--log-every", "1", "--ckpt-dir", d]
    train_launch.main(base + ["--steps", "3", "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "step     3 loss" in out and out.rstrip().endswith("done")
    assert ckpt.latest_step(d) == 3
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 3
    assert manifest["leaves"]["['step']"] == [[], "int32"]
    train_launch.main(base + ["--steps", "5"])
    out = capsys.readouterr().out
    assert f"restored step 3 from {d}" in out
    assert "step     3 loss" not in out and "step     5 loss" in out
    assert ckpt.latest_step(d) == 5


@pytest.mark.parametrize("main", [train_launch.main, serve_launch.main],
                         ids=["train", "serve"])
def test_launchers_need_a_card_without_device(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--steps", "1"] if main is train_launch.main else ["--n", "50"])


def test_train_gnn_runs_on_cpu_and_resumes(tmp_path, capsys):
    """graphcast's reduced config trains on the CPU, checkpoints, and a
    second run resumes from --ckpt-dir at the step it reached."""
    args = ["--arch", "graphcast", "--device", "cpu", "--log-every", "1",
            "--ckpt-dir", str(tmp_path)]
    train_launch.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "arch=graphcast reduced=True" in out and "device=cpu" in out
    losses = [float(l.split("loss ")[1].split()[0])
              for l in out.splitlines() if l.startswith("step ")]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    train_launch.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "restored step 2" in out
    assert [l.split()[1] for l in out.splitlines()
            if l.startswith("step ")] == ["3"]


@pytest.mark.parametrize("arch", ["nequip", "mace", "dimenet"])
def test_train_gnn_raises_naming_its_slice(arch):
    """The GNN archs but graphcast exit as the reference's launcher does,
    naming the one it trains."""
    with pytest.raises(SystemExit, match="supports graphcast"):
        train_launch.main(["--arch", arch, "--device", "cpu", "--steps", "1"])


def test_serve_runs_on_cpu(capsys):
    serve_launch.main(["--n", "600", "--d", "16", "--queries", "5",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "BAMG built" in out and "BAMG     recall@10=" in out
