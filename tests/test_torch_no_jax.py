"""The port and `chip_smoke.py` stand alone: neither imports jax nor the
JAX package `repro`, so they run on a machine that has neither."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(repro_torch.__file__).resolve().parent
SMOKE = ROOT / "chip_smoke.py"
# `import jax...`, `from jax...`, `import repro` / `from repro.x` -- not
# repro_torch
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                        re.MULTILINE)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="repro_torch."))


def test_sources_import_no_jax_and_no_repro():
    files = sorted(PKG.rglob("*.py")) + [SMOKE]
    assert len(files) > 10
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_every_module_imports_with_jax_and_repro_blocked():
    """Blocking a name in sys.modules makes any import of it raise, so
    this fails if any module reaches jax or repro, even indirectly."""
    mods = _modules()
    assert {"repro_torch.serve.ann_engine", "repro_torch.build.builder",
            "repro_torch.build.frontier", "repro_torch.build.prune",
            "repro_torch.build.knn", "repro_torch.build.bamg_refine",
            "repro_torch.build.chunking", "repro_torch.core.graph_build",
            "repro_torch.core.block_assign", "repro_torch.core.bamg",
            "repro_torch.core.navgraph", "repro_torch.core.storage",
            "repro_torch.core.engine"} <= set(mods)
    code = "\n".join([
        "import importlib, sys, runpy",
        "for name in ('jax', 'jaxlib', 'repro'):",
        "    sys.modules[name] = None",
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]",
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        "importlib.import_module('chip_smoke')",
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))",
        "               for k in sys.modules if sys.modules[k] is not None)",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_needs_the_repo_and_a_card(tmp_path):
    """Alone in a directory, or on a host without CUDA, the smoke script
    exits nonzero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(SMOKE.read_text())
    for cwd, script in ((tmp_path, lone), (ROOT, SMOKE)):
        out = subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                             capture_output=True, text=True, timeout=120,
                             env={"PATH": "/usr/bin:/bin",
                                  "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
