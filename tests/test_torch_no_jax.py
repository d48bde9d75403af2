"""The port, `chip_smoke.py`, the harnesses in `tools/` and the examples
in `examples_torch/` stand alone: none imports jax or the JAX package
`repro`, so they run on a machine that has neither."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(repro_torch.__file__).resolve().parent
SMOKE = ROOT / "chip_smoke.py"
EXAMPLES = sorted(str(p) for p in (ROOT / "examples_torch").glob("*.py"))
# `import jax...`, `from jax...`, `import repro` / `from repro.x` -- not
# repro_torch
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                        re.MULTILINE)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="repro_torch."))


def test_sources_import_no_jax_and_no_repro():
    files = (sorted(PKG.rglob("*.py")) + [SMOKE]
             + sorted((ROOT / "tools").glob("*.py"))
             + sorted((ROOT / "examples_torch").glob("*.py")))
    assert len(files) > 10
    names = {p.relative_to(ROOT).as_posix() for p in files}
    assert {"tools/kv_share_check.py", "examples_torch/quickstart.py",
            "examples_torch/serve_ann.py", "examples_torch/din_retrieval.py",
            "examples_torch/fresh_serving.py",
            "examples_torch/train_lm.py"} <= names
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
            "repro_torch.core.engine", "repro_torch.core.io_sim",
            "repro_torch.core.search", "repro_torch.utils.faults",
            "repro_torch.kernels.l2_topk.ops",
            "repro_torch.kernels.l2_topk.ref", "repro_torch.configs.base",
            "repro_torch.configs.din_cfg", "repro_torch.models.layers",
            "repro_torch.models.recsys.embedding",
            "repro_torch.models.recsys.din",
            "repro_torch.kernels.flash_decode.ops",
            "repro_torch.kernels.flash_decode.ref",
            "repro_torch.models.attention", "repro_torch.models.transformer",
            "repro_torch.configs.olmo_1b", "repro_torch.core.rng_rules",
            "repro_torch.core.bmrng", "repro_torch.launch.mesh",
            "repro_torch.serve.runtime.placement",
            "repro_torch.serve.runtime.instructions",
            "repro_torch.serve.runtime.runtime",
            "repro_torch.serve.runtime.scheduler",
            "repro_torch.serve.frontend", "repro_torch.serve.deploy",
            "repro_torch.index.delta.layer", "repro_torch.index.delta.engine",
            "repro_torch.index.delta.consolidate",
            "repro_torch.index.delta.service", "repro_torch.models.moe",
            "repro_torch.configs.gemma_7b",
            "repro_torch.configs.h2o_danube3_4b",
            "repro_torch.configs.qwen2_moe_a2_7b",
            "repro_torch.configs.moonshot_v1_16b_a3b",
            "repro_torch.configs.registry", "repro_torch.utils.tree",
            "repro_torch.data.pipeline", "repro_torch.train.optimizer",
            "repro_torch.train.trainer", "repro_torch.train.compression",
            "repro_torch.train.checkpoint", "repro_torch.train.ft",
            "repro_torch.launch.train", "repro_torch.launch.serve",
            "repro_torch.models.gnn", "repro_torch.models.gnn.common",
            "repro_torch.models.gnn.so3", "repro_torch.models.gnn.sampler",
            "repro_torch.models.gnn.graphcast",
            "repro_torch.models.gnn.nequip", "repro_torch.models.gnn.mace",
            "repro_torch.models.gnn.dimenet",
            "repro_torch.configs.graphcast_cfg",
            "repro_torch.configs.nequip_cfg", "repro_torch.configs.mace_cfg",
            "repro_torch.configs.dimenet_cfg",
            "repro_torch.utils.sharding",
            "repro_torch.models.gnn.ring_gather", "repro_torch.launch.cells",
            "repro_torch.launch.dryrun", "repro_torch.roofline",
            "repro_torch.roofline.analysis",
            "repro_torch.roofline.op_count"} <= set(mods)
    code = "\n".join([
        "import importlib, sys, runpy",
        "for name in ('jax', 'jaxlib', 'repro'):",
        "    sys.modules[name] = None",
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]",
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        "importlib.import_module('chip_smoke')",
        f"for f in {EXAMPLES!r}:",
        "    runpy.run_path(f, run_name='example')",
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
