"""BENCHMARK.json against the benchmark's contract, and the benchmark's
files against the rule that nothing of it imports JAX or the JAX
package."""
import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
E2E = {m["name"]: m for m in SPEC["end_to_end"]}
CELLS = {w["name"]: w for w in SPEC["workloads"]}


def _line(s, most=200):
    return isinstance(s, str) and 1 <= len(s) <= most and "\n" not in s \
        and "\t" not in s


def _reported(metric, cell):
    return cell in metric.get("workloads", CELLS)


def test_names_units_and_text():
    names = [c["name"] for c in SPEC["configs"]] + list(CELLS) \
        + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["config"] for w in CELLS.values()]
    names += [w["traffic"] for w in CELLS.values()]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in SPEC["configs"]]
                 + [c["source"] for c in SPEC["configs"]]
                 + [w["why"] for w in CELLS.values()]
                 + [m["layer"] for m in SPEC["per_layer"]]
                 + SPEC["command"]):
        assert _line(text), text
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_shape_of_the_file():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    for group, n in (("configs", 24), ("workloads", 24), ("end_to_end", 16),
                     ("per_layer", 128)):
        assert 1 <= len(SPEC[group]) <= n
        assert len({e["name"] for e in SPEC[group]}) == len(SPEC[group])
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    pairs = [(w["config"], w["traffic"]) for w in CELLS.values()]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] in (1, 4) for w in CELLS.values())
    four = sum(w["chips"] == 4 for w in CELLS.values())
    assert four <= max(1, len(CELLS) // 4)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in SPEC["end_to_end"] if _reported(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reported(m, cell) for m in SPEC["per_layer"])


def test_moves_names_an_end_to_end_metric_of_each_cell():
    for m in SPEC["per_layer"]:
        target = E2E[m["moves"]]
        for cell in CELLS:
            if _reported(m, cell):
                assert _reported(target, cell), (m["name"], cell)


def test_files_found_by_name():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert (BENCH / "systems" / f"{cfg['system']}.py").exists()
        assert (BENCH / "references" / f"{cfg['reference']}.py").exists()
    for cell, w in CELLS.items():
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
        assert set(limits["limits"]) >= {"bad_rows", "dist_gap"}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"][1:] == ["bench/run.py"]


def _imports(path: Path) -> set:
    """Top-level names of every absolute import in `path`, and
    `bench.<module>` for each module of the benchmark it takes."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module] + [f"{node.module}.{a.name}"
                                     for a in node.names]
        else:
            continue
        for name in names:
            parts = name.split(".")
            tops.add(parts[0])
            if parts[0] == "bench" and len(parts) > 1:
                tops.add(".".join(parts[:2]))
    return tops


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_in_the_benchmark(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "references").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    seen, todo = set(), [path]
    while todo:
        p = todo.pop()
        seen.add(p)
        names = _imports(p)
        assert "repro_torch" not in names, p
        for name in names:
            dep = BENCH / f"{name.split('.')[1]}.py" if "." in name else None
            if dep is not None and dep.exists() and dep not in seen:
                todo.append(dep)
