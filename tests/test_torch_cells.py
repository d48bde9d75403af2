"""The port's dry-run path against the JAX package (CPU): the 40 cells,
the op counter, the roofline and a dry run on a fake process group.

`launch.cells.build_cell` is held against the reference's `build_cell`
for every (arch x shape) cell on both production meshes: kind, comment,
donated arguments, `model_flops` to rel 1e-12, and every argument
leaf's global shape, dtype and spec.  Both sides build on mesh
stand-ins that carry only axis names and sizes (no 512-device process);
the reference's `NamedSharding` is replaced by its spec, and its
`init_lm_params` (in the cells and in `lm_param_specs`) by the shapes of
one `jax.eval_shape` of the real one a config (a MoE init traces for
5-12 s, and the reference traces it up to eight times a cell).  Then the op counter on the reference's scanned
matmul (tests/test_data_pipeline.py), the roofline's arithmetic with the
H100 constants, the production meshes on a fake group, and two reduced
cells dry-run on a fake (2, 2) mesh.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import cells as jcells
from repro.models import transformer as jtf
from repro_torch.configs import registry
from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import device_mesh, make_production_mesh
from repro_torch.roofline import analysis
from repro_torch.roofline.op_count import OpCounter

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = jregistry.all_cells()
_REAL_INIT = jcells.init_lm_params


@functools.lru_cache(maxsize=None)
def _init_shapes(cfg):
    return jax.eval_shape(lambda: _REAL_INIT(cfg, jax.random.PRNGKey(0)))


def _fast_init(cfg, key):
    """The reference init's tree, as zeros of its shapes (one real trace a
    config)."""
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                        _init_shapes(cfg))


@pytest.fixture(scope="module")
def ref_cells():
    """build_cell of the reference, on mesh stand-ins."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcells, "NamedSharding", lambda mesh, spec: spec)
        mp.setattr(jcells, "init_lm_params", _fast_init)
        mp.setattr(jtf, "init_lm_params", _fast_init)   # lm_param_specs'
        out = {}

        def build(arch, shape, mesh_name):
            key = (arch, shape, mesh_name)
            if key not in out:
                dims, names = MESHES[mesh_name]
                mesh = types.SimpleNamespace(axis_names=names,
                                             devices=np.empty(dims))
                out[key] = jcells.build_cell(arch, shape, mesh)
            return out[key]

        yield build


def _norm(spec) -> tuple:
    """A spec as a tuple of axis-name tuples (None and P() alike)."""
    if spec is None:
        return ()
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


def _ref_flat(args, specs) -> dict:
    flat = dict(jax.tree_util.tree_flatten_with_path(args)[0])
    flat = {jax.tree_util.keystr(k): v for k, v in flat.items()}
    sp = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: x is None
        or isinstance(x, jax.sharding.PartitionSpec))[0]
    sp = {jax.tree_util.keystr(k): v for k, v in sp}
    return {k: (tuple(v.shape), np.dtype(v.dtype).name, _norm(sp.get(k)))
            for k, v in flat.items()}


def _port_flat(args, specs, path="") -> dict:
    if isinstance(args, dict):
        out = {}
        for k, v in args.items():
            out.update(_port_flat(v, None if specs is None else specs[k],
                                  f"{path}[{k!r}]"))
        return out
    if isinstance(args, (list, tuple)):
        out = {}
        for i, v in enumerate(args):
            out.update(_port_flat(v, None if specs is None else specs[i],
                                  f"{path}[{i}]"))
        return out
    if args is None:
        return {}
    return {path: (tuple(args.shape), str(args.dtype).replace("torch.", ""),
                   _norm(specs))}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_matches_reference(ref_cells, arch, shape, mesh_name):
    want = ref_cells(arch, shape, mesh_name)
    dims, names = MESHES[mesh_name]
    got = cells.build_cell(arch, shape, types.SimpleNamespace(
        mesh_dim_names=names, shape=dims))
    assert (got.kind, got.comment, tuple(got.donate)) == \
        (want.kind, want.comment, tuple(want.donate))
    assert got.model_flops == pytest.approx(want.model_flops, rel=1e-12)
    assert len(got.args) == len(want.args)
    for i, (ga, gs, wa, ws) in enumerate(zip(got.args, got.specs, want.args,
                                             want.in_shardings)):
        assert _port_flat(ga, gs) == _ref_flat(wa, ws), (arch, shape, i)


def test_registry_has_the_40_cells():
    assert registry.all_cells() == CELLS and len(CELLS) == 40


def test_op_counter_on_scanned_matmul():
    """tests/test_data_pipeline.py's scanned matmul: exactly 5 products
    of 2 * 64^3 FLOPs, and each product's output written once."""
    w = torch.ones(5, 64, 64)
    x = torch.ones(64, 64)
    with OpCounter() as c:
        for wi in w:
            x = x @ wi
    assert c.flops == 5 * 2 * 64 ** 3
    assert c.traffic == 5 * 64 * 64 * 4


def test_op_counter_peak_follows_storages():
    """Live bytes: tracked arguments, plus each allocation until freed;
    views and in-place writes allocate nothing."""
    a = torch.empty(1000, device="meta")
    c = OpCounter()
    c.track({"a": a})
    with c:
        b = a * 2                # + 4000
        b.add_(1)                # in place: written, not allocated
        v = b.view(10, 100)      # view: neither
        del b, v                 # freed
        d = a + 1                # + 4000 again
    assert c.peak == 8000 and c.live == 8000
    assert c.traffic == 12000
    del d
    assert c.live == 4000


def test_roofline_terms():
    """The reference's test_roofline_terms with the H100 constants."""
    r = analysis.Roofline(flops=989e12, traffic_bytes=3.35e12 / 2,
                          collective_bytes=50e9 / 4, collectives={},
                          model_flops=100e12 * 256, n_devices=256)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(0.5)
    assert r.t_collective == pytest.approx(0.25)
    assert r.bottleneck == "compute"
    assert r.mfu_bound == pytest.approx(100e12 / 989e12, rel=1e-6)
    assert analysis.HBM_BYTES == 80 * 2 ** 30
    got = analysis.roofline_from_counts(
        {"flops": 1.0, "traffic_bytes": 2.0},
        {"all_reduce": 10, "all_reduce_max": 1, "all_gather": 4,
         "collective-permute": 3}, 5.0, 1)
    assert got.collectives == {"all-reduce": 11.0, "all-gather": 4.0,
                               "collective-permute": 3.0}
    assert got.collective_bytes == 2 * 11 + 4 + 3


@pytest.mark.parametrize("multi", [False, True])
def test_production_meshes(multi):
    with dryrun.fake_group(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi)
        assert tuple(mesh.shape) == MESHES["multi" if multi else "single"][0]
        assert tuple(mesh.mesh_dim_names) == \
            MESHES["multi" if multi else "single"][1]


SMALL = {"molecule": ("nequip", dict(n_nodes=10, n_edges=24,
                                     batch_graphs=8)),
         "decode_32k": ("olmo-1b", dict(seq_len=64, global_batch=8)),
         # a MoE config under "seq_all": its d_ff is 0, which the tp check
         # of sequence-sharded decode once took for a dense FFN's
         "long_500k": ("qwen2-moe-a2.7b", dict(seq_len=256))}


@pytest.fixture
def small_cells(monkeypatch):
    """nequip/molecule, olmo-1b/decode_32k and qwen2-moe-a2.7b/long_500k
    at their reduced configs and small shapes."""
    for shape, (arch, over) in SMALL.items():
        mod = registry.get_arch(arch)
        monkeypatch.setattr(mod, "model_config",
                            functools.partial(mod.model_config, reduced=True))
        monkeypatch.setitem(mod.SHAPES, shape, dataclasses.replace(
            mod.SHAPES[shape], **over))


@pytest.mark.parametrize("shape", list(SMALL))
def test_dry_run_small_cell(small_cells, shape):
    arch = SMALL[shape][0]
    with dryrun.fake_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cpu")
        rec = dryrun.run_cell(arch, shape, mesh, "small")
    assert rec["n_devices"] == 4 and "rank 0" in rec["note"]
    mem, rl = rec["mem"], rec["roofline"]
    assert 0 < mem["argument_bytes"] <= mem["total_bytes"] and mem["fits_hbm"]
    assert mem["total_bytes"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                  + mem["output_bytes"])
    assert rl["hlo_flops_per_dev"] > 0 and rl["traffic_bytes_per_dev"] > 0
    assert rl["collective_bytes_per_dev"] > 0 and rl["t_bound_s"] > 0
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    if arch == "nequip":
        assert rec["comment"] == "n=80 e=192"
        # below the gates: the whole tables gathered, the sums scattered
        assert rec["comm"]["calls"].get("all_gather", 0) > 0
        assert rec["comm"]["calls"].get("reduce_scatter", 0) > 0
        assert "collective-permute" not in rec["comm"]["calls"]
    else:
        mode = "seq_all" if shape == "long_500k" else "head"
        assert rec["comment"].startswith(f"kv_mode={mode}")


def test_gnn_gates_are_the_reference_values():
    assert (cells.RING_GATHER_ROWS, cells.RING_SCATTER_ELEMS,
            cells.RING_PAIR_ROWS) == (1_000_000, 100_000_000, 1_000_000)


def test_products_cells_take_the_ring_on_meta():
    """On the production mesh only ogb_products crosses the ring gates:
    a NequIP step there runs collective-permutes (rank 0, meta)."""
    with dryrun.fake_group(256):
        mesh = make_production_mesh()
        cell = cells.build_cell("nequip", "ogb_products", mesh)
        gather, scatter = cells.gated_hooks("nequip", mesh)
        table = torch.empty(2449408 // 256, 96, device="meta")
        ix = torch.empty(61861888 // 256, dtype=torch.int64, device="meta")
        from repro_torch.utils.sharding import comm_log
        comm_log.reset()
        out = gather(table, ix)
        assert out.shape == (61861888 // 256, 96)
        assert comm_log.calls["collective-permute"] == 255
        assert cell.comment == "n=2449408 e=61861888"
