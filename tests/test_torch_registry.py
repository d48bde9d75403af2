"""The port's architecture registry and configs against the reference's.

Every ported config equals the reference's field for field
(`dataclasses.asdict`, the MoE block included), full and reduced; the
parameter counts are the reference's; `init_lm_params` stores the
reference's shapes in the dtype asked for, at the reference's scales.
"""
import dataclasses

import jax
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import transformer as jtf
from repro_torch.configs import registry
from repro_torch.models.transformer import init_lm_params

LM_ARCHS = ["gemma-7b", "h2o-danube-3-4b", "olmo-1b", "qwen2-moe-a2.7b",
            "moonshot-v1-16b-a3b"]
GNN_ARCHS = ["dimenet", "graphcast", "mace", "nequip"]


def test_ported_ids():
    assert sorted(registry.ARCHS) == sorted(LM_ARCHS + ["din"])
    assert sorted(set(jregistry.ARCHS) - set(registry.ARCHS)) == GNN_ARCHS
    for aid in registry.ARCHS:
        assert registry.get_arch(aid).ARCH_ID == aid
    assert registry.all_cells() == [
        cell for cell in jregistry.all_cells() if cell[0] in registry.ARCHS]
    assert len(registry.all_cells()) == 24


@pytest.mark.parametrize("arch", LM_ARCHS + ["din"])
def test_configs_match_reference(arch):
    mod, jmod = registry.get_arch(arch), jregistry.get_arch(arch)
    assert (mod.FAMILY, mod.SHAPES.keys()) == (jmod.FAMILY,
                                               jmod.SHAPES.keys())
    assert getattr(mod, "TRAIN_ACCUM", None) == getattr(jmod, "TRAIN_ACCUM",
                                                        None)
    for reduced in (False, True):
        got, want = mod.model_config(reduced), jmod.model_config(reduced)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_counts_match_reference(arch):
    for reduced in (False, True):
        got = registry.get_arch(arch).model_config(reduced)
        want = jregistry.get_arch(arch).model_config(reduced)
        assert got.n_params() == want.n_params()
        assert got.n_active_params() == want.n_active_params()
        if got.moe:
            assert got.moe.n_experts_padded == want.moe.n_experts_padded
            assert got.n_active_params() < got.n_params()


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_archs_raise(arch):
    with pytest.raises(NotImplementedError, match="7.5"):
        registry.get_arch(arch)


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_arch("gpt-2")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_lm_params_bf16_shapes_and_std(arch):
    """bf16 storage of every tensor, at the reference's shapes (MoE:
    router over the logical experts, experts padded) and scales: weights
    N(0, 1/d_in), embedding N(0, 0.02^2), norms neutral."""
    cfg = registry.get_arch(arch).model_config(reduced=True)
    jcfg = jregistry.get_arch(arch).model_config(reduced=True)
    params = init_lm_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.bfloat16)
    shapes = jax.eval_shape(lambda: jtf.init_lm_params(
        jcfg, jax.random.PRNGKey(0)))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    for path, sds in flat:
        t = params
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == sds.shape and t.dtype == torch.bfloat16
    tensors = [t for t in (*params["layers"].values(), *params.values())
               if torch.is_tensor(t)]
    assert len(tensors) == len(flat)
    for name, t in params["layers"].items():
        if t is None or name.endswith("norm"):
            continue
        d_in = t.shape[-2]
        assert abs(float(t.float().std()) * d_in ** 0.5 - 1) < 0.05, name
    assert abs(float(params["embed"].float().std()) / 0.02 - 1) < 0.05
    if params["final_norm"] is not None:
        neutral = 0.0 if cfg.norm == "rmsnorm_gemma" else 1.0
        assert bool((params["final_norm"] == neutral).all())
