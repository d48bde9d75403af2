"""The port's training path on the card.

Every test here needs an NVIDIA GPU; elsewhere each one skips.  The file
imports neither jax nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

The train step computes its loss and gradients under `f32_matmul`, so a
float32 model's gradients do not depend on the caller's TF32 setting;
and a step on the card gives the CPU's losses within rtol 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import din_cfg, olmo_1b, qwen2_moe_a2_7b
from repro_torch.data.synthetic import din_batch, lm_batch
from repro_torch.models import transformer as tf
from repro_torch.models.recsys import din
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import init_train_state, make_train_step
from repro_torch.utils.tree import flatten_with_path, tree_map

pytestmark = pytest.mark.cuda
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
DIN_KEYS = ("hist_items", "hist_cates", "hist_len", "target_item",
            "target_cate", "label")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _lm_grads(params, cfg, tokens, labels):
    return trainer.loss_and_grads(
        lambda p, b: tf.lm_loss(p, cfg, *b), params, (tokens, labels))


def test_f32_gradients_ignore_the_callers_tf32(dev):
    """OLMo's layout at a small width, f32: gradients equal with the
    caller's TF32 on and off, bitwise wherever two runs with it off are
    (the embedding's scatter-add backward may sum in another order each
    run, as it does on a multi-threaded CPU; it is then held within rtol
    1e-5, atol 1e-6 of its largest element); the setting is restored."""
    cfg = dataclasses.replace(olmo_1b.model_config(reduced=True),
                              d_model=256, n_heads=4, n_kv_heads=4,
                              d_head=64, d_ff=512, vocab=2048)
    params = tf.init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    t, l = (torch.from_numpy(a).to(dev)
            for a in lm_batch(0, 2, 128, cfg.vocab))
    prev = torch.backends.cuda.matmul.allow_tf32
    runs = {}
    try:
        for name, tf32 in (("off", False), ("off again", False), ("on", True)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            runs[name] = _lm_grads(params, cfg, t, l)
            assert torch.backends.cuda.matmul.allow_tf32 == tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    off, again, on = (dict(flatten_with_path(runs[k][2]))
                      for k in ("off", "off again", "on"))
    assert torch.equal(runs["on"][0], runs["off"][0])
    for k, g in on.items():
        if torch.equal(off[k], again[k]):
            assert torch.equal(g, off[k]), k
        else:
            torch.testing.assert_close(
                g, off[k], rtol=1e-5, atol=1e-6 * float(off[k].abs().max()))


def _lm_case(reduced_module):
    cfg = reduced_module.model_config(reduced=True)

    def make(device):
        gen = torch.Generator().manual_seed(0)
        params = tf.init_lm_params(cfg, gen, device="cpu")
        params = tree_map(lambda x: x.to(device), params)

        def batch(s):
            t, l = lm_batch(s, 4, 32, cfg.vocab)
            return {"tokens": torch.from_numpy(t).to(device),
                    "labels": torch.from_numpy(l).to(device)}

        def loss_fn(p, b):
            return tf.lm_loss(p, cfg, b["tokens"], b["labels"])
        return params, batch, loss_fn
    return make


def _din_case(device):
    cfg = din_cfg.model_config(reduced=True)
    model = din.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    params = tree_map(lambda x: x.detach().to(device), model.param_tree())

    def batch(s):
        arrays = din_batch(s, 64, cfg.seq_len, cfg.n_items, cfg.n_cates)
        return {k: torch.from_numpy(v).to(device)
                for k, v in zip(DIN_KEYS, arrays)}

    def loss_fn(p, b):
        return din.loss_fn(p, cfg, b), {}
    return params, batch, loss_fn


@pytest.mark.parametrize("case", [
    _lm_case(olmo_1b), _lm_case(qwen2_moe_a2_7b), _din_case],
    ids=["olmo-1b", "qwen2-moe-a2.7b", "din"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_on_the_card_match_the_cpu(dev, case, accum):
    """Three steps from the same parameters and batches: each step's loss
    on the card within rtol 1e-4 of the CPU's."""
    losses = {}
    for device in ("cpu", dev):
        params, batch, loss_fn = case(device)
        step = make_train_step(loss_fn, OPT, accum=accum)
        state = init_train_state(params, OPT)
        out = []
        for s in range(3):
            state, m = step(state, batch(s))
            out.append(float(m["loss"]))
        assert int(state["step"]) == 3
        losses[str(device)] = out
    np.testing.assert_allclose(losses[str(dev)], losses["cpu"], rtol=1e-4)


def test_async_checkpointer_snapshots_card_tensors(dev, tmp_path):
    """CUDA leaves go through pinned buffers the checkpointer keeps
    between saves: each checkpoint holds the state as it was when saved,
    not an in-place update made right after (a CPU leaf beside them)."""
    state = {"w": torch.randn(1000, 100, device=dev),
             "step": torch.zeros((), dtype=torch.int32, device=dev),
             "host": torch.arange(5)}
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=3)
    want = {}
    for step in (1, 2, 3):
        state["w"].add_(1)
        state["step"].fill_(step)
        want[step] = {k: v.cpu().clone() for k, v in state.items()}
        saver.save(step, state)
        state["w"].mul_(2)
    saver.wait()
    for step in (1, 2, 3):
        got, _ = ckpt.restore(str(tmp_path), state, step=step)
        for k, v in got.items():
            assert v.device == state[k].device
            assert torch.equal(v.cpu(), want[step][k]), (step, k)
