"""The benchmark's data: fixed by the configuration's data_seed and the
run's seed, and of low local dimension."""
import pytest
import torch

from bench import data

CFG = {"n": 3000, "dim": 48, "clusters": 4, "latent_dim": 5,
       "latent_std": 1.0, "center_std": 0.5, "noise_std": 0.03,
       "data_seed": 11}


def test_corpus_fixed_by_data_seed():
    a, b = data.corpus(CFG, "cpu"), data.corpus(CFG, "cpu")
    assert a.shape == (3000, 48) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not torch.equal(a, data.corpus(dict(CFG, data_seed=12), "cpu"))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_queries_fixed_by_seed(seed):
    a = data.queries(CFG, 100, seed, "cpu")
    assert torch.equal(a, data.queries(CFG, 100, seed, "cpu"))
    assert not torch.equal(a, data.queries(CFG, 100, seed + 1, "cpu"))
    # held out: not rows of the corpus
    x = data.corpus(CFG, "cpu")
    assert torch.cdist(a, x).min() > 0


def test_clusters_lie_near_latent_subspaces():
    centres, bases = data.mixture(CFG)
    x = data.corpus(CFG, "cpu")
    own = torch.cdist(x, centres).argmin(1)
    for c in range(CFG["clusters"]):
        pts = x[own == c] - centres[c]
        var = torch.linalg.eigvalsh(pts.T @ pts / len(pts)).flip(0)
        assert var[:CFG["latent_dim"]].sum() / var.sum() > 0.95
