"""Faults planted in the program under test, each a context manager, to
show that the check catches them (`bench/tests`, `bench/calibrate.py`).

- `hop_loop_unchanged`: the fused hop loop hands back the pool it was
  given, so no node past the entry seeds is expanded;
- `half_batch`: the search answers the first half of the batch and
  repeats those answers for the rest;
- `answer_altered`: one id of one answer is changed where the search
  returns it;
- `entry_scoring_const`: entry scoring returns one value for every
  candidate, so the seeds are the first candidates and not the nearest.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name: str, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def hop_loop_unchanged():
    from repro_torch.serve import ann_engine

    def make(orig):
        def beam_hops(adj, pool_ids, pool_d, pool_exp, max_hops, **kw):
            hops = torch.zeros(pool_ids.shape[0], dtype=torch.int32,
                               device=pool_ids.device)
            return pool_ids, pool_d, pool_exp, hops
        return beam_hops
    return _patched(ann_engine, "beam_hops", make)


def half_batch():
    from repro_torch.serve import ann_engine

    def make(orig):
        def batched_search(x, adj, codes, codebooks, entry_cands,
                           entry_codes, queries, tomb, **kw):
            b = queries.shape[0]
            h = (b + 1) // 2
            ids, dists, hops = orig(x, adj, codes, codebooks, entry_cands,
                                    entry_codes, queries[:h], tomb, **kw)
            rep = torch.arange(b, device=ids.device) % h
            return ids[rep], dists[rep], hops[rep]
        return batched_search
    return _patched(ann_engine, "batched_search", make)


def answer_altered():
    from repro_torch.serve import ann_engine

    def make(orig):
        def batched_search(x, *args, **kw):
            ids, dists, hops = orig(x, *args, **kw)
            ids = ids.clone()
            ids[0, 0] = (ids[0, 0] + 1) % x.shape[0]
            return ids, dists, hops
        return batched_search
    return _patched(ann_engine, "batched_search", make)


def entry_scoring_const():
    from repro_torch.serve import ann_engine

    def make(orig):
        def pq_adc(tables, codes, **kw):
            return torch.zeros((tables.shape[0], codes.shape[0]),
                               dtype=torch.float32, device=tables.device)
        return pq_adc
    return _patched(ann_engine, "pq_adc", make)


FAULTS = {"hop_loop_unchanged": hop_loop_unchanged,
          "half_batch": half_batch, "answer_altered": answer_altered,
          "entry_scoring_const": entry_scoring_const}
