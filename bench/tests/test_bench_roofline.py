"""The byte count of a search, by hand at a tiny shape."""
from bench import roofline


def test_search_bytes_by_hand():
    shape = {"n": 100, "dim": 8, "pq_m": 2, "pq_k": 4, "r": 3,
             "entry_cands": 5, "max_hops": 2, "rerank": 6}
    codebooks = 2 * 4 * 4 * 4          # M x K x D/M f32
    entries = 5 * 8 + 5 * 2            # int64 ids, M code bytes each
    query = 8 * 4                      # its vector
    hops = 2 * (3 * 4 + 3 * 2)         # R int32 ids, R x M code bytes
    rerank = 6 * 8 * 4                 # exact vectors
    answers = 10 * (8 + 4)             # k int64 ids, f32 dists
    want = codebooks + entries + 7 * (query + hops + rerank + answers)
    assert roofline.search_bytes(shape, batch=7, k=10) == want
