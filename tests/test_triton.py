"""GPU SA kernel (ops/triton_sa.py) in Pallas interpret mode: bitwise
lockstep with the scalar golden model and the XLA engine.

The kernel consumes the engine's threefry stream under the same n1r slot
schedule, so on one backend all three produce identical scores and best
maps.  The same kernel source is compiled for the GPU by the Triton
route; the chip tests (-m gpu) check it there.
"""

import numpy as np
import pytest

from conftest import random_entry
from cuda_satabsearch_tpu.io.pack import pack_database, pack_query
from cuda_satabsearch_tpu.ops import golden, triton_sa
from cuda_satabsearch_tpu.ops.search import (search_db,
                                             search_many_db)


def _kernel(queries, db, tags, **kw):
    return triton_sa.assemble(triton_sa.dispatch(
        queries, db, query_tags=tags, interpret=True, **kw))


def _entries(rng, lo, hi, n):
    return [random_entry(rng, int(o), f"e{i:02d}")
            for i, o in enumerate(rng.integers(lo, hi + 1, size=n))]


def test_kernel_matches_golden_chains():
    """Kernel result == the best of the golden model's chains, fed each
    chain's column of the stream (one entry, so the map is the winning
    chain's)."""
    rng = np.random.default_rng(3)
    entry = random_entry(rng, 11, "db0")
    query = pack_query(random_entry(rng, 6, "q"))
    c_par, r_seq, seed, tag = 32, 2, 1234, 5
    db = pack_database([entry], buckets=(16, 112))
    [(ks, km)] = _kernel([query], db, [tag], maxstart=c_par * r_seq,
                         lorder=True, seed=seed, c_max=c_par)

    import jax.numpy as jnp
    u = np.asarray(triton_sa.uniforms(
        jnp.int32(seed), jnp.asarray([tag], jnp.int32),
        jnp.asarray([0], jnp.uint32), r_seq, 8, c_par))[0, 0]
    best, best_map = None, None
    for c in range(c_par):
        flat = np.concatenate([u[r, :, c] for r in range(r_seq)])
        res = golden.sa_chain(query, entry, True, r_seq, flat)
        if best is None or res.maxscore > best:
            best, best_map = res.maxscore, res.bestmap
    assert ks[0] == best
    np.testing.assert_array_equal(km[0], best_map)


def test_kernel_masks_chains_beyond_cpar():
    """c_par = 8 runs in a 32-lane block: lanes >= 8 must not count."""
    rng = np.random.default_rng(11)
    entries = _entries(rng, 4, 14, 5)
    query = pack_query(random_entry(rng, 5, "q"))
    db = pack_database(entries, buckets=(16, 112))
    [(ks, km)] = _kernel([query], db, [0], maxstart=8, lorder=True, seed=7,
                         c_max=8)
    ref = search_db(query, db, maxstart=8, lorder=True, seed=7,
                    query_tag=0, c_max=8, backend="xla")
    np.testing.assert_array_equal(ks, ref.scores)
    np.testing.assert_array_equal(km, ref.ssemaps)


@pytest.mark.parametrize("n1,lorder,lsoln", [
    (4, True, True), (7, True, True), (7, False, True), (8, True, False),
    (13, True, True), (13, False, False), (19, True, True),
])
def test_kernel_matches_engine(n1, lorder, lsoln):
    """Every bucket width (pow2 and not: 8, 16, 24, 48) vs the engine,
    scores and maps bitwise; query orders padded 4->8 ... 19->32."""
    rng = np.random.default_rng(100 + n1)
    entries = _entries(rng, 3, 45, 13)
    query = pack_query(random_entry(rng, n1, "q"))
    db = pack_database(entries, buckets=(8, 16, 24, 48, 112))
    [(ks, km)] = _kernel([query], db, [2], maxstart=16, lorder=lorder,
                         seed=99, c_max=16, lsoln=lsoln)
    ref = search_db(query, db, maxstart=16, lorder=lorder, seed=99,
                    query_tag=2, c_max=16, backend="xla")
    np.testing.assert_array_equal(ks, ref.scores)
    if lsoln:
        np.testing.assert_array_equal(km, ref.ssemaps)
    else:
        assert (km == -1).all() and km.shape == ref.ssemaps.shape


def test_kernel_wide_entries_and_sequential_restarts():
    """Widths 80 and 112 (128-row blocks, 4 match-bit words) with
    several sequential restarts per chain."""
    rng = np.random.default_rng(29)
    entries = _entries(rng, 60, 111, 3)
    query = pack_query(random_entry(rng, 9, "q"))
    db = pack_database(entries, buckets=(64, 80, 112))
    [(ks, km)] = _kernel([query], db, [1], maxstart=96, lorder=True,
                         seed=3, c_max=32)
    ref = search_db(query, db, maxstart=96, lorder=True, seed=3,
                    query_tag=1, c_max=32, backend="xla")
    np.testing.assert_array_equal(ks, ref.scores)
    np.testing.assert_array_equal(km, ref.ssemaps)


def test_query_batch_matches_single_queries():
    """Mixed exact orders of one round8 group in ONE dispatch (the query
    grid axis) == one dispatch per query, bitwise."""
    rng = np.random.default_rng(43)
    entries = _entries(rng, 4, 30, 9)
    queries = [pack_query(random_entry(rng, n, f"q{n}"))
               for n in (4, 6, 8, 5)]
    db = pack_database(entries, buckets=(16, 32, 112))
    kw = dict(maxstart=16, lorder=True, seed=9, c_max=16)
    multi = _kernel(queries, db, [5, 6, 7, 8], **kw)
    for qi, q in enumerate(queries):
        [(s1, m1)] = _kernel([q], db, [5 + qi], **kw)
        np.testing.assert_array_equal(multi[qi][0], s1)
        np.testing.assert_array_equal(multi[qi][1], m1)
        assert multi[qi][1].shape == (db.nentries, q.order)


def test_budget_split_calls_match_one_call(monkeypatch):
    """A uniform budget too small for one call splits a bucket into
    equal entry chunks and query chunks (padded by repetition); results
    are unchanged."""
    rng = np.random.default_rng(5)
    entries = _entries(rng, 4, 16, 7)
    queries = [pack_query(random_entry(rng, n, f"q{n}")) for n in (5, 7, 6)]
    db = pack_database(entries, buckets=(16, 112))
    kw = dict(maxstart=16, lorder=True, seed=4, c_max=16)
    whole = _kernel(queries, db, [0, 1, 2], **kw)
    pair = (triton_sa.slots_per_restart(8) * 32 * 4)  # r_seq=1, 32 lanes
    # 7 entries x 3 queries: 3 pairs/call -> 1 query x 3 entries (3 x 3
    # calls in a device loop, the last entry chunk padded); 10 -> 1
    # query x all 7 (3 calls); 14 -> 2 queries x 7 (last query padded)
    for pairs_per_call, plan in ((3, (1, 3)), (10, (1, 7)), (14, (2, 7))):
        monkeypatch.setattr(triton_sa, "UNIFORM_BUDGET_BYTES",
                            pairs_per_call * pair)
        assert triton_sa._plan(3, 7, pair) == plan
        split = _kernel(queries, db, [0, 1, 2], **kw)
        for (s0, m0), (s1, m1) in zip(whole, split):
            np.testing.assert_array_equal(s0, s1)
            np.testing.assert_array_equal(m0, m1)


def test_search_many_groups_by_round8():
    """search_many_db on the kernel path (orders from 3 round8 groups,
    interleaved) == per-query search_db on the engine path."""
    rng = np.random.default_rng(61)
    entries = _entries(rng, 4, 20, 6)
    queries = [pack_query(random_entry(rng, n, f"q{i}"))
               for i, n in enumerate((5, 12, 7, 17, 11))]
    db = pack_database(entries, buckets=(16, 112))
    kw = dict(maxstart=16, lorder=True, seed=1, c_max=16)
    got = search_many_db(queries, db, query_tags=[3, 4, 5, 6, 7],
                         backend="triton", **kw)
    for i, q in enumerate(queries):
        ref = search_db(q, db, query_tag=3 + i, backend="xla", **kw)
        np.testing.assert_array_equal(got[i].scores, ref.scores)
        np.testing.assert_array_equal(got[i].ssemaps, ref.ssemaps)
