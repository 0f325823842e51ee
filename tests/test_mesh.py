"""Mesh-sharded execution: bitwise parity with single-device search.

Runs on the virtual 8-device CPU mesh (conftest).  The entry-axis
sharding must not change any score: per-entry RNG keys derive from the
entry's file-order index, which is invariant to bucketing, padding, and
sharding.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from cuda_satabsearch_tpu.io.pack import pack_database, pack_query  # noqa: E402
from cuda_satabsearch_tpu.ops.search import search_db  # noqa: E402
from cuda_satabsearch_tpu.parallel.mesh import (entry_sharding,  # noqa: E402
                                                make_mesh)

from conftest import random_entry  # noqa: E402


def test_sharded_matches_unsharded():
    assert len(jax.devices()) >= 8, "conftest should provide 8 cpu devices"
    rng = np.random.default_rng(3)
    entries = [random_entry(rng, int(n), f"e{i:03d}")
               for i, n in enumerate(rng.integers(4, 30, size=21))]
    query = pack_query(random_entry(rng, 9, "q"))

    db_plain = pack_database(entries)
    res_plain = search_db(query, db_plain, maxstart=16, lorder=True,
                          seed=7, query_tag=3, backend="xla")

    mesh = make_mesh(jax.devices()[:8])
    db_pad = pack_database(entries, pad_to=mesh.size)
    res_shard = search_db(query, db_pad, maxstart=16, lorder=True,
                          seed=7, query_tag=3, backend="xla",
                          sharding=entry_sharding(mesh))

    np.testing.assert_array_equal(res_shard.scores, res_plain.scores)
    np.testing.assert_array_equal(res_shard.ssemaps, res_plain.ssemaps)


def test_mesh_padding_counts():
    rng = np.random.default_rng(5)
    entries = [random_entry(rng, 10, f"e{i}") for i in range(5)]
    db = pack_database(entries, pad_to=8)
    for b in db.buckets:
        assert b.size % 8 == 0
        assert (b.index >= 0).sum() == 5


@pytest.mark.parametrize("ndev", [4, 8])
def test_kernel_sharded_matches_unsharded(ndev):
    """The GPU kernel's path under jax.shard_map over a 4- or 8-device
    CPU mesh (interpret mode) == its unsharded run == the XLA engine,
    bitwise on the same threefry streams (single and multi-query)."""
    from cuda_satabsearch_tpu.ops.search import search_many_db

    rng = np.random.default_rng(13)
    entries = [random_entry(rng, int(n), f"e{i:03d}")
               for i, n in enumerate(rng.integers(4, 30, size=19))]
    query = pack_query(random_entry(rng, 7, "q"))
    queries = [query] + [pack_query(random_entry(rng, n, f"q{n}"))
                         for n in (5, 8)]
    mesh = make_mesh(jax.devices()[:ndev])
    db = pack_database(entries, buckets=(16, 32, 112), pad_to=ndev)

    kw = dict(maxstart=16, lorder=True, seed=7, c_max=16, backend="triton")
    plain = search_db(query, db, query_tag=3, **kw)
    shard = search_db(query, db, query_tag=3, sharding=entry_sharding(mesh),
                      **kw)
    np.testing.assert_array_equal(shard.scores, plain.scores)
    np.testing.assert_array_equal(shard.ssemaps, plain.ssemaps)
    ref = search_db(query, db, maxstart=16, lorder=True, seed=7,
                    query_tag=3, c_max=16, backend="xla")
    np.testing.assert_array_equal(shard.scores, ref.scores)
    np.testing.assert_array_equal(shard.ssemaps, ref.ssemaps)

    multi = search_many_db(queries, db, query_tags=[3, 4, 5],
                           sharding=entry_sharding(mesh), **kw)
    for q, t, got in zip(queries, [3, 4, 5], multi):
        one = search_db(q, db, query_tag=t, **kw)
        np.testing.assert_array_equal(got.scores, one.scores)
        np.testing.assert_array_equal(got.ssemaps, one.ssemaps)


def test_engine_sharded_matches_unsharded_4dev():
    """The XLA engine's SPMD path on a 4-device mesh, bitwise."""
    rng = np.random.default_rng(31)
    entries = [random_entry(rng, int(n), f"e{i:03d}")
               for i, n in enumerate(rng.integers(4, 40, size=15))]
    query = pack_query(random_entry(rng, 10, "q"))
    mesh = make_mesh(jax.devices()[:4])
    plain = search_db(query, pack_database(entries), maxstart=16,
                      lorder=False, seed=2, query_tag=1, backend="xla")
    shard = search_db(query, pack_database(entries, pad_to=4), maxstart=16,
                      lorder=False, seed=2, query_tag=1, backend="xla",
                      sharding=entry_sharding(mesh))
    np.testing.assert_array_equal(shard.scores, plain.scores)
    np.testing.assert_array_equal(shard.ssemaps, plain.ssemaps)


def test_mesh_balance_report():
    """Bucket-split sharding balances work exactly; a naive contiguous
    entry split of a lognormal (ASTRAL-like) size mix does not."""
    from bench import synthetic_entries
    from cuda_satabsearch_tpu.ops.balance import (balance_report,
                                                  format_report)

    db = pack_database(synthetic_entries(2048), pad_to=8)
    rep = balance_report(db, 8)
    # per-shard work equal by construction: every device searches 1/8
    # of every (padded) bucket
    assert rep["imbalance"] < 1e-9
    assert len(set(rep["per_shard_work"])) == 1
    assert len(set(rep["entries_per_shard"])) == 1
    # the naive contiguous split is measurably imbalanced on the
    # size-sorted lognormal mix (small entries first -> last shard
    # gets all the wide ones)
    assert rep["naive_imbalance"] > 0.10
    # padding overhead: entries padded to their bucket width (the mix's
    # rows are 1.30x real rows at the default caps) plus pad_to entries
    assert 0.25 < rep["padding_overhead"] < 0.40
    assert "imbalance 0.00%" in format_report(rep)


def test_mesh_balance_counts_shapes():
    """Work is counted from shapes alone: padded entries x bucket width
    x restarts x iterations, split evenly; real work counts each entry
    at its own order."""
    from cuda_satabsearch_tpu.ops.balance import balance_report

    rng = np.random.default_rng(2)
    entries = [random_entry(rng, n, f"e{i}")
               for i, n in enumerate((3, 5, 9, 20, 20))]
    db = pack_database(entries, buckets=(8, 16, 32, 112), pad_to=2)
    rep = balance_report(db, 2, restarts=4, maxiter=10)
    # buckets: 8 -> [3, 5], 16 -> [9, pad], 32 -> [20, 20]
    it = 4 * 10 / 1e6
    assert rep["per_shard_work"] == pytest.approx(
        [(8 + 16 + 32) * it] * 2)
    assert rep["entries_per_shard"] == [3, 3]
    real = (3 + 5 + 9 + 20 + 20) * it
    assert rep["padding_overhead"] == pytest.approx(
        2 * (8 + 16 + 32) * it / real - 1)
    # file order [3, 5, 9, 20, 20] at widths [8, 8, 16, 32, 32]: the
    # contiguous halves are entries 0-1 and 2-4
    assert rep["per_shard_naive_work"] == pytest.approx(
        [16 * it, 80 * it])
    with pytest.raises(ValueError, match="pad_to"):
        balance_report(pack_database(entries, pad_to=1), 2)
