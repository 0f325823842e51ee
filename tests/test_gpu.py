"""Chip tests: the kernel as compiled for the GPU (Triton route, no
interpret mode) and the XLA engine on the card, against the engine on
the CPU and the golden model.  They skip where JAX finds no GPU; run
them on the card with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
tests/`` (chip_smoke.py does)."""

import jax
import numpy as np
import pytest

from conftest import random_entry
from cuda_satabsearch_tpu.io.pack import pack_database, pack_query
from cuda_satabsearch_tpu.ops.search import search_db, search_many_db

pytestmark = pytest.mark.gpu


def _db(seed, n=24, lo=3, hi=24):
    rng = np.random.default_rng(seed)
    entries = [random_entry(rng, int(o), f"e{i:02d}")
               for i, o in enumerate(rng.integers(lo, hi + 1, size=n))]
    return rng, pack_database(entries)


@pytest.mark.parametrize("n1,lorder", [(7, True), (13, False), (19, True)])
def test_compiled_kernel_matches_engine(gpu, n1, lorder):
    """Kernel compiled for the card == XLA engine on the card, scores and
    maps bitwise, on every default bucket width the DB touches."""
    rng, db = _db(n1)
    query = pack_query(random_entry(rng, n1, "q"))
    kw = dict(maxstart=128, lorder=lorder, seed=5, query_tag=1)
    got = search_db(query, db, backend="triton", **kw)
    ref = search_db(query, db, backend="xla", **kw)
    np.testing.assert_array_equal(got.scores, ref.scores)
    np.testing.assert_array_equal(got.ssemaps, ref.ssemaps)


def test_engine_on_card_matches_cpu(gpu):
    """The engine's log-domain acceptance is bit-stable across
    backends: GPU == CPU, scores and maps."""
    rng, db = _db(3, n=12)
    query = pack_query(random_entry(rng, 9, "q"))
    kw = dict(maxstart=32, lorder=True, seed=11, query_tag=0,
              backend="xla")
    got = search_db(query, db, **kw)
    with jax.default_device(jax.devices("cpu")[0]):
        ref = search_db(query, db, **kw)
    np.testing.assert_array_equal(got.scores, ref.scores)
    np.testing.assert_array_equal(got.ssemaps, ref.ssemaps)


def test_compiled_kernel_query_batch(gpu):
    """One dispatch of a mixed-order group on the card == one search per
    query on the card."""
    rng, db = _db(8)
    queries = [pack_query(random_entry(rng, n, f"q{n}")) for n in (5, 8, 6)]
    kw = dict(maxstart=128, lorder=True, seed=2, backend="triton")
    many = search_many_db(queries, db, query_tags=[0, 1, 2], **kw)
    for t, (q, got) in enumerate(zip(queries, many)):
        one = search_db(q, db, query_tag=t, **kw)
        np.testing.assert_array_equal(got.scores, one.scores)
        np.testing.assert_array_equal(got.ssemaps, one.ssemaps)
