"""What surrounds the GPU kernel and runs on the CPU: the wrapper's
power-of-two padding and call plan, the Triton lowering of every
kernel shape, the choice of implementation per platform, and the
compile-cache location."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import random_entry
from cuda_satabsearch_tpu.core.codes import TYPE_PAD
from cuda_satabsearch_tpu.io.pack import pack_query
from cuda_satabsearch_tpu.ops import search, triton_sa
from cuda_satabsearch_tpu.ops.common import slots_per_restart


@pytest.mark.parametrize("x,want", [(1, 1), (2, 2), (3, 4), (8, 8), (9, 16),
                                    (24, 32), (48, 64), (80, 128),
                                    (112, 128), (104, 128)])
def test_pow2(x, want):
    assert triton_sa.pow2(x) == want


def test_lanes_one_thread_per_chain():
    """The chain axis is a power of two of at least one warp; with
    num_warps = lanes / 32 every thread owns one chain."""
    assert [triton_sa.lanes_for(c) for c in (1, 8, 32, 100, 128)] == \
        [32, 32, 32, 128, 128]


@pytest.mark.parametrize("n1p,d2p,lanes,want", [
    (8, 8, 128, 4), (8, 128, 128, 4), (32, 16, 128, 4), (32, 32, 128, 16),
    (32, 128, 128, 16), (64, 8, 128, 16), (128, 8, 128, 16),
    (8, 8, 32, 1), (128, 32, 32, 4)])
def test_warps_from_shapes(n1p, d2p, lanes, want):
    """One thread per chain while a chain's columns fit the registers,
    four once both the map and candidate columns are long (H100
    sweep, PERF.md)."""
    assert triton_sa.warps_for(n1p, d2p, lanes) == want


@pytest.mark.parametrize("n1", [5, 8, 13, 19, 101])
def test_pad_query(n1):
    """Query arrays pad to pow2(round8(n1)); padded types never match a
    DB SSE, padded codes/distances are zero, the real block is exact."""
    rng = np.random.default_rng(n1)
    q = pack_query(random_entry(rng, n1, "q"))
    n1r = max(8, -(-n1 // 8) * 8)
    qt, qtab, qd = triton_sa.pad_query(q, n1r)
    n1p = triton_sa.pow2(n1r)
    assert qt.shape == (n1p,) and qtab.shape == qd.shape == (n1p, n1p)
    assert qt.dtype == np.int32 and qtab.dtype == np.int8
    np.testing.assert_array_equal(qt[:n1], q.types)
    assert (qt[n1:] == TYPE_PAD).all()
    np.testing.assert_array_equal(qtab[:n1, :n1] >> 3, q.tabhi)
    np.testing.assert_array_equal(qtab[:n1, :n1] & 7, q.tablo)
    np.testing.assert_array_equal(qd[:n1, :n1], q.dmat)
    assert not qtab[n1:].any() and not qd[:, n1:].any()


def test_call_plan_respects_budget(monkeypatch):
    monkeypatch.setattr(triton_sa, "UNIFORM_BUDGET_BYTES", 1000 * 1000)
    pair = 1000  # 1000 pairs per call
    assert triton_sa._plan(4, 100, pair) == (4, 100)  # fits whole
    # cut the query axis: 10 queries per call at most, 105 queries in 11
    # balanced calls of 10 (the last padded by 5)
    assert triton_sa._plan(105, 100, pair) == (10, 100)
    assert triton_sa._plan(21, 100, pair) == (7, 100)  # 3 x 7, not 10+10+1
    # cut the entry axis, balanced: 2500 entries -> 3 calls of 834
    assert triton_sa._plan(1, 2500, pair) == (1, 834)
    # a call never goes below one pair, whatever the budget
    assert triton_sa._plan(3, 5, 10 ** 12) == (1, 1)


def test_budget_holds_a_586db_bucket_at_r4096():
    """The default budget keeps the 586-entry DB's largest bucket (209
    entries) in one call for the 19-SSE query at r=4096 (a cut call
    costs one more program latency)."""
    pair = 32 * slots_per_restart(19) * 128 * 4
    assert triton_sa._plan(1, 209, pair) == (1, 209)


def test_cuts_pad_by_repetition():
    assert triton_sa._cuts(5, 8).tolist() == [[0, 1, 2, 3, 4, 4, 4, 4]]
    assert triton_sa._cuts(7, 3).tolist() == [[0, 1, 2], [3, 4, 5],
                                              [6, 6, 6]]


@pytest.mark.parametrize("K,E,n1r,d2,c_par,r_seq,lorder,lsoln", [
    (1, 70, 8, 112, 128, 1, True, True),
    (3, 50, 24, 24, 128, 32, True, False),
    (1, 3, 104, 80, 100, 1, False, True),
    (2, 9, 16, 8, 16, 2, True, True),
])
def test_kernel_lowers_to_triton(K, E, n1r, d2, c_par, r_seq, lorder,
                                 lsoln):
    """Every primitive of the kernel has a Triton lowering at real
    widths: lower it for CUDA (no card needed; compiling the Triton IR
    to PTX happens only on the card)."""
    call = triton_sa.make_sa_call(K, E, n1r, d2, c_par, r_seq, lorder, lsoln)
    n1p, C = triton_sa.pow2(n1r), triton_sa.lanes_for(c_par)
    P = slots_per_restart(n1r)
    S = jax.ShapeDtypeStruct
    args = (S((K,), jnp.int32), S((K, n1p), jnp.int32),
            S((K, n1p, n1p), jnp.int8), S((K, n1p, n1p), jnp.float32),
            S((E,), jnp.int32), S((E, d2), jnp.int8),
            S((E, d2, d2), jnp.int8), S((E, d2, d2), jnp.float32),
            S((K, E, r_seq, P, C), jnp.float32))
    exp = jax.export.export(
        jax.jit(call), platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(*args)
    text = exp.mlir_module()
    assert "__gpu$xla.gpu.triton" in text
    warps = triton_sa.warps_for(n1p, triton_sa.pow2(d2), C)
    assert f"num_warps = {warps} : i32" in text


@pytest.mark.parametrize("platform,want", [("gpu", "triton"), ("cpu", "xla"),
                                           ("rocm", "xla")])
def test_backend_by_platform(monkeypatch, platform, want):
    """The GPU gets the kernel; every other platform the plain-XLA
    engine."""
    monkeypatch.setattr(search.jax, "default_backend", lambda: platform)
    assert search.resolve_backend() == want
    assert search.resolve_backend("auto") == want
    assert search.resolve_backend("xla") == "xla"
    assert search.resolve_backend("triton") == "triton"


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="unknown backend"):
        search.resolve_backend("pallas")


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_gather_mode_by_platform(monkeypatch, platform):
    monkeypatch.setattr(search.jax, "default_backend", lambda: platform)
    assert search.resolve_gather_mode("auto") == "take"
    assert search.resolve_gather_mode("onehot") == "onehot"


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the cache is there and nothing
    else is changed."""
    from cuda_satabsearch_tpu.core import cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_fixed_dir_in_checkout(monkeypatch):
    """Unset: a fixed .jax_cache at the checkout root, ignored by git --
    the same path in every process (never a temp name, pid or time)."""
    from cuda_satabsearch_tpu.core import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    got = cache.enable_compile_cache()
    assert got == os.path.join(root, ".jax_cache") == cache.CACHE_DIR
    if jax.config.jax_compilation_cache_dir != got:
        assert calls == [("jax_compilation_cache_dir", got)]
    with open(os.path.join(root, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
