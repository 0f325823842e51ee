"""Simulated-annealing search kernel for the GPU (Pallas, Triton route).

Follows the reference's own design on the card
(cudaSaTabsearch_kernel.cu:806-1236): one thread per SA chain, one block
per DB entry, and the whole restart loop -- greedy init, the O(n1^2)
score, the 100 moves with their O(n1) delta -- inside the thread,
closed by a block reduction of the best chain (kernel.cu:1194-1221).

Here one program runs one (query, DB entry) pair.  Its chains lie along
the block's minor axis with ``num_warps = chains / 32``, so each thread
owns one chain (four threads per chain for long queries, warps_for).
Every loop runs inside the kernel.  Per move, the
entry's tables are read with integer-array indexed loads: an entry holds
at most 112 x 112 packed codes and distances, which stay in L1 (the
reference's "noshared" variant for wide entries).  The DB SSEs a chain
has matched are kept as a bitmask, one 32-bit word per 32 DB SSEs.

Triton wants power-of-two block shapes; the query order (padded to
round8) and the bucket caps 24/48/80/112 are not.  The wrapper pads the
query arrays to a power of two and the kernel masks everything beyond
the exact orders, which arrive at run time; the entry tables keep their
bucket shape and are only ever read through clamped indices.

Randomness is the engine's own threefry stream (``uniforms`` below),
generated by XLA and supplied as an input, so kernel, engine
(ops/engine.py) and golden model (ops/golden.py) agree bitwise.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..core.constants import SAParams, DEFAULTS
from .common import round8, slots_per_restart
from .engine import log_acc_slots

I32 = jnp.int32
F32 = jnp.float32

# Largest uniform-stream buffer one kernel call may consume.  The stream
# is materialized per call (restarts x slots x chains f32 per (query,
# entry) pair: 158 KB at r=128 with an 8-SSE query, 5.3 MB at r=4096
# with a 19-SSE one), so calls are cut to this size.  A call that is cut
# costs about one program's latency more, so the budget holds a whole
# 586-entry-DB bucket at r=4096 (1.1 GB).
UNIFORM_BUDGET_BYTES = 4 << 30


def pow2(x: int) -> int:
    """Smallest power of two >= x."""
    return 1 << max(0, int(x) - 1).bit_length()


def lanes_for(c_par: int) -> int:
    """Chain-axis block width: a power of two, at least one warp."""
    return max(32, pow2(c_par))


def pack_codes(tabhi, tablo):
    """hi*8 + lo as int8: tableau codes are 0..4, so one byte holds
    both halves and one load fetches them."""
    return (np.asarray(tabhi, np.int32) * 8
            + np.asarray(tablo, np.int32)).astype(np.int8)


def pad_query(query, n1r: int):
    """Query arrays padded to pow2(n1r) rows: (types int32 [N1P], packed
    codes int8 [N1P, N1P], dmat f32 [N1P, N1P]).  Padding types are
    TYPE_PAD, which no DB SSE carries, so padded rows never match."""
    from ..core.codes import TYPE_PAD

    n1p = pow2(n1r)
    n1 = query.order
    qt = np.full((n1p,), TYPE_PAD, np.int32)
    qt[:n1] = query.types
    qtab = np.zeros((n1p, n1p), np.int8)
    qtab[:n1, :n1] = pack_codes(query.tabhi, query.tablo)
    qd = np.zeros((n1p, n1p), np.float32)
    qd[:n1, :n1] = query.dmat
    return qt, qtab, qd


def _tscord(pq, pt):
    """Pair score from packed codes (+2 both halves equal, +1 one,
    -2 none; kernel.cu:306-332)."""
    he = (pq >> 3) == (pt >> 3)
    le = (pq & 7) == (pt & 7)
    return jnp.where(he & le, 2, jnp.where(he | le, 1, -2)).astype(I32)


def warps_for(n1p: int, d2p: int, lanes: int) -> int:
    """Warps per program.  One warp per 32 chains gives each thread a
    whole chain: its [n1p] map and best map live across the move loop
    and its [d2p] candidate column is rebuilt every move.  Once those
    columns are long (n1p >= 64, or both n1p and d2p >= 32) they spill
    out of the registers, and four times the warps -- each column split
    over four threads -- wins: 1.3x at n1=19 r=4096, 3-10x at n1=101
    (H100, PERF.md).  Short columns lose to the extra cross-warp
    reductions."""
    per_chain = 4 if n1p >= 64 or min(n1p, d2p) >= 32 else 1
    return lanes // 32 * per_chain


@functools.lru_cache(maxsize=None)
def make_sa_call(K: int, E: int, n1r: int, d2: int, c_par: int, r_seq: int,
                 lorder: bool, lsoln: bool, params: SAParams = DEFAULTS,
                 interpret: bool = False):
    """One kernel call over a (K queries) x (E entries) grid.

    fn(n1s[K] i32, qt[K,N1P] i32, qtab[K,N1P,N1P] i8, qd[K,N1P,N1P] f32,
       n2[E] i32, t2[E,d2] i8, tab2[E,d2,d2] i8, dm2[E,d2,d2] f32,
       u[K,E,r_seq,P,C] f32)
      -> scores [K,E] i32 (+ maps [K,E,N1P] i32 when lsoln)

    ``n1s`` are the exact query orders (all with round8(n1) == n1r);
    ``u`` is the supplied uniform stream (``uniforms``, chains padded
    to C lanes; lanes >= c_par are masked out of the result).
    """
    p = params
    n1p = pow2(n1r)
    d2p = pow2(d2)
    C = lanes_for(c_par)
    P = slots_per_restart(n1r, p.maxiter)
    W = -(-d2p // 32)  # matched-bit words per chain
    BIG = n1p + d2p + 999
    EPS = np.float32(p.eps)
    MXSSED = np.float32(p.mxssed)

    def kernel(n1_ref, qt_ref, qtab_ref, qd_ref, n2_ref, t2_ref, tab2_ref,
               dm2_ref, u_ref, s_ref, *m_refs):
        n1 = n1_ref[...]
        n2 = n2_ref[...]
        n1f = n1.astype(F32)
        rows1 = lax.broadcasted_iota(I32, (n1p, C), 0)
        rows2 = lax.broadcasted_iota(I32, (d2p, C), 0)
        lanes = lax.broadcasted_iota(I32, (C,), 0)
        types2 = t2_ref[jnp.minimum(lax.broadcasted_iota(I32, (d2p,), 0),
                                    d2 - 1)].astype(I32)[:, None]

        def row(a, k):
            """a[k[c], c] for a [n1p, C] register array (0 where k is
            out of range)."""
            return jnp.sum(jnp.where(rows1 == k[None, :], a, 0), axis=0)

        def fetch(ref, l, j):
            """ref[l[k, c], j[c]] for the entry's table (indices clamped
            to the bucket cap; every use masks invalid ones)."""
            li = jnp.clip(l, 0, d2 - 1)
            ji = jnp.broadcast_to(jnp.clip(j, 0, d2 - 1)[None, :], (n1p, C))
            return ref[li, ji]

        def qfetch(ref, s):
            """ref[k, s[c]] over the query's padded rows."""
            return ref[rows1, jnp.broadcast_to(s[None, :], (n1p, C))]

        def matched(words):
            w = words[0][None, :]
            for i in range(1, W):
                w = jnp.where((rows2 >> 5) == i, words[i][None, :], w)
            return ((w >> (rows2 & 31)) & 1) != 0

        def set_bit(words, j, cond):
            return tuple(
                jnp.where(cond & ((j >> 5) == i), w | (1 << (j & 31)), w)
                for i, w in enumerate(words))

        def clear_bit(words, j, cond):
            return tuple(
                jnp.where(cond & ((j >> 5) == i), w & ~(1 << (j & 31)), w)
                for i, w in enumerate(words))

        def restart_body(r, carry):
            maxscore, bestmap = carry

            def thinit_body(i, c):
                """Greedy random initial matching (kernel.cu:588-648)."""
                ssemap, words, j, stopped = c
                u_i = u_ref[r, i, :]
                t1 = qt_ref[i]
                attempt = (u_i < p.init_matchprob) & ~stopped
                cmask = ((rows2 >= j[None, :]) & (types2 == t1)
                         & (rows2 < n2))
                jfound = jnp.min(jnp.where(cmask, rows2, BIG), axis=0)
                ok = attempt & (jfound < n2)
                stopped = stopped | (attempt & (jfound >= n2))
                ssemap = jnp.where((rows1 == i) & ok[None, :],
                                   jfound[None, :], ssemap)
                words = set_bit(words, jfound, ok)
                j = jnp.where(ok, jfound + 1, j)
                return ssemap, words, j, stopped

            ssemap, words, _, _ = lax.fori_loop(
                0, n1, thinit_body,
                (jnp.full((n1p, C), -1, I32),
                 tuple(jnp.zeros((C,), I32) for _ in range(W)),
                 jnp.zeros((C,), I32), jnp.zeros((C,), jnp.bool_)))

            def initscore_body(i, acc):
                """Row i of the O(n1^2) score (kernel.cu:396-440)."""
                l_i = row(ssemap, jnp.broadcast_to(i, (C,)))
                vals_d = fetch(dm2_ref, ssemap, l_i)
                vals_t = fetch(tab2_ref, ssemap, l_i).astype(I32)
                qd_i = qd_ref[i, :][:, None]
                qt_i = qtab_ref[i, :].astype(I32)[:, None]
                use = ((rows1 > i) & (ssemap >= 0) & (l_i[None, :] >= 0)
                       & (jnp.abs(qd_i - vals_d) <= MXSSED))
                return acc + jnp.sum(
                    jnp.where(use, _tscord(qt_i, vals_t), 0), axis=0)

            score = lax.fori_loop(0, n1, initscore_body,
                                  jnp.zeros((C,), I32))
            improved = score > maxscore
            maxscore = jnp.where(improved, score, maxscore)
            if lsoln:
                bestmap = jnp.where(improved[None, :], ssemap, bestmap)

            def move_body(it, c):
                """One SA move for every chain (kernel.cu:1032-1191)."""
                ssemap, words, score, maxscore, bestmap, temp = c
                base = n1r + 3 * it
                u_move = u_ref[r, base, :]
                u_cand = u_ref[r, base + 1, :]
                u_acc = u_ref[r, base + 2, :]
                ssei = ((u_move - EPS) * n1f).astype(I32)

                if lorder:  # candidate window (kernel.cu:1053-1083)
                    kbest = jnp.max(jnp.where(
                        (rows1 <= ssei[None, :]) & (ssemap >= 0), rows1, -1),
                        axis=0)
                    startj = jnp.where(kbest >= 0, row(ssemap, kbest), n2)
                    knext = jnp.min(jnp.where(
                        (rows1 > ssei[None, :]) & (ssemap != -1), rows1, BIG),
                        axis=0)
                    endj = jnp.where(
                        ssei == n1 - 1, n2,
                        jnp.where(knext < n1, row(ssemap, knext), -1))
                else:
                    startj = jnp.zeros((C,), I32)
                    endj = jnp.broadcast_to(n2, (C,))

                # uniform same-type unmatched pick (kernel.cu:677-714)
                qt = qt_ref[ssei]
                cand = ((rows2 >= startj[None, :]) & (rows2 < endj[None, :])
                        & (types2 == qt[None, :]) & ~matched(words))
                candi = cand.astype(I32)
                count = jnp.sum(candi, axis=0)
                rr = ((u_cand - EPS) * count.astype(F32)).astype(I32)
                hit = cand & (jnp.cumsum(candi, axis=0) == rr[None, :] + 1)
                newj = jnp.max(jnp.where(hit, rows2, -1), axis=0)
                oldj = row(ssemap, ssei)

                # O(n1) incremental delta (kernel.cu:502-535)
                qd = qfetch(qd_ref, ssei)
                qtb = qfetch(qtab_ref, ssei).astype(I32)
                old_d = fetch(dm2_ref, ssemap, oldj)
                old_t = fetch(tab2_ref, ssemap, oldj).astype(I32)
                new_d = fetch(dm2_ref, ssemap, newj)
                new_t = fetch(tab2_ref, ssemap, newj).astype(I32)
                m = (ssemap >= 0) & (rows1 != ssei[None, :])
                t_o = (m & (oldj[None, :] >= 0) & (ssemap != oldj[None, :])
                       & (jnp.abs(qd - old_d) <= MXSSED))
                t_n = (m & (newj[None, :] >= 0) & (ssemap != newj[None, :])
                       & (jnp.abs(qd - new_d) <= MXSSED))
                delta = jnp.sum(jnp.where(t_n, _tscord(qtb, new_t), 0)
                                - jnp.where(t_o, _tscord(qtb, old_t), 0),
                                axis=0)

                # max tracking before acceptance (kernel.cu:1136-1155)
                newscore = score + delta
                improved = newscore > maxscore
                maxscore = jnp.where(improved, newscore, maxscore)
                at_i = rows1 == ssei[None, :]
                if lsoln:
                    bestmap = jnp.where(
                        improved[None, :],
                        jnp.where(at_i, newj[None, :], ssemap), bestmap)

                # log-domain Metropolis acceptance (engine.log_acc_slots)
                accept = delta.astype(F32) > temp * u_acc
                score = jnp.where(accept, newscore, score)
                ssemap = jnp.where(at_i & accept[None, :], newj[None, :],
                                   ssemap)
                words = clear_bit(words, oldj, accept & (oldj >= 0))
                words = set_bit(words, newj, accept & (newj >= 0))
                return (ssemap, words, score, maxscore, bestmap,
                        temp * np.float32(p.alpha))

            _, _, _, maxscore, bestmap, _ = lax.fori_loop(
                0, p.maxiter, move_body,
                (ssemap, words, score, maxscore, bestmap,
                 jnp.asarray(p.temp0, F32)))
            return maxscore, bestmap

        maxscore, bestmap = lax.fori_loop(
            0, r_seq, restart_body,
            (jnp.full((C,), p.maxscore_init, I32),
             jnp.full((n1p, C), -1, I32)))

        # block reduction over chains (kernel.cu:1194-1233): the first
        # maximal chain wins, as in the reference's serial scan
        live = jnp.where(lanes < c_par, maxscore, p.maxscore_init - 1)
        best = jnp.max(live)
        s_ref[...] = best
        if lsoln:
            winner = jnp.min(jnp.where(live == best, lanes, C))
            m_refs[0][...] = jnp.sum(
                jnp.where(lanes[None, :] == winner, bestmap, 0), axis=1)

    q_spec = lambda *shape: pl.BlockSpec(  # noqa: E731
        (None,) + shape, lambda q, e: (q,) + (0,) * len(shape))
    e_spec = lambda *shape: pl.BlockSpec(  # noqa: E731
        (None,) + shape, lambda q, e: (e,) + (0,) * len(shape))
    out_specs = [pl.BlockSpec((None, None), lambda q, e: (q, e))]
    out_shape = [jax.ShapeDtypeStruct((K, E), I32)]
    if lsoln:
        out_specs.append(pl.BlockSpec((None, None, n1p),
                                      lambda q, e: (q, e, 0)))
        out_shape.append(jax.ShapeDtypeStruct((K, E, n1p), I32))
    return pl.pallas_call(
        kernel,
        grid=(K, E),
        in_specs=[q_spec(), q_spec(n1p), q_spec(n1p, n1p),
                  q_spec(n1p, n1p), e_spec(), e_spec(d2), e_spec(d2, d2),
                  e_spec(d2, d2),
                  pl.BlockSpec((None, None, r_seq, P, C),
                               lambda q, e: (q, e, 0, 0, 0))],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=warps_for(n1p, d2p, C), num_stages=1),
        interpret=interpret,
        name=f"sa_search_d{d2}_n{n1r}",
    )


def uniforms(seed, tags, indices, r_seq: int, n1r: int, c_par: int,
             maxiter: int = DEFAULTS.maxiter):
    """[K, E, r_seq, P, C] stream: for query tag k and entry file-order
    index e, restart r draws uniform(fold_in(fold_in(fold_in(
    PRNGKey(seed), k), e), r), (P, c_par)) -- the engine's per-restart
    block (ops/engine.py restart_body, keyed by search.entry_keys) --
    with the acceptance slots in the log domain and chains padded to the
    kernel's lane width with zeros."""
    P = slots_per_restart(n1r, maxiter)
    C = lanes_for(c_par)
    base = jax.random.PRNGKey(seed)

    def per_entry(key):
        def per_restart(r):
            u = jax.random.uniform(jax.random.fold_in(key, r), (P, c_par),
                                   dtype=F32)
            return jnp.pad(log_acc_slots(u, n1r), ((0, 0), (0, C - c_par)))
        return jax.vmap(per_restart)(jnp.arange(r_seq, dtype=jnp.uint32))

    def per_tag(tag):
        qkey = jax.random.fold_in(base, tag)
        return jax.vmap(lambda i: per_entry(jax.random.fold_in(qkey, i)))(
            indices)

    return jax.vmap(per_tag)(tags)


def _plan(K: int, N: int, pair_bytes: int) -> tuple[int, int]:
    """(queries, entries) per kernel call so that one call's uniform
    stream stays within UNIFORM_BUDGET_BYTES, with the calls of an axis
    equal in size (the last one is padded, so balanced cuts waste the
    least)."""
    budget = max(1, UNIFORM_BUDGET_BYTES // pair_bytes)  # pairs per call
    if K * N <= budget:
        return K, N
    if N <= budget:
        kc = max(1, budget // N)
        return -(-K // -(-K // kc)), N
    return 1, -(-N // -(-N // budget))


def _cuts(n: int, size: int) -> np.ndarray:
    """range(n) as [ceil(n/size), size] index blocks; the last one is
    filled up by repeating n-1 (its results are dropped), so every call
    of a bucket has one shape and compiles once."""
    starts = np.arange(0, n, size)[:, None]
    return np.minimum(starts + np.arange(size)[None, :], n - 1)


def _bucket_search(args, K: int, kc: int, ec: int, n1r: int, d2: int,
                   c_par: int, r_seq: int, lorder: bool, lsoln: bool,
                   params: SAParams, interpret: bool):
    """All (query, entry) pairs of one bucket, as calls of kc queries x
    ec entries.  Several calls run as a device loop (lax.map), so the
    program's size and compile time do not grow with their number and
    only one call's uniform stream is alive at a time.
    Returns scores [K, N] (+ maps [K, N, N1P])."""
    seed, tags, n1s, qt, qtab, qd, index, n2, t2, tab2, dm2 = args
    N = n2.shape[0]
    call = make_sa_call(kc, ec, n1r, d2, c_par, r_seq, lorder, lsoln, params,
                        interpret)

    def one(qi, ei):
        u = uniforms(seed, tags[qi], index[ei], r_seq, n1r, c_par,
                     params.maxiter)
        return tuple(call(n1s[qi], qt[qi], qtab[qi], qd[qi], n2[ei], t2[ei],
                          tab2[ei], dm2[ei], u))

    if kc == K and ec == N:
        out = one(slice(None), slice(None))
        return out[0], (out[1] if lsoln else None)
    qcuts, ecuts = _cuts(K, kc), _cuts(N, ec)
    nq, ne = len(qcuts), len(ecuts)
    qi = jnp.asarray(np.repeat(qcuts, ne, axis=0))
    ei = jnp.asarray(np.tile(ecuts, (nq, 1)))
    out = lax.map(lambda ij: one(*ij), (qi, ei))  # [nq*ne, kc, ec, ...]

    def grid(x):
        x = x.reshape((nq, ne, kc, ec) + x.shape[3:])
        x = jnp.moveaxis(x, 2, 1).reshape((nq * kc, ne * ec) + x.shape[4:])
        return x[:K, :N]

    return grid(out[0]), (grid(out[1]) if lsoln else None)


@functools.lru_cache(maxsize=None)
def _make_db_fn(shapes: tuple, plans: tuple, K: int, n1r: int, c_par: int,
                r_seq: int, lorder: bool, lsoln: bool, params: SAParams,
                interpret: bool, mesh=None):
    """One jitted program for K queries (one round8 group) against every
    bucket: uniform generation and the kernel calls of all buckets are
    enqueued back to back, and the result is one [K, total] score array
    (+ [K, total, N1P] maps) -- one dispatch and one drain per group.

    With ``mesh`` (1-D, over the entry axis) each bucket runs under
    jax.shard_map: every device searches its local slice of the entries.
    Streams are keyed by global file-order indices, so sharded and
    unsharded runs are bitwise equal.  No collectives run in the hot
    loop."""

    def one(args, d2, plan):
        return _bucket_search(args, K, *plan, n1r, d2, c_par, r_seq, lorder,
                              lsoln, params, interpret)

    def f(seed, tags, n1s, qt, qtab, qd, bucket_args):
        s_all, m_all = [], []
        for (_n, d2), plan, bargs in zip(shapes, plans, bucket_args):
            if mesh is None:
                s, m = one((seed, tags, n1s, qt, qtab, qd) + tuple(bargs),
                           d2, plan)
            else:
                from jax.sharding import PartitionSpec as SP

                ax = mesh.axis_names[0]
                out_specs = (SP(None, ax), SP(None, ax, None)) if lsoln \
                    else SP(None, ax)

                def body(*a, d2=d2, plan=plan):
                    s, m = one(a, d2, plan)
                    return (s, m) if lsoln else s

                out = jax.shard_map(
                    body, mesh=mesh,
                    in_specs=(SP(),) * 6 + (SP(ax),) * 5,
                    out_specs=out_specs, check_vma=False,
                )(seed, tags, n1s, qt, qtab, qd, *bargs)
                s, m = out if lsoln else (out, None)
            s_all.append(s)
            m_all.append(m)
        scores = jnp.concatenate(s_all, axis=1)
        if not lsoln:
            return scores
        return scores, jnp.concatenate(m_all, axis=1)

    return jax.jit(f)


def prepare_bucket(bucket, device=None, sharding=None) -> tuple:
    """Device arrays of one bucket in the kernel's layout: (file-order
    index u32, orders i32, types i8, packed codes i8, dmat f32)."""
    host = (bucket.index.astype(np.uint32), bucket.orders.astype(np.int32),
            bucket.types.astype(np.int8),
            pack_codes(bucket.tabhi, bucket.tablo),
            bucket.dmat.astype(np.float32))
    target = sharding if sharding is not None else device
    return tuple(jax.device_put(x, target) if target is not None
                 else jnp.asarray(x) for x in host)


def dispatch(queries, db, *, maxstart: int, lorder: bool, seed: int,
             query_tags, c_max: int = 128, params: SAParams = DEFAULTS,
             device_db: dict | None = None, lsoln: bool = True,
             mesh=None, interpret: bool = False):
    """Enqueue K queries of one round8 order group -- any mix of exact
    orders -- against the whole DB.  Returns a handle for ``assemble``;
    nothing waits for the device here."""
    from .search import choose_chains

    n1r = round8(queries[0].order)
    if any(round8(q.order) != n1r for q in queries):
        raise ValueError("queries of one dispatch must share round8(order)")
    tags = list(query_tags)
    if len(tags) != len(queries):
        raise ValueError("one query tag per query")
    c_par, r_seq = choose_chains(maxstart, c_max)
    padded = [pad_query(q, n1r) for q in queries]
    qarrs = [jnp.asarray(np.stack([pq[i] for pq in padded]))
             for i in range(3)]
    ndev = mesh.size if mesh is not None else 1
    pair_bytes = (r_seq * slots_per_restart(n1r, params.maxiter)
                  * lanes_for(c_par) * 4)
    shapes, plans, bargs = [], [], []
    for bi, bucket in enumerate(db.buckets):
        arrs = device_db.get(bi) if device_db is not None else None
        if arrs is None:
            arrs = prepare_bucket(bucket)
        shapes.append((bucket.size, bucket.dim))
        plans.append(_plan(len(queries), bucket.size // ndev, pair_bytes))
        bargs.append(arrs)
    fn = _make_db_fn(tuple(shapes), tuple(plans), len(queries), n1r, c_par,
                     r_seq, lorder, lsoln, params, interpret, mesh)
    out = fn(jnp.asarray(seed, I32), jnp.asarray(tags, I32),
             jnp.asarray([q.order for q in queries], I32),
             *qarrs, bargs)
    return db, [q.order for q in queries], out, lsoln


def assemble(handle) -> list[tuple[np.ndarray, np.ndarray]]:
    """Drain a dispatch handle (the first point that waits for the
    device) and scatter each query's results into database file order:
    [(scores [N], maps [N, n1])]; maps are -1 when lsoln is off."""
    from ..parallel.distributed import to_host

    db, n1s, out, lsoln = handle
    scores_k = to_host(out[0] if lsoln else out)
    maps_k = to_host(out[1]) if lsoln else None
    K = len(n1s)
    scores = np.zeros((K, db.nentries), np.int32)
    n1p = maps_k.shape[-1] if lsoln else max(n1s)
    maps = np.full((K, db.nentries, n1p), -1, np.int32)
    off = 0
    for b in db.buckets:
        valid = b.index >= 0  # drop mesh-padding entries
        sl = slice(off, off + b.size)
        scores[:, b.index[valid]] = scores_k[:, sl][:, valid]
        if lsoln:
            maps[:, b.index[valid]] = maps_k[:, sl][:, valid]
        off += b.size
    return [(scores[k], maps[k, :, :n1s[k]]) for k in range(K)]
