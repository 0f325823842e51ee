"""Vectorized batched simulated-annealing engine (pure JAX).

The portable, plain-XLA form of the reference's thread-per-chain CUDA
kernel (cudaSaTabsearch_kernel.cu:806-1236), and the reference the GPU
kernel (ops/triton_sa.py) is tested against.  Instead of scalar threads
with divergent control flow, the whole population of SA chains for one
DB entry advances in lockstep as masked vector operations:

* layout is (sse_dim, chain) with the chain axis minor; per-entry SSE
  dimensions are padded only to the entry's size bucket, so a 16-wide
  entry costs a fraction of a 112-wide one per iteration (the answer
  to the reference's small/large split);
* all data-dependent scans of the reference (the LORDER window walk, the
  candidate list build in randtypeind, the O(n1) delta loop) become
  masked reductions over the chain axis -- divergence-free by
  construction;
* randomness is counter-based threefry keyed by (entry, restart); the
  per-restart uniform block has a fixed slot schedule so the scalar
  golden model (ops/golden.py) reproduces any chain bitwise;
* DB entries are vmapped on top, giving the (entry x chain) grid of the
  reference's (block x thread) launch; entries are further sharded
  across devices by the caller (parallel/mesh.py).

Irregular memory access (the only non-SIMD-friendly part of the
algorithm) is isolated in two gather helpers with switchable
implementations ("take" = native XLA gather, "onehot" = one-hot
contraction, a matrix product) so the lowering can be chosen per
platform by measurement (ops/search.resolve_gather_mode).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..core.constants import SAParams, DEFAULTS
from .common import round8

I32 = jnp.int32
F32 = jnp.float32


def log_acc_slots(uniforms, n1: int, axis: int = 0):
    """Transform the Metropolis-acceptance slots of a uniform stream to
    their natural log, in place of the raw uniform.

    The acceptance test is then ``delta > temp * ln_u`` — pure mul/
    compare arithmetic, which is bit-identical across NumPy, XLA on the
    CPU and the GPU, and the Pallas kernel — instead of
    ``exp(delta/temp) > u``, whose
    exp lowering differs by ulps between backends and flips boundary
    decisions (mathematically the two forms are equivalent; the
    reference itself uses approximate expf via --use_fast_math,
    Makefile:51).  Slot layout (the n1r schedule, common.round8): per
    restart, slots [0, n1) feed thinit and slot
    round8(n1) + 3*it + 2 is the acceptance draw of iteration it
    (golden.py docstring); n1 may be given exact or pre-rounded.
    ln(0) = -inf accepts unconditionally, matching exp(x) > 0.
    """
    base = round8(n1)
    P = uniforms.shape[axis]
    idx = jnp.arange(P)
    is_acc = (idx >= base) & ((idx - base) % 3 == 2)
    shape = [1] * uniforms.ndim
    shape[axis] = P
    return jnp.where(is_acc.reshape(shape), jnp.log(uniforms), uniforms)


def _tscord(qh, ql, th, tl):
    """Vector tableau pair score (+2 both halves equal / +1 one / -2 none),
    kernel.cu:306-332."""
    he = qh == th
    le = ql == tl
    return jnp.where(he & le, 2, jnp.where(he | le, 1, -2)).astype(I32)


def _make_gathers(d2: int, gather_mode: str):
    iota2 = jnp.arange(d2, dtype=I32)[:, None]  # [d2, 1]

    def gather_rows(table, idx):
        """rows[d, c] = table[idx[c], d] for a symmetric [d2, d2] table.

        "take": native gather along the minor axis.
        "onehot": contraction table^T @ onehot(idx), at full f32
        precision (a TF32 product would round distances that are not
        on its grid).
        """
        idxc = jnp.clip(idx, 0, d2 - 1)
        if gather_mode == "onehot":
            oh = (iota2 == idxc[None, :]).astype(F32)  # [d2, C]
            out = lax.dot_general(table.astype(F32), oh,
                                  (((0,), (0,)), ((), ())),
                                  precision=lax.Precision.HIGHEST,
                                  preferred_element_type=F32)
            return out if table.dtype == F32 else out.astype(table.dtype)
        return jnp.take(table, idxc, axis=1)

    def gather_sub(data, idx):
        """out[k, c] = data[idx[k, c], c] for data [d2, C], idx [n1, C]."""
        idxc = jnp.clip(idx, 0, d2 - 1)
        if gather_mode == "onehot":
            oh = idxc[:, None, :] == iota2[None, :, :]  # [n1, d2, C]
            return jnp.sum(jnp.where(oh, data[None, :, :], 0), axis=1)
        return jnp.take_along_axis(data, idxc, axis=0)

    return gather_rows, gather_sub


@functools.lru_cache(maxsize=None)
def make_entry_search(n1: int, d2: int, c_par: int, r_seq: int,
                      lorder: bool, gather_mode: str = "take",
                      params: SAParams = DEFAULTS):
    """Build the single-entry search function.

    Returns fn(qtypes[n1], qtabhi[n1,n1], qtablo, qdmat,
               types2[d2], tabhi2[d2,d2], tablo2, dmat2, n2, key)
            -> (maxscore scalar i32, bestmap [n1] i32)
    running c_par lockstep chains x r_seq sequential restarts
    (total restarts = c_par * r_seq).
    """
    p = params
    maxiter = p.maxiter
    n1r = round8(n1)  # slot-schedule base (common.round8)
    per_restart = n1r + 3 * maxiter
    C = c_par
    iota1 = jnp.arange(n1, dtype=I32)[:, None]  # [n1, 1]
    iota2 = jnp.arange(d2, dtype=I32)[:, None]  # [d2, 1]
    BIG = I32(n1 + d2 + 999)
    EPS = F32(p.eps)
    MXSSED = F32(p.mxssed)
    gather_rows, gather_sub = _make_gathers(d2, gather_mode)

    def entry_search(qtypes, qtabhi, qtablo, qdmat,
                     types2, tabhi2, tablo2, dmat2, n2, key):
        # compute in int32 (int8 storage is cast once here; XLA keeps the
        # device copy int8 and fuses the widening into consumers)
        qtypes = qtypes.astype(I32)
        qtabhi = qtabhi.astype(I32)
        qtablo = qtablo.astype(I32)
        types2 = types2.astype(I32)
        tabhi2 = tabhi2.astype(I32)
        tablo2 = tablo2.astype(I32)
        n2 = n2.astype(I32)

        def thinit_body(i, carry):
            """Greedy random initial matching step (kernel.cu:588-648)."""
            ssemap, revmap, j, stopped, uniforms = carry
            u_i = lax.dynamic_slice_in_dim(uniforms, i, 1, axis=0)[0]  # [C]
            t1 = lax.dynamic_index_in_dim(qtypes, i, keepdims=False)
            attempt = (u_i < p.init_matchprob) & ~stopped
            cmask = (iota2 >= j[None, :]) & (types2[:, None] == t1) \
                    & (iota2 < n2)
            jfound = jnp.where(cmask, iota2, BIG).min(axis=0)  # [C]
            ok = attempt & (jfound < n2)
            stopped = stopped | (attempt & (jfound >= n2))
            ssemap = jnp.where((iota1 == i) & ok[None, :],
                               jfound[None, :], ssemap)
            revmap = jnp.where((iota2 == jfound[None, :]) & ok[None, :],
                               i, revmap)
            j = jnp.where(ok, jfound + 1, j)
            return ssemap, revmap, j, stopped, uniforms

        def initscore_body(i, carry):
            """Row i of the full O(n1^2) rescore (kernel.cu:396-440)."""
            acc, ssemap = carry
            l = ssemap  # [n1, C]
            l_i = lax.dynamic_slice_in_dim(ssemap, i, 1, axis=0)[0]  # [C]
            rows_d = gather_rows(dmat2, l_i)  # [d2, C]
            rows_th = gather_rows(tabhi2, l_i)
            rows_tl = gather_rows(tablo2, l_i)
            vals_d = gather_sub(rows_d, l)  # [n1, C]
            vals_th = gather_sub(rows_th, l)
            vals_tl = gather_sub(rows_tl, l)
            qd_i = lax.dynamic_slice_in_dim(qdmat, i, 1, axis=0)[0][:, None]
            qth_i = lax.dynamic_slice_in_dim(qtabhi, i, 1, axis=0)[0][:, None]
            qtl_i = lax.dynamic_slice_in_dim(qtablo, i, 1, axis=0)[0][:, None]
            use = (iota1 > i) & (l >= 0) & (l_i[None, :] >= 0) \
                  & (jnp.abs(qd_i - vals_d) <= MXSSED)
            tsc = _tscord(qth_i, qtl_i, vals_th, vals_tl)
            acc = acc + jnp.where(use, tsc, 0).sum(axis=0)
            return acc, ssemap

        def iter_body(it, carry):
            """One SA move for all chains (kernel.cu:1032-1191)."""
            ssemap, revmap, score, maxscore, bestmap, temp, uniforms = carry
            u3 = lax.dynamic_slice_in_dim(uniforms, n1r + 3 * it, 3, axis=0)
            u_move, u_cand, u_acc = u3[0], u3[1], u3[2]  # [C] each

            ssei = ((u_move - EPS) * F32(n1)).astype(I32)  # [C]

            # --- candidate window (kernel.cu:1053-1083) ---
            if lorder:
                km = jnp.where((iota1 <= ssei[None, :]) & (ssemap >= 0),
                               iota1, -1)
                kbest = km.max(axis=0)  # nearest mapped predecessor (or -1)
                sj = jnp.take_along_axis(
                    ssemap, jnp.clip(kbest, 0, n1 - 1)[None, :], axis=0)[0]
                startj = jnp.where(kbest >= 0, sj, n2)
                kn = jnp.where((iota1 > ssei[None, :]) & (ssemap != -1),
                               iota1, BIG)
                knext = kn.min(axis=0)  # nearest mapped successor (or BIG)
                ej = jnp.take_along_axis(
                    ssemap, jnp.clip(knext, 0, n1 - 1)[None, :], axis=0)[0]
                endj = jnp.where(ssei == n1 - 1, n2,
                                 jnp.where(knext < n1, ej, -1))
            else:
                startj = jnp.zeros((C,), I32)
                endj = jnp.broadcast_to(n2, (C,))

            # --- uniform same-type unmatched pick (kernel.cu:677-714) ---
            qt = jnp.take(qtypes, ssei)  # [C]
            cand = (iota2 >= startj[None, :]) & (iota2 < endj[None, :]) \
                   & (types2[:, None] == qt[None, :]) & (revmap < 0)
            count = cand.sum(axis=0, dtype=I32)
            r = ((u_cand - EPS) * count.astype(F32)).astype(I32)
            cum = jnp.cumsum(cand.astype(I32), axis=0)
            hit = cand & (cum == (r[None, :] + 1))
            newj = jnp.where(hit, iota2, -1).max(axis=0)  # [C], -1 = unmap

            oldj = jnp.take_along_axis(ssemap, ssei[None, :], axis=0)[0]

            # --- O(n1) incremental delta (kernel.cu:502-535) ---
            l = ssemap
            qd = jnp.take(qdmat, ssei, axis=1)  # [n1, C] (symmetric table)
            qth = jnp.take(qtabhi, ssei, axis=1)
            qtl = jnp.take(qtablo, ssei, axis=1)
            old_d = gather_sub(gather_rows(dmat2, oldj), l)
            old_th = gather_sub(gather_rows(tabhi2, oldj), l)
            old_tl = gather_sub(gather_rows(tablo2, oldj), l)
            new_d = gather_sub(gather_rows(dmat2, newj), l)
            new_th = gather_sub(gather_rows(tabhi2, newj), l)
            new_tl = gather_sub(gather_rows(tablo2, newj), l)
            m = (l >= 0) & (iota1 != ssei[None, :])
            t_o = m & (oldj[None, :] >= 0) & (l != oldj[None, :]) \
                  & (jnp.abs(qd - old_d) <= MXSSED)
            t_n = m & (newj[None, :] >= 0) & (l != newj[None, :]) \
                  & (jnp.abs(qd - new_d) <= MXSSED)
            tsc_o = _tscord(qth, qtl, old_th, old_tl)
            tsc_n = _tscord(qth, qtl, new_th, new_tl)
            delta = (jnp.where(t_n, tsc_n, 0)
                     - jnp.where(t_o, tsc_o, 0)).sum(axis=0)  # [C]

            # --- max tracking before acceptance (kernel.cu:1136-1155) ---
            newscore = score + delta
            improved = newscore > maxscore
            moved_map = jnp.where(iota1 == ssei[None, :],
                                  newj[None, :], ssemap)
            maxscore = jnp.where(improved, newscore, maxscore)
            bestmap = jnp.where(improved[None, :], moved_map, bestmap)

            # --- Metropolis acceptance (kernel.cu:1166-1187) ---
            # log-domain acceptance (u_acc slot carries ln(u); see
            # log_acc_slots): pure arithmetic, backend-bitwise-stable
            accept = delta.astype(F32) > temp * u_acc
            score = jnp.where(accept, newscore, score)
            ssemap = jnp.where((iota1 == ssei[None, :]) & accept[None, :],
                               newj[None, :], ssemap)
            acc2 = accept[None, :]
            revmap = jnp.where((iota2 == oldj[None, :]) & acc2
                               & (oldj[None, :] >= 0), -1, revmap)
            revmap = jnp.where((iota2 == newj[None, :]) & acc2
                               & (newj[None, :] >= 0),
                               ssei[None, :], revmap)
            temp = temp * F32(p.alpha)
            return ssemap, revmap, score, maxscore, bestmap, temp, uniforms

        def restart_body(restart, carry):
            maxscore, bestmap = carry
            key_r = jax.random.fold_in(key, restart)
            uniforms = log_acc_slots(
                jax.random.uniform(key_r, (per_restart, C), dtype=F32), n1)
            ssemap = jnp.full((n1, C), -1, I32)
            revmap = jnp.full((d2, C), -1, I32)
            j0 = jnp.zeros((C,), I32)
            stopped = jnp.zeros((C,), bool)
            ssemap, revmap, _, _, _ = lax.fori_loop(
                0, n1, thinit_body, (ssemap, revmap, j0, stopped, uniforms))
            score, _ = lax.fori_loop(
                0, n1, initscore_body, (jnp.zeros((C,), I32), ssemap))
            improved = score > maxscore
            maxscore = jnp.where(improved, score, maxscore)
            bestmap = jnp.where(improved[None, :], ssemap, bestmap)
            temp = F32(p.temp0)
            ssemap, revmap, score, maxscore, bestmap, temp, _ = lax.fori_loop(
                0, maxiter, iter_body,
                (ssemap, revmap, score, maxscore, bestmap, temp, uniforms))
            return maxscore, bestmap

        maxscore0 = jnp.full((C,), p.maxscore_init, I32)
        bestmap0 = jnp.full((n1, C), -1, I32)
        maxscore, bestmap = lax.fori_loop(
            0, r_seq, restart_body, (maxscore0, bestmap0))

        # block reduction over chains (kernel.cu:1194-1233); argmax picks
        # the first maximal chain like the reference's serial scan
        winner = jnp.argmax(maxscore).astype(I32)
        outscore = jnp.take(maxscore, winner)
        outmap = jnp.take(bestmap, winner, axis=1)
        return outscore, outmap

    return entry_search


@functools.lru_cache(maxsize=None)
def make_bucket_search(n1: int, d2: int, c_par: int, r_seq: int,
                       lorder: bool, gather_mode: str = "take",
                       params: SAParams = DEFAULTS):
    """vmapped-over-entries, jitted bucket search.

    fn(qtypes, qtabhi, qtablo, qdmat,
       types2[E,d2], tabhi2[E,d2,d2], tablo2, dmat2, n2[E], keys[E])
      -> (scores [E] i32, bestmaps [E, n1] i32)
    """
    entry_fn = make_entry_search(n1, d2, c_par, r_seq, lorder,
                                 gather_mode, params)
    batched = jax.vmap(entry_fn,
                       in_axes=(None, None, None, None, 0, 0, 0, 0, 0, 0))
    return jax.jit(batched)
