"""High-level search orchestration: buckets, chunking, key derivation.

Drives the SA kernel (ops/triton_sa.py) on the GPU, or the vectorized
engine (ops/engine.py) elsewhere, over a PackedDB, mirroring the role
of the reference host driver's per-query launch loop
(cudaSaTabsearch.cu:987-1115) but with size buckets instead of the
small/large two-pass split, and deterministic per-entry RNG keys derived
from the entry's position in the database file (stable across bucketing
and sharding).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core.constants import DEFAULT_MAXSTART, SAParams, DEFAULTS
from ..io.pack import PackedBucket, PackedDB, PackedQuery
from .engine import make_bucket_search

DEFAULT_SEED = 1234  # the reference's fixed seed (cudaSaTabsearch.cu:263,:871)

# Entries per compiled engine call: bounds compile time and temporary
# memory; chunks are padded to a common size so each bucket shape
# compiles once.
_CHUNK_ENTRIES = 128


def resolve_gather_mode(gather_mode: str) -> str:
    """'auto' -> native gathers ('take') on every platform: 'onehot'
    builds an [n1, d2, C] mask per fetch, which no GPU or CPU
    measurement favours (PERF.md)."""
    if gather_mode != "auto":
        return gather_mode
    return "take"


@dataclass
class SearchResult:
    scores: np.ndarray  # int32 [nentries], database file order
    ssemaps: np.ndarray  # int32 [nentries, n1], -1 where unmapped
    names: list[str]
    orders: np.ndarray  # int32 [nentries]
    query_order: int
    maxstart: int

    @property
    def nentries(self) -> int:
        return len(self.names)


def choose_chains(maxstart: int, c_max: int = 128) -> tuple[int, int]:
    """Split total restarts into (parallel chains, sequential restarts).

    The chain axis is the kernel's thread axis, so we prefer the largest
    divisor of ``maxstart`` that is <= c_max (the reference requires
    maxstart to be a multiple of its 128-thread block for the same
    reason, cudaSaTabsearch.cu:34-35).
    """
    if maxstart < 1:
        raise ValueError("maxstart must be >= 1")
    for c in range(min(maxstart, c_max), 0, -1):
        if maxstart % c == 0:
            return c, maxstart // c
    return 1, maxstart


@functools.lru_cache(maxsize=None)
def _entry_keys_jit():
    def gen(seed, query_tag, indices):
        base = jax.random.fold_in(jax.random.PRNGKey(seed), query_tag)
        return jax.vmap(lambda i: jax.random.fold_in(base, i))(indices)

    return jax.jit(gen)


def entry_keys(seed: int, query_tag: int, indices: np.ndarray) -> jax.Array:
    """Per-entry RNG keys: fold the query tag then the entry's file-order
    index into the base seed (counter-based replacement for the
    reference's 16384 CURAND states, cudaSaTabsearch.cu:258-264).
    jitted (an eager vmap retraces per call)."""
    return _entry_keys_jit()(seed, query_tag,
                             jnp.asarray(indices, dtype=jnp.uint32))


def _chunk_size(nentries: int) -> int:
    return min(_CHUNK_ENTRIES, max(nentries, 1))


def search_bucket(query: PackedQuery, bucket: PackedBucket, *,
                  maxstart: int, lorder: bool, seed: int, query_tag: int,
                  c_max: int = 128, gather_mode: str = "auto",
                  params: SAParams = DEFAULTS,
                  device_arrays: dict | None = None,
                  sharding=None) -> tuple[np.ndarray, np.ndarray]:
    """Search one packed bucket; returns (scores [N], bestmaps [N, n1]).

    ``sharding``: an optional entry-axis jax.sharding.NamedSharding.
    When given, the bucket (pre-padded to a multiple of the mesh size by
    pack_database(pad_to=...)) runs SPMD across the mesh: inputs are
    placed sharded, the query replicated, and XLA partitions the vmapped
    entry axis with no collectives in the hot loop.
    """
    n1, d2 = query.order, bucket.dim
    c_par, r_seq = choose_chains(maxstart, c_max)
    fn = make_bucket_search(n1, d2, c_par, r_seq, lorder,
                            resolve_gather_mode(gather_mode), params)

    qargs = tuple(jnp.asarray(x) for x in (query.types, query.tabhi,
                                           query.tablo, query.dmat))
    if sharding is not None:
        from ..parallel.mesh import replicated

        rep = replicated(sharding.mesh)
        qargs = tuple(jax.device_put(x, rep) for x in qargs)
    if device_arrays is not None:
        types2, tabhi2, tablo2, dmat2 = (device_arrays["types"],
                                         device_arrays["tabhi"],
                                         device_arrays["tablo"],
                                         device_arrays["dmat"])
        orders = device_arrays["orders"]
    else:
        def put(x):
            x = jnp.asarray(x)
            return jax.device_put(x, sharding) if sharding is not None else x

        types2 = put(bucket.types)
        tabhi2 = put(bucket.tabhi)
        tablo2 = put(bucket.tablo)
        dmat2 = put(bucket.dmat)
        orders = put(bucket.orders)
    keys = entry_keys(seed, query_tag, bucket.index)
    if sharding is not None:
        keys = jax.device_put(keys, sharding)

    n = bucket.size
    # sharded execution runs the whole bucket in one SPMD call (chunk
    # slicing would break the even entry-axis partition)
    cs = n if sharding is not None else _chunk_size(n)
    scores = np.empty((n,), np.int32)
    maps = np.empty((n, n1), np.int32)
    for start in range(0, n, cs):
        end = min(start + cs, n)
        sl = slice(start, end)
        if end - start < cs and n > cs:
            # pad the tail chunk to the common size to reuse the compile
            pad = cs - (end - start)
            idx = np.concatenate([np.arange(start, end),
                                  np.zeros(pad, np.int64)])
            s, m = fn(*qargs, types2[idx], tabhi2[idx], tablo2[idx],
                      dmat2[idx], orders[idx], keys[idx])
            scores[sl] = np.asarray(s)[:end - start]
            maps[sl] = np.asarray(m)[:end - start]
        else:
            s, m = fn(*qargs, types2[sl], tabhi2[sl], tablo2[sl],
                      dmat2[sl], orders[sl], keys[sl])
            if sharding is not None:
                from ..parallel.distributed import to_host

                scores[sl] = to_host(s)
                maps[sl] = to_host(m)
            else:
                scores[sl] = np.asarray(s)
                maps[sl] = np.asarray(m)
    return scores, maps


def _sharding_mesh(sharding):
    """Mesh behind a sharding spec: a fixed jax.sharding.Sharding or
    the upload_db-documented callable ``bucket_size -> Sharding`` (its
    mesh is size-independent, so probe with size 1)."""
    if sharding is None:
        return None
    if callable(sharding):
        return sharding(1).mesh
    return sharding.mesh


def resolve_backend(backend: str = "auto") -> str:
    """'auto' -> the SA kernel (ops/triton_sa.py) on the GPU, the XLA
    engine (ops/engine.py) on every other platform.  Explicit names
    ("triton", "xla") let tests and the kernel-vs-engine comparison pick
    one; "triton" off the GPU runs in Pallas interpret mode."""
    if backend not in ("auto", "triton", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "auto":
        return backend
    return "triton" if jax.default_backend() == "gpu" else "xla"


def search_many_db(queries, db: PackedDB, *, query_tags,
                   maxstart: int = DEFAULT_MAXSTART, lorder: bool = True,
                   seed: int = DEFAULT_SEED, c_max: int = 128,
                   gather_mode: str = "auto", params: SAParams = DEFAULTS,
                   device_db: dict | None = None, sharding=None,
                   backend: str = "auto",
                   lsoln: bool = True) -> list[SearchResult]:
    """Search several queries; results in query order.

    On the kernel path the queries are grouped by round8(order) -- the
    kernel is specialized per 8-padded order and takes exact orders at
    run time -- and each group is ONE device program and ONE drain, all
    groups enqueued before the first drain.  The engine runs the queries
    one after another."""
    use = resolve_backend(backend)
    tags = list(query_tags)
    if use == "xla":
        return [search_db(q, db, maxstart=maxstart, lorder=lorder, seed=seed,
                          query_tag=t, c_max=c_max, gather_mode=gather_mode,
                          params=params, device_db=device_db,
                          sharding=sharding, backend=use, lsoln=lsoln)
                for q, t in zip(queries, tags)]
    from . import triton_sa
    from .common import round8

    groups: dict[int, list[int]] = {}
    for i, q in enumerate(queries):
        groups.setdefault(round8(q.order), []).append(i)
    arrays = None
    if device_db is not None:
        arrays = {bi: d["triton"] for bi, d in device_db.items()}
    handles = [(idxs, triton_sa.dispatch(
        [queries[i] for i in idxs], db, maxstart=maxstart, lorder=lorder,
        seed=seed, query_tags=[tags[i] for i in idxs], c_max=c_max,
        params=params, device_db=arrays, lsoln=lsoln,
        mesh=_sharding_mesh(sharding),
        interpret=jax.default_backend() != "gpu"))
        for idxs in groups.values()]
    out: list = [None] * len(queries)
    for idxs, h in handles:
        for i, (scores, maps) in zip(idxs, triton_sa.assemble(h)):
            out[i] = SearchResult(scores=scores, ssemaps=maps,
                                  names=db.names, orders=db.orders,
                                  query_order=queries[i].order,
                                  maxstart=maxstart)
    return out


def search_db(query: PackedQuery, db: PackedDB, *,
              maxstart: int = DEFAULT_MAXSTART, lorder: bool = True,
              seed: int = DEFAULT_SEED, query_tag: int = 0,
              c_max: int = 128, gather_mode: str = "auto",
              params: SAParams = DEFAULTS,
              device_db: dict | None = None, sharding=None,
              backend: str = "auto", lsoln: bool = True) -> SearchResult:
    """Search the whole packed DB; results in database file order."""
    if resolve_backend(backend) == "triton":
        return search_many_db(
            [query], db, query_tags=[query_tag], maxstart=maxstart,
            lorder=lorder, seed=seed, c_max=c_max, params=params,
            device_db=device_db, sharding=sharding, backend="triton",
            lsoln=lsoln)[0]
    n1 = query.order
    scores = np.zeros((db.nentries,), np.int32)
    maps = np.full((db.nentries, n1), -1, np.int32)
    for bi, bucket in enumerate(db.buckets):
        darr = device_db.get(bi) if device_db is not None else None
        s, m = search_bucket(
            query, bucket, maxstart=maxstart,
            lorder=lorder, seed=seed, query_tag=query_tag,
            c_max=c_max, gather_mode=gather_mode,
            params=params,
            device_arrays=darr["xla"] if darr else None,
            sharding=sharding)
        valid = bucket.index >= 0  # drop mesh-padding entries
        scores[bucket.index[valid]] = s[valid]
        maps[bucket.index[valid]] = m[valid]
    return SearchResult(scores=scores, ssemaps=maps, names=db.names,
                        orders=db.orders, query_order=n1, maxstart=maxstart)


def upload_db(db: PackedDB, device=None, sharding=None,
              backend: str = "auto") -> dict:
    """Pre-upload packed DB arrays to device(s) once (the analog of the
    reference's one-time cudaMemcpy3D of the whole DB,
    cudaSaTabsearch.cu:924-963).
    Returns {bucket_idx: {backend: arrays}} in the resolved backend's
    layout.

    If ``sharding`` is given (a callable bucket_size -> jax.sharding
    .Sharding or a fixed Sharding), arrays are placed with their entry
    axis sharded across the mesh.
    """
    use = resolve_backend(backend)
    out = {}
    for bi, b in enumerate(db.buckets):
        s = sharding(b.size) if callable(sharding) else sharding
        if use == "triton":
            from .triton_sa import prepare_bucket

            out[bi] = {use: prepare_bucket(b, device=device, sharding=s)}
            continue

        def put(x):
            if s is not None:
                return jax.device_put(jnp.asarray(x), s)
            if device is not None:
                return jax.device_put(jnp.asarray(x), device)
            return jnp.asarray(x)

        out[bi] = {use: {"types": put(b.types), "tabhi": put(b.tabhi),
                         "tablo": put(b.tablo), "dmat": put(b.dmat),
                         "orders": put(b.orders)}}
    return out
