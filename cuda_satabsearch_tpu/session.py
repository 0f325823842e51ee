"""Search session: a resident packed+uploaded DB and a query stream.

The analog of the reference driver's lifecycle (cudaSaTabsearch.cu
main, :573-1340): load DB once, copy it to the device once, then run any
number of queries against it, each costing only a tiny query upload plus
the kernel.  Used by the CLI (both stdin and query-list modes), the
benchmark runner, and the eval harness.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass


from .core.constants import DEFAULT_MAXSTART, SAParams, DEFAULTS, MAXDIM
from .io.pack import (DEFAULT_BUCKETS, PackedDB, PackedQuery, pack_database,
                      pack_query)
from .io.parser import TableauEntry, read_database
from .ops.search import (SearchResult, resolve_backend, search_db,
                         search_many_db, upload_db)
from .stats.gumbel import score_stats


@dataclass
class SessionConfig:
    maxstart: int = DEFAULT_MAXSTART
    seed: int = 1234
    gather_mode: str = "auto"
    c_max: int = 128
    buckets: tuple = DEFAULT_BUCKETS
    maxdim: int = MAXDIM
    params: SAParams = DEFAULTS
    use_mesh: bool = False  # shard the entry axis over all devices
    compat_z: bool = False  # reproduce the reference's int-truncated z
    devices: object = None  # optional explicit device list for the mesh


class SearchSession:
    def __init__(self, dbfile: str, config: SessionConfig | None = None,
                 entries: list[TableauEntry] | None = None, *,
                 backend: str = "auto"):
        """``backend``: "auto" picks the implementation by platform
        (ops.search.resolve_backend); tests and the kernel-vs-engine
        comparison name one explicitly."""
        from .core.cache import enable_compile_cache

        enable_compile_cache()  # persist compiled kernels across runs
        self.config = config or SessionConfig()
        self.dbfile = dbfile
        self.backend = resolve_backend(backend)

        self.sharding = None
        pad_to = 1
        if self.config.use_mesh:
            from .parallel.mesh import entry_sharding, make_mesh

            mesh = make_mesh(self.config.devices)
            self.sharding = entry_sharding(mesh)
            pad_to = mesh.size

        t0 = time.perf_counter()
        self.db: PackedDB
        if entries is not None:
            self.db = pack_database(entries, self.config.buckets,
                                    pad_to=pad_to)
        else:
            from .io import native

            if native.available():
                # C++ parse+pack (native/satab_io.cpp), ~10x the Python
                # parser on large DBs
                self.db = native.pack_database_file(
                    dbfile, self.config.buckets,
                    maxdim=self.config.maxdim, pad_to=pad_to)
            else:
                self.db = pack_database(
                    read_database(dbfile, maxdim=self.config.maxdim),
                    self.config.buckets, pad_to=pad_to)
        self.load_ms = (time.perf_counter() - t0) * 1000.0

        t0 = time.perf_counter()
        self.device_db = upload_db(self.db, sharding=self.sharding,
                                   backend=self.backend)
        self.upload_ms = (time.perf_counter() - t0) * 1000.0
        self._query_tag = 0

    @property
    def nentries(self) -> int:
        return self.db.nentries

    def resolve_query(self, name: str) -> PackedQuery | None:
        """Resolve a query by identifier from the resident DB (query-list
        mode, cudaSaTabsearch.cu:730-788)."""
        loc = self.db.lookup(name)
        if loc is None:
            return None
        return pack_query(self.db.entry(*loc))

    def search_many(self, queries, *, lorder: bool = True,
                    lsoln: bool = False) -> list[SearchResult]:
        """Search a query stream.  On the kernel path each round8 order
        group is one device program, and every group is enqueued before
        the first drain (ops.search.search_many_db)."""
        cfg = self.config
        tags = list(range(self._query_tag, self._query_tag + len(queries)))
        self._query_tag += len(queries)
        return search_many_db(
            queries, self.db, query_tags=tags, maxstart=cfg.maxstart,
            lorder=lorder, seed=cfg.seed, c_max=cfg.c_max,
            gather_mode=cfg.gather_mode, params=cfg.params,
            device_db=self.device_db, sharding=self.sharding,
            backend=self.backend, lsoln=lsoln)

    def search(self, query: PackedQuery, *, lorder: bool = True,
               query_tag: int | None = None,
               lsoln: bool = True) -> SearchResult:
        cfg = self.config
        if query_tag is None:
            query_tag = self._query_tag
        self._query_tag = query_tag + 1
        return search_db(query, self.db, maxstart=cfg.maxstart,
                         lorder=lorder, seed=cfg.seed, query_tag=query_tag,
                         c_max=cfg.c_max, gather_mode=cfg.gather_mode,
                         params=cfg.params, device_db=self.device_db,
                         sharding=self.sharding, backend=self.backend,
                         lsoln=lsoln)


def format_results(result: SearchResult, qn: int, *, lsoln: bool,
                   compat_z: bool = False, out=None) -> None:
    """Emit result lines ``name rawscore norm2 z p`` (+ 1-based ssemap
    pair lines under LSOLN), byte-compatible with the reference's
    ``%-8s %d %g %g %g`` / ``%3d %3d`` (cudaSaTabsearch.cu:1102-1114)."""
    out = out or sys.stdout
    scores = result.scores
    n2s, z, p = score_stats(scores, qn, result.orders, compat=compat_z)
    lines = []
    for i in range(result.nentries):
        lines.append("%-8s %d %g %g %g\n"
                     % (result.names[i], scores[i], n2s[i], z[i], p[i]))
        if lsoln:
            for k in range(qn):
                j = result.ssemaps[i, k]
                if j >= 0:
                    lines.append("%3d %3d\n" % (k + 1, j + 1))
    out.write("".join(lines))


def print_query_header(program: str, ltype: bool, lorder: bool, lsoln: bool,
                       qid: str, dbfile: str, out=None) -> None:
    """The '#' metadata headers downstream eval scripts key on
    (cudaSaTabsearch.cu:1027-1030; mkroctabs.py splits on '# QUERY ID =')."""
    out = out or sys.stdout
    tf = lambda b: "T" if b else "F"
    out.write("# %s LTYPE = %s LORDER = %s LSOLN = %s\n"
              % (program, tf(ltype), tf(lorder), tf(lsoln)))
    out.write("# QUERY ID = %-8s\n" % qid)
    out.write("# DBFILE = %-80s\n" % dbfile)
