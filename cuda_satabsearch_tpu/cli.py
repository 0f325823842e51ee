"""tpusatabsearch — drop-in CLI for SA tableau search on the GPU.

Flag- and protocol-compatible with the reference driver
(/root/reference/nvcc_src_current/cudaSaTabsearch.cu:573-700):

* standard mode: stdin carries ``dbfile`` line, options line
  ``T|F T|F T|F`` (LTYPE LORDER LSOLN), then query tableaux+distmatrices;
* ``-q DBFILE``: query-list mode — stdin carries structure identifiers
  resolved against the database; LTYPE=T LORDER=T LSOLN=F forced;
* ``-r N``: number of SA restarts (default 128);
* ``-c``: run on the CPU (the JAX CPU backend and the XLA engine; the
  reference's ``-c`` runs its host-compiled kernel).

Extensions (all optional, default off):
* ``--mesh``: shard the DB entry axis over all visible devices;
* ``--gather-mode {take,onehot}``: gather lowering;
* ``--compat-z``: reproduce the reference's int-truncated z-score call
  (gumbelstats.c:50 signature vs the double at call site
  cudaSaTabsearch.cu:1105) for byte-level output parity;
* ``--seed N``, ``--cmax N``: RNG seed / max lockstep chains.

stdout carries results; all telemetry goes to stderr (the reference's
stream separation, SURVEY §5).
"""

from __future__ import annotations

import argparse
import sys
import time

from .core.constants import DEFAULT_MAXSTART, MAXDIM
from .io.pack import pack_query
from .io.parser import parse_search_input
from .session import (SearchSession, SessionConfig, format_results,
                      print_query_header)

PROGRAM = "tpusatabsearch"


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=PROGRAM,
        description="Simulated-annealing tableau search")
    ap.add_argument("-c", "--cpu", action="store_true",
                    help="run on the CPU instead of the GPU")
    ap.add_argument("-q", "--querydb", metavar="DBFILE", default=None,
                    help="query-list mode: read query ids from stdin, "
                         "resolve them in DBFILE")
    ap.add_argument("-r", "--restarts", type=int, default=DEFAULT_MAXSTART,
                    help="number of SA restarts per entry (default 128)")
    ap.add_argument("--mesh", action="store_true",
                    help="shard DB entries across all visible devices")
    ap.add_argument("--gather-mode", choices=("auto", "take", "onehot"),
                    default="auto")
    ap.add_argument("--compat-z", action="store_true",
                    help="reproduce reference int-truncated z-scores")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--cmax", type=int, default=128,
                    help="max lockstep chains per entry")
    return ap


def main(argv=None) -> int:
    """CLI entry point; returns a process exit status.

    Errors in input parsing / DB loading print an ERROR line and return
    1 (the reference's behavior for the same failures,
    cudaSaTabsearch.cu:667-712), rather than tracebacks.
    """
    try:
        return _run(argv)
    except (FileNotFoundError, ValueError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


def _run(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    err = sys.stderr
    print(f"MAXDIM = {MAXDIM}", file=err)
    config = SessionConfig(maxstart=args.restarts, seed=args.seed,
                           gather_mode=args.gather_mode, c_max=args.cmax,
                           use_mesh=args.mesh, compat_z=args.compat_z)

    if args.querydb is not None:
        # query-list mode (cudaSaTabsearch.cu:631-664): LTYPE/LORDER=T,
        # LSOLN=F forced
        qids = [line.strip() for line in sys.stdin if line.strip()]
        dbfile = args.querydb
        ltype, lorder, lsoln = True, True, False
        queries = None
    else:
        sin = parse_search_input(sys.stdin)
        dbfile = sin.dbfile
        ltype, lorder, lsoln = sin.ltype, sin.lorder, sin.lsoln
        if not ltype:
            print("WARNING: LTYPE is always set to T", file=err)
            ltype = True
        if not sin.queries:
            print("ERROR: no query structures found on stdin", file=err)
            return 1
        print(f"Read {len(sin.queries)} query structures", file=err)
        queries = [pack_query(q) for q in sin.queries]
        qids = [q.name for q in queries]

    print("Loading database...", file=err)
    session = SearchSession(dbfile, config)
    print(f"Loaded {session.nentries} db entries "
          f"({session.load_ms:.1f} ms load, "
          f"{session.upload_ms:.1f} ms device upload)", file=err)
    print(f"maxstart = {args.restarts}", file=err)

    # resolve query-list ids against the resident DB (the reference's
    # query-list mode, cudaSaTabsearch.cu:730-788).  NOTE: qn passed to
    # the stats is the resolved query's order; the reference's query-list
    # mode indexes the wrong array here (cudaSaTabsearch.cu:997, SURVEY
    # §3.3) — deliberately fixed, not replicated.
    resolved: list[tuple[str, object]] = []
    if queries is not None:
        resolved = list(zip(qids, queries))
    else:
        for qid in qids:
            query = session.resolve_query(qid)
            if query is None:
                print(f"ERROR: query structure {qid} not found in db",
                      file=err)
                continue
            resolved.append((qid, query))
    if not resolved:
        return 1 if qids else 0

    # all queries dispatched as one pipeline: device work is enqueued
    # back-to-back and drained once (the reference amortizes its one-time
    # DB copy the same way, cudaSaTabsearch.cu:987-1115; here the
    # per-query drain round trip is the cost being amortized)
    t0 = time.perf_counter()
    results = session.search_many([q for _, q in resolved], lorder=lorder,
                                  lsoln=lsoln)
    dt = time.perf_counter() - t0
    for (qid, query), result in zip(resolved, results):
        print_query_header(PROGRAM, ltype, lorder, lsoln, qid, dbfile)
        format_results(result, query.order, lsoln=lsoln,
                       compat_z=config.compat_z)
    iters = (session.nentries * args.restarts
             * session.config.params.maxiter * len(resolved))
    print(f"search time {dt * 1000.0:.3f} ms "
          f"({len(resolved)} queries)", file=err)
    print(f"{iters / dt / 1.0e6:.1f} million iterations/sec", file=err)
    return 0


if __name__ == "__main__":
    sys.exit(main())
