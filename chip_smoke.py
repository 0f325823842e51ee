#!/usr/bin/env python3
"""Smoke test of the tableau search on one NVIDIA GPU.

    python3 chip_smoke.py                # one card: every phase below
    python3 chip_smoke.py --four-cards   # only the DB sharded over 4 cards

Phases (any failure exits non-zero; nothing is caught and nothing falls
back to the CPU or to interpret mode):

  0. JAX must find a GPU (checked in a child process, so that the CLI
     children of phase 4 get the card before this process takes it).
  4. The CLI as child processes, one after another, with this process
     off the card: standard mode on the 586-entry DB (the worked example:
     top 3 must be d1c3ta_, d2faza1, d1uela_), query-list mode, and
     multiquery.input (8-, 13- and 101-SSE queries); then the chip tests
     (pytest -m gpu).
  1. Native library build; the 586-entry fixture DB and the 14,291-entry
     synthetic DB (bench.synthetic_entries) loaded through SearchSession.
  2. Every program compiled at its real widths (reported as set-up) and
     peak device memory.
  3. Correctness: the engine on the card against the golden model and
     against the engine on the CPU; the kernel compiled for the card
     against the engine on the card, bitwise; search_many against
     search, LSOLN on and off.
  5. The bench shapes timed on the path that stands, and the kernel
     against the engine (A, B, B, A), each line with the card's name and
     power limit.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
DB586 = "tableauxdistmatrixdb.small.ascii"
TOP3 = {"d1c3ta_", "d2faza1", "d1uela_"}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")
    log(f"ok: {what}")


def child(args, *, stdin=None, cwd=ROOT, env=None, timeout=900):
    t0 = time.perf_counter()
    r = subprocess.run(args, input=stdin, cwd=cwd, capture_output=True,
                       text=True, timeout=timeout,
                       env={**os.environ, **(env or {})})
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-4000:])
        raise SystemExit(f"FAILED: {' '.join(args[:4])} exited "
                         f"{r.returncode}")
    return r, time.perf_counter() - t0


def probe_platform() -> str:
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True, timeout=300)
    return r.stdout.strip().splitlines()[-1] if r.returncode == 0 else ""


def top_hits(stdout: str, k: int = 3) -> list:
    rows = [ln.split() for ln in stdout.splitlines()
            if ln and not ln.startswith("#") and len(ln.split()) == 5]
    rows.sort(key=lambda r: -int(r[1]))
    return [(r[0], int(r[1])) for r in rows[:k]]


def phase_cli(gpu: str) -> None:
    cli = [sys.executable, "-m", "cuda_satabsearch_tpu", "-r", "128"]
    env = {"PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                           "")}
    with open(os.path.join(FIXTURES, "d1ubia_.input")) as fh:
        query_text = "".join(fh.readlines()[2:])
    r, dt = child(cli, stdin=f"{DB586}\nT T F\n" + query_text,
                  cwd=FIXTURES, env=env)
    top = top_hits(r.stdout)
    log(f"cli standard mode, 586 entries, r=128: {dt:.1f} s wall "
        f"(one process, compile included) [{gpu}]; top 3 {top}")
    check({n for n, _ in top} == TOP3,
          "worked example: top 3 are d1c3ta_, d2faza1, d1uela_")

    r, dt = child(cli + ["-q", DB586], stdin="d1kcul1\nd1c3ta_\n",
                  cwd=FIXTURES, env=env)
    heads = [ln for ln in r.stdout.splitlines() if ln.startswith("# QUERY")]
    log(f"cli query-list mode (2 ids): {dt:.1f} s wall; {heads}")
    check(len(heads) == 2 and "LSOLN = F" in r.stdout,
          "query-list mode answers both ids, LSOLN forced off")

    with open(os.path.join(FIXTURES, "multiquery.input")) as fh:
        r, dt = child(cli, stdin=fh.read(), cwd=FIXTURES, env=env)
    nres = sum(1 for ln in r.stdout.splitlines()
               if ln and not ln.startswith("#"))
    nq = r.stdout.count("# QUERY ID")
    log(f"cli multiquery.input: {nq} queries, {nres} result lines, "
        f"{dt:.1f} s wall")
    check(nq == 3 and nres == 3 * 586, "multiquery: 3 x 586 results")

    r, dt = child([sys.executable, "-m", "pytest", "-q", "-m", "gpu",
                   "-p", "no:cacheprovider", "tests/test_gpu.py"],
                  env={"JAX_PLATFORMS": "cuda,cpu"}, timeout=1200)
    last = r.stdout.strip().splitlines()[-1]
    log(f"chip tests (pytest -m gpu): {last} ({dt:.1f} s)")
    check(" passed" in last and "skipped" not in last
          and "failed" not in last, "chip tests pass on the card")


def timed(fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def fmt(ts) -> str:
    return "[" + ", ".join(f"{t * 1e3:.3f}" for t in ts) + "] ms"


def read_queries(name: str) -> list:
    from cuda_satabsearch_tpu.io.pack import pack_query
    from cuda_satabsearch_tpu.io.parser import parse_search_input

    with open(os.path.join(FIXTURES, name)) as fh:
        return [pack_query(q) for q in parse_search_input(fh).queries]


def one_card(gpu: str, dev) -> None:
    import jax
    import numpy as np

    from bench import synthetic_entries
    from cuda_satabsearch_tpu.io import native
    from cuda_satabsearch_tpu.ops.search import search_db
    from cuda_satabsearch_tpu.session import SearchSession, SessionConfig

    # phase 1: native build and both DBs through SearchSession
    check(native.available(), "native library built from satab_io.cpp")
    dbfile = os.path.join(FIXTURES, DB586)
    t0 = time.perf_counter()
    s586 = SearchSession(dbfile, SessionConfig(maxstart=128))
    s4k = SearchSession(dbfile, SessionConfig(maxstart=4096))
    big = SearchSession("<synthetic>", SessionConfig(maxstart=128),
                        entries=synthetic_entries(14291))
    log(f"set-up: DBs loaded and uploaded in "
        f"{time.perf_counter() - t0:.1f} s (586 and 14,291 entries); "
        f"backend {s586.backend}")
    check(s586.backend == "triton" and big.nentries == 14291,
          "the GPU routes to the compiled kernel")

    [ub] = read_queries("d1ubia_.input")
    [ph] = read_queries("d2phlb1.input")
    mq = read_queries("multiquery.input")
    q101 = next(q for q in mq if q.order == 101)

    # phase 2: compile every program family at real widths (set-up)
    families = [
        ("586db 8-SSE r128 search", lambda: s586.search(ub, query_tag=0)),
        ("586db 8-SSE r128 x384 stream",
         lambda: s586.search_many([ub] * 384)),
        ("586db multiquery (8, 13, 101 SSEs)",
         lambda: s586.search_many(mq)),
        ("large14291 8-SSE r128 search", lambda: big.search(ub,
                                                            query_tag=0)),
        ("large14291 8-SSE r128 x64 stream",
         lambda: big.search_many([ub] * 64)),
        ("586db 19-SSE r4096 search", lambda: s4k.search(ph, query_tag=0)),
        ("586db 19-SSE r4096 x16 stream",
         lambda: s4k.search_many([ph] * 16)),
    ]
    for name, fn in families:
        t0 = time.perf_counter()
        fn()
        log(f"set-up: compile+first run {name}: "
            f"{time.perf_counter() - t0:.1f} s")
    peak = dev.memory_stats()["peak_bytes_in_use"]
    log(f"peak device memory after compiling: {peak} bytes "
        f"({peak / 2**30:.2f} GiB) [{gpu}]")

    # phase 3: correctness.  The engine on the card against the golden
    # model: the cases of tests/test_engine.py, run here on the GPU.
    cpu = jax.devices("cpu")[0]
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    os.environ["JAX_PLATFORMS"] = "cuda,cpu"  # conftest keeps the card
    from test_engine import _run_pair

    for n1, n2, cap, lorder in ((6, 8, 16, True), (6, 8, 16, False),
                                (8, 8, 16, True), (4, 12, 16, True),
                                (12, 5, 16, True), (9, 15, 16, True)):
        score, bestmap, gscore, gmap, _ = _run_pair(
            n1, n2, cap, 8, 2, lorder, seed=n1 * 100 + n2)
        check(score == gscore and np.array_equal(bestmap, gmap),
              f"engine on the card == golden (n1={n1}, n2={n2}, "
              f"lorder={lorder})")

    e586 = SearchSession(dbfile, SessionConfig(maxstart=128), backend="xla")
    for q in (ub, ph, q101):
        for lorder in (True, False):
            k = s586.search(q, lorder=lorder, query_tag=0)
            e = e586.search(q, lorder=lorder, query_tag=0)
            check(np.array_equal(k.scores, e.scores)
                  and np.array_equal(k.ssemaps, e.ssemaps),
                  f"kernel == engine on the card, 586 entries, "
                  f"n1={q.order}, lorder={lorder}, r=128, scores+maps")
            with jax.default_device(cpu):
                c = search_db(q, s586.db, maxstart=128, lorder=lorder,
                              seed=1234, query_tag=0, backend="xla")
            flips = int((e.scores != c.scores).sum())
            check(flips == 0 and np.array_equal(e.ssemaps, c.ssemaps),
                  f"engine on the card == engine on the CPU, 586 entries, "
                  f"n1={q.order}, lorder={lorder}, r=128 ({flips} flipped)")
    r = s586.search(ub, query_tag=0)
    top = sorted(zip(r.scores.tolist(), r.names), reverse=True)[:3]
    log(f"worked example top 3: {top}")
    check({n for _, n in top} == TOP3, "worked example ranking")
    for lsoln in (True, False):
        many = s586.search_many(mq, lsoln=lsoln)
        tag0 = s586._query_tag - len(mq)
        for i, q in enumerate(mq):
            one = s586.search(q, query_tag=tag0 + i, lsoln=lsoln)
            check(np.array_equal(many[i].scores, one.scores)
                  and (not lsoln
                       or np.array_equal(many[i].ssemaps, one.ssemaps)),
                  f"search_many == search, n1={q.order}, lsoln={lsoln}")

    # phase 5: the bench shapes on the path that stands (the kernel),
    # and the kernel against the engine, A B B A, per-query latency
    import bench

    engines = {"586db": e586,
               "large14291": SearchSession(
                   "<synthetic>", SessionConfig(maxstart=128),
                   entries=synthetic_entries(14291), backend="xla"),
               "d2phlb1_r4096": SearchSession(
                   dbfile, SessionConfig(maxstart=4096), backend="xla")}
    for label, sess, q, r_, nq in (("586db", s586, ub, 128, 384),
                                   ("large14291", big, ub, 128, 64),
                                   ("d2phlb1_r4096", s4k, ph, 4096, 16)):
        eng = engines[label]
        t0 = time.perf_counter()
        eng.search(q, query_tag=0)
        log(f"set-up: compile+first run engine {label}: "
            f"{time.perf_counter() - t0:.1f} s")
        iters = sess.nentries * r_ * 100
        ab = {"kernel": [], "engine": []}
        for name in ("kernel", "engine", "engine", "kernel"):
            one = sess if name == "kernel" else eng
            ab[name] += timed(lambda: one.search(q, query_tag=0), 3)
        for name, ts in ab.items():
            med = float(np.median(ts))
            log(f"time A/B {label} {name} per-query {fmt(ts)}, median "
                f"{med * 1e3:.3f} ms = {iters / med / 1e6:.1f} M it/s "
                f"[{gpu}]")
        st_t = timed(lambda: sess.search_many([q] * nq), 3)
        log(f"time {label} kernel sustained x{nq} {fmt(st_t)} = "
            f"{iters * nq / min(st_t) / 1e6:.1f} M it/s [{gpu}]")
    log(f"bench reference figures (other cards): A100 "
        f"{bench.BASELINE_M_IT_S} / {bench.BASELINE_LARGE}, M2070 "
        f"{bench.BASELINE_BIGQ} M it/s")

    onehot = SearchSession(dbfile, SessionConfig(maxstart=128,
                                                 gather_mode="onehot"),
                           backend="xla")
    t0 = time.perf_counter()
    check(np.array_equal(onehot.search(ub, query_tag=0).scores,
                         e586.search(ub, query_tag=0).scores),
          "engine gather modes agree (onehot == take)")
    log(f"set-up: compile+first run engine onehot: "
        f"{time.perf_counter() - t0:.1f} s")
    ab = {"take": [], "onehot": []}
    for name in ("take", "onehot", "onehot", "take"):
        one = e586 if name == "take" else onehot
        ab[name] += timed(lambda: one.search(ub, query_tag=0), 3)
    for name, ts in ab.items():
        log(f"time A/B 586db engine gather={name} per-query {fmt(ts)}, "
            f"median {float(np.median(ts)) * 1e3:.3f} ms [{gpu}]")


def four_cards(gpu: str) -> None:
    import jax
    import numpy as np

    from bench import synthetic_entries
    from cuda_satabsearch_tpu.session import SearchSession, SessionConfig

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"FAILED: --four-cards needs 4 GPUs, "
                         f"found {len(devs)}")
    entries = synthetic_entries(14291)
    [ub] = read_queries("d1ubia_.input")
    t0 = time.perf_counter()
    one = SearchSession("<synthetic>", SessionConfig(maxstart=128),
                        entries=entries)
    four = SearchSession("<synthetic>", SessionConfig(
        maxstart=128, use_mesh=True, devices=devs[:4]), entries=entries)
    log(f"set-up: 14,291 entries loaded on 1 card and over 4 in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, s in (("1 card", one), ("4 cards", four)):
        t0 = time.perf_counter()
        s.search(ub, query_tag=0)
        log(f"set-up: compile+first run {name}: "
            f"{time.perf_counter() - t0:.1f} s")
    res = {}
    for name, s in (("1 card", one), ("4 cards", four), ("4 cards", four),
                    ("1 card", one)):
        t = timed(lambda: s.search(ub, query_tag=0), 3)
        res[name] = s.search(ub, query_tag=0)
        log(f"time large14291 8-SSE r128 per-query on {name}: {fmt(t)} "
            f"[{gpu}]")
    check(np.array_equal(res["4 cards"].scores, res["1 card"].scores)
          and np.array_equal(res["4 cards"].ssemaps, res["1 card"].ssemaps),
          "4-card sharded search == 1-card search, scores+maps bitwise")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the DB sharded over 4 cards")
    args = ap.parse_args()

    platform = probe_platform()
    if platform != "gpu":
        print(f"no GPU found (JAX platform: {platform or 'none'})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from bench import gpu_info

    gpu = gpu_info().splitlines()[0]
    log(f"card: {gpu}")
    if not args.four_cards:
        phase_cli(gpu)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        return 1
    if args.four_cards:
        four_cards(gpu)
    else:
        one_card(gpu, devs[0])
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
