"""Diagnose the bf16 distance-quantization contribution to ranking
parity (ROADMAP design debt 5): rerun d2phlb1 r=4096 WITHOUT
io.pack.quantize_dmat and compare
parity-vs-oracle with the quantized run.

Usage: python scripts/quantize_diag.py [--restarts 4096]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
GOLD = os.path.join(FIX, "refgolden")


def run_once(restarts: int, quantized: bool):
    from cuda_satabsearch_tpu.eval.acceptance import parity_report
    from cuda_satabsearch_tpu.io import pack
    from cuda_satabsearch_tpu.io.pack import pack_query
    from cuda_satabsearch_tpu.io.parser import parse_search_input
    from cuda_satabsearch_tpu.session import SearchSession, SessionConfig
    from cuda_satabsearch_tpu.stats.gumbel import norm2
    from scripts.acceptance_eval import load_scores

    from cuda_satabsearch_tpu.io.parser import read_database

    # pass entries= so packing goes through the Python pack_database
    # path (the native C++ packer quantizes internally and has no
    # bypass), with pack.quantize_dmat monkeypatched to identity
    orig = pack.quantize_dmat
    if not quantized:
        pack.quantize_dmat = lambda d: d
    try:
        dbfile = os.path.join(FIX, "tableauxdistmatrixdb.small.ascii")
        session = SearchSession(
            dbfile, SessionConfig(maxstart=restarts),
            entries=read_database(dbfile))
        with open(os.path.join(FIX, "d2phlb1.input")) as f:
            query = pack_query(parse_search_input(f).queries[0])
    finally:
        pack.quantize_dmat = orig
    t0 = time.perf_counter()
    res = session.search(query, lorder=True, lsoln=False)
    dt = time.perf_counter() - t0
    ours = {res.names[i]: norm2(int(res.scores[i]), query.order,
                                int(res.orders[i]))
            for i in range(res.nentries)}
    ref = load_scores(os.path.join(GOLD, f"d2phlb1_small_r{restarts}.out"))
    rep = parity_report(ours, ref)
    print(f"quantized={quantized}: {rep.row()}  [{dt:.1f} s]")
    return rep


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--restarts", type=int, default=4096)
    args = ap.parse_args()
    q = run_once(args.restarts, True)
    u = run_once(args.restarts, False)
    print(f"\nbf16-quantization contribution (d2phlb1 r={args.restarts}, "
          f"XLA engine):\n"
          f"  auc5 {q.auc5:.4f} (quantized) vs {u.auc5:.4f} (full f32) "
          f"-> delta {q.auc5 - u.auc5:+.4f}\n"
          f"  spearman {q.spearman:.4f} vs {u.spearman:.4f}, "
          f"top10 {q.top10:.2f} vs {u.top10:.2f}")


if __name__ == "__main__":
    main()
