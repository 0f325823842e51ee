"""Acceptance evaluation: ranking parity vs the reference CPU oracle.

Since real Fischer/query200 benchmark data (PDB structures + SCOP
classifications) cannot be fetched in this environment, the acceptance
criterion is evaluated the way the reference itself validates GPU
results against CPU results: statistical ranking agreement on the same
DB (SURVEY §4.1).  Three layers of evidence:

1. noise floor — the reference's OWN GPU-vs-CPU agreement, computed
   from its archived 2012 run logs (d2phlb1, r=4096, 586-entry DB;
   old/nvcc_src_cuda5/{cpu_cudaSaTabsearch.o1462445,
   gpucudaSaTabsearch_fermi.o1462444});
2. oracle goldens — outputs of the unmodified reference CPU code
   (tools/refgolden, reproduces the archived log bitwise) on bundled
   queries at r=128 and r=4096 (tests/fixtures/refgolden/*.out);
3. our runs — the same queries through SearchSession on the current
   platform (the kernel on the GPU, the engine on the CPU); parity metrics (Spearman / top-k overlap / retrieval AUC
   with gold = ref top 5%) must be at or above the noise floor, and
   AUC within 0.01 of the reference GPU's (BASELINE.md's "within 1%").

Usage: python scripts/acceptance_eval.py [--restarts 128 4096] [--cpu]
Writes a markdown report to stdout; telemetry to stderr.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
GOLD = os.path.join(FIX, "refgolden")
REFLOG = "/root/reference/old/nvcc_src_cuda5"

QUERIES = {"d1ubia_": 8, "d1ae6h1": 13, "d2phlb1": 19}


def load_scores(path, col=2):
    """{name: score} from a reference-format output file (col 2 =
    norm2 size-normalized score, the ranking the eval layer uses)."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) == 5:
                try:
                    out[parts[0]] = float(parts[col])
                except ValueError:
                    pass
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--restarts", type=int, nargs="+", default=[128, 4096])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from cuda_satabsearch_tpu.eval.acceptance import parity_report
    from cuda_satabsearch_tpu.io.pack import pack_query
    from cuda_satabsearch_tpu.io.parser import parse_search_input
    from cuda_satabsearch_tpu.session import SearchSession, SessionConfig
    from cuda_satabsearch_tpu.stats.gumbel import norm2

    print("# Acceptance evaluation — ranking parity vs reference CPU "
          "oracle\n")
    print("Metrics: Spearman rank correlation over all 586 entries; "
          "top-10/top-50 overlap;\nretrieval AUC with gold = reference "
          "top 5% (by norm2 score).\n")

    # --- layer 1: reference's own GPU-vs-CPU noise floor
    cpu_log = os.path.join(REFLOG, "cpu_cudaSaTabsearch.o1462445")
    gpu_log = os.path.join(REFLOG, "gpucudaSaTabsearch_fermi.o1462444")
    floor = None
    if os.path.exists(cpu_log) and os.path.exists(gpu_log):
        floor = parity_report(load_scores(gpu_log), load_scores(cpu_log))
        print("## Reference noise floor (its own GPU vs CPU, d2phlb1 "
              "r=4096, archived 2012 logs)\n")
        print(f"    {floor.row()}\n")

    # --- layers 2+3 per query/restart
    dbfile = os.path.join(FIX, "tableauxdistmatrixdb.small.ascii")
    print("## This framework vs reference CPU oracle "
          f"(platform={'cpu' if args.cpu else 'default'})\n")
    print("| query | n1 | restarts | spearman | top10 | top50 | auc5 | "
          "ref-GPU auc5 |")
    print("|---|---|---|---|---|---|---|---|")
    rows = []
    for r in args.restarts:
        session = SearchSession(dbfile, SessionConfig(maxstart=r))
        for qname, n1 in QUERIES.items():
            gold_path = os.path.join(GOLD, f"{qname}_small_r{r}.out")
            if not os.path.exists(gold_path):
                print(f"(skipping {qname} r={r}: no oracle golden)",
                      file=sys.stderr)
                continue
            ref = load_scores(gold_path)
            with open(os.path.join(FIX, f"{qname}.input")) as f:
                sin = parse_search_input(f)
            query = pack_query(sin.queries[0])
            t0 = time.perf_counter()
            res = session.search(query, lorder=True, lsoln=False)
            dt = time.perf_counter() - t0
            ours = {res.names[i]: norm2(int(res.scores[i]), n1,
                                        int(res.orders[i]))
                    for i in range(res.nentries)}
            rep = parity_report(ours, ref)
            gpu_auc = ""
            if floor is not None and qname == "d2phlb1" and r == 4096:
                gpu_auc = f"{floor.auc5:.4f}"
            rows.append((qname, n1, r, rep))
            print(f"| {qname} | {n1} | {r} | {rep.spearman:.4f} | "
                  f"{rep.top10:.2f} | {rep.top50:.2f} | {rep.auc5:.4f} "
                  f"| {gpu_auc} |")
            print(f"{qname} r={r}: {rep.row()}  [{dt*1e3:.0f} ms]",
                  file=sys.stderr)
    print()
    if floor is not None:
        d2p = [rep for q, n1, r, rep in rows
               if q == "d2phlb1" and r == 4096]
        if d2p:
            delta = d2p[0].auc5 - floor.auc5
            verdict = "PASS" if delta >= -0.01 else "FAIL"
            print(f"**Acceptance (d2phlb1 r=4096): our AUC {d2p[0].auc5:.4f}"
                  f" vs reference-GPU AUC {floor.auc5:.4f} "
                  f"(delta {delta:+.4f}) -> {verdict}** "
                  "(bar: within 0.01, BASELINE.md)\n")


if __name__ == "__main__":
    main()
