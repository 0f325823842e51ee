"""Produce the end-to-end L4 evaluation artifact (eval_artifacts/).

Drives the full product pipeline on real hardware and commits its
outputs under eval_artifacts/:

1. run the bundled mixed-order multiquery stream
   (tests/fixtures/multiquery.input: 8-, 13- and 101-SSE queries vs
   the 586-entry DB) through the real CLI (search_many path) on the
   GPU kernel, timing the run;
2. run the same stream with ``-c`` (the XLA engine on the CPU) as the
   comparison row;
3. build a gold-standard file from the reference CPU oracle outputs
   (top 5% by norm2 score, the acceptance-eval convention) for the
   queries with oracle goldens;
4. evaluate with `python -m cuda_satabsearch_tpu.eval` (AUC table,
   LaTeX rows, slrtab files) and emit the mkquery200timestab.sh-style
   AUC/time/speedup LaTeX table via eval.timestab.

The CLI runs are child processes, one after another; this process
never initializes a JAX backend, so each child has the card to itself.

Usage: python scripts/make_eval_artifact.py [--restarts 128]
"""

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
GOLD_SRC = os.path.join(FIX, "refgolden")
OUT = os.path.join(REPO, "eval_artifacts")

sys.path.insert(0, REPO)


def build_gold(path: str, frac: float = 0.05) -> list[str]:
    """Gold file: for each query with a reference-oracle golden, the
    oracle's top ``frac`` of DB entries by norm2 score are positives."""
    from scripts.acceptance_eval import load_scores

    lines = []
    covered = []
    for qname in ("d1ubia_", "d1ae6h1"):
        gp = os.path.join(GOLD_SRC, f"{qname}_small_r4096.out")
        ref = load_scores(gp)
        k = max(1, int(len(ref) * frac))
        top = sorted(ref, key=ref.get, reverse=True)[:k]
        lines.append(" ".join([qname] + sorted(top)))
        covered.append(qname)
    with open(path, "w") as fh:
        fh.write("# gold = reference CPU oracle top 5% by norm2 "
                 "(r=4096 goldens)\n")
        fh.write("\n".join(lines) + "\n")
    return covered


def run_cli(outpath: str, restarts: int, backend_args: list[str]) -> float:
    """Run the real CLI; returns the CLI-reported SEARCH time (its
    'search time N ms' stderr line — dispatch+device+drain for the
    whole stream).  Process wall time would also count start-up and
    compilation, which are not the comparison."""
    import re

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    with open(os.path.join(FIX, "multiquery.input")) as fin, \
            open(outpath, "w") as fout:
        proc = subprocess.run(
            [sys.executable, "-m", "cuda_satabsearch_tpu",
             "-r", str(restarts)] + backend_args,
            stdin=fin, stdout=fout, stderr=subprocess.PIPE,
            cwd=FIX, env=env, check=True)
    wall = time.perf_counter() - t0
    m = re.search(r"search time ([\d.]+) ms",
                  proc.stderr.decode(errors="replace"))
    if not m:
        print("WARNING: CLI 'search time' line not found; falling back "
              f"to process wall time ({wall:.1f} s), which includes "
              "start-up and compilation — rows are not comparable",
              file=sys.stderr)
        return wall
    return float(m.group(1)) / 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--restarts", type=int, default=128)
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)

    gold_path = os.path.join(OUT, "gold_oracle_top5.txt")
    covered = build_gold(gold_path)
    print(f"gold standard written for {covered}", file=sys.stderr)

    runs = []
    for label, extra in (("gpu-kernel", []), ("cpu-engine", ["-c"])):
        out = os.path.join(OUT, f"multiquery_{label}.out")
        dt = run_cli(out, args.restarts, extra)
        runs.append((label, out, dt))
        print(f"{label}: {dt:.1f} s", file=sys.stderr)

    from cuda_satabsearch_tpu.eval.__main__ import main as eval_main

    slrdir = os.path.join(OUT, "slrtabs")
    for dest, argv in (
            ("auc_table.txt", [runs[0][1], "--gold", gold_path,
                               "--roc50", "--slrtab-dir", slrdir]),
            ("auc_table.tex", [runs[0][1], "--gold", gold_path,
                               "--roc50", "--latex"])):
        with open(os.path.join(OUT, dest), "w") as fh:
            old = sys.stdout
            sys.stdout = fh
            try:
                eval_main(argv)
            finally:
                sys.stdout = old

    manifest = os.path.join(OUT, "timestab_manifest.tsv")
    with open(manifest, "w") as fh:
        fh.write("# label\tresults\tseconds  (slowest row = baseline)\n")
        for label, out, dt in sorted(runs, key=lambda r: -r[2]):
            fh.write(f"{label}\t{out}\t{dt:.2f}\n")
    from cuda_satabsearch_tpu.eval.timestab import main as timestab_main

    with open(os.path.join(OUT, "timestab.tex"), "w") as fh:
        old = sys.stdout
        sys.stdout = fh
        try:
            timestab_main([manifest, "--gold", gold_path])
        finally:
            sys.stdout = old
    print(f"artifact written to {OUT}", file=sys.stderr)


if __name__ == "__main__":
    main()
