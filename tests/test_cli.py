"""End-to-end CLI tests: stdin protocol -> stdout contract.

Drives cuda_satabsearch_tpu.cli.main in-process on the CPU backend
against the bundled reference fixture DBs, asserting the output
contract the reference's eval toolchain depends on: '#' metadata
headers (mkroctabs.py:14-36 keys on them), the '%-8s %d %g %g %g'
result lines, LSOLN '%3d %3d' pair lines (cudaSaTabsearch.cu:1102-1114),
--compat-z quantized statistics, query-list resolution, and the worked
example's documented ranking (README_example_usage.txt:92-111).
"""

import io
import os
import re

import numpy as np
import pytest

from cuda_satabsearch_tpu import cli
from cuda_satabsearch_tpu.stats.gumbel import GUMBEL_A, GUMBEL_B, z_gumbel

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")

RESULT_RE = re.compile(
    r"^(\S{1,8})\s+(-?\d+) (-?[\d.]+(?:e-?\d+)?|-?\d+) "
    r"(-?[\d.]+(?:e-?\d+)?) ([\d.]+(?:e-?\d+)?)$")
PAIR_RE = re.compile(r"^(?: {0,2}\d{1,3}) (?: {0,2}\d{1,3})$")


def run_cli(argv, stdin_text, monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin", io.StringIO(stdin_text))
    monkeypatch.chdir(FIXTURES)
    rc = cli.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def read_fixture(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return f.read()


def parse_results(stdout):
    """Split stdout into per-query (header_dict, result_lines, pair_lines)."""
    blocks = []
    cur = None
    for line in stdout.splitlines():
        if line.startswith("# ") and "LTYPE" in line:
            cur = {"header": [line], "results": [], "pairs": []}
            blocks.append(cur)
        elif line.startswith("#"):
            cur["header"].append(line)
        elif RESULT_RE.match(line):
            cur["results"].append(RESULT_RE.match(line).groups())
        else:
            assert PAIR_RE.match(line), f"unexpected line: {line!r}"
            cur["pairs"].append(tuple(int(t) for t in line.split()))
    return blocks


def test_single_query_identity(monkeypatch, capsys):
    """d1ubia_ vs the 1-entry DB containing a structure of the same
    fold family: headers + result format + LSOLN identity pairs."""
    rc, out, err = run_cli(["-c"], read_fixture("d1ubia_.input"),
                           monkeypatch, capsys)
    assert rc == 0
    blocks = parse_results(out)
    assert len(blocks) == 1
    b = blocks[0]
    assert b["header"][0] == (
        "# tpusatabsearch LTYPE = T LORDER = T LSOLN = T")
    assert b["header"][1].startswith("# QUERY ID = D1UBIA_")
    # %-8s pads the query id to width 8
    assert b["header"][1] == "# QUERY ID = " + "%-8s" % "D1UBIA_"
    assert b["header"][2].startswith("# DBFILE = ")
    assert len(b["results"]) == 1
    name, raw, n2s, z, p = b["results"][0]
    assert name == "d1ndda_"
    # the input's query IS d1ndda_'s tableau: identity mapping, every
    # SSE matched -> 8 LSOLN pairs i -> i (1-based)
    assert b["pairs"] == [(k + 1, k + 1) for k in range(8)]
    assert int(raw) > 30  # self-match score is high (56 at full match)


def test_lsoln_off_variant(monkeypatch, capsys):
    """d2phlb1.input has LSOLN=F: no pair lines may appear."""
    text = read_fixture("d2phlb1.input").replace(
        "tableauxdistmatrixdb.small.ascii",
        "tableauxdistmatrixdb.test2.ascii")
    rc, out, err = run_cli(["-c"], text, monkeypatch, capsys)
    assert rc == 0
    blocks = parse_results(out)
    assert blocks[0]["header"][0].endswith("LSOLN = F")
    assert blocks[0]["pairs"] == []
    assert len(blocks[0]["results"]) == 1  # test2.ascii has one entry


def test_compat_z_quantization(monkeypatch, capsys):
    """--compat-z reproduces the reference's int-truncated z/p: every
    emitted z must equal z_gumbel(int(norm2score)) exactly, e.g. the
    z=-1.27278 / 0.903563 plateaus of README_example_usage.txt:43-49."""
    rc, out, err = run_cli(["-c", "--compat-z"],
                           read_fixture("d1ubia_.input"),
                           monkeypatch, capsys)
    assert rc == 0
    b = parse_results(out)[0]
    for name, raw, n2s, z, p in b["results"]:
        zq = z_gumbel(np.floor(np.float64(n2s)), GUMBEL_A, GUMBEL_B)
        assert ("%g" % zq) == z
    # the quantized plateau values themselves, as printed by the
    # reference for norm2 scores in [0, 1) and [1, 2)
    assert "%g" % z_gumbel(0.0, GUMBEL_A, GUMBEL_B) == "-1.27278"
    assert "%g" % z_gumbel(1.0, GUMBEL_A, GUMBEL_B) == "0.903563"


def test_multiquery_pipelined(monkeypatch, capsys):
    """multiquery.input (3 queries of different SSE counts: 8, 13, 101)
    vs the 1-entry DB: one block per query, in input order (the
    pipeline groups queries by order internally and must restore input
    order on output), each with exactly one result line."""
    text = read_fixture("multiquery.input").replace(
        "tableauxdistmatrixdb.small.ascii",
        "tableauxdistmatrixdb.test2.ascii")
    rc, out, err = run_cli(["-c"], text, monkeypatch, capsys)
    assert rc == 0
    blocks = parse_results(out)
    assert len(blocks) == 3
    got_ids = [b["header"][1].split("=")[1].strip() for b in blocks]
    assert got_ids == ["D1UBIA_", "D1AE6H1", "d1twfa_"]
    for b in blocks:
        assert len(b["results"]) == 1
        assert b["results"][0][0] == "d1kcul1"


def test_querylist_mode(monkeypatch, capsys):
    """-q resolves ids from the DB; LSOLN forced off; unknown ids are
    reported on stderr and skipped."""
    rc, out, err = run_cli(
        ["-c", "-q", "tableauxdistmatrixdb.test2.ascii", "-r", "64"],
        "d1kcul1\nnosuchid\n", monkeypatch, capsys)
    assert rc == 0
    assert "ERROR: query structure nosuchid not found" in err
    blocks = parse_results(out)
    assert len(blocks) == 1
    b = blocks[0]
    assert b["header"][0].endswith("LSOLN = F")
    assert b["header"][1] == "# QUERY ID = " + "%-8s" % "d1kcul1"
    assert b["pairs"] == []
    name, raw, n2s, z, p = b["results"][0]
    assert name == "d1kcul1"
    assert int(raw) > 50  # self-match of a 12-SSE entry


def test_bad_db_error(monkeypatch, capsys):
    rc, out, err = run_cli(
        ["-c"], "/nonexistent/db.ascii\nT T F\n" +
        "\n".join(read_fixture("d1ubia_.input").splitlines()[2:]),
        monkeypatch, capsys)
    assert rc == 1
    assert "ERROR" in err


def test_no_queries_error(monkeypatch, capsys):
    rc, out, err = run_cli(
        ["-c"], "tableauxdistmatrixdb.test.ascii\nT T F\n",
        monkeypatch, capsys)
    assert rc == 1
    assert "ERROR" in err


@pytest.mark.slow
def test_worked_example_ranking(monkeypatch, capsys):
    """The reference's worked example (README_example_usage.txt:92-111):
    ubiquitin query vs the 586-entry DB must rank d1c3ta_, d2faza1,
    d1uela_ as the clear top 3 (scores jitter across RNG streams;
    ranking of the top hits is the documented contract)."""
    text = read_fixture("d1ubia_.input").replace(
        "tableauxdistmatrixdb.test.ascii",
        "tableauxdistmatrixdb.small.ascii")
    rc, out, err = run_cli(["-c"], text, monkeypatch, capsys)
    assert rc == 0
    b = parse_results(out)[0]
    assert len(b["results"]) == 586
    ranked = sorted(b["results"], key=lambda r: -int(r[1]))
    top3 = [r[0] for r in ranked[:3]]
    assert set(top3) == {"d1c3ta_", "d2faza1", "d1uela_"}


def test_missing_dbfile_errors_fast(monkeypatch, capsys):
    """A nonexistent DB path (e.g. the bundled 2qp2-1.input probe,
    whose dbfile line points at the reference author's home dir) must
    produce an ERROR line and exit 1 from the DB load — before anything
    is uploaded to the device or compiled."""
    from cuda_satabsearch_tpu import session

    def boom(*a, **k):
        raise AssertionError("device upload ran before the DB load")

    monkeypatch.setattr(session, "upload_db", boom)
    rc, out, err = run_cli(["-c"], read_fixture("2qp2-1.input"),
                           monkeypatch, capsys)
    assert rc == 1
    assert "ERROR" in err and "2qp2" not in out


def test_cli_mesh_flag_bitwise_vs_unsharded(monkeypatch, capsys):
    """--mesh (entry axis sharded over all visible devices — here the
    virtual 8-device CPU mesh) produces byte-identical output to the
    unsharded run: the user-facing face of the sharded==unsharded
    bitwise guarantee."""
    stdin_text = read_fixture("d1ubia_.input")
    rc1, out1, _ = run_cli(["-r", "16"], stdin_text, monkeypatch, capsys)
    rc2, out2, _ = run_cli(["-r", "16", "--mesh"], stdin_text,
                           monkeypatch, capsys)
    assert rc1 == 0 and rc2 == 0
    strip = [ln for ln in out1.splitlines() if not ln.startswith("#")]
    strip2 = [ln for ln in out2.splitlines() if not ln.startswith("#")]
    assert strip and strip == strip2
