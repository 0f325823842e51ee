"""Evaluation-harness tests: AUC semantics, multiquery parsing,
Gumbel fit recovery."""

import io

import numpy as np

from cuda_satabsearch_tpu.eval import (auc, compute_auc, fit_gumbel,
                                       iter_multiquery, parse_searchresult,
                                       roc_curve, roc_n, write_slrtab)


def test_compute_auc_trapezoid():
    # perfect ROC
    assert compute_auc([0, 0, 1], [0, 1, 1]) == 1.0
    # diagonal
    assert abs(compute_auc([0, 0.5, 1], [0, 0.5, 1]) - 0.5) < 1e-12


def test_auc_perfect_and_random():
    scores = np.array([10, 9, 8, 1, 0.5, 0.2])
    labels = np.array([1, 1, 1, 0, 0, 0])
    assert auc(scores, labels) == 1.0
    assert auc(-scores, labels) == 0.0
    # AUC equals normalized Mann-Whitney U
    rng = np.random.default_rng(0)
    s = rng.random(200)
    l = rng.integers(0, 2, 200)
    pos = s[l == 1]
    neg = s[l == 0]
    u = ((pos[:, None] > neg[None, :]).sum()
         + 0.5 * (pos[:, None] == neg[None, :]).sum())
    expect = u / (len(pos) * len(neg))
    assert abs(auc(s, l) - expect) < 1e-12


def test_auc_ties_handled():
    scores = [5, 5, 5, 5]
    labels = [1, 0, 1, 0]
    assert abs(auc(scores, labels) - 0.5) < 1e-12


def test_roc_n():
    scores = [9, 8, 7, 6, 5]
    labels = [1, 1, 0, 0, 1]
    # ROC1: first FP at rank 3, tp=2 at that point -> 2 / (1*3)
    assert abs(roc_n(scores, labels, 1) - 2 / 3) < 1e-12
    assert roc_n([3, 2, 1], [1, 1, 1, ][:3], 50) >= 0  # no crash npos only?


def test_parse_searchresult_skips_nan():
    text = "# comment\nd1aaaa_ 5.0\nd2bbbb_ nan\nd3cccc_ 1.0\nbadline\n"
    res, comments = parse_searchresult(io.StringIO(text))
    assert res == [(1.0, "d3cccc_"), (5.0, "d1aaaa_")]
    assert comments == ["# comment\n"]


def test_iter_multiquery_splits():
    text = ("# tpusatabsearch LTYPE = T LORDER = T LSOLN = F\n"
            "# QUERY ID = d1ubia_\n"
            "# DBFILE = x\n"
            "d1aaaa_ 5 1.0 0.5 0.1\n"
            "d2bbbb_ 3 0.5 0.2 0.3\n"
            "# QUERY ID = d2phlb1\n"
            "d1aaaa_ 7 1.0 0.5 0.1\n")
    out = list(iter_multiquery(io.StringIO(text)))
    assert out[0][0] == "d1ubia_"
    assert out[0][1] == [(5.0, "d1aaaa_"), (3.0, "d2bbbb_")]
    assert out[1] == ("d2phlb1", [(7.0, "d1aaaa_")])
    # self-skip
    text2 = "# QUERY ID = d1aaaa_\nd1aaaa_ 9\nd2bbbb_ 1\n"
    out2 = list(iter_multiquery(io.StringIO(text2), skip_self=True))
    assert out2[0][1] == [(1.0, "d2bbbb_")]


def test_write_slrtab():
    buf = io.StringIO()
    write_slrtab(buf, [(5.0, "d1aaaa_"), (3.0, "D2BBBB_")], {"d2bbbb_"})
    assert buf.getvalue() == "5.0 0\n3.0 1\n"


def test_fit_gumbel_recovers_params():
    rng = np.random.default_rng(42)
    a_true, b_true = 0.378, 0.358  # the reference's shipped params
    n = 200000
    u = rng.random(n)
    samples = a_true - b_true * np.log(-np.log(u))
    a, b = fit_gumbel(samples)
    assert abs(a - a_true) < 0.01
    assert abs(b - b_true) < 0.01


def test_norms():
    from cuda_satabsearch_tpu.stats.norms import (empirical_zscores, norm1,
                                                  norm2, norm3)

    assert norm1(10, 4, 8) == 2.5
    assert norm2(10, 4, 8) == 10 / 6.0
    assert norm3(10, 4, 8) == 2.5
    assert norm3(10, 1, 8) == 0.0  # 7/8 > 0.75 size difference
    z = empirical_zscores([1.0, 2.0, 3.0])
    assert abs(z[1]) < 1e-12 and z[2] > 0


def test_fischer_tables_consistent():
    from cuda_satabsearch_tpu.eval.fischer import (
        FISCHER_TABLE, FISCHER_FOLD_IDS, FISCHER_CLASS_IDS, fischer_gold)
    assert len(FISCHER_TABLE) == 68
    assert sum(len(v) for v in FISCHER_FOLD_IDS.values()) == 68
    assert set(FISCHER_CLASS_IDS) == {
        "alpha", "beta", "alpha/beta", "alpha+beta", "other"}
    gold_f = fischer_gold("fold")
    gold_c = fischer_gold("class")
    for pid in FISCHER_TABLE:
        assert pid in gold_f[pid]  # self is a positive
        assert gold_f[pid] <= gold_c[pid]  # fold level refines class
    assert gold_f["1tie"] == {"1tie", "8i1b"}
    assert gold_c["2pna"] == {"1fxi_a", "1cew", "1stf_i", "2pna",
                              "2sar_a", "1onc", "5fd1"}


def test_fischer_eval_cli(tmp_path, capsys):
    from cuda_satabsearch_tpu.eval.__main__ import main as eval_main
    # synthetic multiquery output: 1tie ranks its fold-mate first
    res = tmp_path / "out.txt"
    res.write_text(
        "# QUERY ID = 1tie\n"
        "8i1b 9.0\n1arb 3.0\n1mup 2.0\n"
        "# QUERY ID = 1mdc\n"
        "1mup 1.0\n8i1b 5.0\n1arb 4.0\n")
    rc = eval_main([str(res), "--fischer", "fold"])
    out = capsys.readouterr().out
    assert rc == 0
    lines = [l for l in out.splitlines() if l.startswith(("1tie", "1mdc"))]
    assert "1.0000" in lines[0]  # 1tie: perfect ranking
    assert "0.0000" in lines[1]  # 1mdc: fold-mate ranked last
    rc = eval_main([str(res), "--fischer", "fold", "--latex"])
    out = capsys.readouterr().out
    assert r"1tie & 1.0000 \\" in out
    assert r"mean & 0.5000 \\" in out


def test_scop_cla_parsing_and_gold(tmp_path):
    import io
    from cuda_satabsearch_tpu.eval.scop import (
        parse_cla, scop_gold, group_by_level, domain_info,
        sample_query_list)
    cla = io.StringIO(
        "# dir.cla.scope.txt\n"
        "d1ubia_ 1ubi A: d.15.1.1 14982 cl=1,cf=2,sf=3,fa=4\n"
        "d1fxia_ 1fxi A: d.15.1.1 14983 cl=1,cf=2,sf=3,fa=4\n"
        "d2faza1 2faz A: d.15.2.1 14984 cl=1,cf=2,sf=5,fa=6\n"
        "d1arba_ 1arb A: b.47.1.2 20000 cl=7,cf=8,sf=9,fa=10\n"
        "d2sgaa_ 2sga A: b.47.1.1 20001 cl=7,cf=8,sf=9,fa=11\n")
    doms = parse_cla(cla)
    assert len(doms) == 5
    folds = group_by_level(doms, "fold")
    assert sorted(folds["d.15"]) == ["d1fxia_", "d1ubia_", "d2faza1"]
    gold = scop_gold(doms, queries=["d1ubia_"], level="superfamily")
    assert gold["d1ubia_"] == {"d1ubia_", "d1fxia_"}
    gold = scop_gold(doms, queries=["d1ubia_"], level="fold",
                     restrict_to=["d1ubia_", "d1arba_"])
    assert gold["d1ubia_"] == {"d1ubia_"}
    info = domain_info(doms, ["d1arba_", "nope"])
    assert info[0] == "d1arba_ b.47.1.2 b.47 b.47.1"
    assert info[1].startswith("#")
    # class-proportional sampling: 3 d-class + 2 b-class, ask for 5
    q = sample_query_list(doms, 5, seed=1)
    assert len(q) == 5 and len(set(q)) == 5
    q2 = sample_query_list(doms, 2, seed=1)
    assert len(q2) == 2


def test_nh3d_tables_and_gold():
    from cuda_satabsearch_tpu.eval.nh3d import (
        NH3D_QUERIES, all_cath_ids, architecture, cathmap, compress,
        nh3d_gold)
    ids = all_cath_ids()
    assert len(ids) == 806  # matches reference scripts/cathmap.py CATHMAP
    assert "4.10.990" in ids
    assert len(NH3D_QUERIES) == 73
    cm = cathmap()
    assert len(cm) == 806  # compression is collision-free on Nh3D
    assert cm["1101290"] == "1.10.1290"  # the reference's own example
    assert cm["3301530"] == "3.30.1530"
    qset = set(NH3D_QUERIES)
    assert qset <= set(ids)  # every query is in the dataset
    gold = nh3d_gold("arch")
    assert set(gold) == {compress(q) for q in NH3D_QUERIES}
    g = gold[compress("1.10.1040")]
    assert compress("1.10.1040") in g  # self positive
    assert all(cm[p].startswith("1.10.") for p in g)
    assert len(g) == sum(1 for i in ids if architecture(i) == "1.10")
    gold_c = nh3d_gold("class")
    assert gold[compress("3.20.19")] < gold_c[compress("3.20.19")]


def test_nh3d_eval_cli(tmp_path, capsys):
    from cuda_satabsearch_tpu.eval.__main__ import main as eval_main
    res = tmp_path / "out.txt"
    # query 1.20.5 (compressed 1205): rank an arch-mate first, then
    # non-arch entries
    res.write_text(
        "# QUERY ID = 1205\n"
        "120150 9.0\n34010 3.0\n25010 2.0\n")
    rc = eval_main([str(res), "--nh3d", "arch"])
    out = capsys.readouterr().out
    assert rc == 0
    assert any(l.startswith("1205") and "1.0000" in l
               for l in out.splitlines())


def test_cops_gold(tmp_path):
    from cuda_satabsearch_tpu.eval.cops import parse_cops_tp
    tp = tmp_path / "cops.tp"
    tp.write_text("# header\n"
                  "c1abcA_ T1 T2 T3 T4 T5 T6\n"
                  "badline only three\n"
                  "c2defB_ U1 U2 U3 U4 U5 U6\n")
    gold = parse_cops_tp(str(tp))
    assert gold["c1abca_"] == {"t1", "t2", "t3", "t4", "t5", "t6"}
    assert len(gold) == 2
    import pytest
    with pytest.raises(ValueError):
        parse_cops_tp(str(tp), strict=True)


def test_timestab(tmp_path, capsys):
    from cuda_satabsearch_tpu.eval.timestab import main as ts_main
    res1 = tmp_path / "a.txt"
    res1.write_text("# QUERY ID = 1tie\n8i1b 9.0\n1arb 3.0\n1mup 2.0\n")
    res2 = tmp_path / "b.txt"
    res2.write_text("# QUERY ID = 1tie\n8i1b 1.0\n1arb 3.0\n1mup 2.0\n")
    man = tmp_path / "manifest.tsv"
    man.write_text("# label\tresults\tseconds\n"
                   f"cpu baseline\t{res1}\t3600\n"
                   f"gpu\t{res2}\t36\n")
    rc = ts_main([str(man), "--fischer", "fold"])
    out = capsys.readouterr().out
    assert rc == 0
    assert r"\begin{tabular}" in out
    # rows sorted by time descending: baseline first, speedup 1 then 100
    lines = [l for l in out.splitlines() if " & " in l and "AUC" not in l]
    assert lines[0].startswith("cpu baseline")
    assert "1.00" in lines[0].split("&")[-1]
    assert "100.00" in lines[1].split("&")[-1]
    assert "1 h 0 m 0 s" in lines[0]


# ---------------------------------------------------------------------------
# competitor-output adapters (scripts/*out2col* twins)
# ---------------------------------------------------------------------------

def _collect(items):
    from cuda_satabsearch_tpu.eval.adapters import write_2col
    import io
    buf = io.StringIO()
    write_2col(items, buf)
    return buf.getvalue()


def test_adapter_dalilite():
    import io
    from cuda_satabsearch_tpu.eval.adapters import iter_dalilite
    # two DCCP records for the same target -> max Z kept; ids converted
    # to Fischer form (1atnA -> 1atn_a; 1cew listed chainless stays 1cew)
    dccp = io.StringIO(
        " DCCP   1   940.2  2.9  211   21.5   211  0001  1timA 1atnA\n"
        " DCCP   1   900.0  2.9  211   30.0   211  0002  1timA 1atnA\n"
        " DCCP   1   100.0  2.9   50    5.0    50  0003  1timA 1cewA\n")
    out = _collect(iter_dalilite(dccp))
    lines = out.splitlines()
    assert lines[0] == "# QUERY ID = 1tim_a"
    assert ("1atn_a", "30.0") == tuple(lines[1].split())
    assert ("1cew", "5.0") == tuple(lines[2].split())


def test_adapter_vast():
    import io
    from cuda_satabsearch_tpu.eval.adapters import iter_vast
    gibbs = io.StringIO(
        "d1abca_ Nclique= 3\n"
        "Nres a b c d e Pcli x\n"
        "100 1 2 3 4 5 0.9 y\n"
        "d1abca_ Nclique= 1\n"
        "Nres a b c d e Pcli x\n"
        "100 1 2 3 4 5 0.4 y\n")
    out = _collect(iter_vast(gibbs))
    assert out == "d1abca_    0.9\n"


def test_adapter_ssm_xml():
    import io
    from cuda_satabsearch_tpu.eval.adapters import iter_ssm_xml
    xml = io.StringIO(
        "<SSMResults><Match><Q-score>0.61</Q-score>"
        "<Target><name>d1ubia_</name></Target></Match>"
        "<Match><Q-score>0.32</Q-score>"
        "<Target><name>d2fazA1</name></Target></Match></SSMResults>")
    out = _collect(iter_ssm_xml(xml))
    assert out == "d1ubia_    0.61\nd2fazA1    0.32\n"


def test_adapter_tableausearch():
    import io
    from cuda_satabsearch_tpu.eval.adapters import iter_tableausearch
    scores = io.StringIO(
        "/db/d1u3ya_.ent.angles   Score-of-comparison:    -149.2\n"
        "/db/d1geea_.ent.angles   Score-of-comparison:    -593.7\n")
    out = _collect(iter_tableausearch(scores))
    assert out == "d1u3ya_    -149.2\nd1geea_    -593.7\n"


def test_adapter_sheba():
    import io
    from cuda_satabsearch_tpu.eval.adapters import iter_sheba
    txt = io.StringIO(
        "junk\n"
        " pdb1   na       pdb2   nb   id    m   %ma    %mb \n"
        " 1timA  247  d1abca_  100  10  55  20  30\n"
        " 1timA  247  d2defb_  200  11  66  21  31\n"
        " 1timA  247  footer   0  0  0  0  0\n"
        "\n"
        "after\n")
    out = _collect(iter_sheba(txt))
    lines = out.splitlines()
    assert lines[0] == "# QUERYID = 1timA"
    assert lines[1:] == ["d1abca_    55", "d2defb_    66"]
    # a footer-only table yields no result rows (the reference's
    # unconditional `head -n -1`, shebaout2col.sh)
    one = io.StringIO(
        " pdb1   na       pdb2   nb   id    m   %ma    %mb \n"
        " 1timA  247  footer   0  0  0  0  0\n\n")
    assert _collect(iter_sheba(one)).splitlines()[1:] == []


def test_adapter_yakusa():
    import io
    from cuda_satabsearch_tpu.eval.adapters import iter_yakusa
    txt = io.StringIO(
        "Query: d1ubia_\n"
        "Description query : a b c d1ubia_\n"
        "Protein rank: 1 score: 118.48 Z-score: 24.29 name: d1u6ra1 : x\n"
        "Protein rank: 2 score: 90.0 Z-score: inf name: d2abca_ : x\n")
    out = _collect(iter_yakusa(txt, queryid=True))
    lines = out.splitlines()
    assert "# Query: d1ubia_" in lines
    assert "# QUERY ID = d1ubia_" in lines
    assert "d1u6ra1    24.29" in lines
    assert "d2abca_    99999" in lines


def test_adapter_topscompare_lock2():
    import io
    from cuda_satabsearch_tpu.eval.adapters import (iter_lock2,
                                                    iter_topscompare)
    out = _collect(iter_topscompare(io.StringIO(
        "12.5 d1abca_extra\n3.5 probe\n4.0 d2defb_\n")))
    assert out == "d1abca_    12.5\nd2defb_    4.0\n"
    out = _collect(iter_lock2(io.StringIO(
        "** Query = /x/d1ubia_.pdb\n"
        "** Target = /x/d1abca_.pdb\n"
        "final score: 41.5\n"
        "** Target = /x/d2defb_.pdb\n"
        "final score: 12.0\n"), queryid=True))
    lines = out.splitlines()
    assert lines[0] == "# QUERY ID = d1ubia_"
    assert lines[1:] == ["d1abca_    41.5", "d2defb_    12.0"]


def test_split_multiquery(tmp_path):
    import io
    from cuda_satabsearch_tpu.eval.adapters import split_multiquery
    # two-pass output: same query id appears twice (small then large db)
    stream = io.StringIO(
        "# QUERY ID = d1ubia_\nd1abca_ 10\n"
        "# QUERY ID = d2phlb1\nd1abca_ 5\n"
        "# QUERY ID = d1ubia_\nd9bigx_ 20\n")
    paths = split_multiquery(stream, str(tmp_path))
    assert sorted(p.split("/")[-1] for p in paths) == [
        "d1ubia_.out", "d2phlb1.out"]
    body = (tmp_path / "d1ubia_.out").read_text()
    assert "d1abca_    10" in body and "d9bigx_    20" in body


def test_extrunner_per_file(tmp_path):
    """run_per_file drives one command per input (qptabmatch_allall
    semantics: .out/.err per query in a created results dir)."""
    from cuda_satabsearch_tpu.eval.extrunner import (collect_2col,
                                                     run_per_file)
    qdir = tmp_path / "queries"
    qdir.mkdir()
    (qdir / "d1abca_.tableaudistmatrix").write_text("A\n")
    (qdir / "d2defb_.tableaudistmatrix").write_text("B\n")
    (qdir / "ignored.txt").write_text("x\n")
    res = run_per_file("echo {name} 12.5; echo hit2 3.5", str(qdir),
                       str(tmp_path / "results"), db_file="dbf")
    assert [r.name for r in res] == ["d1abca_", "d2defb_"]
    assert all(r.returncode == 0 for r in res)
    body = (tmp_path / "results" / "d1abca_.out").read_text()
    assert body == "d1abca_ 12.5\nhit2 3.5\n"
    # tableausearch-format output normalizes through the adapter layer
    cols = collect_2col(res, "tableausearch", str(tmp_path / "cols"))
    assert (tmp_path / "cols" / "d2defb_.2col").read_text() == (
        "d2defb_    12.5\nhit2    3.5\n")
    assert len(cols) == 2


def test_extrunner_stdin_and_pairs(tmp_path):
    """stdin mode feeds the query file (tsrchd protocol); pairs mode
    runs the n*n comparisons of qptabmatch_allpairs."""
    from cuda_satabsearch_tpu.eval.extrunner import (run_all_pairs,
                                                     run_per_file)
    qdir = tmp_path / "q"
    qdir.mkdir()
    (qdir / "a.td").write_text("alpha\n")
    (qdir / "b.td").write_text("beta\n")
    res = run_per_file("cat", str(qdir), str(tmp_path / "r1"),
                       suffix=".td", stdin=True)
    assert (tmp_path / "r1" / "a.out").read_text() == "alpha\n"
    pairs = run_all_pairs("echo {name}", str(qdir), str(tmp_path / "r2"),
                          suffix=".td")
    assert sorted(r.name for r in pairs) == [
        "a__a", "a__b", "b__a", "b__b"]
    assert (tmp_path / "r2" / "a__b.out").read_text() == "a__b\n"


def test_extrunner_cli(tmp_path):
    from cuda_satabsearch_tpu.eval.extrunner import main as ext_main
    qdir = tmp_path / "q"
    qdir.mkdir()
    (qdir / "x.td").write_text("data\n")
    rc = ext_main(["--program", "echo hit 1.0", "--query-dir", str(qdir),
                   "--results-dir", str(tmp_path / "out"),
                   "--suffix", ".td"])
    assert rc == 0
    assert (tmp_path / "out" / "x.out").read_text() == "hit 1.0\n"
    rc = ext_main(["--program", "false", "--query-dir", str(qdir),
                   "--results-dir", str(tmp_path / "out2"),
                   "--suffix", ".td"])
    assert rc == 1


def test_scop_cli_make_gold(tmp_path):
    """The scop module CLI produces gold files / dominfo / query lists
    from dir.cla (the tsevalfn/scopdominfo/genquerylist driver
    surface)."""
    from cuda_satabsearch_tpu.eval.scop import main as scop_main
    cla = tmp_path / "dir.cla.scop.txt"
    cla.write_text(
        "# comment\n"
        "d1aaaa_ 1aaa A: b.1.1.1 1001 cl=46456\n"
        "d1bbba_ 1bbb A: b.1.1.2 1002 cl=46456\n"
        "d1ccca_ 1ccc A: b.1.2.1 1003 cl=46456\n"
        "d1ddda_ 1ddd A: c.2.1.1 1004 cl=46456\n")
    gold = tmp_path / "fold.gold"
    rc = scop_main(["--cla", str(cla), "--make-gold", "fold",
                    "-o", str(gold)])
    assert rc == 0
    lines = gold.read_text().splitlines()
    assert "d1aaaa_ d1aaaa_ d1bbba_ d1ccca_" in lines
    assert "d1ddda_ d1ddda_" in lines
    # superfamily level separates b.1.1 from b.1.2
    rc = scop_main(["--cla", str(cla), "--make-gold", "superfamily",
                    "-o", str(gold)])
    assert "d1aaaa_ d1aaaa_ d1bbba_" in gold.read_text().splitlines()
    # restrict to a DB: build a tiny ASCII header-only db
    db = tmp_path / "db.ascii"
    db.write_text("d1aaaa_ 8\nd1ccca_ 12\n")
    rc = scop_main(["--cla", str(cla), "--make-gold", "fold",
                    "--restrict-db", str(db), "-o", str(gold)])
    assert "d1aaaa_ d1aaaa_ d1ccca_" in gold.read_text().splitlines()
    # the produced gold file round-trips through the eval loader
    from cuda_satabsearch_tpu.eval.__main__ import load_gold_standard
    g = load_gold_standard(str(gold))
    assert g["d1aaaa_"] == {"d1aaaa_", "d1ccca_"}


def test_scop_cli_dominfo_and_sample(tmp_path, capsys):
    from cuda_satabsearch_tpu.eval.scop import main as scop_main
    cla = tmp_path / "cla.txt"
    cla.write_text("".join(
        f"d1a{i:02d}a_ 1a{i:02d} A: {c}.1.1.1 {1000+i} cl=1\n"
        for i, c in enumerate("aaabbbbbcc")))
    scop_main(["--cla", str(cla), "--dominfo", "d1a00a_", "d9zzza_"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "d1a00a_ a.1.1.1 a.1 a.1.1"
    assert out[1].startswith("# d9zzza_")
    scop_main(["--cla", str(cla), "--sample-queries", "5", "--seed", "2"])
    picks = capsys.readouterr().out.split()
    assert len(picks) == 5


def test_db_names_keeps_float_looking_ids(tmp_path):
    """_db_names must keep entry names that PARSE as floats but are
    real identifiers ('1e50', '2e28', 'nan'-like) and raw PDB codes,
    while never mistaking distance rows for headers."""
    from cuda_satabsearch_tpu.eval.scop import _db_names

    db = tmp_path / "db.ascii"
    db.write_text(
        "1e50    2\n"
        "e  \n"
        "OT e  \n"
        " 0.000 \n"
        " 5.250  0.000 \n"
        "\n"
        "d1ubqa_    2\n"
        "e  \n"
        "RT e  \n"
        " 0.000 \n"
        " 7.125  0.000 \n"
        "\n"
        "2e28    2\n"
        "xa \n"
        "PD xa \n"
        " 1.000 \n"
        " 9.000  1.000 \n")
    assert _db_names(str(db)) == ["1e50", "d1ubqa_", "2e28"]


def test_slrtabs_to_star(tmp_path):
    from cuda_satabsearch_tpu.eval.tables import slrtabs_to_star

    (tmp_path / "a.slrtab").write_text("5.0 1\n3.0 0\n2.0 1\n1.0 0\n")
    (tmp_path / "b.slrtab").write_text("9.0 1\n8.0 0\n")
    pos = tmp_path / "positives.dat"
    neg = tmp_path / "negatives.dat"
    slrtabs_to_star([("Method A", str(tmp_path / "a.slrtab")),
                     ("Method B", str(tmp_path / "b.slrtab"))],
                    str(pos), str(neg))
    plines = pos.read_text().splitlines()
    assert plines[0] == "Method A\tMethod B"
    assert plines[1] == "5.0\t9.0"
    # uneven method lengths pad with empty cells instead of crashing
    # (the reference's own FIXME at slrtabs2star.py:122)
    assert plines[2] == "2.0\t"
    nlines = neg.read_text().splitlines()
    assert nlines[1] == "3.0\t8.0"
    assert nlines[2] == "1.0\t"


def test_star_auc_table():
    import io as _io

    from cuda_satabsearch_tpu.eval.tables import star_auc_table

    # 3-method StAR results.txt: delta-AUC upper / p-value lower
    results = ('\t"A"\t"B"\t"C"\n'
               '"A"\t0\t0.05\t0.01\n'
               '"B"\t0.001\t0\t0.02\n'
               '"C"\t0.9\t0.4\t0\n')
    ci = ("pair\tdelta\tci\n"
          '"A"/"B"\t-0.05\t( -0.06 , -0.04 )\n'
          '"A"/"C"\t0.01\t( -0.005 , 0.025 )\n')
    rows = star_auc_table(_io.StringIO(results), _io.StringIO(ci), "A")
    # B differs significantly (p=0.001 < 0.05), C does not (p=0.9)
    assert rows[0].startswith("B\t0.0500\t0.001\t-0.0500")
    assert rows[1].startswith("A, C\t0.000")


def test_timer_table(tmp_path):
    import io as _io

    from cuda_satabsearch_tpu.eval.tables import timer_table

    db = tmp_path / "db.ascii"
    db.write_text("d1aaaa_ 5\n0.0\nd2bbbb_ 7\n0.0\n")
    (tmp_path / "d1qqqq_.input").write_text("db.ascii\nT T F\n"
                                            "d1qqqq_ 9\n")
    stream = ("# QUERY ID = D1QQQQ_\n"
              f"# DBFILE = {db}\n"
              "d1aaaa_ 42 1.25\n"
              "d2bbbb_ 17 0.75\n")
    out = _io.StringIO()
    timer_table(_io.StringIO(stream), str(tmp_path), out)
    lines = [ln for ln in out.getvalue().splitlines()
             if not ln.startswith("#")]
    assert lines[0] == "queryid dbid querysses dbsses score cputime"
    assert lines[1] == "d1qqqq_ d1aaaa_ 9 5 42 1.25"
    assert lines[2] == "d1qqqq_ d2bbbb_ 9 7 17 0.75"


def test_sum_elapsed():
    from cuda_satabsearch_tpu.eval.tables import sum_elapsed

    texts = ["blah 123user 4.5system 2:05.50elapsed 99%CPU\n",
             "first 0:30.00elapsed\nthen 1:02:03elapsed more\n"]
    # 125.5 s + 3723 s = 3848.5 -> 3849 s = 1 h 4 m 9 s
    assert sum_elapsed(texts) == "1 h 4 m 9 s"
    assert sum_elapsed(texts, "ms") == "64 m 9 s"
    assert sum_elapsed(texts, "hm") == "1 h 4 m"


def test_star_auc_latex_and_merge_and_rank(tmp_path):
    import io as _io

    from cuda_satabsearch_tpu.eval.tables import (merge_output,
                                                  result_rank,
                                                  star_auc_latex)

    rows = ["B\t0.0500\t0.001\t-0.0500",
            "A, C\t0.000\t0.05\t0.000"]
    tex = star_auc_latex(rows)
    assert tex[0].startswith(r"{\begin{tabular}{lrr}")
    # sorted ascending by signed delta: B (-0.05) before A, C (0)
    assert tex.index(next(t for t in tex if t.startswith("B "))) < \
        tex.index(next(t for t in tex if t.startswith("A, C")))
    assert tex[-1] == r"\end{tabular}}"
    tex_np = star_auc_latex(rows, include_p=False)
    assert "p-value" not in "\n".join(tex_np)

    d1 = tmp_path / "m1"
    d2 = tmp_path / "m2"
    d1.mkdir(); d2.mkdir()
    (d1 / "d1q__.out").write_text("# hdr\nd1a__ 5\nd1b__ 3\nd1c__ 1\n")
    (d2 / "d1q__.out").write_text("d1b__ 30\nd1a__ 50\nbad ERROR\n")
    out = _io.StringIO()
    merge_output(str(d1), str(d2), out)
    assert out.getvalue().splitlines() == ["d1q__ d1a__ 5 50",
                                           "d1q__ d1b__ 3 30"]

    res = _io.StringIO("# c\nd1a__ 5 x\nd1b__ 9 x\nd1c__ 1 x\n")
    assert result_rank(res, "d1b__") == (3, 3)  # ascending: best=last


def test_iter_multiquery_skips_lsoln_pair_lines():
    """LSOLN '%3d %3d' pair lines must NOT parse as result rows, while
    all-digit result ids (Nh3D 7-digit CATH ids) must survive."""
    import io as _io

    from cuda_satabsearch_tpu.eval.results import iter_multiquery

    stream = ("# QUERY ID = D1UBIA_\n"
              "d1ndda_  54 6.75 13.4 1.9e-08\n"
              "  1   3\n"
              " 12  45\n"
              "111 102\n"
              "1101040 50\n"
              "d2xyz__  7 0.5 -1.2 0.9\n")
    [(qid, results)] = list(iter_multiquery(_io.StringIO(stream)))
    assert qid == "D1UBIA_"
    assert [(s, n) for s, n in results] == [
        (54.0, "d1ndda_"), (50.0, "1101040"), (7.0, "d2xyz__")]


def test_roc_n_tie_fair_order_invariant():
    """ROC50 must not depend on the input order of tied entries."""
    import numpy as np

    from cuda_satabsearch_tpu.eval.roc import roc_n

    scores = [9, 5, 5, 5, 5, 2, 2, 1]
    labels = [1, 1, 0, 1, 0, 0, 1, 0]
    base = roc_n(scores, labels, n=3)
    rng = np.random.default_rng(0)
    for _ in range(10):
        p = rng.permutation(len(scores))
        assert roc_n([scores[i] for i in p],
                     [labels[i] for i in p], n=3) == base
    # hand value: blocks 9(1p), 5(2p,2q), 2(1p,1q), 1(0p,1q); n=3
    # fp1,fp2 in the 5-block: area += 2*1 + 2*(4)/(2*2) = 4; tp->3
    # fp3 in the 2-block: area += 1*3 + 1*(1)/(2*1) = 3.5; total 7.5
    assert abs(base - 7.5 / (3 * 4)) < 1e-12
