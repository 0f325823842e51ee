"""Native C++ data layer vs the pure-Python reference path."""

import os

import numpy as np
import pytest

from cuda_satabsearch_tpu.io import native
from cuda_satabsearch_tpu.io.pack import pack_database
from cuda_satabsearch_tpu.io.parser import read_database
from cuda_satabsearch_tpu.stats.gumbel import score_stats

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")



@pytest.fixture(autouse=True)
def _native_library():
    """Decided at run time, not at import: loading builds the library
    from native/satab_io.cpp on first use."""
    if not native.available():
        pytest.skip("native library could not be built")


def test_concurrent_builds_leave_one_valid_library(tmp_path):
    """Six processes building at once (the test workers' race) end with
    one loadable library and no temporary files."""
    import ctypes
    import shutil
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(FIXTURES), "..", "native")
    for name in ("satab_io.cpp", "Makefile"):
        shutil.copy(os.path.join(src, name), tmp_path / name)
    lib = tmp_path / "libsatab_io.so"
    code = ("import sys; from cuda_satabsearch_tpu.io import native; "
            "native.build_library(sys.argv[1])")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(lib)],
                              cwd=root, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), errs
    assert sum("# building" in e for e in errs) == 1, errs
    ctypes.CDLL(str(lib)).satab_label_size  # loads and resolves
    leftovers = [f.name for f in tmp_path.iterdir()
                 if f.name.startswith(".build.") and f.suffix == ".so"]
    assert leftovers == []


@pytest.mark.parametrize("dbname", ["tableauxdistmatrixdb.test.ascii",
                                    "tableauxdistmatrixdb.test2.ascii",
                                    "tableauxdistmatrixdb.small.ascii"])
def test_native_pack_matches_python(dbname):
    path = os.path.join(FIXTURES, dbname)
    pdb = pack_database(read_database(path))
    ndb = native.pack_database_file(path)
    assert ndb.nentries == pdb.nentries
    assert ndb.names == pdb.names
    np.testing.assert_array_equal(ndb.orders, pdb.orders)
    assert len(ndb.buckets) == len(pdb.buckets)
    for nb, pb in zip(ndb.buckets, pdb.buckets):
        assert nb.dim == pb.dim
        assert nb.names == pb.names
        np.testing.assert_array_equal(nb.tabhi, pb.tabhi)
        np.testing.assert_array_equal(nb.tablo, pb.tablo)
        np.testing.assert_array_equal(nb.types, pb.types)
        np.testing.assert_array_equal(nb.dmat, pb.dmat)
        np.testing.assert_array_equal(nb.orders, pb.orders)
        np.testing.assert_array_equal(nb.index, pb.index)


def test_native_pack_mesh_padding():
    path = os.path.join(FIXTURES, "tableauxdistmatrixdb.small.ascii")
    pdb = pack_database(read_database(path), pad_to=8)
    ndb = native.pack_database_file(path, pad_to=8)
    for nb, pb in zip(ndb.buckets, pdb.buckets):
        assert nb.size == pb.size
        np.testing.assert_array_equal(nb.index, pb.index)
        np.testing.assert_array_equal(nb.orders, pb.orders)
        # pad rows included — the appended DMAT_PAD sentinel must be
        # the bf16-QUANTIZED value (raw 1e9 is off the bf16 grid and
        # would break the Python-path bitwise equality and the dgp
        # pack_qc contract)
        np.testing.assert_array_equal(nb.dmat, pb.dmat)
        np.testing.assert_array_equal(nb.types, pb.types)
        np.testing.assert_array_equal(nb.tabhi, pb.tabhi)
        np.testing.assert_array_equal(nb.tablo, pb.tablo)


def test_native_missing_file():
    with pytest.raises(FileNotFoundError):
        native.pack_database_file("/nonexistent/db.ascii")


def test_native_score_stats_matches_python():
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 60, 500).astype(np.int32)
    orders = rng.integers(2, 100, 500).astype(np.int32)
    from cuda_satabsearch_tpu.core.constants import GUMBEL_A, GUMBEL_B

    for compat in (False, True):
        n2p, zp, pp = score_stats(scores, 8, orders, compat=compat)
        n2n, zn, pn = native.score_stats_native(scores, orders, 8,
                                                GUMBEL_A, GUMBEL_B,
                                                compat=compat)
        np.testing.assert_allclose(n2n, n2p, rtol=1e-12)
        np.testing.assert_allclose(zn, zp, rtol=1e-12)
        # p-values near 0 amplify constant-rounding noise; atol covers it
        np.testing.assert_allclose(pn, pp, rtol=1e-9, atol=1e-15)


def test_native_writer_matches_python_writer():
    """C++ ASCII emission == io/writer.format_entry byte-for-byte on
    the reference fixtures and random entries."""
    import numpy as np

    from conftest import random_entry
    from cuda_satabsearch_tpu.io import native
    from cuda_satabsearch_tpu.io.parser import read_database
    from cuda_satabsearch_tpu.io.writer import format_entry

    import os

    fixtures = os.path.join(os.path.dirname(__file__), "fixtures")
    entries = read_database(
        os.path.join(fixtures, "tableauxdistmatrixdb.small.ascii"))[:40]
    entries += read_database(os.path.join(fixtures, "d1qlpa_.ascii"))
    rng = np.random.default_rng(5)
    entries += [random_entry(rng, int(n), f"syn{n}")
                for n in rng.integers(2, 60, size=8)]
    # a name far beyond the header buffer's old 64-byte limit must
    # emit in full (dynamic sizing), identically on both sides
    entries.append(random_entry(rng, 5, "x" * 90))
    for e in entries:
        assert native.format_entry_native(e) == format_entry(e), e.name


def test_native_error_paths_match_python(tmp_path):
    """Round-5 hardening: inputs where the Python path raises must
    raise (not crash, abort, or silently corrupt) on the native path."""

    # a directory: FileNotFoundError, not a process abort
    with pytest.raises(FileNotFoundError):
        native.pack_database_file(str(tmp_path))

    # garbage distance token: ValueError, not silent 0.0
    bad = tmp_path / "bad.ascii"
    bad.write_text("d1x__ 2\ne \nOS e \n0.000\ngarbage 0.000\n")
    with pytest.raises(ValueError):
        native.pack_database_file(str(bad))
    with pytest.raises(ValueError):
        read_database(str(bad))

    # partially-numeric order: ValueError, not 5
    bad2 = tmp_path / "bad2.ascii"
    bad2.write_text("d1x__ 2x\ne \nOS e \n0.000\n1.0 0.000\n")
    with pytest.raises(ValueError):
        native.pack_database_file(str(bad2))

    # order <= maxdim but beyond the last bucket cap: ValueError like
    # pack_database, not a silent drop leaving a None name hole
    big = tmp_path / "big.ascii"
    lines = ["dbig__ 20"]
    lines += [" ".join(["e " if i == j else "OS" for j in range(i + 1)])
              for i in range(20)]
    lines += [" ".join(["%6.3f" % (0.0 if i == j else 5.0)
                        for j in range(i + 1)]) for i in range(20)]
    big.write_text("\n".join(lines) + "\n")
    with pytest.raises(ValueError):
        native.pack_database_file(str(big), buckets=(8, 16), maxdim=111)

    # no trailing newline on the last token: parses, equal to Python
    ok = tmp_path / "ok.ascii"
    ok.write_text("d1y__ 2\ne \nOS e \n0.000\n1.500 0.000")  # no \n
    ndb = native.pack_database_file(str(ok))
    pdb = pack_database(read_database(str(ok)))
    np.testing.assert_array_equal(ndb.buckets[0].dmat, pdb.buckets[0].dmat)

    # long names (up to the 127-char native label) survive un-truncated
    long = tmp_path / "long.ascii"
    name = "d" + "x" * 60
    long.write_text(f"{name} 2\ne \nOS e \n0.000\n1.500 0.000\n")
    ndb = native.pack_database_file(str(long))
    assert ndb.names == [name]


def test_native_writer_multibyte_name_parity():
    """Header padding counts CHARACTERS like Python's '{:>6s}' (printf
    %6s pads by bytes, which diverged for multibyte UTF-8 names)."""
    from cuda_satabsearch_tpu.io.parser import TableauEntry
    from cuda_satabsearch_tpu.io.writer import format_entry

    t = np.array([0, 1], np.uint8)
    hi = np.array([[0, 2], [2, 1]], np.uint8)
    d = np.array([[0, 1.5], [1.5, 1]], np.float32)
    for name in ("ab", "αβ", "d1ubia_"):
        e = TableauEntry(name=name, order=2, tabhi=hi, tablo=hi.copy(),
                         types=t, dmat=d)
        assert native.format_entry_native(e) == format_entry(e)


def test_native_randomized_roundtrip_parity(tmp_path):
    """Fuzz: random synthetic DBs (orders 2-111, random names, mesh
    padding) written by the Python writer must parse+pack BITWISE
    identically through the native and pure-Python paths."""
    from conftest import random_entry
    from cuda_satabsearch_tpu.io.writer import format_database

    rng = np.random.default_rng(99)
    for trial in range(3):
        orders = rng.integers(2, 112, size=25)
        entries = []
        for i, o in enumerate(orders):
            name = "d" + "".join(
                rng.choice(list("abcdefgh123_"), size=int(
                    rng.integers(3, 12))))
            entries.append(random_entry(rng, int(o), f"{name}{i}"))
        path = tmp_path / f"fuzz{trial}.ascii"
        path.write_text(format_database(entries))
        for pad_to in (1, 8):
            ndb = native.pack_database_file(str(path), pad_to=pad_to)
            pdb = pack_database(read_database(str(path)),
                                pad_to=pad_to)
            assert ndb.names == pdb.names
            np.testing.assert_array_equal(ndb.orders, pdb.orders)
            for nb, pb in zip(ndb.buckets, pdb.buckets):
                np.testing.assert_array_equal(nb.tabhi, pb.tabhi)
                np.testing.assert_array_equal(nb.tablo, pb.tablo)
                np.testing.assert_array_equal(nb.types, pb.types)
                np.testing.assert_array_equal(nb.dmat, pb.dmat)
                np.testing.assert_array_equal(nb.index, pb.index)
