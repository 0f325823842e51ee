"""ctypes bindings for the native C++ data layer (native/satab_io.cpp).

Provides a fast parse+pack path (native twin of the reference's
parsetableaux.c, SURVEY N7) and batch score statistics (gumbelstats.c,
N8).  ``SATAB_NATIVE=0`` disables it; without a library the pure-Python
path is used.

The library is built from native/satab_io.cpp alone, at first use
(``make -C native``, under a file lock, into a temporary name that
``os.replace`` then moves into place, so concurrent processes leave one
valid library).  A build attempt and a failed build each print one line
on stderr.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..core.codes import TYPE_PAD
from ..core.constants import MAXDIM
from .pack import (DEFAULT_BUCKETS, DMAT_PAD, PackedBucket, PackedDB,
                   quantize_dmat)

_LIB = None
_TRIED = False


def _lib_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "native", "libsatab_io.so")


def _stale(path: str, src: str) -> bool:
    return (not os.path.exists(path)
            or os.path.getmtime(src) > os.path.getmtime(path))


def build_library(path: str) -> None:
    """Build ``path`` from its source unless it is up to date.  Holds a
    file lock while building and publishes with os.replace, so any
    number of concurrent callers end with one valid library."""
    import fcntl
    import subprocess
    import sys

    ndir = os.path.dirname(path)
    src = os.path.join(ndir, "satab_io.cpp")
    if not os.path.exists(src) or not _stale(path, src):
        return
    with open(os.path.join(ndir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale(path, src):  # another process built it meanwhile
            return
        tmp = f".build.{os.getpid()}.so"
        print(f"# building {path} (make -C {ndir})", file=sys.stderr)
        try:
            r = subprocess.run(["make", "-C", ndir, f"LIB={tmp}"],
                               capture_output=True, text=True, timeout=300)
            ok = r.returncode == 0 and os.path.exists(os.path.join(ndir, tmp))
            why = (r.stderr.strip().splitlines() or ["no output"])[-1]
        except (OSError, subprocess.SubprocessError) as e:
            ok, why = False, f"{type(e).__name__}: {e}"
        if ok:
            os.replace(os.path.join(ndir, tmp), path)
        else:
            print(f"# native build failed ({why}); using the Python "
                  f"parser", file=sys.stderr)
            if os.path.exists(os.path.join(ndir, tmp)):
                os.remove(os.path.join(ndir, tmp))


def load_library():
    """The loaded library or None (disabled / could not be built)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("SATAB_NATIVE", "1") == "0":
        return None
    path = _lib_path()
    build_library(path)
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.satab_pack_file.restype = ctypes.c_void_p
    lib.satab_pack_file.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_int]
    lib.satab_error.restype = ctypes.c_char_p
    lib.satab_error.argtypes = [ctypes.c_void_p]
    for name, res in [("satab_nentries", ctypes.c_int64),
                      ("satab_nskipped", ctypes.c_int64)]:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = [ctypes.c_void_p]
    lib.satab_bucket_count.restype = ctypes.c_int64
    lib.satab_bucket_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.satab_bucket_cap.restype = ctypes.c_int
    lib.satab_bucket_cap.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for name in ("satab_bucket_tabhi", "satab_bucket_tablo",
                 "satab_bucket_types"):
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ctypes.c_int8)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.satab_bucket_dmat.restype = ctypes.POINTER(ctypes.c_float)
    lib.satab_bucket_dmat.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for name in ("satab_bucket_orders", "satab_bucket_index"):
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ctypes.c_int32)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.satab_bucket_names.restype = ctypes.POINTER(ctypes.c_char)
    lib.satab_bucket_names.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.satab_label_size.restype = ctypes.c_int
    lib.satab_free.argtypes = [ctypes.c_void_p]
    lib.satab_score_stats.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
    lib.satab_format_entry.restype = ctypes.c_void_p  # malloc'd text
    lib.satab_format_entry.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_float)]
    lib.satab_free_text.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return load_library() is not None


def _as_array(ptr, shape, dtype):
    n = int(np.prod(shape))
    buf = np.ctypeslib.as_array(ptr, shape=(n,))
    return buf.view(dtype).reshape(shape).copy()


def pack_database_file(path: str, buckets: tuple = DEFAULT_BUCKETS,
                       maxdim: int = MAXDIM, pad_to: int = 1) -> PackedDB:
    """Parse + pack an ASCII DB file natively into a PackedDB.

    Semantically identical to parser.read_database + pack.pack_database
    (tests assert equality); ~10x faster on large DBs.
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library not available")
    caps = (ctypes.c_int * len(buckets))(*buckets)
    h = lib.satab_pack_file(path.encode(), maxdim, caps, len(buckets))
    if not h:
        raise FileNotFoundError(path)
    try:
        err = lib.satab_error(h)
        if err:
            raise ValueError(err.decode())
        nentries = lib.satab_nentries(h)
        label = lib.satab_label_size() + 1
        packed = []
        names_all: list = [None] * nentries
        orders_all = np.zeros((nentries,), np.int32)
        for b in range(len(buckets)):
            cnt = lib.satab_bucket_count(h, b)
            if cnt == 0:
                continue
            cap = lib.satab_bucket_cap(h, b)
            tabhi = _as_array(lib.satab_bucket_tabhi(h, b),
                              (cnt, cap, cap), np.int8)
            tablo = _as_array(lib.satab_bucket_tablo(h, b),
                              (cnt, cap, cap), np.int8)
            types = _as_array(lib.satab_bucket_types(h, b),
                              (cnt, cap), np.int8)
            dmat = quantize_dmat(_as_array(lib.satab_bucket_dmat(h, b),
                                           (cnt, cap, cap), np.float32))
            orders = _as_array(lib.satab_bucket_orders(h, b),
                               (cnt,), np.int32)
            index = _as_array(lib.satab_bucket_index(h, b),
                              (cnt,), np.int32)
            raw = ctypes.string_at(lib.satab_bucket_names(h, b),
                                   cnt * label)
            names = [raw[i * label:(i + 1) * label].split(b"\0")[0].decode()
                     for i in range(cnt)]
            if pad_to > 1 and cnt % pad_to:
                n = -(-cnt // pad_to) * pad_to
                extra = n - cnt

                def padn(a, fill):
                    pad_shape = (extra,) + a.shape[1:]
                    return np.concatenate(
                        [a, np.full(pad_shape, fill, a.dtype)])

                tabhi = padn(tabhi, 0)
                tablo = padn(tablo, 0)
                types = padn(types, TYPE_PAD)
                # pad with the QUANTIZED sentinel: the entry rows were
                # bf16-quantized by the native packer already, and
                # pack.pack_database quantizes the whole padded array —
                # a raw 1e9 here would differ bitwise from the Python
                # path (and violate the dgp pack_qc bf16-grid contract)
                dmat = padn(dmat, quantize_dmat(
                    np.float32(DMAT_PAD)).item())
                orders = padn(orders, 1)
                index = padn(index, -1)
                names = names + ["<pad>"] * extra
            for i in range(cnt):
                names_all[index[i]] = names[i]
                orders_all[index[i]] = orders[i]
            packed.append(PackedBucket(dim=cap, tabhi=tabhi, tablo=tablo,
                                       types=types, dmat=dmat,
                                       orders=orders, names=names,
                                       index=index))
        return PackedDB(buckets=packed, nentries=int(nentries),
                        names=names_all, orders=orders_all)
    finally:
        lib.satab_free(h)


def score_stats_native(scores, orders, qn: int, a: float, b: float,
                       compat: bool = False):
    """Batch (norm2, z, p) via the C++ twin of gumbelstats.c."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library not available")
    scores = np.ascontiguousarray(scores, np.int32)
    orders = np.ascontiguousarray(orders, np.int32)
    n = len(scores)
    n2 = np.empty(n, np.float64)
    z = np.empty(n, np.float64)
    p = np.empty(n, np.float64)
    pi32 = ctypes.POINTER(ctypes.c_int32)
    pf64 = ctypes.POINTER(ctypes.c_double)
    lib.satab_score_stats(
        scores.ctypes.data_as(pi32), orders.ctypes.data_as(pi32),
        n, qn, a, b, int(compat),
        n2.ctypes.data_as(pf64), z.ctypes.data_as(pf64),
        p.ctypes.data_as(pf64))
    return n2, z, p


def format_entry_native(entry) -> str:
    """ASCII emission via the C++ twin of io/writer.format_entry
    (convdb2.py:214-226 format) — byte-identical to the Python writer;
    the fast path for bulk DB exports."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library not available")
    n = entry.order
    tabhi = np.ascontiguousarray(entry.tabhi[:n, :n], np.int8)
    tablo = np.ascontiguousarray(entry.tablo[:n, :n], np.int8)
    types = np.ascontiguousarray(entry.types[:n], np.int8)
    dmat = np.ascontiguousarray(entry.dmat[:n, :n], np.float32)
    pi8 = ctypes.POINTER(ctypes.c_int8)
    ptr = lib.satab_format_entry(
        entry.name.encode(), n, tabhi.ctypes.data_as(pi8),
        tablo.ctypes.data_as(pi8), types.ctypes.data_as(pi8),
        dmat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if not ptr:
        raise ValueError(f"{entry.name}: unencodable entry")
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        lib.satab_free_text(ptr)
