"""ctypes bindings for the native HITRAN ``.par`` scanner
(hitran_scan.cpp; this package's own copy of
bart_tpu/native/hitran_native.py).

The shared library is built with g++ at first use into
``bart_tpu_torch/build/`` (utils/build.py), keyed on a hash of the
source, written under a temporary name and moved into place, so that
processes building it at once do not read a half-written file.  This is
host code: no device.  linelist.hitran.read_par tries it first and falls
back to the numpy parser.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from bart_tpu_torch.utils import build

__all__ = ["read_par", "library_path"]

_SRC = Path(__file__).resolve().parent / "hitran_scan.cpp"
_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None


def library_path() -> Path:
    """bart_tpu_torch/build/libhitran_scan_<hash>.so, keyed on the
    source and flags."""
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return build.BUILD_DIR / f"libhitran_scan_{key.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL:
    """Build the scanner once per source hash (g++) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.is_file():
        build.build_dir()
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.hitran_count.argtypes = [ctypes.c_char_p]
    lib.hitran_count.restype = ctypes.c_long
    lib.hitran_parse.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int8),
    ] + [np.ctypeslib.ndpointer(np.float64)] * 6
    lib.hitran_parse.restype = ctypes.c_long
    _lib = lib
    return lib


def read_par(path: str, species: str | None = None):
    """Native-parse a .par file -> {species: LineList} (the contract of
    linelist.hitran.read_par).  Raises ValueError on a record with an
    unparseable numeric field, so the caller can hand the file to the
    tolerant numpy parser, which reports each bad record."""
    from bart_tpu_torch.linelist.hitran import LineList
    from bart_tpu_torch.linelist.molecules import HITRAN_IDS

    lib = _load()
    n = lib.hitran_count(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    mol_id = np.empty(n, np.int32)
    iso = np.empty(n, np.int8)
    wn = np.empty(n, np.float64)
    s296 = np.empty(n, np.float64)
    gair = np.empty(n, np.float64)
    gself = np.empty(n, np.float64)
    elow = np.empty(n, np.float64)
    nair = np.empty(n, np.float64)
    got = lib.hitran_parse(path.encode(), mol_id, iso, wn, s296, gair,
                           gself, elow, nair)
    if got != n:
        raise IOError(f"{path}: parsed {got} of {n} records")
    # the scanner marks unparseable fields NaN
    bad = (~np.isfinite(wn) | ~np.isfinite(s296) | ~np.isfinite(elow)
           | ~np.isfinite(gair) | ~np.isfinite(gself)
           | ~np.isfinite(nair))
    if bad.any():
        raise ValueError(
            f"{path}: {int(bad.sum())} records with unparseable numeric "
            f"fields (first at record {int(np.where(bad)[0][0]) + 1})")

    out = {}
    for mid in np.unique(mol_id):
        name = HITRAN_IDS.get(int(mid), f"M{int(mid)}")
        if species is not None and name != species:
            continue
        m = mol_id == mid
        order = np.argsort(wn[m], kind="stable")
        out[name] = LineList(
            name, wn[m][order], s296[m][order], elow[m][order],
            gair[m][order], gself[m][order], nair[m][order], iso[m][order],
        )
    return out
