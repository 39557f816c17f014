"""Kurucz/Schwenke/Plez molecular line-list drivers (PS H2O, TiO, VO):
this package's own host copy of bart_tpu/linelist/kurucz_mol.py (the
analytic Q(296 K) through the port's torch partition functions, in
float64 on the CPU).

Equivalents of the reference pylineread database drivers for dbtype
``ps`` / ``ts`` / ``vo`` (reference: SURVEY.md section 2.2;
examples/demo/pyline_demo.cfg names the sources:
http://kurucz.harvard.edu/molecules/h2o/h2ofastfix.bin with
h2opartfn.dat, .../tio/tioschwenke.bin with tiopart.dat, and Plez's VO
list).  The reference's own driver sources are absent from the checkout
(empty transit submodule, SURVEY.md section 0), so the layouts below
follow the published Kurucz packed-binary conventions:

* ``ps`` (Partridge & Schwenke H2O, h2ofastfix.bin): little-endian
  8-byte records ``[int32 iwl][int16 ielo][int16 igflog]`` where

    - wavelength  wl_nm = exp(iwl * RATIOLOG), RATIOLOG = ln(1 + 1/2e6)
      (so consecutive representable wavelengths differ by 1 part in
      2e6 — the Kurucz log-wavelength quantization);
    - lower-state energy E'' = |ielo| cm-1;
    - gf = 10^(0.001*(|igflog| - 16384))  (the Kurucz "tablog" 0.001-dex
      quantization centered on 16384);
    - the two sign bits pack the isotopologue:
      iso = 2*(ielo < 0) + (igflog < 0) indexing
      [1H1H16O, 1H1H17O, 1H1H18O, 1H2H16O].

* ``ts`` (Schwenke TiO, tioschwenke.bin): same packing; the file uses a
  16-byte record stride with the 8 data bytes first (``record_size``
  parameter; pass 8 if your copy is densely packed).  The 2-bit isotope
  code indexes [46TiO, 47TiO, 48TiO, 49TiO] — 50TiO lines are folded
  into the dominant 48TiO by this packing.

* ``vo`` (Plez VO): ASCII "lambda[nm]  E_low[eV]  log gf  [...]".

Records are sorted by wavelength, so wavenumber windows are cut with a
binary search on the packed iwl field — the whole file is never loaded.
gf-based intensities convert to the HITRAN S(296) convention via

  S296 = (pi e^2 / m_e c^2) * gf * iso_frac * exp(-c2 E''/296) *
         (1 - exp(-c2 nu/296)) / Q(296)

Partition functions come from the Kurucz ASCII tables (h2opartfn.dat /
tiopart.dat; ``read_kurucz_partition``) or any (T, Q) table.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from bart_tpu_torch import constants as const
from bart_tpu_torch.linelist.hitran import TREF, LineList
from bart_tpu_torch.linelist.tips import partition_function

__all__ = [
    "read_ps_binary", "read_tio_binary", "write_ps_binary", "read_plez_vo",
    "gf_to_s296", "read_kurucz_partition", "PS_ISOTOPES", "TIO_ISOTOPES",
]

# pi e^2/(m_e c^2) in cm (the standard gf -> integrated-cross-section
# prefactor, = pi * classical electron radius)
_GF_PREFACTOR = 8.85282e-13
# Kurucz log-wavelength quantization: wl_nm = exp(iwl * RATIOLOG)
RATIOLOG = float(np.log(1.0 + 1.0 / 2e6))
# Kurucz 0.001-dex log-gf quantization: gf = 10^(0.001*(igflog-16384))
_TABLOG_OFFSET = 16384
_NM_TO_CM = 1e-7

#: (name, mass[amu], terrestrial fraction) per 2-bit isotope code
PS_ISOTOPES = (
    ("1H1H16O", 18.010565, 0.997317),
    ("1H1H17O", 19.014780, 3.719e-4),
    ("1H1H18O", 20.014811, 1.99983e-3),
    ("1H2H16O", 19.016740, 3.107e-4),
)
TIO_ISOTOPES = (
    ("46Ti16O", 61.947544, 0.0825),
    ("47Ti16O", 62.946649, 0.0744),
    ("48Ti16O", 63.942861, 0.7372 + 0.0518),  # 50TiO folded in (see module doc)
    ("49Ti16O", 64.942780, 0.0541),
)


def gf_to_s296(gf, wn0, elower, q296, iso_frac=1.0):
    """HITRAN-convention S(296) [cm-1/(molec cm-2)] from oscillator
    strengths, weighted by terrestrial isotopic fraction (the HITRAN
    intensity convention the opacity engine assumes)."""
    c2 = const.C2
    return (
        _GF_PREFACTOR * gf * iso_frac
        * np.exp(-c2 * elower / TREF)
        * (1.0 - np.exp(-c2 * wn0 / TREF))
        / q296
    )


def _pack_records(wl_nm, elower_cm, gf, iso):
    iwl = np.round(np.log(np.asarray(wl_nm, np.float64))
                   / RATIOLOG).astype(np.int64)
    igf = np.round(np.log10(np.asarray(gf, np.float64)) * 1000.0
                   + _TABLOG_OFFSET).astype(np.int64)
    ielo = np.round(np.asarray(elower_cm, np.float64)).astype(np.int64)
    iso = np.asarray(iso, np.int64)
    if np.any(ielo > 32767) or np.any(igf < 0) or np.any(igf > 32767):
        raise ValueError("values out of range for Kurucz int16 packing")
    ielo = np.where(iso >= 2, -ielo, ielo)
    # -0 has no int16 representation: an E''=0 line can't carry the
    # ielo sign bit; same for the igf bit at gf exactly 10^-16.384
    igf = np.where(iso % 2 == 1, -igf, igf)
    return iwl, ielo, igf


def write_ps_binary(path: str, wl_nm, elower_cm, gf, iso=None,
                    record_size: int = 8) -> None:
    """Write a PS/TiO-layout binary line file (test fixture generator;
    byte-exact inverse of ``read_ps_binary``).  Records must be
    wavelength-sorted for the window binary search to work."""
    n = len(np.atleast_1d(wl_nm))
    if iso is None:
        iso = np.zeros(n, int)
    iwl, ielo, igf = _pack_records(wl_nm, elower_cm, gf, iso)
    pad = b"\x00" * (record_size - 8)
    with open(path, "wb") as f:
        for a, b, c in zip(iwl, ielo, igf):
            f.write(struct.pack("<ihh", int(a), int(b), int(c)) + pad)


def _binsearch_wl(f, target_iwl: int, nrec: int, record_size: int) -> int:
    """First record with iwl >= target (records are wavelength-sorted)."""
    lo, hi = 0, nrec
    while lo < hi:
        mid = (lo + hi) // 2
        f.seek(mid * record_size)
        (iwl,) = struct.unpack("<i", f.read(4))
        if iwl < target_iwl:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _read_kurucz_packed(
    path: str,
    species: str,
    isotopes,
    wn_min: float,
    wn_max: float,
    pf_table,
    record_size: int,
    gamma_h2: float,
    n_exp: float,
) -> LineList:
    nbytes = os.path.getsize(path)
    nrec = nbytes // record_size
    with open(path, "rb") as f:
        # wavenumber window -> wavelength window -> packed-iwl window
        wl_lo_nm = 1.0e7 / wn_max if np.isfinite(wn_max) else None
        wl_hi_nm = 1.0e7 / max(wn_min, 1e-30)
        i0 = (0 if wl_lo_nm is None else
              _binsearch_wl(f, int(np.ceil(np.log(wl_lo_nm) / RATIOLOG)),
                            nrec, record_size))
        i1 = _binsearch_wl(f, int(np.floor(np.log(wl_hi_nm) / RATIOLOG)) + 1,
                           nrec, record_size)
        f.seek(i0 * record_size)
        raw = np.frombuffer(
            f.read((i1 - i0) * record_size),
            dtype=np.dtype([("iwl", "<i4"), ("ielo", "<i2"), ("igf", "<i2"),
                            ("pad", f"V{record_size - 8}")]
                           if record_size > 8 else
                           [("iwl", "<i4"), ("ielo", "<i2"), ("igf", "<i2")]),
        )

    wl_nm = np.exp(raw["iwl"].astype(np.float64) * RATIOLOG)
    wn0 = 1.0e7 / wl_nm
    ielo = raw["ielo"].astype(np.int64)
    igf = raw["igf"].astype(np.int64)
    elower = np.abs(ielo).astype(np.float64)
    gf = 10.0 ** (0.001 * (np.abs(igf) - _TABLOG_OFFSET))
    iso = (2 * (ielo < 0) + (igf < 0)).astype(np.int8)

    keep = (wn0 > wn_min) & (wn0 < wn_max)
    wn0, elower, gf, iso = wn0[keep], elower[keep], gf[keep], iso[keep]

    if pf_table is not None:
        q296 = float(np.interp(TREF, pf_table[0], pf_table[1]))
    else:
        q296 = float(partition_function(species)(
            torch.tensor(TREF, dtype=torch.float64)))
    iso_frac = np.asarray([fr for _, _, fr in isotopes])[iso]
    s296 = gf_to_s296(gf, wn0, elower, q296, iso_frac)

    order = np.argsort(wn0, kind="stable")
    n = len(wn0)
    return LineList(
        species=species,
        wn0=wn0[order], s296=s296[order], elower=elower[order],
        gamma_air=np.full(n, gamma_h2), gamma_self=np.full(n, 1.4 * gamma_h2),
        n_air=np.full(n, n_exp), iso=iso[order],
    )


def read_ps_binary(
    path: str,
    species: str = "H2O",
    wn_min: float = 0.0,
    wn_max: float = np.inf,
    pf_table=None,
    record_size: int = 8,
) -> LineList:
    """Read a Partridge & Schwenke h2ofastfix.bin-layout file (dbtype
    ``ps``; layout in the module docstring)."""
    isotopes = PS_ISOTOPES if species == "H2O" else TIO_ISOTOPES
    return _read_kurucz_packed(path, species, isotopes, wn_min, wn_max,
                               pf_table, record_size,
                               gamma_h2=0.05, n_exp=0.5)


def read_tio_binary(
    path: str,
    species: str = "TiO",
    wn_min: float = 0.0,
    wn_max: float = np.inf,
    pf_table=None,
    record_size: int = 16,
) -> LineList:
    """Read a Schwenke tioschwenke.bin-layout file (dbtype ``ts``):
    the PS packing on a 16-byte record stride (module docstring)."""
    return _read_kurucz_packed(path, species, TIO_ISOTOPES, wn_min, wn_max,
                               pf_table, record_size,
                               gamma_h2=0.05, n_exp=0.7)


def read_kurucz_partition(path: str):
    """Read a Kurucz ASCII partition-function table (h2opartfn.dat /
    tiopart.dat): comment/header lines, then rows ``T  Q_iso1 ...
    Q_isoN``.  Returns (T [nT], Q [nT] terrestrial-abundance-weighted
    mean over isotopologue columns) usable as ``pf_table``."""
    temps, qcols = [], []
    with open(path) as f:
        for line in f:
            s = line.split()
            if not s:
                continue
            try:
                row = [float(v) for v in s]
            except ValueError:
                continue  # header / column-label line
            if len(row) < 2:
                continue
            temps.append(row[0])
            qcols.append(row[1:])
    if not temps:
        raise ValueError(f"no numeric (T, Q) rows found in {path}")
    ncol = min(len(r) for r in qcols)
    q = np.asarray([r[:ncol] for r in qcols]).mean(axis=1)
    return np.asarray(temps), q


_EV_TO_CM = 8065.54429


def read_plez_vo(
    path: str,
    species: str = "VO",
    wn_min: float = 0.0,
    wn_max: float = np.inf,
    pf_table=None,
) -> LineList:
    """Read a Plez-format ASCII list: 'lambda[nm] E_low[eV] log(gf)'."""
    wl, elo_ev, loggf = [], [], []
    with open(path) as f:
        for line in f:
            s = line.split()
            if len(s) < 3 or line.lstrip().startswith(("#", "'")):
                continue
            try:
                wl.append(float(s[0]))
                elo_ev.append(float(s[1]))
                loggf.append(float(s[2]))
            except ValueError:
                continue
    wn0 = 1.0e7 / np.asarray(wl)
    elower = np.abs(np.asarray(elo_ev)) * _EV_TO_CM
    gf = 10.0 ** np.asarray(loggf)

    keep = (wn0 > wn_min) & (wn0 < wn_max)
    wn0, elower, gf = wn0[keep], elower[keep], gf[keep]

    if pf_table is not None:
        q296 = float(np.interp(TREF, pf_table[0], pf_table[1]))
    else:
        q296 = float(partition_function(species)(
            torch.tensor(TREF, dtype=torch.float64)))
    s296 = gf_to_s296(gf, wn0, elower, q296)

    order = np.argsort(wn0, kind="stable")
    n = len(wn0)
    return LineList(
        species=species,
        wn0=wn0[order], s296=s296[order], elower=elower[order],
        gamma_air=np.full(n, 0.05), gamma_self=np.full(n, 0.07),
        n_air=np.full(n, 0.5), iso=np.ones(n, np.int8),
    )
