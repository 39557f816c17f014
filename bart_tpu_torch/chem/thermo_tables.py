"""Thermodynamic-table ingestion: JANAF ASCII, NASA-7, NASA-9 formats.

This package's own host copy of bart_tpu/chem/thermo_tables.py.

The reference's TEA derives chemical potentials from JANAF tables
(reference: SURVEY.md section 2.4 — readJANAF.py; Blecic et al. 2016):

    g_i(T)/RT = -gef_i(T)/R + dHf_i(298.15)/(R T)

with gef = -(G(T)-H(298))/T the "Gibbs energy function" column.  This
module reads that format plus the two standard polynomial conventions:

* NASA-7 (CHEMKIN / GRI-Mech / Burcat): two T ranges x 7 coefficients,
    Cp/R = a1 + a2 T + a3 T^2 + a4 T^3 + a5 T^4
    H/RT = a1 + a2 T/2 + a3 T^2/3 + a4 T^3/4 + a5 T^4/5 + a6/T
    S/R  = a1 lnT + a2 T + a3 T^2/2 + a4 T^3/3 + a5 T^4/4 + a7
* NASA-9 (CEA thermo.inp): per-interval 7 coefficients with T^-2/T^-1
  terms plus integration constants b1, b2.

All three produce (T_grid, g/RT) tables in the FORMATION convention
(zero = standard-state elements at 298.15 K).  That convention differs
from the package's analytic free-atom zero (chem/thermo.py) by a per-
ELEMENT shift, which the element-potential solver (chem/tea.py) absorbs
exactly into the Lagrange multipliers — so a table set covering ALL
species of a solve is interchangeable with the analytic path, but the
two conventions must never be mixed within one solve (tea.py warns).

``builtin_tables()`` serves the shipped GRI-Mech 3.0 NASA-7 data
(chem/data/nasa7_gri30.dat) for the H/C/N/O core species.
"""

from __future__ import annotations

import os
import re

import numpy as np

__all__ = [
    "read_janaf", "read_nasa7", "read_nasa9",
    "nasa7_gibbs_rt", "nasa9_gibbs_rt",
    "g_table_nasa7", "g_table_nasa9", "builtin_tables", "BUILTIN_NASA7",
]

_R = 8.31446261815324  # J/(mol K)
BUILTIN_NASA7 = os.path.join(os.path.dirname(__file__), "data",
                             "nasa7_gri30.dat")


# ---------------------------------------------------------------------------
# JANAF ASCII tables (the reference TEA's native input)

def read_janaf(path: str):
    """Read a NIST-JANAF ASCII table -> (T, g/RT) formation-convention
    table (TEA's formula: -gef/R + dHf298/(R T); readJANAF.py
    semantics).

    Expected columns (tab/space separated, after 1-2 header lines):
    T[K]  Cp  S  -[G-H(Tr)]/T  H-H(Tr)  delta-f H  delta-f G  log Kf
    with Cp/S/gef in J/(mol K) and enthalpies in kJ/mol.  Rows with
    non-numeric entries (INFINITE at T=0) are skipped.
    """
    temps, gefs, dhf = [], [], []
    with open(path) as f:
        for line in f:
            s = line.split()
            if len(s) < 6:
                continue
            try:
                row = [float(v) for v in s[:7]]
            except ValueError:
                continue
            temps.append(row[0])
            gefs.append(row[3])
            dhf.append(row[5])
    if not temps:
        raise ValueError(f"no numeric JANAF rows in {path}")
    temps = np.asarray(temps)
    gefs = np.asarray(gefs)
    # formation enthalpy at the 298.15 K reference row
    i298 = int(np.argmin(np.abs(temps - 298.15)))
    dhf298 = dhf[i298] * 1000.0  # kJ/mol -> J/mol
    keep = temps > 0
    T = temps[keep]
    g_rt = -gefs[keep] / _R + dhf298 / (_R * T)
    return T, g_rt


# ---------------------------------------------------------------------------
# NASA-7 polynomials (CHEMKIN THERMO format)

def _f15(chunk: str) -> float:
    chunk = chunk.strip()
    return float(chunk) if chunk else 0.0


def read_nasa7(path: str) -> dict:
    """Parse a CHEMKIN-format THERMO file -> {NAME: (t_low, t_common,
    t_high, a_low[7], a_high[7])}.  Names are upper-cased."""
    out = {}
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    i = 0
    default_ts = None
    while i < len(lines):
        ln = lines[i]
        s = ln.strip()
        if (not s or s.startswith("!") or s.upper().startswith("THERMO")):
            i += 1
            continue
        if s.upper().startswith("END"):
            break
        # global default temperature line (three floats)
        if default_ts is None and re.fullmatch(
            r"[\d.\sEe+-]+", s
        ) and len(s.split()) == 3 and "1" != s.split()[-1]:
            try:
                default_ts = [float(v) for v in s.split()]
                i += 1
                continue
            except ValueError:
                pass
        if len(ln) < 80 or ln[79] != "1":
            i += 1
            continue
        name = ln[:18].split()[0].upper()
        try:
            t_low = float(ln[45:55])
            t_high = float(ln[55:65])
            t_common = float(ln[65:73])
        except ValueError:
            t_low, t_common, t_high = (default_ts or [200.0, 1000.0, 3500.0])
        c = []
        for j in (1, 2, 3):
            row = lines[i + j]
            for k in range(5):
                if len(c) >= 14:
                    break
                c.append(_f15(row[15 * k:15 * (k + 1)]))
        a_high = np.asarray(c[:7])
        a_low = np.asarray(c[7:14])
        out[name] = (t_low, t_common, t_high, a_low, a_high)
        i += 4
    if not out:
        raise ValueError(f"no NASA-7 records found in {path}")
    return out


def nasa7_gibbs_rt(rec, T):
    """g(T)/RT = H/RT - S/R from a read_nasa7 record (formation
    convention)."""
    t_low, t_common, t_high, a_low, a_high = rec
    T = np.asarray(T, np.float64)

    def eval_g(a, T):
        h_rt = (a[0] + a[1] * T / 2 + a[2] * T**2 / 3 + a[3] * T**3 / 4
                + a[4] * T**4 / 5 + a[5] / T)
        s_r = (a[0] * np.log(T) + a[1] * T + a[2] * T**2 / 2
               + a[3] * T**3 / 3 + a[4] * T**4 / 4 + a[6])
        return h_rt - s_r

    return np.where(T < t_common, eval_g(a_low, T), eval_g(a_high, T))


def g_table_nasa7(rec, t_grid=None):
    """(T, g/RT) table from a NASA-7 record, clamped to its T range
    (polynomials diverge badly when extrapolated)."""
    t_low, _, t_high, _, _ = rec
    if t_grid is None:
        t_grid = np.linspace(t_low, t_high, 200)
    t_eval = np.clip(t_grid, t_low, t_high)
    return np.asarray(t_grid, np.float64), nasa7_gibbs_rt(rec, t_eval)


# ---------------------------------------------------------------------------
# NASA-9 polynomials (CEA thermo.inp format)

_D_EXP = re.compile(r"[dD]")


def _f16(chunk: str) -> float:
    chunk = _D_EXP.sub("E", chunk.strip())
    return float(chunk) if chunk else 0.0


def read_nasa9(path: str) -> dict:
    """Parse a CEA thermo.inp-format file -> {NAME: [(t_lo, t_hi,
    a[7], b1, b2), ...]} (one entry per temperature interval)."""
    out = {}
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    i = 0
    while i < len(lines):
        s = lines[i].strip()
        if (not s or s.startswith("!") or s.startswith("#")
                or s.lower().startswith("thermo")):
            i += 1
            continue
        if s.upper().startswith("END"):
            break
        # species header line: name in cols 0-15 (letters), then source
        if lines[i][0] not in " \t" and not s[0].isdigit():
            name = s.split()[0].upper()
            i += 1
            hdr = lines[i]
            try:
                nint = int(hdr[:2])
            except ValueError:
                continue
            i += 1
            intervals = []
            for _ in range(nint):
                trange = lines[i].split()
                t_lo, t_hi = float(trange[0]), float(trange[1])
                c1 = lines[i + 1]
                c2 = lines[i + 2]
                coeffs = [_f16(c1[16 * k:16 * (k + 1)]) for k in range(5)]
                coeffs += [_f16(c2[:16]), _f16(c2[16:32])]
                b1 = _f16(c2[48:64])
                b2 = _f16(c2[64:80])
                intervals.append((t_lo, t_hi, np.asarray(coeffs), b1, b2))
                i += 3
            out[name] = intervals
        else:
            i += 1
    if not out:
        raise ValueError(f"no NASA-9 records found in {path}")
    return out


def nasa9_gibbs_rt(intervals, T):
    """g(T)/RT from NASA-9 intervals:
    H/RT = -a1/T^2 + a2 lnT/T + a3 + a4 T/2 + a5 T^2/3 + a6 T^3/4
           + a7 T^4/5 + b1/T
    S/R  = -a1/(2T^2) - a2/T + a3 lnT + a4 T + a5 T^2/2 + a6 T^3/3
           + a7 T^4/4 + b2
    """
    T = np.asarray(T, np.float64)
    g = np.zeros_like(T)
    done = np.zeros_like(T, bool)
    for (t_lo, t_hi, a, b1, b2) in intervals:
        h_rt = (-a[0] / T**2 + a[1] * np.log(T) / T + a[2] + a[3] * T / 2
                + a[4] * T**2 / 3 + a[5] * T**3 / 4 + a[6] * T**4 / 5
                + b1 / T)
        s_r = (-a[0] / (2 * T**2) - a[1] / T + a[2] * np.log(T) + a[3] * T
               + a[4] * T**2 / 2 + a[5] * T**3 / 3 + a[6] * T**4 / 4 + b2)
        sel = (~done) & (T >= t_lo) & (T <= t_hi)
        g = np.where(sel, h_rt - s_r, g)
        done |= sel
    if not done.all():
        # clamp out-of-range temperatures to the nearest interval edge
        t_min = min(iv[0] for iv in intervals)
        t_max = max(iv[1] for iv in intervals)
        Tc = np.clip(T, t_min, t_max)
        g = np.where(done, g, nasa9_gibbs_rt(intervals, Tc))
    return g


def g_table_nasa9(intervals, t_grid=None):
    if t_grid is None:
        t_min = min(iv[0] for iv in intervals)
        t_max = max(iv[1] for iv in intervals)
        t_grid = np.linspace(t_min, t_max, 200)
    return np.asarray(t_grid, np.float64), nasa9_gibbs_rt(intervals, t_grid)


# ---------------------------------------------------------------------------

def builtin_tables(species=None, path: str | None = None,
                   t_grid=None) -> dict:
    """(T, g/RT) tables for ``species`` from a NASA-7 file (default:
    the shipped GRI-Mech 3.0 data), extended by the computed
    JANAF-grade tables of chem/thermo_species.py for ions, alkalis,
    and TiO/VO (same formation convention, so mixing is exact).
    Raises KeyError listing any species covered by neither — a PARTIAL
    table set must not be mixed with the analytic free-atom
    thermochemistry (module doc)."""
    from bart_tpu_torch.chem.thermo_species import EXTRA_SPECIES, computed_tables

    recs = read_nasa7(path or BUILTIN_NASA7)
    if species is None:
        out = {name: g_table_nasa7(rec, t_grid)
               for name, rec in recs.items()}
        out.update(computed_tables(t_grid=t_grid))
        return out
    missing = [s for s in species
               if s.upper() not in recs and s not in EXTRA_SPECIES]
    if missing:
        raise KeyError(
            f"species {missing} not in {path or BUILTIN_NASA7} nor in the "
            "computed-thermo registry (chem/thermo_species.py); extend "
            "the thermo data or drop `thermofile` to use the analytic "
            "free-atom thermochemistry for ALL species (conventions "
            "must not be mixed)"
        )
    out = {}
    for s in species:
        if s.upper() in recs:
            out[s] = g_table_nasa7(recs[s.upper()], t_grid)
        else:
            out[s] = computed_tables([s], t_grid=t_grid)[s]
    return out
