"""ExoMol line-list driver (.states / .trans / .pf): this package's own
host copy of bart_tpu/linelist/exomol.py (the analytic Q(296 K) through
the port's torch partition functions, in float64 on the CPU).

Modern successor to the reference's pylineread database drivers
(reference: SURVEY.md sections 2.2/3.5).  ExoMol is today's standard
source for hot-exoplanet line lists; the reference predates it.

Formats (exomol.com definitions):
  .states : id  E[cm-1]  g_tot  J  [...]
  .trans  : id_upper  id_lower  A[s-1]  [wavenumber]
  .pf     : T[K]  Q(T)
  .broad  : code  gamma_ref[cm-1/bar @296K]  n_T  [J'' ...]
            (one file per broadener, e.g. MOL__H2.broad / MOL__He.broad;
            code 'a0' rows are J''-indexed, any other code is used as
            the J-independent default)

Intensities are converted to the HITRAN S(296 K) convention used by
the opacity engine:

  S296 = g' A / (8 pi c nu^2) * exp(-c2 E''/296) *
         (1 - exp(-c2 nu/296)) / Q(296)

Pressure-broadening from .broad files is mixed over the H2/He bath
(gamma = sum_b vmr_b * gamma_b(J''), converted from per-bar to the
HITRAN per-atm convention) and stored in the LineList's
gamma_air/n_air slots, so BroadeningSpec(mode='air') applies proper
ExoMol widths in the opacity engine.  Without .broad files the
registry-level constant defaults are used (the reference has no
per-line widths at all for non-HITRAN databases: its voigt.c widths
come from collision theory, scripts/broadening.py:91-127).
"""

from __future__ import annotations

import gzip

import numpy as np
import torch

from bart_tpu_torch import constants as const
from bart_tpu_torch.linelist.hitran import TREF, LineList
from bart_tpu_torch.linelist.tips import partition_function

__all__ = ["read_states", "read_trans", "read_pf", "read_broad",
           "read_exomol"]

_BAR_TO_ATM_GAMMA = 1.01325  # gamma[cm-1/atm] = gamma[cm-1/bar] * this


def _open(path: str):
    if path.endswith(".gz") or path.endswith(".bz2"):
        if path.endswith(".bz2"):
            import bz2

            return bz2.open(path, "rt")
        return gzip.open(path, "rt")
    return open(path)


def read_states(path: str):
    """-> (energy[cm-1], g_total, J) indexed by state id (1-based ids
    map to row id-1).  J is -1 where the column is absent."""
    energies, gs, js = [], [], []
    with _open(path) as f:
        for line in f:
            s = line.split()
            if len(s) < 3 or s[0].startswith("#"):
                continue
            energies.append(float(s[1]))
            gs.append(float(s[2]))
            js.append(float(s[3]) if len(s) > 3 else -1.0)
    return np.asarray(energies), np.asarray(gs), np.asarray(js)


def read_trans(path: str):
    """-> (id_upper, id_lower, A) int/float arrays."""
    up, lo, A = [], [], []
    with _open(path) as f:
        for line in f:
            s = line.split()
            if len(s) < 3 or s[0].startswith("#"):
                continue
            up.append(int(s[0]))
            lo.append(int(s[1]))
            A.append(float(s[2]))
    return np.asarray(up, np.int64), np.asarray(lo, np.int64), np.asarray(A)


def read_pf(path: str):
    """-> (T, Q) arrays from a .pf file."""
    t, q = [], []
    with _open(path) as f:
        for line in f:
            s = line.split()
            if len(s) < 2 or s[0].startswith("#"):
                continue
            t.append(float(s[0]))
            q.append(float(s[1]))
    return np.asarray(t), np.asarray(q)


def read_broad(path: str):
    """Parse an ExoMol .broad file -> (j_table, gamma_table, n_table,
    default_gamma, default_n).  'a0' rows are J''-indexed (table lookup
    with clamp-to-last for higher J); any other code contributes the
    J-independent default."""
    j, gam, nexp = [], [], []
    dg, dn = [], []
    with _open(path) as f:
        for line in f:
            s = line.split()
            if len(s) < 3 or s[0].startswith("#"):
                continue
            code, g_ref, n_t = s[0], float(s[1]), float(s[2])
            if code == "a0" and len(s) > 3:
                j.append(float(s[3]))
                gam.append(g_ref)
                nexp.append(n_t)
            else:
                dg.append(g_ref)
                dn.append(n_t)
    default_g = float(np.mean(dg)) if dg else (float(np.mean(gam)) if gam
                                               else 0.05)
    default_n = float(np.mean(dn)) if dn else (float(np.mean(nexp)) if nexp
                                               else 0.5)
    order = np.argsort(j)
    return (np.asarray(j)[order], np.asarray(gam)[order],
            np.asarray(nexp)[order], default_g, default_n)


def _broad_lookup(broad, J):
    """Per-line (gamma, n) from a read_broad table; J<0 -> defaults."""
    jt, gt, nt, dg, dn = broad
    if len(jt) == 0:
        return np.full(J.shape, dg), np.full(J.shape, dn)
    # exact-match lookup with clamp beyond the tabulated J range
    idx = np.clip(np.searchsorted(jt, J), 0, len(jt) - 1)
    gamma = gt[idx]
    n = nt[idx]
    missing = J < 0
    return np.where(missing, dg, gamma), np.where(missing, dn, n)


def read_exomol(
    states_path: str,
    trans_paths: list[str] | str,
    species: str,
    pf_path: str | None = None,
    wn_min: float = 0.0,
    wn_max: float = np.inf,
    broadeners: list[tuple[str, float]] | None = None,
) -> LineList:
    """Assemble a LineList from ExoMol files, trimmed to [wn_min, wn_max].

    ``broadeners`` is a list of (path_to_broad_file, bath_vmr) — e.g.
    [("CH4__H2.broad", 0.85), ("CH4__He.broad", 0.15)] — mixed into a
    single per-line HITRAN-convention (gamma_air, n_air) pair.
    """
    if isinstance(trans_paths, str):
        trans_paths = [trans_paths]
    energy, g, jq = read_states(states_path)

    if pf_path:
        t_tab, q_tab = read_pf(pf_path)
        q296 = float(np.interp(TREF, t_tab, q_tab))
    else:
        q296 = float(partition_function(species)(
            torch.tensor(TREF, dtype=torch.float64)))

    broad_tables = [(read_broad(p), vmr) for p, vmr in (broadeners or [])]

    wn_all, s_all, el_all, ga_all, na_all = [], [], [], [], []
    for tp in trans_paths:
        up, lo, A = read_trans(tp)
        e_up = energy[up - 1]
        e_lo = energy[lo - 1]
        g_up = g[up - 1]
        j_lo = jq[lo - 1]
        nu = e_up - e_lo
        keep = (nu > max(wn_min, 1e-6)) & (nu < wn_max)
        nu, e_lo, g_up, A, j_lo = (nu[keep], e_lo[keep], g_up[keep],
                                   A[keep], j_lo[keep])
        c2 = const.C2
        s296 = (
            g_up * A / (8.0 * np.pi * const.C_LIGHT * nu**2)
            * np.exp(-c2 * e_lo / TREF)
            * (1.0 - np.exp(-c2 * nu / TREF))
            / q296
        )
        if broad_tables:
            gamma = np.zeros(len(nu))
            n_air = np.zeros(len(nu))
            vmr_tot = sum(v for _, v in broad_tables)
            for tab, vmr in broad_tables:
                gl, nl = _broad_lookup(tab, j_lo)
                gamma += vmr * gl
                n_air += vmr * nl
            gamma *= _BAR_TO_ATM_GAMMA / vmr_tot
            n_air /= vmr_tot
        else:
            gamma = np.full(len(nu), 0.05)
            n_air = np.full(len(nu), 0.5)
        wn_all.append(nu)
        s_all.append(s296)
        el_all.append(e_lo)
        ga_all.append(gamma)
        na_all.append(n_air)

    wn = np.concatenate(wn_all)
    order = np.argsort(wn, kind="stable")
    n = len(wn)
    gamma_air = np.concatenate(ga_all)[order]
    return LineList(
        species=species,
        wn0=wn[order],
        s296=np.concatenate(s_all)[order],
        elower=np.concatenate(el_all)[order],
        gamma_air=gamma_air,
        gamma_self=1.4 * gamma_air,
        n_air=np.concatenate(na_all)[order],
        iso=np.ones(n, np.int8),
    )
