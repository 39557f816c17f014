"""Computed JANAF-grade formation-convention thermo tables.

This package's own host copy of bart_tpu/chem/thermo_species.py.

Extends the shipped GRI-Mech NASA-7 set (chem/thermo_tables.py) to the
species the reference's TEA covers through the full JANAF set but
GRI-Mech does not: ions (`_ion_p`/`_ion_n` naming, reference
makeatm.make_preatm; SURVEY.md section 2.4), alkali atoms, and the
TiO/VO molecules the line-list layer supports.

Rather than shipping fabricated "CEA data", each table is COMPUTED
from published constants by the same statistical mechanics JANAF
itself used (Chase 1998, introduction):

    S(T)   = S_trans + S_rot + S_vib + S_el      (exact ideal-gas RRHO)
    H(T)   = dHf(298.15) + [H(T) - H(298.15)]    (closed-form RRHO)
    g/RT   = H/RT - S/R                           (formation convention)

Inputs per species: mass, electronic levels (NIST ASD), vibrational /
rotational constants (Huber & Herzberg 1979), and dHf(298.15) anchors
(JANAF / CODATA; ion values derived from neutral dHf + NIST
ionization energies with the electron-convention offset 6.197 kJ/mol
= 2.5 R x 298.15, which reproduces the JANAF ion values: e.g.
Na+ 609.3, H+ 1536.2, H- 139.0 kJ/mol).

Sanity anchors reproduced by these formulas (tests/test_chem.py):
S(298.15) of e- = 20.98, Na = 153.72, K = 160.34 J/mol/K (published
JANAF values); Na ionization matches the Saha equation.

The tables share the GRI set's formation convention (zero = reference-
state elements at 298.15 K), so mixed solves are exact — the solver's
element potentials absorb the common per-element shifts.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_R = 8.31446261815324          # J/(mol K)
_KB = 1.380649e-23             # J/K
_H = 6.62607015e-34            # J s
_C = 2.99792458e10             # cm/s
_AMU = 1.66053906660e-27       # kg
_P0 = 1.0e5                    # 1 bar [Pa]
_T0 = 298.15
_EV = 96.4853321               # kJ/mol per eV
_ECONV = 2.5 * _R * _T0 / 1000.0   # 6.197 kJ/mol electron-convention offset
_CM_TO_K = _H * _C / _KB       # hc/k [K per cm-1] (c in cm/s above)


@dataclasses.dataclass(frozen=True)
class SpeciesThermo:
    """Constants for one computed-thermo species.

    ``levels``: electronic levels [(E [cm-1], degeneracy g)].
    ``omega``/``wexe``/``B``: diatomic constants [cm-1] (None = atom).
    ``omegas``: polyatomic fundamentals [cm-1], degenerate modes
    repeated (harmonic treatment with OBSERVED fundamentals — the
    standard RRHO recipe JANAF itself uses for polyatomics).
    ``rot_abc``: (A, B, C) rotational constants [cm-1] for a
    NONLINEAR polyatomic; a linear polyatomic sets ``B`` + ``omegas``.
    ``dhf298``: formation enthalpy at 298.15 K [kJ/mol].
    """

    name: str
    mass: float                      # amu
    levels: tuple                    # ((E_cm, g), ...)
    dhf298: float                    # kJ/mol
    omega: float | None = None       # cm-1
    wexe: float = 0.0
    B: float | None = None           # cm-1
    sigma: int = 1
    omegas: tuple = ()               # polyatomic fundamentals [cm-1]
    rot_abc: tuple | None = None     # (A, B, C) [cm-1], nonlinear top


def _el_stats(levels, T):
    """Electronic q, <theta>, <theta^2> with theta = E*hc/k [K]."""
    T = np.asarray(T, np.float64)[..., None]
    th = np.array([e * _CM_TO_K for e, _ in levels])
    g = np.array([gg for _, gg in levels])
    w = g * np.exp(-th / T)
    q = w.sum(-1)
    m1 = (w * th).sum(-1) / q
    m2 = (w * th * th).sum(-1) / q
    return q, m1, m2


def _s_trans_r(mass_amu, T):
    """Sackur-Tetrode S_trans/R at 1 bar (SI, derived not memorized)."""
    T = np.asarray(T, np.float64)
    m = mass_amu * _AMU
    lam3 = (2.0 * np.pi * m * _KB * T / _H**2) ** 1.5
    return np.log(lam3 * _KB * T / _P0) + 2.5


def thermo_funcs(st: SpeciesThermo, T):
    """-> (S/R, [H(T)-H(298)]/R [K]) ideal-gas RRHO."""
    T = np.asarray(T, np.float64)
    q_el, th1, _ = _el_stats(st.levels, T)
    q0, th1_0, _ = _el_stats(st.levels, np.array([_T0]))

    s_r = _s_trans_r(st.mass, T) + np.log(q_el) + th1 / T
    dh_r = 2.5 * (T - _T0) + (th1 - th1_0[0])

    def add_vib(s_r, dh_r, nu_cm):
        """One harmonic oscillator at frequency nu [cm-1]."""
        th_v = nu_cm * _CM_TO_K
        x = th_v / T
        x0 = th_v / _T0
        s_r = s_r + x / np.expm1(x) - np.log(-np.expm1(-x))
        dh_r = dh_r + th_v / np.expm1(x) - th_v / np.expm1(x0)
        return s_r, dh_r

    if st.omega is not None:
        # diatomic: rotation (linear, classical — theta_rot << 298 K
        # for all species here) + vibration with the anharmonicity-
        # corrected fundamental (omega_0 = omega_e - 2 omega_e x_e)
        th_r = st.B * _CM_TO_K
        s_r = s_r + np.log(T / (st.sigma * th_r)) + 1.0
        dh_r = dh_r + (T - _T0)
        s_r, dh_r = add_vib(s_r, dh_r, st.omega - 2.0 * st.wexe)
    elif st.omegas:
        # polyatomic RRHO: classical rotation (nonlinear top via
        # (A, B, C); linear via B) + one harmonic oscillator per
        # fundamental (degenerate modes appear repeated in omegas)
        if st.rot_abc is not None:
            th_abc = np.prod([a * _CM_TO_K for a in st.rot_abc])
            s_r = (s_r + 1.5 + np.log(np.sqrt(np.pi) / st.sigma)
                   + 0.5 * np.log(T**3 / th_abc))
            dh_r = dh_r + 1.5 * (T - _T0)
        else:
            th_r = st.B * _CM_TO_K
            s_r = s_r + np.log(T / (st.sigma * th_r)) + 1.0
            dh_r = dh_r + (T - _T0)
        for nu in st.omegas:
            s_r, dh_r = add_vib(s_r, dh_r, nu)
    return s_r, dh_r


def g_rt(st: SpeciesThermo, T):
    """Formation-convention g(T)/RT = H/RT - S/R."""
    T = np.asarray(T, np.float64)
    s_r, dh_r = thermo_funcs(st, T)
    return (st.dhf298 * 1000.0 / _R + dh_r) / T - s_r


def entropy_298(st: SpeciesThermo) -> float:
    """S(298.15) [J/mol/K] — published-value sanity anchor."""
    s_r, _ = thermo_funcs(st, np.array([_T0]))
    return float(s_r[0] * _R)


def _ion(dhf_neutral, ie_ev):
    """Cation dHf(298) [kJ/mol] on the JANAF electron convention."""
    return dhf_neutral + ie_ev * _EV + _ECONV


# --------------------------------------------------------------------------
# Registry.  Sources: masses + ionization energies NIST ASD; electronic
# levels NIST ASD (lowest multiplets; higher terms are exp(-E/kT)
# suppressed below ~4000 K); diatomic constants Huber & Herzberg 1979;
# dHf anchors JANAF (Chase 1998) / CODATA.  TiO/VO dHf carry ~5 kJ/mol
# literature spread (D0 6.87-6.92 eV for TiO) — noted in tests.

EXTRA_SPECIES: dict[str, SpeciesThermo] = {}


def _add(*args, **kw):
    st = SpeciesThermo(*args, **kw)
    EXTRA_SPECIES[st.name] = st


_add("e-", 5.48579909e-4, ((0.0, 2),), 0.0)
_add("H+", 1.007276, ((0.0, 1),), _ion(217.998, 13.59844))
_add("H-", 1.008926, ((0.0, 1),), 217.998 - 0.75420 * _EV - _ECONV)
_add("Na", 22.98977, ((0.0, 2), (16956.2, 2), (16973.4, 4)), 107.3)
_add("Na+", 22.98922, ((0.0, 1),), _ion(107.3, 5.13908))
_add("K", 39.0983, ((0.0, 2), (12985.2, 2), (13042.9, 4)), 89.0)
_add("K+", 39.09775, ((0.0, 1),), _ion(89.0, 4.34066))
_add("Li", 6.941, ((0.0, 2), (14903.9, 6)), 159.3)
_add("Li+", 6.94045, ((0.0, 1),), _ion(159.3, 5.39172))
_add("Cs", 132.90545, ((0.0, 2), (11178.3, 2), (11732.3, 4)), 76.5)
_add("Cs+", 132.90490, ((0.0, 1),), _ion(76.5, 3.89390))
_add("Ti", 47.867, ((0.0, 5), (170.1, 7), (386.9, 9)), 473.0)
_add("V", 50.9415, ((0.0, 4), (137.4, 6), (323.5, 8), (552.9, 10)),
     515.5)
_add("TiO", 63.866, ((0.0, 6), (3446.0, 2), (5661.0, 1), (11872.0, 6),
                     (14020.0, 6)),
     54.39, omega=1009.02, wexe=4.50, B=0.53541)
_add("VO", 66.9409, ((0.0, 4), (9499.0, 8), (12606.0, 8)),
     149.0, omega=1011.3, wexe=4.86, B=0.5463)

# --- round-4 breadth extension: the metal atoms/ions and hydride/
# oxide diatomics of hot-Jupiter retrievals (UHJ Fe/Mg/Ca lines, M-
# dwarf FeH/CrH/CaH/MgH bands, SiO/AlO).  Atom levels NIST ASD;
# diatomic constants Huber & Herzberg 1979; dHf anchors JANAF where
# the species is in JANAF (all atoms, SiO, AlO, AlH, SiH, NaH, MgH,
# CaH), else derived from measured D0 (FeH: Schultz & Armentrout
# 1.59 eV; CrH: 1.93 eV; KH: 1.81 eV) via dHf(XH) = dHf(X) + dHf(H)
# - D0 with ~+-10 kJ/mol spread documented in tests/test_chem.py.
# S(298.15) of every JANAF-covered entry reproduces the published
# value to <0.6 J/mol/K (test_chem.py anchor list).

_add("Mg", 24.305, ((0.0, 1), (21850.4, 1), (21870.5, 3), (21911.2, 5)),
     147.1)
_add("Mg+", 24.30445, ((0.0, 2),), _ion(147.1, 7.64624))
_add("Ca", 40.078, ((0.0, 1), (15157.9, 1), (15210.1, 3), (15315.9, 5)),
     177.8)
_add("Ca+", 40.07745, ((0.0, 2), (13650.2, 4), (13710.9, 6)),
     _ion(177.8, 6.11316))
_add("Fe", 55.845, ((0.0, 9), (415.9, 7), (704.0, 5), (888.1, 3),
                    (978.1, 1), (6928.3, 11), (7376.8, 9)), 415.5)
_add("Fe+", 55.84445, ((0.0, 10), (384.8, 8), (667.7, 6), (862.6, 4),
                       (977.1, 2)), _ion(415.5, 7.90247))
_add("Si", 28.0855, ((0.0, 1), (77.1, 3), (223.2, 5), (6298.8, 5)),
     450.0)
_add("Si+", 28.08495, ((0.0, 2), (287.2, 4)), _ion(450.0, 8.15169))
_add("Al", 26.9815, ((0.0, 2), (112.1, 4)), 330.0)
_add("Al+", 26.98095, ((0.0, 1),), _ion(330.0, 5.98577))
_add("Cr", 51.9961, ((0.0, 7),), 397.5)
_add("Cr+", 51.99555, ((0.0, 6),), _ion(397.5, 6.76651))
_add("Mn", 54.938, ((0.0, 6),), 283.3)
_add("Ti+", 47.86645, ((0.0, 4), (94.1, 6), (225.7, 8), (393.4, 10)),
     _ion(473.0, 6.82812))
_add("V+", 50.94095, ((0.0, 1), (36.1, 3), (106.6, 5), (208.9, 7),
                      (339.2, 9)), _ion(515.5, 6.74619))
_add("SiO", 44.085, ((0.0, 1),), -100.4,
     omega=1241.54, wexe=5.966, B=0.72679)
_add("AlO", 42.981, ((0.0, 2), (5406.0, 4)), 66.9,
     omega=979.23, wexe=6.97, B=0.64136)
_add("AlH", 27.989, ((0.0, 1),), 259.5,
     omega=1682.57, wexe=29.09, B=6.3938)
# SiH ground 2Pi: spin-orbit components resolved (142 cm-1 split)
_add("SiH", 29.093, ((0.0, 2), (142.0, 2)), 376.6,
     omega=2041.80, wexe=35.51, B=7.4996)
_add("NaH", 23.998, ((0.0, 1),), 142.0,
     omega=1172.2, wexe=19.72, B=4.9012)
_add("KH", 40.106, ((0.0, 1),), 125.0,
     omega=983.6, wexe=14.3, B=3.33)
_add("MgH", 25.313, ((0.0, 2),), 229.8,
     omega=1495.20, wexe=31.89, B=5.8257)
_add("CaH", 41.086, ((0.0, 2),), 230.9,
     omega=1298.34, wexe=19.10, B=4.2766)
_add("CrH", 53.004, ((0.0, 6),), 429.0,
     omega=1581.0, wexe=30.0, B=6.22)
_add("FeH", 56.853, ((0.0, 8),), 480.0,
     omega=1774.0, wexe=34.0, B=6.40)

# --- round-5 breadth extension: sulfur / phosphorus / halide chemistry
# and the first POLYATOMIC species (H2S, SO2, PH3, TiO2, VO2), the
# standard hot-Jupiter retrieval set the reference's TEA reaches
# through the full JANAF tables (makeatm.py:606-691 naming contract;
# SURVEY section 2.4).  Atom levels NIST ASD; diatomic constants
# Huber & Herzberg 1979; polyatomic fundamentals + rotational
# constants from Herzberg vol. III / HITRAN; dHf anchors JANAF
# (Chase 1998).  PH is not in JANAF: dHf derived from measured
# D0(P-H) ~ 3.0 eV via dHf(PH) = dHf(P) + dHf(H) - D, carrying
# ~+-10 kJ/mol literature spread (same situation as FeH/CrH above).
# TiO2/VO2 dHf carry ~+-10 kJ/mol spread; their fundamentals are
# matrix-isolation/anion-photoelectron values.

_add("S", 32.06, ((0.0, 5), (396.055, 3), (573.640, 1), (9238.609, 5)),
     276.98)
_add("P", 30.97376, ((0.0, 4), (11361.02, 4), (11376.63, 6)), 316.5)
_add("Cl", 35.453, ((0.0, 4), (882.35, 2)), 121.30)
# SH ground X2Pi: spin-orbit components resolved (377 cm-1 split)
_add("SH", 33.073, ((0.0, 2), (377.0, 2)), 139.33,
     omega=2711.6, wexe=59.9, B=9.4611)
_add("SO", 48.064, ((0.0, 3),), 5.01,
     omega=1149.2, wexe=5.6, B=0.7208)
_add("S2", 64.12, ((0.0, 3),), 128.60,
     omega=725.65, wexe=2.844, B=0.2955, sigma=2)
_add("HCl", 36.461, ((0.0, 1),), -92.31,
     omega=2990.946, wexe=52.8186, B=10.59341)
_add("NaCl", 58.443, ((0.0, 1),), -181.42,
     omega=366.0, wexe=2.05, B=0.21806)
_add("KCl", 74.551, ((0.0, 1),), -214.68,
     omega=281.0, wexe=1.30, B=0.12864)
_add("PH", 31.982, ((0.0, 3),), 235.0,
     omega=2365.2, wexe=44.5, B=8.5371)
_add("H2S", 34.081, ((0.0, 1),), -20.50, sigma=2,
     omegas=(2614.4, 1182.6, 2628.5),
     rot_abc=(10.374, 8.991, 4.732))
_add("SO2", 64.064, ((0.0, 1),), -296.81, sigma=2,
     omegas=(1151.38, 517.69, 1361.76),
     rot_abc=(2.02736, 0.34417, 0.29354))
_add("PH3", 33.998, ((0.0, 1),), 5.40, sigma=3,
     omegas=(2321.1, 992.1, 2326.9, 2326.9, 1118.3, 1118.3),
     rot_abc=(4.4522, 4.4522, 3.919))
_add("TiO2", 79.866, ((0.0, 1),), -305.4, sigma=2,
     omegas=(962.5, 330.0, 934.8),
     rot_abc=(1.0697, 0.2823, 0.2233))
_add("VO2", 82.940, ((0.0, 2),), -230.1, sigma=2,
     omegas=(970.0, 310.0, 936.0),
     rot_abc=(1.01, 0.29, 0.225))


def computed_tables(species=None, t_grid=None) -> dict:
    """(T, g/RT) tables for the computed-thermo species (all of them
    when ``species`` is None; unknown names raise KeyError)."""
    if t_grid is None:
        t_grid = np.linspace(200.0, 6000.0, 400)
    t_grid = np.asarray(t_grid, np.float64)
    names = list(EXTRA_SPECIES) if species is None else list(species)
    out = {}
    for n in names:
        if n not in EXTRA_SPECIES:
            raise KeyError(n)
        out[n] = (t_grid, g_rt(EXTRA_SPECIES[n], t_grid))
    return out
