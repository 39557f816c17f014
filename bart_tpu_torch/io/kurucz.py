"""Kurucz stellar-atmosphere grid reader, model selection and the
blackbody star (this package's own host copy of bart_tpu/io/kurucz.py).

Parses the Kurucz .pck grid format (reference: code/kurucz_inten.py:160-317
read; code/wine.py:69-124 readkurucz) and returns the stellar flux for a
requested (Teff, log g): nearest-model selection like the reference, a
bilinear-in-(T, log g) mode and the reference's bicubic spline mode.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bart_tpu_torch import constants as const

__all__ = ["KuruczGrid", "read_kurucz_pck", "stellar_flux", "blackbody_star"]


@dataclasses.dataclass
class KuruczGrid:
    inten: np.ndarray   # [nmod, nwavl] flux in W m-2 sr-1 Hz-1 (x4 Eddington)
    wave_m: np.ndarray  # [nwavl] wavelength [m], ascending
    grav: np.ndarray    # [nmod] log10 g
    temp: np.ndarray    # [nmod] Teff [K]


def read_kurucz_pck(path: str) -> KuruczGrid:
    """Parse a Kurucz .pck grid file (format per the reference reader:
    TEFF/GRAVITY header lines, 10-char fixed-width flux records,
    wavelength block in nm after the 'END' header)."""
    with open(path) as f:
        text = f.read().replace("\r", "\n")
    lines = text.split("\n")

    heads = []
    startwave = 0
    for i, ln in enumerate(lines):
        if ln.startswith("TEFF"):
            heads.append(i)
        elif ln.endswith("END"):
            startwave = i + 1
    if not heads:
        raise ValueError(f"{path}: no TEFF model headers found")
    temp = np.array([float(lines[i][5:12]) for i in heads])
    grav = np.array([float(lines[i][22:29]) for i in heads])
    nmod = len(heads)
    nline = (heads[2] - heads[1] - 1) // 2 if nmod > 2 else (len(lines) - heads[0] - 1) // 2

    wstr = "".join(lines[startwave : heads[0]])
    wave = np.array(
        [float(wstr[j : j + 10]) for j in range(0, len(wstr) // 10 * 10, 10)]
    )
    wave = wave[wave != 0] * 1e-9  # nm -> m
    nwavl = wave.size

    inten = np.zeros((nmod, nwavl))
    for m, i in enumerate(heads):
        s1 = "".join(lines[i + 1 : i + 1 + nline])
        vals = [float(s1[j : j + 10]) for j in range(0, min(len(s1), nwavl * 10), 10)]
        inten[m, : len(vals)] = vals

    # Eddington flux x4, CGS erg cm-2 -> MKS (reference :311-313)
    inten *= 4.0 * 1e-3
    return KuruczGrid(inten, wave, grav, temp)


def stellar_flux(
    grid: KuruczGrid, temperature: float, logg: float, mode: str = "nearest"
) -> tuple[np.ndarray, np.ndarray, float, float]:
    """Stellar flux per wavenumber [erg s-1 cm-2 cm] on an ascending
    wavenumber grid [cm-1].

    mode='nearest' reproduces wine.readkurucz (code/wine.py:104-122):
    nearest sampled T and nearest log g, then the first model with
    temp==tmodel and grav >= gmodel.  mode='interp' bilinearly
    interpolates log-flux in (T, log g).  mode='spline' is the
    reference kurucz_inten.interp equivalent (code/kurucz_inten.py:
    8-159): 2-D bicubic spline in (T, log g) per wavelength.
    """
    c_si = 2.99792458e8
    starwn = np.flipud(c_si / grid.wave_m) / c_si * 1e-2  # = 1/(wave m) *1e-2
    # (frequency -> wavenumber cm-1, ascending after flip)

    if mode == "nearest":
        tmodel = grid.temp[np.argmin(np.abs(grid.temp - temperature))]
        gmodel = grid.grav[np.argmin(np.abs(grid.grav - logg))]
        sel = np.where((grid.temp == tmodel) & (grid.grav >= gmodel))[0]
        imodel = sel[0] if len(sel) else np.argmin(
            np.abs(grid.temp - temperature) + np.abs(grid.grav - logg)
        )
        inten = grid.inten[imodel]
        tmod, gmod = float(tmodel), float(gmodel)
    elif mode == "interp":
        ts = np.unique(grid.temp)
        gs = np.unique(grid.grav)
        t0, t1 = _bracket(ts, temperature)
        g0, g1 = _bracket(gs, logg)
        ft = 0.0 if t1 == t0 else (temperature - t0) / (t1 - t0)
        fg = 0.0 if g1 == g0 else (logg - g0) / (g1 - g0)

        def model(t, g):
            sel = np.where((grid.temp == t) & (grid.grav == g))[0]
            if not len(sel):
                sel = np.where(grid.temp == t)[0][:1]
            return grid.inten[sel[0]]

        with np.errstate(divide="ignore"):
            lg = (
                (1 - ft) * (1 - fg) * _safe_log(model(t0, g0))
                + (1 - ft) * fg * _safe_log(model(t0, g1))
                + ft * (1 - fg) * _safe_log(model(t1, g0))
                + ft * fg * _safe_log(model(t1, g1))
            )
        inten = np.where(np.isfinite(lg), np.exp(lg), 0.0)
        tmod, gmod = float(temperature), float(logg)
    elif mode == "spline":
        from scipy.interpolate import RectBivariateSpline

        ts = np.unique(grid.temp)
        gs = np.unique(grid.grav)
        if len(ts) < 2 or len(gs) < 2:
            # degenerate grid (single Teff or single log g): bicubic is
            # undefined along that axis — use the bilinear path
            return stellar_flux(grid, temperature, logg, mode="interp")
        nw = grid.inten.shape[1]
        # assemble the full (T, logg) model cube; missing models fall
        # back to the nearest available model at that T
        cube = np.zeros((len(ts), len(gs), nw))
        for i, tv in enumerate(ts):
            row_default = grid.inten[np.where(grid.temp == tv)[0][0]]
            for j, gv in enumerate(gs):
                sel = np.where((grid.temp == tv) & (grid.grav == gv))[0]
                cube[i, j] = grid.inten[sel[0]] if len(sel) else row_default
        kt = min(3, len(ts) - 1)
        kg = min(3, len(gs) - 1)
        tq = float(np.clip(temperature, ts[0], ts[-1]))
        gq = float(np.clip(logg, gs[0], gs[-1]))
        inten = np.empty(nw)
        # One bicubic surface per wavelength on the RAW intensities
        # (reference kurucz_inten.interp semantics).  Raw — not log —
        # because zero-flux models (cool stars at short wavelengths)
        # would become log sentinels that the cubic overshoots by
        # orders of magnitude; raw overshoot is bounded and clamped.
        for w in range(nw):
            sp = RectBivariateSpline(ts, gs, cube[:, :, w], kx=kt, ky=kg)
            inten[w] = sp(tq, gq)[0, 0]
        inten = np.maximum(inten, 0.0)
        tmod, gmod = tq, gq
    else:
        raise ValueError(f"unknown mode {mode!r}")

    inten = np.flipud(inten)  # to ascending wavenumber
    # F_freq [W m-2 sr-1 Hz-1] -> F_wn [erg s-1 cm-2 cm]
    # (x c for Hz-1 -> m; x1e3 MKS->cgs; x pi sr-1 -> flux;
    #  reference code/wine.py:112-122)
    starfl = inten * 1e3 * np.pi * (1e2 * 2.99792458e8)
    return starfl, starwn, tmod, gmod


def _bracket(vals: np.ndarray, x: float) -> tuple[float, float]:
    i = np.searchsorted(vals, x)
    i = np.clip(i, 1, len(vals) - 1)
    return float(vals[i - 1]), float(vals[i])


def _safe_log(x):
    return np.log(np.where(x > 0, x, 1e-300))


def blackbody_star(
    wn_grid: np.ndarray, temperature: float
) -> tuple[np.ndarray, np.ndarray]:
    """Blackbody stellar flux per wavenumber [erg s-1 cm-2 cm] on
    ``wn_grid`` [cm-1]: F = pi B_wn(T)."""
    x = const.C2 * wn_grid / temperature
    B = 2.0 * const.H_PLANCK * const.C_LIGHT**2 * wn_grid**3 / np.expm1(x)
    return np.pi * B, np.asarray(wn_grid, np.float64)
