"""Sampling grids: pressure layers and files, wavenumber arrays and the
folded fine wavenumber grid (this package's own host copy of
bart_tpu/utils/grids.py).
"""

from __future__ import annotations

import numpy as np

__all__ = ["pressure_grid", "write_pressure_file", "read_pressure_file",
           "wavenumber_grid", "folded_fine_grid"]


def folded_fine_grid(wn_out: np.ndarray, K: int) -> np.ndarray:
    """Midpoint-rule fine sampling for folded rtosamp: K samples per
    output bin [wn_b - d/2, wn_b + d/2), at wn_b + d((k+0.5)/K - 0.5),
    bin-major (fine index f = b*K + k).

    The RT pipeline evaluates extinction/tau/flux at these fine points
    and the OUTPUT spectrum is the per-bin mean of the fine spectrum —
    averaging AFTER exp(-tau), the unbiased scheme of
    docs/LINE_SAMPLING.md.
    """
    wn_out = np.asarray(wn_out, np.float64)
    K = int(K)
    if K <= 1:
        return wn_out
    d = wn_out[1] - wn_out[0] if len(wn_out) > 1 else 1.0
    off = d * ((np.arange(K) + 0.5) / K - 0.5)
    return (wn_out[:, None] + off[None, :]).reshape(-1)


def pressure_grid(
    n_layers: int, p_top: float, p_bottom: float, log: bool = True
) -> np.ndarray:
    """Pressure array [bar], top-first (ascending), log- or
    linear-spaced (reference code/makeP.py:44-47)."""
    if log:
        return np.logspace(np.log10(p_top), np.log10(p_bottom), n_layers)
    return np.linspace(p_top, p_bottom, n_layers)


def write_pressure_file(pressure: np.ndarray, path: str) -> None:
    """Write the 2-column pressure file format (reference
    code/makeP.py:49-59)."""
    with open(path, "w") as f:
        f.write("Layer  P (bar)\n")
        for i, p in enumerate(pressure):
            f.write("{:5d}  {:.4e}\n".format(i + 1, p))


def read_pressure_file(path: str) -> np.ndarray:
    """Read a pressure file (reference code/PT.py:66-97)."""
    pres = []
    with open(path) as f:
        next(f)  # header
        for line in f:
            s = line.strip()
            if s:
                pres.append(float(s.split()[1]))
    return np.asarray(pres, np.float64)


def wavenumber_grid(
    wnlow: float | None = None,
    wnhigh: float | None = None,
    wndelt: float = 1.0,
    wllow: float | None = None,
    wlhigh: float | None = None,
    wlfct: float = 1e-4,
    wnfct: float = 1.0,
) -> np.ndarray:
    """Output wavenumber grid [cm-1], ascending, inclusive of endpoints.

    Either (wnlow, wnhigh) in units of ``wnfct`` cm-1 or (wllow, wlhigh)
    in units of ``wlfct`` cm may be given; wavelength bounds map to
    wn = 1/(wl*wlfct) (reference: transit makesample.c semantics; cfg
    surface in code/makecfg.py:36-52).

    Note on ``wnosamp``: the reference oversamples this grid by a factor
    wnosamp to tabulate Voigt profiles at fine resolution and snap line
    centers to the fine grid (SURVEY.md section 6).  bart_tpu evaluates
    the Voigt function directly at exact line-center offsets, so no
    profile-tabulation grid exists; wnosamp is accepted in configs and
    ignored.  Spectrum-level resolution is instead controlled by the
    ``rtosamp`` config key (the whole pipeline runs at wndelt/rtosamp
    spacing) — the measured error budget of point sampling vs rtosamp
    is in docs/LINE_SAMPLING.md.
    """
    if wnlow is None:
        if wllow is None or wlhigh is None:
            raise ValueError("need either wn or wl bounds")
        wnlow = 1.0 / (wlhigh * wlfct)
        wnhigh = 1.0 / (wllow * wlfct)
    else:
        wnlow = wnlow * wnfct
        wnhigh = wnhigh * wnfct
    n = int(np.floor((wnhigh - wnlow) / wndelt)) + 1
    return wnlow + wndelt * np.arange(n)
