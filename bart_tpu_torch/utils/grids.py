"""Sampling grids: pressure layers and the folded fine wavenumber grid
(this package's own copy of ``pressure_grid`` and ``folded_fine_grid``
of bart_tpu/utils/grids.py).
"""

from __future__ import annotations

import numpy as np

__all__ = ["pressure_grid", "folded_fine_grid"]


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
