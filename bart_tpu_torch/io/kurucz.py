"""Stellar flux (this package's own copy of ``blackbody_star`` of
bart_tpu/io/kurucz.py; the Kurucz grid reader stays with the JAX
package).
"""

from __future__ import annotations

import numpy as np

from bart_tpu_torch import constants as const

__all__ = ["blackbody_star"]


def blackbody_star(
    wn_grid: np.ndarray, temperature: float
) -> tuple[np.ndarray, np.ndarray]:
    """Blackbody stellar flux per wavenumber [erg s-1 cm-2 cm] on
    ``wn_grid`` [cm-1]: F = pi B_wn(T)."""
    x = const.C2 * wn_grid / temperature
    B = 2.0 * const.H_PLANCK * const.C_LIGHT**2 * wn_grid**3 / np.expm1(x)
    return np.pi * B, np.asarray(wn_grid, np.float64)
