"""Planck function in wavenumber units (cgs).

B_wn(T) = 2 h c^2 wn^3 / (exp(h c wn / k T) - 1)
[erg s-1 cm-2 sr-1 / cm-1]  (port of bart_tpu/rt/planck.py).
"""

from __future__ import annotations

import torch

from bart_tpu_torch import constants as const

__all__ = ["planck_wn", "C1"]

C1 = 2.0 * const.H_PLANCK * const.C_LIGHT**2   # 2 h c^2


def planck_wn(wn: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Planck spectral radiance; broadcasts wn against T."""
    x = const.C2 * wn / T
    return C1 * wn**3 / torch.expm1(x)
