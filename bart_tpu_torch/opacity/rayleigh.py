"""Rayleigh scattering extinction (port of bart_tpu/opacity/rayleigh.py).

Mode 1 scales an H2 Rayleigh cross-section by 10^param (the fitted
retrieval parameter); mode 2 ('polar') applies it unscaled.
"""

from __future__ import annotations

import torch

__all__ = ["h2_rayleigh_cross_section", "rayleigh_extinction"]


def h2_rayleigh_cross_section(wn_grid):
    """H2 Rayleigh cross-section [cm^2/molecule] vs wavenumber [cm-1]:
    Dalgarno & Williams (1962), sigma = 8.14e-13/lam^4 + 1.28e-6/lam^6
    + 1.61/lam^8 with lam in Angstrom.  Plain arithmetic, so a numpy
    array (the forward model's host set-up) or a tensor."""
    lam_ang = 1e8 / wn_grid
    il2 = 1.0 / (lam_ang * lam_ang)
    il4 = il2 * il2
    return 8.14e-13 * il4 + 1.28e-6 * il4 * il2 + 1.61 * il4 * il4


def rayleigh_extinction(wn_grid: torch.Tensor, n_h2: torch.Tensor,
                        log_factor, mode: int = 1) -> torch.Tensor:
    """Extinction [..., L, W] in cm-1 from n_h2 [..., L] cm-3.

    mode 1: 10^log_factor x sigma_H2(wn) x n_H2 (``log_factor`` a float
    or a tensor of the batch shape); mode 2: unscaled.
    """
    sig = h2_rayleigh_cross_section(wn_grid)
    factor = torch.as_tensor(log_factor, dtype=n_h2.dtype,
                             device=n_h2.device)
    factor = 10.0 ** factor if mode == 1 else torch.ones_like(factor)
    return factor[..., None, None] * n_h2[..., None] * sig
