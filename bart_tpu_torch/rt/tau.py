"""Vertical optical depth (port of bart_tpu/rt/tau.py:tau_vertical).

Conventions: layers top-first (index 0 = lowest pressure), radius
descending [cm], extinction [cm-1] per (layer, wn).  Leading batch
dimensions (chains) broadcast through.
"""

from __future__ import annotations

import torch

__all__ = ["tau_vertical", "TAU_CLAMP"]

# Saturation value standing in for the reference's `toomuch` cutoff:
# exp(-88) underflows f32, so deeper layers contribute exactly zero.
TAU_CLAMP = 88.0


def tau_vertical(extinction: torch.Tensor,
                 radius_cm: torch.Tensor) -> torch.Tensor:
    """tau[..., layer, wn] from extinction[..., layer, wn] and
    radius_cm[..., layer]:

    tau_l = sum_{k<l} 0.5 (e_k + e_{k+1}) (r_k - r_{k+1}); tau_0 = 0.
    """
    dr = radius_cm[..., :-1] - radius_cm[..., 1:]               # [..., L-1]
    seg = 0.5 * (extinction[..., :-1, :] + extinction[..., 1:, :]) \
        * dr[..., None]
    tau = torch.cumsum(seg, dim=-2)
    return torch.cat([torch.zeros_like(tau[..., :1, :]), tau], dim=-2)
