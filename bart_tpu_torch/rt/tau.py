"""Optical depth along vertical and slant rays (port of
bart_tpu/rt/tau.py).

Conventions: layers top-first (index 0 = lowest pressure), radius
descending [cm], extinction [cm-1] per (layer, wn).  Leading batch
dimensions (chains) broadcast through.
"""

from __future__ import annotations

import torch

__all__ = ["tau_vertical", "tau_slant", "slant_chords", "TAU_CLAMP"]

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


def slant_chords(radius_cm: torch.Tensor) -> torch.Tensor:
    """Chord coordinates x[..., i, k] = sqrt(r_k^2 - b_i^2), 0 where
    r_k <= b_i, with impact parameters b_i = r_i (descending radii).

    Factored as sqrt((d_k - d_i)(r_k + r_i)) with d = r - r[-1]: the
    only subtraction is between the small anchored deltas, exactly
    rounded in float32 and exactly zero on the diagonal.  The direct
    r_k^2 - r_i^2 loses half the float32 mantissa and can leave a
    ~14 km spurious chord on the diagonal.
    """
    delta = radius_cm - radius_cm[..., -1:]
    h = torch.clamp(delta[..., None, :] - delta[..., :, None], min=0.0)
    s = radius_cm[..., None, :] + radius_cm[..., :, None]
    return torch.sqrt(h * s)


def tau_slant(extinction: torch.Tensor,
              radius_cm: torch.Tensor) -> torch.Tensor:
    """Slant optical depth per impact parameter tau[..., b, wn], one ray
    grazing each layer: 2 sum_k dx[b, k] emid[k], the trapezoid over the
    chord coordinate of each ray."""
    x = slant_chords(radius_cm)
    dx = x[..., :, :-1] - x[..., :, 1:]                         # [..., L, L-1]
    emid = 0.5 * (extinction[..., :-1, :] + extinction[..., 1:, :])
    return 2.0 * torch.matmul(dx, emid)
