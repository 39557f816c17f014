"""Transit (transmission) geometry, batched over chains (port of
bart_tpu/rt/transit_geom.py).

The in-transit flux deficit

    depth(wn) = [ pi R_deep^2 + 2 pi int_{R_deep}^{R_top}
                  (1 - e^{-tau(b, wn)}) b db ] / (pi R_star^2)

with the planet below the deepest modelled layer opaque.
"""

from __future__ import annotations

import torch

from bart_tpu_torch.rt.tau import TAU_CLAMP, slant_chords, tau_slant

__all__ = ["slant_geometry", "transit_depth"]


def slant_geometry(radius_cm: torch.Tensor):
    """The slant path and the annulus integral as two operators of the
    descending radii [..., L] alone:

        tau[..., b, wn] = G @ ext                        (== tau_slant)
        depth[..., wn]  = (r_deep^2 + wgt @ (1 - e^{-min(tau, 88)}))
                          / r_star^2                     (== transit_depth)

    G [..., L, L] spreads tau_slant's trapezoid over segment lengths dx
    onto per-layer weights (dx[i, j] + dx[i, j-1]); wgt [..., L] = 2 b c
    folds the impact-parameter trapezoid weights c in.  G is exactly
    lower-triangular (G[b, l] = 0 for l > b: the chords of layers below
    an impact parameter are clamped to 0), which the fused transit
    kernel relies on.
    """
    x = slant_chords(radius_cm)
    dx = x[..., :, :-1] - x[..., :, 1:]                          # [..., L, L-1]
    zc = torch.zeros_like(dx[..., :1])
    G = torch.cat([dx, zc], dim=-1) + torch.cat([zc, dx], dim=-1)
    delta = radius_cm - radius_cm[..., -1:]
    db = delta[..., :-1] - delta[..., 1:]                        # [..., L-1] > 0
    z1 = torch.zeros_like(db[..., :1])
    c = 0.5 * (torch.cat([db, z1], dim=-1) + torch.cat([z1, db], dim=-1))
    return G, 2.0 * c * radius_cm


def transit_depth(extinction: torch.Tensor, radius_cm: torch.Tensor,
                  r_star_cm: float) -> torch.Tensor:
    """Transit depth depth[..., wn] from extinction [..., L, wn] and
    descending radii [..., L] in cm (the unfused reference)."""
    tau = torch.clamp(tau_slant(extinction, radius_cm), max=TAU_CLAMP)
    absorb = 1.0 - torch.exp(-tau)
    integrand = absorb * radius_cm[..., None]
    delta = radius_cm - radius_cm[..., -1:]
    db = delta[..., :-1] - delta[..., 1:]
    ann = torch.sum(0.5 * (integrand[..., :-1, :] + integrand[..., 1:, :])
                    * db[..., None], dim=-2)
    area = radius_cm[..., -1:] ** 2 + 2.0 * ann
    return area / r_star_cm ** 2
