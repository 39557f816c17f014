"""Hydrostatic-equilibrium radius integration, batched over chains (port
of bart_tpu/physics/hydro.py).

Per-layer radii anchored at R(p0) = R0 with layer-varying gravity
g(r) = g0 R0^2 / r^2, in the reference's discrete scheme (makeatm
radpress): the anchor formula, then one recurrence down and one up
from the anchor layer.  The recurrences are a Python loop of about
2 L steps, each a few tiny ops on [C] tensors — host-bound on the card
until a later change captures them in a CUDA graph.
"""

from __future__ import annotations

import numpy as np
import torch

from bart_tpu_torch.utils.interp import interp

__all__ = ["radius_profile", "anchor_index"]

# Gas constant N_A * k_B [J mol-1 K-1]: the 0.5 (T/mu) R / g terms then
# come out directly in km.
_R_GAS = 6.02214076e23 * 1.380649e-23


def anchor_index(pressure: np.ndarray, p0: float) -> int:
    """Static index of the layer nearest the reference pressure."""
    return int(np.argmin(np.abs(np.asarray(pressure) - p0)))


def radius_profile(pressure: torch.Tensor, temperature: torch.Tensor,
                   mu: torch.Tensor, p0: float, R0, g0: float,
                   i0: int | None = None) -> torch.Tensor:
    """Radius [C, L] in km, top-first.

    ``pressure`` [L] bar; ``temperature`` and ``mu`` (mean molar mass,
    g/mol) [C, L]; ``p0`` reference pressure [bar]; ``R0`` radius at p0
    [km] (float or [C]); ``g0`` gravity at p0 [m s-2]; ``i0`` the
    anchor layer (from ``pressure``/``p0`` when None).
    """
    if i0 is None:
        i0 = anchor_index(pressure.cpu().numpy(), p0)
    n = pressure.shape[0]
    logp = torch.log10(pressure)
    t_over_mu = temperature / mu                                 # [C, L]

    # interpolated T/mu at p0 in log-pressure space (makeatm.py:212-218)
    tm0 = interp(torch.log10(torch.tensor(p0, dtype=pressure.dtype,
                                          device=pressure.device)),
                 logp, t_over_mu)                                # [C]

    rad_i0 = R0 + 0.5 * (t_over_mu[:, i0] + tm0) * _R_GAS * torch.log(
        p0 / pressure[i0]) / g0
    g_i0 = g0 * R0**2 / rad_i0**2

    lnp = torch.log(pressure)
    dlnp = lnp[1:] - lnp[:-1]                      # dlnp[j-1] = lnp[j] - lnp[j-1]
    rad = [None] * n
    rad[i0] = rad_i0
    rad_prev, g_prev = rad_i0, g_i0
    for j in range(i0 + 1, n):                     # downward (deeper)
        a = 0.5 * (t_over_mu[:, j] + t_over_mu[:, j - 1]) * _R_GAS
        r = rad_prev - a * dlnp[j - 1] / g_prev
        g_prev = g_prev * rad_prev**2 / r**2
        rad[j] = rad_prev = r
    rad_prev, g_prev = rad_i0, g_i0
    for j in range(i0 - 1, -1, -1):                # upward
        a = 0.5 * (t_over_mu[:, j] + t_over_mu[:, j + 1]) * _R_GAS
        r = rad_prev + a * dlnp[j] / g_prev
        g_prev = g_prev * rad_prev**2 / r**2
        rad[j] = rad_prev = r
    return torch.stack(rad, dim=1)
