"""Eclipse (dayside emission) spectrum synthesis — the unfused reference
math behind the fused kernel (port of bart_tpu/rt/eclipse.py).

Emergent intensity per (wn, mu) of a plane-parallel, non-scattering
atmosphere

    I(mu) = sum_layers B(T_l) e^{-tau_l/mu} dtau_l/mu
            + B(T_bot) e^{-tau_bot/mu}

with the boundary term making the isothermal limit exact (F = pi B),
then F = 2 pi sum_i w_i mu_i I(mu_i).  Leading batch dimensions
(chains) broadcast through every function.
"""

from __future__ import annotations

import numpy as np
import torch

from bart_tpu_torch.rt.planck import planck_wn
from bart_tpu_torch.rt.tau import TAU_CLAMP

__all__ = ["eclipse_intensity", "eclipse_flux", "raygrid_weights",
           "expsum_weights"]


# Exponential-sum quadrature of E3(tau) = sum_m a_m e^{-m tau} (nodes
# mu_m = 1/m); coefficients and their derivation as in
# bart_tpu/rt/eclipse.py:_EXPSUM_A (sum a_m = 1/2 exactly, so the
# isothermal limit is kept).
_EXPSUM_A = {
    4: (1.61335934078130794e-01, 4.88550756927762009e-01,
        -4.07055615912562785e-01, 2.57168924906669982e-01),
    6: (1.47012763339087416e-01, 7.19438102862494544e-01,
        -1.55504909139625247e+00, 2.68410535882847823e+00,
        -2.29259268782271342e+00, 7.97085554188905698e-01),
    8: (1.37265647678806169e-01, 9.92469095570294391e-01,
        -4.02223479276460694e+00, 1.30181210122982343e+01,
        -2.51569208626538448e+01, 2.83933133356001832e+01,
        -1.71813168685346263e+01, 4.31930343280555995e+00),
}


def expsum_weights(n: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """(mu, w) of the exponential-sum quadrature: mu = [1, 1/2, ...,
    1/n] with w_m mu_m = a_m.  Enables the fused kernel's one-exponential
    powers mode."""
    if n not in _EXPSUM_A:
        raise ValueError(
            f"expsum quadrature supports n in {sorted(_EXPSUM_A)}, "
            f"got {n}")
    a = np.asarray(_EXPSUM_A[n], np.float64)
    m = np.arange(1, n + 1, dtype=np.float64)
    return 1.0 / m, a * m


def raygrid_weights(angles_deg) -> tuple[np.ndarray, np.ndarray]:
    """Quadrature (mu, w) for F = 2 pi sum w_i I(mu_i) mu_i from ray
    angles in degrees: trapezoid in mu over [0, 1], the grid augmented
    with the mu=0 endpoint (where I mu -> 0)."""
    mu = np.sort(np.cos(np.deg2rad(np.asarray(angles_deg, np.float64))))
    grid = np.concatenate([[0.0], mu])
    tw = np.zeros(len(grid))
    tw[0] = 0.5 * (grid[1] - grid[0])
    tw[-1] = 0.5 * (grid[-1] - grid[-2])
    tw[1:-1] = 0.5 * (grid[2:] - grid[:-2])
    return mu, tw[1:]


def eclipse_intensity(tau: torch.Tensor, temperature: torch.Tensor,
                      wn: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """I[..., mu, wn] from tau[..., layer, wn] and T[..., layer].

    Summation-by-parts form (one consumer of the attenuation tensor):
    I = sum_l e^{-tau_l/mu} C_l with C_0 = Bmid_0,
    C_l = Bmid_l - Bmid_{l-1}, C_{L-1} = B_{L-1} - Bmid_{L-2}.
    """
    tau = torch.clamp(tau, max=TAU_CLAMP)
    B = planck_wn(wn, temperature[..., None])                   # [..., L, W]
    atten = torch.exp(tau[..., None, :, :]
                      * (-1.0 / mu)[:, None, None])             # [..., M, L, W]
    if B.shape[-2] == 1:
        return B * atten[..., 0, :]
    Bmid = 0.5 * (B[..., 1:, :] + B[..., :-1, :])
    C = torch.cat([Bmid[..., :1, :], Bmid[..., 1:, :] - Bmid[..., :-1, :],
                   B[..., -1:, :] - Bmid[..., -1:, :]], dim=-2)
    return torch.sum(atten * C[..., None, :, :], dim=-2)


def eclipse_flux(tau: torch.Tensor, temperature: torch.Tensor,
                 wn: torch.Tensor, mu: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """Hemispheric flux F[..., wn] = 2 pi sum_i w_i I(mu_i) mu_i
    [erg s-1 cm-2 / cm-1]."""
    I = eclipse_intensity(tau, temperature, wn, mu)
    return 2.0 * np.pi * torch.sum((weights * mu)[:, None] * I, dim=-2)
