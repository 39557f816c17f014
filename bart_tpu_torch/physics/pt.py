"""Temperature-pressure profiles, batched over chains (port of
bart_tpu/physics/pt.py).

Only the Line et al. (2013) profile (``pt_line``, the demo retrieval's
PT) is ported so far; the other families raise.  Pressure arrays are
top-of-atmosphere first (ascending pressure).
"""

from __future__ import annotations

import math

import torch

from bart_tpu_torch import constants as const

__all__ = ["pt_line", "pt_generator", "n_pt_params"]

_EULER_GAMMA = 0.5772156649015329

#: Number of free parameters per PT model type (bart_tpu/physics/pt.py).
n_pt_params = {
    "iso": 1,
    "line": 5,
    "madhu_noinv": 5,
    "madhu_inv": 6,
    "adiabatic": 3,
    "piette": 8,
}


def _exp1(x: torch.Tensor) -> torch.Tensor:
    """Exponential integral E1(x), x > 0, branch-free fixed work: the
    24-term power series for x <= 1 and the 30-deep bottom-up
    continued fraction for x > 1, both evaluated and selected."""
    xs = torch.where(x > 0, x, torch.ones_like(x))

    xc = torch.clamp(xs, max=1.0)
    term = torch.ones_like(xc)
    acc = torch.zeros_like(xc)
    for k in range(1, 25):
        term = term * xc / k
        acc = acc + (term / k if k % 2 == 1 else -term / k)
    series = -_EULER_GAMMA - torch.log(xc) + acc

    xf = torch.clamp(xs, min=1.0)
    cf = torch.zeros_like(xf)
    for k in range(30, 0, -1):
        cf = k / (1.0 + k / (xf + cf))
    frac = torch.exp(-xf) / (xf + cf)

    return torch.where(x <= 1.0, series, frac)


def _expn2(x: torch.Tensor) -> torch.Tensor:
    """Exponential integral E2(x) = exp(-x) - x E1(x), E2(0) = 1."""
    safe = torch.where(x > 0, x, torch.ones_like(x))
    e2 = torch.exp(-safe) - safe * _exp1(safe)
    return torch.where(x > 0, e2, torch.ones_like(x))


def _xi(gamma: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Line et al. (2013) Eq. 14."""
    gt = gamma * tau
    return (2.0 / 3.0) * (
        1.0
        + (1.0 / gamma) * (1.0 + (0.5 * gt - 1.0) * torch.exp(-gt))
        + gamma * (1.0 - 0.5 * tau**2) * _expn2(gt)
    )


def pt_line(p: torch.Tensor, log_kappa, log_gamma1, log_gamma2, alpha,
            beta, R_star, T_star, T_int, sma, grav,
            T_int_type: str = "const"):
    """Line et al. (2013) Eqs. 13-16, batched: ``p`` [L] bar; the five
    free parameters are [C] tensors; the fixed arguments are floats
    (``R_star``/``sma`` m, ``T_star``/``T_int`` K, ``grav`` cm s-2).
    Returns (T [C, L], valid [C]) — always valid."""
    kappa = (10.0**log_kappa)[:, None]
    gamma1 = (10.0**log_gamma1)[:, None]
    gamma2 = (10.0**log_gamma2)[:, None]
    alpha = alpha[:, None]
    beta = beta[:, None]

    if T_int_type == "thorngren":
        T_eq = math.sqrt(R_star / (2.0 * sma)) * T_star
        F = 4.0 * const.SIGMA_SB * T_eq**4
        T_int = 1.24 * T_eq * math.exp(-((math.log(F) - 0.14) ** 2) / 2.96)

    T_irr = beta * math.sqrt(R_star / (2.0 * sma)) * T_star
    tau = kappa * (p * const.BAR_TO_BARYE) / grav                # [C, L]

    xi1 = _xi(gamma1, tau)
    xi2 = _xi(gamma2, tau)

    T4 = 0.75 * (
        T_int**4 * (2.0 / 3.0 + tau)
        + T_irr**4 * (1.0 - alpha) * xi1
        + T_irr**4 * alpha * xi2
    )
    T = T4**0.25
    return T, torch.ones(T.shape[0], dtype=torch.bool, device=T.device)


def pt_generator(p: torch.Tensor, free_params: torch.Tensor, pt_type: str,
                 pt_args=None):
    """Dispatch a PT model by name: ``free_params`` [C, nPT] ->
    (T [C, L], valid [C]).  ``pt_args`` are the fixed arguments of
    'line': [R_star, T_star, T_int, sma, grav, T_int_type]."""
    if pt_type != "line":
        raise NotImplementedError(
            f"PT model {pt_type!r} is not ported yet (ROADMAP queue 1, "
            "item 3: the other PT families); only 'line' is")
    cols = [free_params[:, i] for i in range(n_pt_params[pt_type])]
    return pt_line(p, *cols, *pt_args)
