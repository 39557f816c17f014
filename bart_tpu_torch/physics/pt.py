"""Temperature-pressure profiles, batched over chains (port of
bart_tpu/physics/pt.py): the six parametric profiles of the reference
BART.

- ``pt_inversion``    Madhusudhan & Seager (2009), inverted, 6 params
- ``pt_no_inversion`` Madhusudhan & Seager (2009), non-inverted, 5 params
- ``pt_line``         Line et al. (2013), 5 params (+ fixed arguments)
- ``pt_iso``          isothermal, 1 param
- ``pt_adiabatic``    naive adiabat, 3 params
- ``pt_piette``       Piette & Madhusudhan (2020), 8 params

Each takes the pressure grid ``p`` [L] bar (top-of-atmosphere first,
ascending, log-uniform) and its free parameters as [C] tensors, and
returns (T [C, L], valid [C]): a non-physical draw is flagged, not
raised, and its T is still computed.  The Gaussian smoothing of the
Madhusudhan and Piette profiles (scipy's gaussian_filter1d with
mode='nearest') is one [L, L] matrix product, the edge replication
folded into the first and last columns, the matrix made once per grid
and device: no convolution whose algorithm a library picks per call,
and nothing in a call that reads a device value on the host.
"""

from __future__ import annotations

import functools
import math
import weakref

import torch

from bart_tpu_torch import constants as const
from bart_tpu_torch.utils.interp import interp

__all__ = ["gaussian_smooth", "pt_inversion", "pt_no_inversion", "pt_line",
           "pt_iso", "pt_adiabatic", "pt_piette", "PT_MODELS",
           "pt_generator", "n_pt_params"]

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


def _smoothing_matrix(kernel: torch.Tensor, L: int) -> torch.Tensor:
    """[L, L] matrix M with (x @ M.T)[i] = sum_t kernel[t] x[clamp(i + t)]
    for t in [-R, R]: correlation with the 2R+1 taps of ``kernel`` on the
    edge-replicated series (gaussian_filter1d's mode='nearest').  Built
    as a sum of one-hot rows, so it has the same bits on every device."""
    R = (kernel.shape[0] - 1) // 2
    dev = kernel.device
    idx = torch.clamp(torch.arange(L, device=dev)[:, None]
                      + torch.arange(-R, R + 1, device=dev), 0, L - 1)
    onehot = torch.nn.functional.one_hot(idx, L).to(kernel.dtype)
    return torch.sum(kernel[None, :, None] * onehot, dim=1)


@functools.lru_cache(maxsize=None)
def _gaussian_matrix(L: int, sigma: float, truncate: float,
                     dtype: torch.dtype, device: torch.device):
    """gaussian_smooth's matrix, made once per (L, sigma, dtype, device):
    the normalised kernel of radius int(truncate sigma + 0.5)."""
    radius = int(truncate * sigma + 0.5)
    t = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    kernel = torch.exp(-0.5 * (t / sigma) ** 2)
    return _smoothing_matrix(kernel / torch.sum(kernel), L)


def gaussian_smooth(x: torch.Tensor, sigma, truncate: float = 4.0
                    ) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter1d(mode='nearest') along the last
    axis of ``x`` [..., L]; ``sigma`` a Python float (it fixes the
    radius).  One matrix product: on the card it has the same bits in a
    CUDA graph as outside one."""
    sigma = float(sigma)
    if sigma <= 0 or int(truncate * sigma + 0.5) == 0:
        return x
    M = _gaussian_matrix(x.shape[-1], sigma, float(truncate), x.dtype,
                         x.device)
    return torch.matmul(x, M.T)


def _region_fill(p, T_l1, T_mid_pos, T_mid_neg, T_l3, p1, p2, p3):
    """Per-layer temperature by pressure region (inversion case); the
    boundaries p1 < p2 < p3 are [C, 1], the candidates [C, L]."""
    return torch.where(p < p1, T_l1, torch.where(
        p < p2, T_mid_pos, torch.where(p < p3, T_mid_neg, T_l3)))


def pt_inversion(p: torch.Tensor, a1, a2, p1, p2, p3, T3,
                 smooth: bool = True):
    """Madhusudhan & Seager (2009) Eq. 2, thermal-inversion case: the
    exponential factors a1, a2, the boundary pressures p1 < p2 < p3 [bar]
    and the deep temperature T3, each [C].  Returns (T [C, L], valid
    [C]); valid needs T0..T3 > 0 and ordered pressures."""
    p0 = torch.min(p)
    T2 = T3 - (torch.log(p3 / p2) / a2) ** 2
    T0 = T2 + (torch.log(p1 / p2) / -a2) ** 2 - (torch.log(p1 / p0) / a1) ** 2
    T1 = T0 + (torch.log(p1 / p0) / a1) ** 2

    a1c, a2c, p2c = a1[:, None], a2[:, None], p2[:, None]
    T_l1 = (torch.log(p / p0) / a1c) ** 2 + T0[:, None]
    T_l2_pos = (torch.log(p / p2c) / -a2c) ** 2 + T2[:, None]
    T_l2_neg = (torch.log(p / p2c) / a2c) ** 2 + T2[:, None]
    T_l3 = T3[:, None].expand_as(T_l1)

    T = _region_fill(p, T_l1, T_l2_pos, T_l2_neg, T_l3, p1[:, None], p2c,
                     p3[:, None])
    valid = (T0 > 0) & (T1 > 0) & (T2 > 0) & (T3 > 0) & (p1 < p2) & (p2 < p3)
    if smooth:
        T = gaussian_smooth(T, 4.0)
    return T, valid


def pt_no_inversion(p: torch.Tensor, a1, a2, p1, p3, T3,
                    smooth: bool = True):
    """Madhusudhan & Seager (2009) Eq. 2, non-inversion case (a1, a2, p1,
    p3, T3, each [C]).  Returns (T [C, L], valid [C])."""
    p0 = torch.min(p)
    T1 = T3 - (torch.log(p3 / p1) / a2) ** 2
    T0 = T1 - (torch.log(p1 / p0) / a1) ** 2

    p1c = p1[:, None]
    T_l1 = (torch.log(p / p0) / a1[:, None]) ** 2 + T0[:, None]
    T_l2 = (torch.log(p / p1c) / a2[:, None]) ** 2 + T1[:, None]
    T_l3 = T3[:, None].expand_as(T_l1)

    T = torch.where(p < p1c, T_l1, torch.where(p < p3[:, None], T_l2, T_l3))
    valid = (T0 > 0) & (T1 > 0) & (T3 > 0) & (p1 < p3)
    if smooth:
        T = gaussian_smooth(T, 4.0)
    return T, valid


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

    # both streams in one pass of _xi's fixed-work series and fraction
    xi1, xi2 = _xi(torch.stack([gamma1, gamma2]), tau)

    T4 = 0.75 * (
        T_int**4 * (2.0 / 3.0 + tau)
        + T_irr**4 * (1.0 - alpha) * xi1
        + T_irr**4 * alpha * xi2
    )
    T = T4**0.25
    return T, torch.ones(T.shape[0], dtype=torch.bool, device=T.device)


def pt_iso(p: torch.Tensor, T):
    """Isothermal profile at T [C]."""
    T = T[:, None] + torch.zeros_like(p)
    return T, torch.ones(T.shape[0], dtype=torch.bool, device=T.device)


def pt_adiabatic(p: torch.Tensor, T0, gamma, logp0):
    """Naive adiabat T0 / (1 + (gamma - 1) / gamma ln(p0 / p)) with
    p0 = 10^logp0 bar; valid where T > 0 in every layer."""
    p0 = 10.0 ** logp0
    T = T0[:, None] / (1.0 + ((gamma - 1.0) / gamma)[:, None]
                       * torch.log(p0[:, None] / p))
    return T, torch.all(T > 0, dim=1)


#: pressures [bar] of Piette's anchors between the top and the bottom
_PIETTE_ANCHORS = (0.01, 0.1, 1.0, 3.2, 10.0, 32.0)
# the pressure grids seen by pt_piette -> (log10 p, the anchors' log10 p,
# the smoothing matrix), keyed by the grid tensor's id while it lives
_PIETTE_GRIDS: dict[int, tuple] = {}


def _traced_sigma_matrix(dlp: torch.Tensor, L: int, max_radius: int = 64):
    """The smoothing matrix of sigma = 0.3 / dlp layers, ``dlp`` a device
    scalar: a 2 max_radius + 1 tap kernel masked to the radius
    floor(4 sigma + 0.5), as scipy's for any radius <= max_radius."""
    sigma = 0.3 / dlp
    radius_f = torch.floor(4.0 * sigma + 0.5)
    t = torch.arange(-max_radius, max_radius + 1, dtype=dlp.dtype,
                     device=dlp.device)
    kernel = torch.exp(-0.5 * (t / sigma) ** 2)
    kernel = torch.where(torch.abs(t) <= radius_f, kernel,
                         torch.zeros_like(kernel))
    return _smoothing_matrix(kernel / torch.sum(kernel), L)


def _smooth_traced_sigma(x: torch.Tensor, dlp: torch.Tensor,
                         max_radius: int = 64) -> torch.Tensor:
    """Gaussian smoothing of x [..., L] with sigma = 0.3 / dlp, ``dlp`` a
    device scalar (bart_tpu's traced-sigma smoothing)."""
    M = _traced_sigma_matrix(dlp, x.shape[-1], max_radius)
    return torch.matmul(x, M.T)


def _piette_grid(p: torch.Tensor):
    """(log10 p [L], the eight anchors' log10 p, the smoothing matrix of
    sigma = 0.3 dex) of the grid ``p``: they depend on the grid alone, so
    they are made on its device at the first call with this tensor and
    kept while it lives.  Made by device operations only: nothing is read
    on the host."""
    key = id(p)
    hit = _PIETTE_GRIDS.get(key)
    if hit is not None and hit[0]() is p:
        return hit[1]
    logp = torch.log10(p)
    idx = torch.stack(
        [torch.argmin(p)]
        + [torch.argmin(torch.abs(p - v)) for v in _PIETTE_ANCHORS]
        + [torch.argmax(p)])
    # sigma = 0.3 dex in layers of the (log-uniform) grid
    dlp = torch.abs(logp[0] - logp[1])
    grid = (logp, logp[idx], _traced_sigma_matrix(dlp, p.shape[0]))
    _PIETTE_GRIDS[key] = (
        weakref.ref(p, lambda _, k=key: _PIETTE_GRIDS.pop(k, None)), grid)
    return grid


def pt_piette(p: torch.Tensor, T0, dTbot_32, dT32_10, dT10_0, dT0_1,
              dT1_01, dT01_001, dT001_top):
    """Piette & Madhusudhan (2020) difference-parameterised profile: T0 at
    3.2 bar and seven temperature differences between the layers nearest
    {top, 0.01, 0.1, 1, 3.2, 10, 32 bar, bottom}, linear in log10 p
    between them, then smoothed with sigma = 0.3 dex.  Each parameter
    [C]; returns (T [C, L], valid [C]), valid where T > 0 throughout."""
    logp, anchor_lp, M = _piette_grid(p)
    T_10 = T0 + dT10_0
    T_32 = T_10 + dT32_10
    T_bot = T_32 + dTbot_32
    T_1 = T0 - dT0_1
    T_01 = T_1 - dT1_01
    T_001 = T_01 - dT01_001
    T_top = T_001 - dT001_top
    anchor_T = torch.stack([T_top, T_001, T_01, T_1, T0, T_10, T_32, T_bot],
                           dim=1)                                 # [C, 8]
    T = torch.matmul(interp(logp, anchor_lp, anchor_T), M.T)
    return T, torch.all(T > 0, dim=1)


PT_MODELS = {
    "iso": pt_iso,
    "line": pt_line,
    "madhu_noinv": pt_no_inversion,
    "madhu_inv": pt_inversion,
    "adiabatic": pt_adiabatic,
    "piette": pt_piette,
}


def pt_generator(p: torch.Tensor, free_params: torch.Tensor, pt_type: str,
                 pt_args=None):
    """Dispatch a PT model by name: ``free_params`` [C, nPT] ->
    (T [C, L], valid [C]).  ``pt_args`` are the fixed arguments, of
    'line' only: [R_star, T_star, T_int, sma, grav, T_int_type]."""
    fn = PT_MODELS[pt_type]
    cols = [free_params[:, i] for i in range(n_pt_params[pt_type])]
    if pt_args is not None:
        return fn(p, *cols, *pt_args)
    return fn(p, *cols)
