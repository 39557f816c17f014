"""Voigt line profile via the Faddeeva function (port of
bart_tpu/physics/voigt.py).

Weideman (1994, SIAM J. Numer. Anal. 31, 1497) rational series for
w(z) = exp(-z^2) erfc(-iz), Im(z) >= 0, with N = 32 terms, evaluated
in real arithmetic (complex operations expanded by hand) exactly as
the reference writes it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["faddeeva_real", "voigt_profile", "doppler_hwhm",
           "lorentz_hwhm_collision", "SQRT_LN2", "SQRT_PI"]

SQRT_LN2 = float(np.sqrt(np.log(2.0)))
SQRT_PI = float(np.sqrt(np.pi))
_INV_SQRT_PI = float(1.0 / np.sqrt(np.pi))
_C_LIGHT = 2.99792458e10
_K_B = 1.380649e-16


@functools.lru_cache(maxsize=None)
def _weideman_coeffs(n: int) -> tuple[float, tuple[float, ...]]:
    """Weideman (1994) rational-series coefficients (host precompute)."""
    m = 2 * n
    m2 = 2 * m
    k = np.arange(-m + 1, m)
    ell = np.sqrt(n / np.sqrt(2.0))
    theta = k * np.pi / m
    t = ell * np.tan(theta / 2.0)
    f = np.exp(-(t**2)) * (ell**2 + t**2)
    f = np.append(0.0, f)
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / m2
    a = np.flipud(a[1 : n + 1])
    return float(ell), tuple(float(v) for v in a)


def faddeeva_real(x: torch.Tensor, y: torch.Tensor,
                  n_terms: int = 32) -> torch.Tensor:
    """Re[w(x + i y)] for y >= 0, branch-free; broadcasts x against y."""
    ell, a = _weideman_coeffs(n_terms)

    # t = (L + i z)/(L - i z), z = x + i y: num = (L - y) + i x,
    # den = (L + y) - i x
    dr = ell + y
    di = -x
    d2 = dr * dr + di * di
    inv_d2 = 1.0 / d2
    nr = ell - y
    ni = x
    tr = (nr * dr + ni * di) * inv_d2
    ti = (ni * dr - nr * di) * inv_d2

    # Horner over complex t for p = sum a_k t^(n-1-k):
    #   pr' = pr tr - pi ti + a_k,  pi' = pr ti + pi tr
    # into preallocated buffers (eager torch would otherwise allocate
    # seven full-size temporaries per term), rounding each product as
    # written: no fused multiply-adds
    pr = torch.full_like(tr, a[0])
    pi = torch.zeros_like(tr)
    spare = torch.empty_like(tr)
    tmp = torch.empty_like(tr)
    for k in range(1, n_terms):
        torch.mul(pr, tr, out=spare)
        spare.sub_(torch.mul(pi, ti, out=tmp)).add_(a[k])
        torch.mul(pr, ti, out=tmp)
        pi.mul_(tr).add_(tmp)
        pr, spare = spare, pr

    # w = 2 p / (L - i z)^2 + (1/sqrt(pi)) / (L - i z)
    inv_r = dr * inv_d2
    inv_i = -di * inv_d2
    sq_r = inv_r * inv_r - inv_i * inv_i
    sq_i = 2.0 * inv_r * inv_i
    return 2.0 * (pr * sq_r - pi * sq_i) + _INV_SQRT_PI * inv_r


def voigt_profile(dx: torch.Tensor, sigma: torch.Tensor,
                  gamma: torch.Tensor) -> torch.Tensor:
    """Normalised Voigt profile V(dx; sigma, gamma) [1/units of dx]: the
    offset from line center ``dx``, the Gaussian standard deviation
    ``sigma`` and the Lorentzian HWHM ``gamma`` broadcast together
    (scipy.special.voigt_profile's convention)."""
    inv = 1.0 / (sigma * np.sqrt(2.0))
    return faddeeva_real(dx * inv, gamma * inv) * inv * _INV_SQRT_PI


def doppler_hwhm(wn0, temperature, mass_g):
    """Doppler HWHM [cm-1]: wn0/c sqrt(2 ln2 kT/m); ``temperature`` a
    tensor, ``mass_g`` in g."""
    return wn0 / _C_LIGHT * torch.sqrt(
        2.0 * np.log(2.0) * _K_B * temperature / mass_g)


def lorentz_hwhm_collision(pressure_barye, temperature, mass_g, diam_cm,
                           q_partners, mass_partners_g, diam_partners_cm):
    """Collision-theory Lorentz HWHM [cm-1] of one absorber against
    perturbing partners (leading partner axis summed), all cgs:

      HWHM = sqrt(2) / (c sqrt(pi k T)) p
             sum_j q_j ((d + d_j)/2)^2 sqrt(1/m + 1/m_j)
    """
    coll = torch.sum(
        q_partners
        * ((diam_cm + diam_partners_cm) * 0.5) ** 2
        * torch.sqrt(1.0 / mass_g + 1.0 / mass_partners_g),
        dim=0,
    )
    return (np.sqrt(2.0) / _C_LIGHT
            / torch.sqrt(temperature * np.pi * _K_B)
            * pressure_barye * coll)
