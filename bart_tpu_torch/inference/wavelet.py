"""The wavelet (red-noise) likelihood of Carter & Winn (2009), batched
over chains (port of bart_tpu/inference/wavelet.py, MC3's dwt.c).

The residuals are transformed with the orthonormal Daubechies-4 wavelet
pyramid (periodic boundary) and modelled as 1/f^gamma red noise of
amplitude sigma_r plus white noise sigma_w:

    sigma^2_W(m) = sigma_r^2 2^{-gamma m} + sigma_w^2       (octave m)
    sigma^2_S    = sigma_r^2 2^{-gamma} g(1) + sigma_w^2    (scaling)

with octaves m = 1 (coarsest, 1 coefficient) .. M (finest, 2^{M-1}
coefficients) for 2^M samples, and g(1) = 1/(2 ln 2).  With sigma_r = 0
the transform's orthonormality makes it the white Gaussian
log-likelihood.  The pyramid's gather indices and filters are made once
per (length, dtype, device): a captured step copies nothing from the
host.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["dwt_db4", "wavelet_loglike"]

_SQ3 = math.sqrt(3.0)
# Daubechies-4 analysis filters (orthonormal): h, and g[k] = (-1)^k h[3-k]
_H = np.array([1.0 + _SQ3, 3.0 + _SQ3, 3.0 - _SQ3, 1.0 - _SQ3]) / (
    4.0 * math.sqrt(2.0))
_G = np.array([_H[3], -_H[2], _H[1], -_H[0]])


@functools.lru_cache(maxsize=None)
def _pyramid(n: int, dtype: torch.dtype, device: torch.device):
    """(per level of an n-point pyramid, the [N/2, 4] gather indices
    2i + k mod N of its blocks; the filters [4, 2], h then g)."""
    idx = []
    m = n
    while m > 1:
        idx.append((2 * torch.arange(m // 2, device=device)[:, None]
                    + torch.arange(4, device=device)) % m)
        m //= 2
    filters = torch.tensor(np.stack([_H, _G], axis=1), dtype=dtype,
                           device=device)
    return idx, filters


def dwt_db4(x: torch.Tensor) -> list[torch.Tensor]:
    """The full DB4 pyramid of x [..., 2^M] (M >= 1): [detail_M (finest,
    [..., N/2]), ..., detail_1 (coarsest, [..., 1]), scaling ([..., 1])].
    Orthonormal: the sum of squares is preserved."""
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"dwt_db4 needs a power-of-two length, got {n}")
    idx, filters = _pyramid(n, x.dtype, x.device)
    out = []
    a = x
    for blocks in idx:
        ad = torch.matmul(a[..., blocks], filters)          # [..., N/2, 2]
        a = ad[..., 0]
        out.append(ad[..., 1])
    out.append(a)
    return out


def wavelet_loglike(resid: torch.Tensor, gamma, sigma_r, sigma_w,
                    min_sigma: float = 1e-30) -> torch.Tensor:
    """Carter & Winn (2009) log-likelihood [C] of residuals resid [C, n],
    zero-padded to the next power of two as dwt.c does.  ``gamma`` (the
    red-noise index; the scaling coefficient takes g(1), the reference's
    gamma = 1 case), ``sigma_r`` and ``sigma_w`` are [C] tensors, the
    three trailing parameters of the wlike mode."""
    n = resid.shape[-1]
    n2 = 1 << max(math.ceil(math.log2(max(n, 2))), 1)
    if n2 != n:
        resid = torch.nn.functional.pad(resid, (0, n2 - n))

    coeffs = dwt_db4(resid)
    nlev = len(coeffs) - 1                     # = M
    var_w = sigma_w * sigma_w
    var_r = sigma_r * sigma_r

    logl = torch.zeros(resid.shape[:-1], dtype=resid.dtype,
                       device=resid.device)
    # coeffs[0] is the finest octave (m = M), coeffs[nlev - 1] the
    # coarsest (m = 1)
    for i, d in enumerate(coeffs[:-1]):
        m = nlev - i
        var = torch.clamp(var_r * 2.0 ** (-gamma * m) + var_w, min=min_sigma)
        logl = logl - 0.5 * torch.sum(d * d, dim=-1) / var \
            - 0.5 * d.shape[-1] * torch.log(2.0 * math.pi * var)
    g1 = 1.0 / (2.0 * math.log(2.0))
    var_s = torch.clamp(var_r * 2.0 ** (-gamma) * g1 + var_w, min=min_sigma)
    s = coeffs[-1][..., 0]
    return logl - 0.5 * s * s / var_s \
        - 0.5 * torch.log(2.0 * math.pi * var_s)
