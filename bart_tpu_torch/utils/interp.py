"""Linear interpolation with ``jnp.interp``'s semantics.

torch has no ``interp``.  This follows jax's own formula
(``searchsorted(side='right')`` bracket clipped to [1, n-1], the
small-``dx`` guard, constant values beyond both ends), so a port that
replaces ``jnp.interp`` reproduces it to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["interp"]

_NP_FLOAT = {torch.float32: np.float32, torch.float64: np.float64}


def interp(x: torch.Tensor, xp: torch.Tensor,
           fp: torch.Tensor) -> torch.Tensor:
    """f(x) by linear interpolation of (xp, fp), ``xp`` [n] ascending.

    Either ``x`` is batched and ``fp`` is [n] (result shaped like
    ``x``), or ``fp`` is [..., n] and ``x`` is [k] or a scalar (result
    [..., k] or [...]).
    """
    scalar = x.dim() == 0
    xq = x.reshape(1) if scalar else x
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, xq.contiguous(), right=True),
                    1, n - 1)
    f_lo = fp[..., i - 1]
    dx = xp[i] - xp[i - 1]
    delta = xq - xp[i - 1]
    np_dt = _NP_FLOAT[xp.dtype]
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np_dt).eps))
    f = torch.where(dx0, f_lo,
                    f_lo + (delta / torch.where(dx0, torch.ones_like(dx), dx))
                    * (fp[..., i] - f_lo))
    f = torch.where(xq < xp[0], fp[..., :1], f)
    f = torch.where(xq > xp[-1], fp[..., -1:], f)
    return f[..., 0] if scalar else f
