"""Contribution functions and transmittance (port of bart_tpu/post/cf.py).

Knutson et al. (2008) eq. 2 contribution functions of eclipse geometry,
band-averaged per filter, and the slant-path transmittance exp(-tau) of
transit geometry, from the forward model's own extinction
(``ForwardModel.diagnostics``).  Numpy arrays (or tensors) in, numpy
arrays out, as bart_tpu's; the work runs on ``device``, the card unless
the caller asks for the CPU.  Leading batch dimensions (posterior
samples) broadcast through.
"""

from __future__ import annotations

import numpy as np
import torch

from bart_tpu_torch.device import resolve_device
from bart_tpu_torch.obs.bands import build_band_matrix
from bart_tpu_torch.rt.planck import planck_wn
from bart_tpu_torch.rt.tau import tau_slant, tau_vertical

__all__ = ["contribution_functions", "transmittance", "band_average"]


def contribution_functions(extinction, radius_cm, temperature, pressure_bar,
                           wn, *, device: str | torch.device = "cuda"
                           ) -> np.ndarray:
    """cf[..., layer, wn] = B(T, wn) d(e^-tau)/d(ln p) from extinction
    [..., L, W] cm-1, radius_cm and temperature [..., L], pressure_bar
    [L] and wn [W]: layers top-first, on the layer midpoints padded to L
    (the last row zero), in the extinction's dtype."""
    dev = resolve_device(device)
    ext = torch.as_tensor(extinction, device=dev)
    rad, T, p, wn = (torch.as_tensor(a, dtype=ext.dtype, device=dev)
                     for a in (radius_cm, temperature, pressure_bar, wn))
    tau = tau_vertical(ext, rad)
    B = planck_wn(wn, T[..., None])                            # [..., L, W]
    expt = torch.exp(-tau)
    lnp = torch.log(p)
    dexp = expt[..., :-1, :] - expt[..., 1:, :]   # e^-tau decreasing down
    dlnp = (lnp[:-1] - lnp[1:])[:, None]          # negative
    cf = torch.zeros_like(B)
    cf[..., :-1, :] = 0.5 * (B[..., :-1, :] + B[..., 1:, :]) * dexp / dlnp
    return torch.abs(cf).cpu().numpy()


def transmittance(extinction, radius_cm, *,
                  device: str | torch.device = "cuda") -> np.ndarray:
    """Slant-path transmittance exp(-tau)[..., impact layer, wn] of
    transit geometry from extinction [..., L, W] and radius_cm [..., L]."""
    dev = resolve_device(device)
    ext = torch.as_tensor(extinction, device=dev)
    tau = tau_slant(ext, torch.as_tensor(radius_cm, dtype=ext.dtype,
                                         device=dev))
    return torch.exp(-torch.clamp(tau, max=700.0)).cpu().numpy()


def band_average(quantity_lw, spec_wn: np.ndarray,
                 filters: list[tuple[np.ndarray, np.ndarray]], *,
                 device: str | torch.device = "cuda") -> np.ndarray:
    """The per-layer quantity [..., L, W] averaged over each filter's band
    -> [..., L, nfilt]."""
    dev = resolve_device(device)
    q = torch.as_tensor(quantity_lw, device=dev)
    W = build_band_matrix(spec_wn, filters, device=dev, dtype=q.dtype).weights
    return torch.matmul(q, W.T).cpu().numpy()
