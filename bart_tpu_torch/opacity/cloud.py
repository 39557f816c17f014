"""Gray cloud models (port of bart_tpu/opacity/cloud.py).

* ``cloud_deck_extinction``: an opaque gray deck below a top pressure,
  a steep but smooth ramp in log-pressure (the fitted cloudtop).
* ``extended_cloud_extinction``: a linear ramp in radius between a
  cloud top and bottom (the static cloudrad/cloudext flags).
* ``gray_extinction``: constant extinction between two pressures.
"""

from __future__ import annotations

import torch

__all__ = ["cloud_deck_extinction", "extended_cloud_extinction",
           "gray_extinction"]

# Extinction amplitude inside the opaque deck [cm-1]: tau across one
# layer far beyond the clamp for any realistic layer thickness.
_DECK_KAPPA = 1.0e2
# Transition width of the deck top in dex of pressure.
_DECK_WIDTH_DEX = 0.05


def cloud_deck_extinction(pressure_bar: torch.Tensor, log10_p_top,
                          nwave: int) -> torch.Tensor:
    """Opaque-deck extinction [..., L, nwave] in cm-1.

    ``log10_p_top`` is log10 of the cloud-top pressure in bar, a float
    or a tensor of the batch shape [...].  Layers below the top get
    _DECK_KAPPA through a sigmoid ramp of width _DECK_WIDTH_DEX.
    """
    top = torch.as_tensor(log10_p_top, dtype=pressure_bar.dtype,
                          device=pressure_bar.device)
    x = (torch.log10(pressure_bar) - top[..., None]) / _DECK_WIDTH_DEX
    profile = _DECK_KAPPA * torch.sigmoid(x)                   # [..., L]
    return profile[..., None].expand(*profile.shape, nwave)


def extended_cloud_extinction(rad_km: torch.Tensor, r_top_km: float,
                              r_bot_km: float, kappa: float) -> torch.Tensor:
    """Extended gray cloud per layer [..., L] in cm-1: a linear ramp from
    0 at the cloud-top radius to ``kappa`` at the cloud-bottom radius,
    ``kappa`` below."""
    ramp = (r_top_km - rad_km) / max(r_top_km - r_bot_km, 1e-12)
    return kappa * torch.clamp(ramp, 0.0, 1.0)


def gray_extinction(pressure_bar: torch.Tensor, p_lo_bar: float,
                    p_hi_bar: float, kappa: float,
                    nwave: int) -> torch.Tensor:
    """Constant gray extinction ``kappa`` [cm-1] between two pressures,
    [L, nwave]."""
    inside = (pressure_bar >= p_lo_bar) & (pressure_bar <= p_hi_bar)
    profile = torch.where(inside, torch.full_like(pressure_bar, kappa),
                          torch.zeros_like(pressure_bar))
    return profile[:, None].expand(pressure_bar.shape[0], nwave)
