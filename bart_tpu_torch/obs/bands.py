"""Band integration as one dense matmul (port of bart_tpu/obs/bands.py).

W[nfilt, nwave] is precomputed on the host so that bandflux =
spectrum @ W.T equals the reference's trapz(spectrum * nifilter,
specwn[band]) per filter, with the filter normalisation and, for
eclipse geometry, the stellar-flux division and (Rp/Rs)^2 folded in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bart_tpu_torch.device import resolve_device

__all__ = ["BandMatrix", "build_band_matrix", "band_integrate"]


@dataclasses.dataclass
class BandMatrix:
    """Dense band-integration operator."""

    weights: torch.Tensor     # [nfilt, nwave]
    nfilters: int


def _trapz_weights(x: np.ndarray) -> np.ndarray:
    w = np.zeros_like(x)
    w[0] = 0.5 * (x[1] - x[0])
    w[-1] = 0.5 * (x[-1] - x[-2])
    w[1:-1] = 0.5 * (x[2:] - x[:-2])
    return w


def build_band_matrix(spec_wn: np.ndarray,
                      filters: list[tuple[np.ndarray, np.ndarray]],
                      star_flux: np.ndarray | None = None,
                      rprs: float | None = None, *,
                      device: str | torch.device = "cuda",
                      dtype: torch.dtype = torch.float64) -> BandMatrix:
    """Precompute W on the host and put it on ``device`` (the card unless
    the caller asks for the CPU).  ``filters`` are (wn, transmission)
    ascending pairs; with ``star_flux`` (on spec_wn) and ``rprs`` the
    eclipse conversion spec/star * rprs^2 is folded in.  Raises
    ValueError if a filter reaches beyond the spectrum grid."""
    device = resolve_device(device)
    spec_wn = np.asarray(spec_wn, np.float64)
    W = np.zeros((len(filters), len(spec_wn)))
    for i, (fwn, ftr) in enumerate(filters):
        if fwn[0] < spec_wn[0] or fwn[-1] > spec_wn[-1]:
            raise ValueError(
                f"Wavenumber array ({spec_wn[0]:.2f} - {spec_wn[-1]:.2f} "
                f"cm-1) does not cover the filter[{i}] range "
                f"({fwn[0]:.2f} - {fwn[-1]:.2f} cm-1)."
            )
        idx = np.where((spec_wn < fwn[-1]) & (spec_wn > fwn[0]))[0]
        x = spec_wn[idx]
        ifilter = np.interp(x, fwn, ftr)
        tw = _trapz_weights(x)
        row = ifilter / np.sum(ifilter * tw) * tw
        if star_flux is not None:
            row = row * (rprs**2) / np.asarray(star_flux)[idx]
        W[i, idx] = row
    return BandMatrix(weights=torch.as_tensor(W, dtype=dtype, device=device),
                      nfilters=len(filters))


def band_integrate(bands, spectrum: torch.Tensor) -> torch.Tensor:
    """bandflux[..., nfilt] = spectrum[..., nwave] @ W.T.  ``bands`` is
    a BandMatrix or the raw weight tensor.  Full float32 on the card:
    resolve_device keeps TF32 off."""
    w = bands.weights if isinstance(bands, BandMatrix) else bands
    return torch.matmul(spectrum, w.T)
