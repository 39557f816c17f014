"""Line-by-line cross-sections on wavenumber tiles (port of
bart_tpu/opacity/extinction.py).

Lines are bucketed onto tiles of the output grid on the host, once
(``tile_lines_bucketed``); the Voigt profile is then evaluated directly
for every (condition, line, gridpoint) triple as plain torch ops
(``cross_section_tiles``).  Eager torch materialises each
[cond, tile, line, point] temporary, so the caller bounds the batch by
bytes (opacity.grid.build_opacity_grid).

Line strength follows the HITRAN convention

  S(T) = S296 Q(296)/Q(T) exp(-c2 E''/T)/exp(-c2 E''/296)
              (1-exp(-c2 wn0/T))/(1-exp(-c2 wn0/296)).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from bart_tpu_torch import constants as const
from bart_tpu_torch.device import resolve_device
from bart_tpu_torch.linelist.hitran import TREF, LineList
from bart_tpu_torch.linelist.molecules import get_molecule
from bart_tpu_torch.linelist.tips import partition_function
from bart_tpu_torch.physics.voigt import (
    doppler_hwhm, faddeeva_real, lorentz_hwhm_collision,
)

__all__ = ["LineTiles", "BroadeningSpec", "tile_lines_bucketed",
           "cross_section_tiles", "wing_cutoff"]

_SQRT_2LN2 = float(np.sqrt(2.0 * np.log(2.0)))
_INV_SQRT_PI = float(1.0 / np.sqrt(np.pi))
_ATM_BARYE = 1.01325e6  # 1 atm in barye


@dataclasses.dataclass(frozen=True)
class BroadeningSpec:
    """Lorentz broadening: 'collision' (collision theory against an
    H2/He bath of fractions q_h2/q_he) or 'air' (HITRAN air widths)."""

    mode: str = "collision"
    q_h2: float = 0.85
    q_he: float = 0.15

    def gamma_lorentz(self, lines: "LineTiles", mass_g: float,
                      diam_cm: float, T: torch.Tensor,
                      p_barye: torch.Tensor) -> torch.Tensor:
        """Lorentz HWHM [cm-1] for conditions T, p [cond]:
        [cond, 1, 1] ('collision') or [cond, nt, L] ('air')."""
        if self.mode == "collision":
            h2 = get_molecule("H2")
            he = get_molecule("He")
            coll = (
                self.q_h2
                * ((diam_cm + h2.diameter * 1e-8) * 0.5) ** 2
                * np.sqrt(1.0 / mass_g + 1.0 / (h2.mass * const.AMU))
                + self.q_he
                * ((diam_cm + he.diameter * 1e-8) * 0.5) ** 2
                * np.sqrt(1.0 / mass_g + 1.0 / (he.mass * const.AMU))
            )
            gamma = (np.sqrt(2.0) / const.C_LIGHT
                     / torch.sqrt(T * np.pi * const.K_BOLTZ)
                     * p_barye * coll)
            return gamma[:, None, None]
        if self.mode == "air":
            p_atm = p_barye / _ATM_BARYE
            return (lines.gamma_air[None]
                    * p_atm[:, None, None]
                    * (TREF / T)[:, None, None] ** lines.n_air[None])
        raise ValueError(f"unknown broadening mode {self.mode!r}")


@dataclasses.dataclass
class LineTiles:
    """Lines bucketed per output-grid tile: [n_tiles, lines_per_tile]
    tensors, ``weight`` 0 on padding slots; ``wn_tiles`` the grid
    reshaped to [n_tiles, tile_size] (padded with its last value)."""

    species: str
    wn_tiles: torch.Tensor    # [nt, W]
    wn0: torch.Tensor         # [nt, L]
    s296: torch.Tensor
    elower: torch.Tensor
    gamma_air: torch.Tensor
    n_air: torch.Tensor
    weight: torch.Tensor      # [nt, L] 1/0 padding mask
    cutoff: float             # wing reach used for bucketing [cm-1]
    n_grid: int               # original grid length


def wing_cutoff(nwidth: float, wn_max: float, t_min: float,
                p_max_barye: float, mass_g: float, diam_cm: float,
                spec: BroadeningSpec, cutoff_max: float = 25.0) -> float:
    """Maximum line-wing reach [cm-1]: nwidth x the largest HWHM over
    the (T, p) domain, clamped to ``cutoff_max`` (the HITRAN-standard
    25 cm-1 far-wing truncation)."""
    f64 = torch.float64
    h2 = get_molecule("H2")
    he = get_molecule("He")
    gl = float(lorentz_hwhm_collision(
        p_max_barye, torch.tensor(t_min, dtype=f64), mass_g, diam_cm,
        torch.tensor([spec.q_h2, spec.q_he], dtype=f64),
        torch.tensor([h2.mass, he.mass], dtype=f64) * const.AMU,
        torch.tensor([h2.diameter, he.diameter], dtype=f64) * 1e-8,
    ))
    gd = float(doppler_hwhm(wn_max, torch.tensor(4000.0, dtype=f64),
                            mass_g))
    return float(min(nwidth * max(gl, gd), cutoff_max))


def tile_lines_bucketed(lines: LineList, wn_grid: np.ndarray, cutoff: float,
                        tile_size: int = 256, pad_lines_to: int = 128,
                        ethresh: float = 0.0, *,
                        device: str | torch.device = "cuda",
                        dtype: torch.dtype = torch.float64,
                        ) -> list[tuple[np.ndarray, LineTiles]]:
    """Variable-depth tiling on the host (numpy), returned as tensors.

    Each tile receives every line whose center lies within ``cutoff`` of
    its span; tiles are grouped into geometric depth classes, each
    padded to its own maximum line count (rounded up to
    ``pad_lines_to``).  Returns [(tile_indices, LineTiles), ...].
    ``ethresh`` > 0 first culls lines below ethresh x max(S296).
    """
    device = resolve_device(device)
    if ethresh > 0 and lines.nlines:
        lines = lines.cull(ethresh)
    wn_grid = np.asarray(wn_grid, np.float64)
    n = len(wn_grid)
    nt = -(-n // tile_size)
    npad = nt * tile_size - n
    wn_padded = np.concatenate([wn_grid, np.full(npad, wn_grid[-1])])
    wn_tiles = wn_padded.reshape(nt, tile_size)

    lo = np.searchsorted(lines.wn0, wn_tiles[:, 0] - cutoff)
    hi = np.searchsorted(lines.wn0, wn_tiles[:, -1] + cutoff)
    counts = hi - lo

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    class_of = np.ceil(
        np.log2(np.maximum(counts, 1) / pad_lines_to)
    ).clip(min=0).astype(int)
    out = []
    for cls in np.unique(class_of):
        sel = np.where(class_of == cls)[0]
        max_l = int(max(counts[sel].max(), 1))
        max_l = -(-max_l // pad_lines_to) * pad_lines_to
        idx = lo[sel][:, None] + np.arange(max_l)[None, :]
        weight = (idx < hi[sel][:, None]).astype(np.float64)
        idx = np.clip(idx, 0, max(lines.nlines - 1, 0))
        if lines.nlines == 0:
            z = np.zeros((len(sel), max_l))
            cols = dict(wn0=z, s296=z, elower=z, gamma_air=z, n_air=z)
        else:
            cols = dict(wn0=lines.wn0[idx], s296=lines.s296[idx],
                        elower=lines.elower[idx],
                        gamma_air=lines.gamma_air[idx],
                        n_air=lines.n_air[idx])
        out.append((sel, LineTiles(
            species=lines.species,
            wn_tiles=t(wn_tiles[sel]),
            weight=t(weight),
            cutoff=cutoff,
            n_grid=n,
            **{k: t(v) for k, v in cols.items()},
        )))
    return out


def _line_strength(tiles: LineTiles, T: torch.Tensor,
                   q_fn: Callable) -> torch.Tensor:
    """S(T) per line [cond, nt, L] for conditions T [cond]."""
    c2 = const.C2
    Tb = T[:, None, None]
    qr = (q_fn(torch.tensor(TREF, dtype=T.dtype, device=T.device))
          / q_fn(T))[:, None, None]
    boltz = torch.exp(-c2 * tiles.elower * (1.0 / Tb - 1.0 / TREF))
    # padding slots have wn0 = 0 -> 0/0 in the stimulated-emission
    # factor; substitute a safe center (their weight is 0 anyway)
    wn0 = torch.where(tiles.weight > 0, tiles.wn0,
                      torch.full_like(tiles.wn0, 1000.0))
    stim = ((1.0 - torch.exp(-c2 * wn0 / Tb))
            / (1.0 - torch.exp(-c2 * wn0 / TREF)))
    return tiles.s296 * qr * boltz * stim * tiles.weight


def cross_section_tiles(tiles: LineTiles, T: torch.Tensor,
                        p_barye: torch.Tensor, spec: BroadeningSpec,
                        nwidth: float = 0.0, q_table=None, osamp: int = 1,
                        wndelt: float = 1.0) -> torch.Tensor:
    """Per-tile cross-sections sigma[cond, nt, W] in cm^2/molecule for
    conditions T, p_barye [cond]: exact point sampling of the Voigt
    profile at the output wavenumbers.  ``nwidth`` > 0 truncates each
    profile at nwidth x max(Doppler, Lorentz) HWHM.  Only ``osamp`` = 1
    is ported (bin averaging comes with the on-the-fly line mode).
    """
    if int(osamp) != 1:
        raise NotImplementedError(
            "cross_section_tiles: osamp > 1 (bin-averaged profiles) is "
            "not ported yet (ROADMAP queue 1, item 11)")
    mol = get_molecule(tiles.species)
    mass_g = mol.mass * const.AMU
    diam_cm = mol.diameter * 1e-8
    q_fn = partition_function(tiles.species, q_table)

    s = _line_strength(tiles, T, q_fn)                          # [c, nt, L]
    gd = (tiles.wn0 / const.C_LIGHT
          * torch.sqrt(2.0 * np.log(2.0) * const.K_BOLTZ * T / mass_g)
          [:, None, None])                                      # Doppler HWHM
    # padding slots have wn0 = 0 -> gd = 0; guard 1/0 (weight zeroes them)
    sigma_g = torch.where(tiles.weight > 0, gd, torch.ones_like(gd)) \
        / _SQRT_2LN2
    gl = spec.gamma_lorentz(tiles, mass_g, diam_cm, T, p_barye)
    gl = torch.broadcast_to(gl, gd.shape)

    inv = 1.0 / (sigma_g * math.sqrt(2.0))
    y = gl * inv                                                # [c, nt, L]

    dx = tiles.wn_tiles[:, None, :] - tiles.wn0[:, :, None]     # [nt, L, W]
    x = dx * inv[..., None]                                     # [c, nt, L, W]
    prof = faddeeva_real(x, y[..., None]) * (inv * _INV_SQRT_PI)[..., None]
    del x
    if nwidth > 0:
        reach = nwidth * torch.maximum(gd, gl)
        prof = prof * (torch.abs(dx) <= reach[..., None])
    contrib = (s * tiles.weight)[..., None] * prof
    return torch.sum(contrib, dim=2)                            # [c, nt, W]
