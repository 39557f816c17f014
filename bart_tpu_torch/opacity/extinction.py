"""Line-by-line cross-sections on wavenumber tiles (port of
bart_tpu/opacity/extinction.py).

Lines are bucketed onto tiles of the output grid on the host, once
(``tile_lines``: uniform tiles; ``tile_lines_bucketed``: tiles grouped
by depth); the Voigt profile is then evaluated directly for every
(condition, line, gridpoint) triple as plain torch ops
(``cross_section_tiles``, and ``cross_section_grid`` on the output
grid), point-sampled at the gridpoints or, with ``osamp`` > 1,
averaged over each gridpoint's bin.  Eager torch materialises each
[cond, tile, line, point(, sub-sample)] temporary, so the caller bounds
the batch by bytes (``cond_bytes``; opacity.grid.build_opacity_grid,
the on-the-fly mode of rt.forward.ForwardModel).

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

__all__ = ["LineTiles", "BroadeningSpec", "tile_lines", "tile_lines_bucketed",
           "cross_section_tiles", "cross_section_grid", "wing_cutoff",
           "cond_bytes"]

_SQRT_2LN2 = float(np.sqrt(2.0 * np.log(2.0)))
_INV_SQRT_PI = float(1.0 / np.sqrt(np.pi))
_ATM_BARYE = 1.01325e6  # 1 atm in barye
# Live [cond, tile, line, point(, sub-sample)] temporaries of one
# cross_section_tiles call in eager torch: x, the Faddeeva
# real/imaginary Horner pair and their products, the profile, the mask
# and the contribution.
_LIVE_TEMPS = 10


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

    @classmethod
    def from_abundances(cls, species, abundances, mode: str = "collision"
                        ) -> "BroadeningSpec":
        """Collision-broadening bath from the baseline atmosphere's own
        H2/He mixing ratios (the reference reads these columns from the
        atm file: code/BARTfunc.py:189-201).  Mean over layers; falls back
        to the 0.85/0.15 defaults when either collider is absent."""
        sp = list(species)
        q = np.asarray(abundances, np.float64)
        if "H2" in sp and "He" in sp:
            qh2 = float(np.mean(q[:, sp.index("H2")]))
            qhe = float(np.mean(q[:, sp.index("He")]))
            if qh2 > 0.0 or qhe > 0.0:
                return cls(mode=mode, q_h2=qh2, q_he=qhe)
        return cls(mode=mode)


@dataclasses.dataclass
class LineTiles:
    """Lines bucketed per output-grid tile: [n_tiles, lines_per_tile]
    tensors, ``weight`` 0 on padding slots; ``wn_tiles`` the grid
    reshaped to [n_tiles, tile_size] (padded with its last value),
    ``grid_mask`` False on that padding."""

    species: str
    wn_tiles: torch.Tensor    # [nt, W]
    grid_mask: torch.Tensor   # [nt, W] bool
    wn0: torch.Tensor         # [nt, L]
    s296: torch.Tensor
    elower: torch.Tensor
    gamma_air: torch.Tensor
    n_air: torch.Tensor
    weight: torch.Tensor      # [nt, L] 1/0 padding mask
    cutoff: float             # wing reach used for bucketing [cm-1]
    n_grid: int               # original grid length

    @property
    def shape(self) -> tuple[int, int, int]:
        """(n_tiles, lines_per_tile, tile_size)."""
        return (self.wn0.shape[0], self.wn0.shape[1], self.wn_tiles.shape[1])


def cond_bytes(tiles: LineTiles, osamp: int, itemsize: int) -> int:
    """Bytes of one condition's live temporaries in cross_section_tiles
    (the sub-sample axis counts with ``osamp`` > 1)."""
    nt, L, W = tiles.shape
    return _LIVE_TEMPS * nt * L * W * max(int(osamp), 1) * itemsize


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


def _grid_tiles(wn_grid: np.ndarray, tile_size: int):
    """(wn_tiles [nt, tile_size], grid_mask, n): the grid padded with its
    last value to whole tiles, and False on that padding."""
    wn_grid = np.asarray(wn_grid, np.float64)
    n = len(wn_grid)
    nt = -(-n // tile_size)
    npad = nt * tile_size - n
    wn_padded = np.concatenate([wn_grid, np.full(npad, wn_grid[-1])])
    grid_mask = np.concatenate([np.ones(n, bool), np.zeros(npad, bool)])
    return (wn_padded.reshape(nt, tile_size),
            grid_mask.reshape(nt, tile_size), n)


def _make_tiles(lines: LineList, wn_tiles, grid_mask, lo, hi, max_l: int,
                cutoff: float, n: int, device, dtype) -> LineTiles:
    """The LineTiles of tiles whose lines are lines[lo:hi], each padded
    to ``max_l`` slots (weight 0 on padding), as tensors."""
    idx = lo[:, None] + np.arange(max_l)[None, :]
    weight = (idx < hi[:, None]).astype(np.float64)
    idx = np.clip(idx, 0, max(lines.nlines - 1, 0))
    if lines.nlines == 0:
        z = np.zeros((len(lo), max_l))
        cols = dict(wn0=z, s296=z, elower=z, gamma_air=z, n_air=z)
    else:
        cols = dict(wn0=lines.wn0[idx], s296=lines.s296[idx],
                    elower=lines.elower[idx],
                    gamma_air=lines.gamma_air[idx], n_air=lines.n_air[idx])

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return LineTiles(
        species=lines.species,
        wn_tiles=t(wn_tiles),
        grid_mask=torch.as_tensor(grid_mask, device=device),
        weight=t(weight),
        cutoff=cutoff,
        n_grid=n,
        **{k: t(v) for k, v in cols.items()},
    )


def tile_lines(lines: LineList, wn_grid: np.ndarray, cutoff: float,
               tile_size: int = 256, pad_lines_to: int = 128,
               ethresh: float = 0.0, *,
               device: str | torch.device = "cuda",
               dtype: torch.dtype = torch.float64) -> LineTiles:
    """Uniform tiling on the host (numpy), returned as tensors on
    ``device`` (the card unless the caller asks for the CPU).

    Each tile of ``tile_size`` grid points receives every line whose
    center lies within ``cutoff`` of its span; every tile is padded to
    the deepest tile's line count, rounded up to ``pad_lines_to``.
    ``ethresh`` > 0 first culls lines below ethresh x max(S296) (the
    reference's extinction.c strength cutoff, applied before bucketing).
    """
    device = resolve_device(device)
    if ethresh > 0 and lines.nlines:
        lines = lines.cull(ethresh)
    wn_tiles, grid_mask, n = _grid_tiles(wn_grid, tile_size)
    nt = wn_tiles.shape[0]
    lo = np.searchsorted(lines.wn0, wn_tiles[:, 0] - cutoff)
    hi = np.searchsorted(lines.wn0, wn_tiles[:, -1] + cutoff)
    max_l = int((hi - lo).max()) if nt else 0
    max_l = max(pad_lines_to, -(-max_l // pad_lines_to) * pad_lines_to)
    return _make_tiles(lines, wn_tiles, grid_mask, lo, hi, max_l, cutoff, n,
                       device, dtype)


def tile_lines_bucketed(lines: LineList, wn_grid: np.ndarray, cutoff: float,
                        tile_size: int = 256, pad_lines_to: int = 128,
                        ethresh: float = 0.0, *,
                        device: str | torch.device = "cuda",
                        dtype: torch.dtype = torch.float64,
                        ) -> list[tuple[np.ndarray, LineTiles]]:
    """Variable-depth tiling on the host (numpy), returned as tensors.

    As ``tile_lines``, but the tiles are grouped into geometric depth
    classes, each padded to its own maximum line count (rounded up to
    ``pad_lines_to``).  Returns [(tile_indices, LineTiles), ...].
    """
    device = resolve_device(device)
    if ethresh > 0 and lines.nlines:
        lines = lines.cull(ethresh)
    wn_tiles, grid_mask, n = _grid_tiles(wn_grid, tile_size)
    lo = np.searchsorted(lines.wn0, wn_tiles[:, 0] - cutoff)
    hi = np.searchsorted(lines.wn0, wn_tiles[:, -1] + cutoff)
    counts = hi - lo

    class_of = np.ceil(
        np.log2(np.maximum(counts, 1) / pad_lines_to)
    ).clip(min=0).astype(int)
    out = []
    for cls in np.unique(class_of):
        sel = np.where(class_of == cls)[0]
        max_l = int(max(counts[sel].max(), 1))
        max_l = -(-max_l // pad_lines_to) * pad_lines_to
        out.append((sel, _make_tiles(lines, wn_tiles[sel], grid_mask[sel],
                                     lo[sel], hi[sel], max_l, cutoff, n,
                                     device, dtype)))
    return out


def _line_strength(tiles: LineTiles, T: torch.Tensor,
                   q_fn: Callable) -> torch.Tensor:
    """S(T) per line [cond, nt, L] for conditions T [cond]."""
    c2 = const.C2
    Tb = T[:, None, None]
    # a fill, not a host copy: a CUDA graph may capture this
    qr = (q_fn(torch.full((), TREF, dtype=T.dtype, device=T.device))
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
    conditions T, p_barye [cond].  ``nwidth`` > 0 truncates each profile
    at nwidth x max(Doppler, Lorentz) HWHM.

    ``osamp`` = 1 samples the Voigt profile exactly at the output
    wavenumbers.  ``osamp`` > 1 returns the bin-averaged cross-section:
    for every (line, bin) pair the profile is integrated over the
    ``wndelt``-wide bin around each gridpoint by an ``osamp``-point
    midpoint rule in the coordinate theta of x = HWHM_V tan(theta), with
    the Olivero-Longbothum Voigt HWHM as the scale (exact for a
    Lorentzian; resolves a Doppler core of any width).  A bin-averaged
    sigma fed through exp(-tau) is curve-of-growth biased for saturated
    lines (docs/LINE_SAMPLING.md).
    """
    osamp = int(osamp)
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
    sw = s * tiles.weight

    if osamp > 1:
        dxa = (tiles.wn_tiles[:, None, :] - 0.5 * wndelt
               - tiles.wn0[:, :, None])                         # [nt, L, W]
        wv = torch.clamp(0.5346 * gl + torch.sqrt(0.2166 * gl * gl + gd * gd),
                         min=1e-12)[..., None]                  # [c, nt, L, 1]
        ta = torch.atan(dxa / wv)                               # [c, nt, L, W]
        dt = (torch.atan((dxa + wndelt) / wv) - ta) / osamp
        k = torch.arange(osamp, dtype=dxa.dtype, device=dxa.device) + 0.5
        tan_t = torch.tan(ta[..., None] + dt[..., None] * k)    # [c,nt,L,W,K]
        del ta
        x_off = wv[..., None] * tan_t                           # wn offsets
        prof = (faddeeva_real(x_off * inv[..., None, None],
                              y[..., None, None])
                * (inv * _INV_SQRT_PI)[..., None, None])
        if nwidth > 0:
            reach = nwidth * torch.maximum(gd, gl)
            prof = prof * (torch.abs(x_off) <= reach[..., None, None])
        del x_off
        # the bin integral is sum prof wv (1 + tan^2) dtheta; its average
        avg = (torch.sum(prof * (1.0 + tan_t * tan_t), dim=-1)
               * wv * dt / wndelt)                              # [c, nt, L, W]
        return torch.sum(sw[..., None] * avg, dim=2)            # [c, nt, W]

    dx = tiles.wn_tiles[:, None, :] - tiles.wn0[:, :, None]     # [nt, L, W]
    x = dx * inv[..., None]                                     # [c, nt, L, W]
    prof = faddeeva_real(x, y[..., None]) * (inv * _INV_SQRT_PI)[..., None]
    del x
    if nwidth > 0:
        reach = nwidth * torch.maximum(gd, gl)
        prof = prof * (torch.abs(dx) <= reach[..., None])
    contrib = sw[..., None] * prof
    return torch.sum(contrib, dim=2)                            # [c, nt, W]


def cross_section_grid(tiles: LineTiles, T: torch.Tensor,
                       p_barye: torch.Tensor, spec: BroadeningSpec,
                       nwidth: float = 0.0, q_table=None, osamp: int = 1,
                       wndelt: float = 1.0) -> torch.Tensor:
    """Cross-sections sigma[cond, n_grid] in cm^2/molecule: the output-grid
    view of ``cross_section_tiles`` (its arguments)."""
    sig = cross_section_tiles(tiles, T, p_barye, spec, nwidth=nwidth,
                              q_table=q_table, osamp=osamp, wndelt=wndelt)
    return sig.reshape(T.shape[0], -1)[:, :tiles.n_grid]
