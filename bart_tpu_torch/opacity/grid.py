"""Opacity grid: the precomputed cross-section table and its runtime
T-interpolation (port of bart_tpu/opacity/grid.py).

sigma[mol, nT, nlayer, nwave] in cm^2/molecule is built once, on the
device, and stored in float32 whatever the compute dtype (as the JAX
build does).  The build is plain torch: the JAX package has no Pallas
kernel for it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bart_tpu_torch import constants as const
from bart_tpu_torch.device import resolve_device
from bart_tpu_torch.linelist.hitran import LineList
from bart_tpu_torch.linelist.molecules import get_molecule
from bart_tpu_torch.opacity.extinction import (
    BroadeningSpec, cond_bytes, cross_section_tiles, tile_lines_bucketed,
    wing_cutoff,
)

__all__ = ["OpacityGrid", "build_opacity_grid", "build_budget",
           "interp_opacity", "save_grid", "load_grid", "fine_bin_mask"]


def fine_bin_mask(sigma_fine: torch.Tensor, K: int, delta: float = 0.02,
                  floor: float = 1e-12) -> torch.Tensor:
    """Which output bins need in-bin fine resolution? -> bool [Wout], on
    the table's device (bart_tpu.opacity.grid.fine_bin_mask).

    The static adaptive resolution of the folded kernels (rt.fused): a
    bin is smooth when, for every table row (molecule x T-node) and
    layer, the in-bin relative deviation from the bin mean is at most
    ``delta``.  Smooth bins run at K = 1 on the bin-mean cross-section:
    the first-order sampling error vanishes (mean_k tau_k = taubar) and
    the curvature residual is at most 0.27 delta^2.  Rows whose bin mean
    is below ``floor`` times the molecule's global maximum are ignored.
    ``sigma_fine`` is [M, nT, L, Wout K] or [rows, L, Wout K], bin-major.
    One (molecule, T-node) plane is scanned at a time, so the
    temporaries are [L, Wout, K].
    """
    sig = sigma_fine[None] if sigma_fine.dim() == 3 else sigma_fine
    M, nT, L, Wf = sig.shape
    W = Wf // K
    if W * K != Wf:
        raise ValueError(f"fine wn axis {Wf} is not a multiple of K={K}")
    fine = torch.zeros(W, dtype=torch.bool, device=sig.device)
    for m in range(M):
        gmax = sig[m].max()
        for it in range(nT):
            s = sig[m, it].reshape(L, W, K)
            sbar = s.mean(-1)
            dev = (s - sbar[..., None]).abs().amax(-1)
            rel = torch.where(sbar > 0, dev / torch.where(sbar > 0, sbar, 1.0),
                              0.0)
            fine |= ((rel > delta) & (sbar > floor * gmax)).any(dim=0)
    return fine


@dataclasses.dataclass
class OpacityGrid:
    """sigma[mol, nT, nlayer, nwave] in cm^2/molecule (float32 tensor)."""

    species: list[str]
    t_grid: np.ndarray       # [nT], uniform ascending
    pressure: np.ndarray     # [nlayer] bar, ascending (top-first)
    wn_grid: np.ndarray      # [nwave] cm-1, ascending
    sigma: torch.Tensor      # [nmol, nT, nlayer, nwave]

    @property
    def t_min(self) -> float:
        return float(self.t_grid[0])

    @property
    def t_step(self) -> float:
        return float(self.t_grid[1] - self.t_grid[0])


def build_opacity_grid(
    lines_by_species: dict[str, LineList],
    wn_grid: np.ndarray,
    t_grid: np.ndarray,
    pressure_bar: np.ndarray,
    spec: BroadeningSpec | None = None,
    nwidth: float = 20.0,
    ethresh: float = 0.0,
    tile_size: int = 256,
    q_tables: dict | None = None,
    budget_bytes: float = 2e9,
    osamp: int = 1,
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> OpacityGrid:
    """Build the opacity table (the --justOpacity stage) on ``device``
    (the card unless the caller asks for the CPU).

    Conditions (T x layer, T-major) are evaluated in batches whose
    [cond, tile, line, point] temporaries (times ``osamp`` sub-samples)
    fit ``budget_bytes``; a tile bucket too deep for even one condition
    is split along the line axis and the partial sigmas summed
    (cross-sections add over lines).  The budget sets the chunking only,
    never the numbers.  ``osamp`` > 1 stores bin-averaged cross-sections
    (extinction.cross_section_tiles).  ``dtype`` is the compute dtype;
    the table is accumulated and stored in float32.
    """
    spec = spec or BroadeningSpec()
    device = resolve_device(device)
    t_grid = np.asarray(t_grid, np.float64)
    pressure_bar = np.asarray(pressure_bar, np.float64)
    nT, nP, nW = len(t_grid), len(pressure_bar), len(wn_grid)

    TT, PP = np.meshgrid(t_grid, pressure_bar, indexing="ij")
    conds_T = torch.as_tensor(TT.ravel(), dtype=dtype, device=device)
    conds_p = torch.as_tensor(PP.ravel() * const.BAR_TO_BARYE, dtype=dtype,
                              device=device)
    ncond = conds_T.shape[0]
    itemsize = torch.tensor([], dtype=dtype).element_size()
    wndelt = float(wn_grid[1] - wn_grid[0]) if nW > 1 else 1.0
    nWp = -(-nW // tile_size) * tile_size

    species = list(lines_by_species)
    sigma = torch.zeros((len(species), ncond, nW), dtype=torch.float32,
                        device=device)
    for im, name in enumerate(species):
        mol = get_molecule(name)
        cutoff = wing_cutoff(
            nwidth, float(wn_grid[-1]), float(t_grid[0]),
            float(pressure_bar[-1]) * const.BAR_TO_BARYE,
            mol.mass * const.AMU, mol.diameter * 1e-8, spec,
        )
        buckets = tile_lines_bucketed(
            lines_by_species[name], wn_grid, cutoff, tile_size=tile_size,
            ethresh=ethresh, device=device, dtype=dtype,
        )
        q_table = (q_tables or {}).get(name)
        out = torch.zeros((ncond, nWp), dtype=torch.float32, device=device)
        for tile_idx, tiles in buckets:
            L_b = tiles.wn0.shape[1]
            per_line = cond_bytes(tiles, osamp, itemsize) // L_b
            L_cap = max(int(budget_bytes // per_line), 1)
            cols = (torch.as_tensor(tile_idx, device=device)[:, None]
                    * tile_size
                    + torch.arange(tile_size, device=device)).reshape(-1)
            for l0 in range(0, L_b, L_cap):
                seg = tiles if L_b <= L_cap else dataclasses.replace(
                    tiles, **{f: getattr(tiles, f)[:, l0:l0 + L_cap]
                              for f in ("wn0", "s296", "elower", "gamma_air",
                                        "n_air", "weight")})
                per_cond = cond_bytes(seg, osamp, itemsize)
                cb = max(1, min(ncond, int(budget_bytes // per_cond)))
                for c0 in range(0, ncond, cb):
                    sig = cross_section_tiles(
                        seg, conds_T[c0:c0 + cb], conds_p[c0:c0 + cb], spec,
                        nwidth=nwidth, q_table=q_table, osamp=osamp,
                        wndelt=wndelt,
                    ).to(torch.float32)                     # [cb, nt_b, W]
                    out[c0:c0 + cb, cols] += sig.reshape(sig.shape[0], -1)
        sigma[im] = out[:, :nW]

    return OpacityGrid(
        species=species,
        t_grid=t_grid,
        pressure=pressure_bar,
        wn_grid=np.asarray(wn_grid, np.float64),
        sigma=sigma.reshape(len(species), nT, nP, nW),
    )


def build_budget(device: torch.device) -> float:
    """The byte budget of a build's temporaries on ``device``: an eighth
    of the card's memory (the build's peak is ~1.6x the budget), and
    build_opacity_grid's default on the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory / 8
    return 2e9


def interp_opacity(grid_sigma: torch.Tensor, t_grid_min: float,
                   t_grid_step: float, n_t: int,
                   T_layers: torch.Tensor) -> torch.Tensor:
    """Interpolate sigma[mol, nT, nlayer, nwave] in T at per-layer
    temperatures T_layers [C, nlayer] -> sigma[C, mol, nlayer, nwave]
    (uniform-grid bracketing and clamping as rt.fused.interp_weights)."""
    from bart_tpu_torch.rt.fused import interp_weights

    w = interp_weights(n_t, t_grid_min, t_grid_step,
                       T_layers).to(grid_sigma.dtype)           # [C, L, nT]
    return torch.einsum("clt,mtlw->cmlw", w, grid_sigma)


def save_grid(grid: OpacityGrid, path: str) -> None:
    """Save uncompressed: a compressed npz of a production table takes
    minutes to inflate on every cold start."""
    np.savez(
        path,
        species=np.asarray(grid.species),
        t_grid=grid.t_grid,
        pressure=grid.pressure,
        wn_grid=grid.wn_grid,
        sigma=grid.sigma.cpu().numpy(),
    )


def load_grid(path: str, *, device: str | torch.device = "cuda"
              ) -> OpacityGrid:
    """Load a grid saved by this package or by bart_tpu (whose npz is
    compressed; ``np.load`` reads both) onto ``device`` (the card unless
    the caller asks for the CPU)."""
    device = resolve_device(device)
    with np.load(path) as z:
        return OpacityGrid(
            species=[str(s) for s in z["species"]],
            t_grid=z["t_grid"],
            pressure=z["pressure"],
            wn_grid=z["wn_grid"],
            sigma=torch.as_tensor(z["sigma"], device=device),
        )
