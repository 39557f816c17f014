"""Collision-induced absorption (port of bart_tpu/opacity/cia.py).

Bilinear interpolation of tabulated CIA opacity in (T, wavenumber),
scaled by the number densities of the two colliding species, in amagat.

The reader is host numpy, copied rather than imported: bart_tpu's module
imports jax at top level.  File format, the Borysow/transit-style grid
table:

    # comment lines
    i <species1> <species2>
    t   T1 T2 ... Tn
    wn1 a11 a12 ... a1n
    ...

with absorption in cm-1 amagat-2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bart_tpu_torch.utils.interp import interp

__all__ = ["CiaTable", "read_cia", "cia_extinction", "cia_weights",
           "LOSCHMIDT"]

# Loschmidt number: molecules cm-3 at 1 amagat
LOSCHMIDT = 2.6867811e19


@dataclasses.dataclass
class CiaTable:
    species: tuple[str, str]
    temps: np.ndarray      # [nT], ascending
    wn: np.ndarray         # [nwn], ascending
    absorption: np.ndarray # [nT, nwn] in cm-1 amagat-2


def read_cia(path: str) -> CiaTable:
    """Read a transit/Borysow-style CIA grid table."""
    species = ("H2", "H2")
    temps = None
    rows = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            if s.startswith("i "):
                parts = s.split()
                species = (parts[1], parts[2])
            elif s.startswith("t "):
                temps = np.asarray([float(x) for x in s.split()[1:]])
            else:
                rows.append([float(x) for x in s.split()])
    if temps is None or not rows:
        raise ValueError(f"{path}: not a CIA grid table")
    data = np.asarray(rows)
    return CiaTable(species, temps, data[:, 0], data[:, 1:].T.copy())


def _bracket(temps: torch.Tensor, T: torch.Tensor):
    """(it, f): bracket ``searchsorted(temps, T) - 1`` (side left)
    clipped to [0, nT-2] and fraction clipped to [0, 1], so T beyond
    either end takes the edge value.  A T exactly on node k > 0 lands on
    the upper end of bracket k-1."""
    n = temps.shape[0]
    it = torch.clamp(torch.searchsorted(temps, T.contiguous(), right=False)
                     - 1, 0, n - 2)
    t0, t1 = temps[it], temps[it + 1]
    return it, torch.clamp((T - t0) / (t1 - t0), 0.0, 1.0)


def cia_weights(temps: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Linear T-interpolation weights w[..., nT] on the (non-uniform)
    table temperatures, with ``cia_extinction``'s bracketing."""
    it, f = _bracket(temps, T)
    iota = torch.arange(temps.shape[0], device=T.device)
    zero = torch.zeros((), dtype=T.dtype, device=T.device)
    w = torch.where(iota == it[..., None], (1.0 - f)[..., None], zero)
    return torch.where(iota == it[..., None] + 1, w + f[..., None], w)


def cia_extinction(table_temps: torch.Tensor, table_wn: torch.Tensor,
                   table_abs: torch.Tensor, wn_grid: torch.Tensor,
                   T_layers: torch.Tensor, n1_amagat: torch.Tensor,
                   n2_amagat: torch.Tensor) -> torch.Tensor:
    """Extinction [..., L, W] in cm-1: the table interpolated at
    (T_layers [..., L], wn_grid [W]) times n1 n2 [..., L] in amagat^2.

    Out-of-range T clamps to the table edge; out-of-range wn
    contributes zero.  The unfused reference of the CIA rows that
    ForwardModel folds into the rows contraction.
    """
    tab = interp(wn_grid, table_wn, table_abs)                  # [nT, W]
    outside = (wn_grid < table_wn[0]) | (wn_grid > table_wn[-1])
    tab = torch.where(outside, torch.zeros_like(tab), tab)
    it, f = _bracket(table_temps, T_layers)
    alpha = tab[it] * (1.0 - f)[..., None] + tab[it + 1] * f[..., None]
    return alpha * (n1_amagat * n2_amagat)[..., None]
