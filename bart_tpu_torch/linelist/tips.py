"""Total internal partition sums Q(T) on torch tensors (port of
bart_tpu/linelist/tips.py).

``q_approx``: rigid-rotor x harmonic-oscillator analytic Q(T) from the
molecular constants of bart_tpu.linelist.molecules (line strengths use
only the ratio Q(Tref)/Q(T), so constant factors cancel).
``q_tabulated``: linear interpolation of a user (T, Q) table.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from bart_tpu_torch import constants as const
from bart_tpu_torch.linelist.molecules import Molecule, get_molecule
from bart_tpu_torch.utils.interp import interp

__all__ = ["partition_function", "q_approx", "q_tabulated"]

_C2 = const.C2   # hc/k [cm K]


def _q_vib(t: torch.Tensor, vib) -> torch.Tensor:
    qvib = torch.ones_like(t)
    for wn_i, g_i in vib:
        qvib = qvib * (1.0 - torch.exp(-_C2 * wn_i / t)) ** (-g_i)
    return qvib


def q_approx(mol: Molecule) -> Callable[[torch.Tensor], torch.Tensor]:
    """Analytic Q(T) callable on a float tensor T (atoms: Q = 1)."""
    if mol.linear is None:
        return lambda T: torch.ones_like(T)

    vib = tuple(mol.vib)
    sig = mol.sigma_rot
    if mol.linear:
        B = mol.rot_const[0]

        def q(T):
            x = T / (_C2 * B)
            qrot = (x + 1.0 / 3.0 + _C2 * B / (15.0 * T)) / sig
            return qrot * _q_vib(T, vib)

        return q

    A, B, C = mol.rot_const

    def q(T):
        qrot = np.sqrt(np.pi) / sig * torch.sqrt((T / _C2) ** 3 / (A * B * C))
        return qrot * _q_vib(T, vib)

    return q


def q_tabulated(temps: np.ndarray,
                values: np.ndarray) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear interpolation of a tabulated partition function."""
    t_np = np.asarray(temps, np.float64)
    q_np = np.asarray(values, np.float64)

    def q(T):
        t_tab = torch.as_tensor(t_np, dtype=T.dtype, device=T.device)
        q_tab = torch.as_tensor(q_np, dtype=T.dtype, device=T.device)
        return interp(T, t_tab, q_tab)

    return q


def partition_function(species: str,
                       table: tuple[np.ndarray, np.ndarray] | None = None
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Q(T) for a species: tabulated if a table is given, else the
    analytic approximation."""
    if table is not None:
        return q_tabulated(*table)
    return q_approx(get_molecule(species))
