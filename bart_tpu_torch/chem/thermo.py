"""Gas-phase thermochemistry: dimensionless Gibbs energies g°(T)/RT.

This package's own host copy of bart_tpu/chem/thermo.py.

The reference's TEA reads JANAF free-energy tables (reference:
SURVEY.md section 2.4 — readJANAF.py et al.).  This module instead
derives chemical potentials from the same statistical mechanics that
powers its partition functions (linelist/tips.py) plus tabulated 0-K
atomization energies:

    mu_i°(T)/RT = -ln( q_trans,i(T) * kT/p° * q_int,i(T) ) - D0_i/(R T)

with the energy zero at free ground-state atoms, so element-conserving
reaction Delta-G's are consistent across species.  Accuracy is set by
the rigid-rotor/harmonic q_int (few %% in Q => ~0.01-0.05 in g/RT) and
the atomization energies (<1%%).  MEASURED against published GRI-Mech
3.0 NASA-7 data (chem/thermo_tables.py; tests/test_chem.py): major-
species equilibrium abundances agree to <=5%% over 800-2000 K at 1 bar
— CO/H2O/N2 to <3%%, CH4 to <3%%, NH3 (inversion-doubled, the RRHO
worst case) to ~5%%.
User-supplied (T, g/RT) tables override the analytic path (the JANAF
capability; readers for JANAF ASCII / NASA-7 / NASA-9 formats live in
chem/thermo_tables.py).  Tables use the formation convention — supply
them for ALL species of a solve or none (conventions differ by per-
element shifts the solver absorbs only when applied uniformly).
"""

from __future__ import annotations

import numpy as np
import torch

from bart_tpu_torch import constants as const
from bart_tpu_torch.linelist.molecules import get_molecule
from bart_tpu_torch.linelist.tips import q_approx

__all__ = ["gibbs_rt", "ATOMS", "D0_KJ_MOL"]

# 0-K atomization energies [kJ/mol] (molecule -> free atoms).
D0_KJ_MOL: dict[str, float] = {
    "H2": 432.07, "O2": 493.57, "N2": 941.64, "CO": 1071.8,
    "CO2": 1598.3, "H2O": 917.78, "CH4": 1642.2, "NH3": 1157.9,
    "HCN": 1265.9, "C2H2": 1626.2, "C2H4": 2225.4, "C2H6": 2787.0,
    "OH": 423.72, "NO": 626.84, "H2S": 713.4, "SO2": 1062.5,
    "N2O": 1103.0, "O3": 595.4, "TiO": 657.7, "VO": 621.3,
}

# Atomic species: (mass amu, electronic ground degeneracy)
ATOMS: dict[str, tuple[float, float]] = {
    "H": (1.00783, 2.0), "He": (4.00260, 1.0), "C": (12.0000, 9.0),
    "N": (14.00307, 4.0), "O": (15.99491, 9.0), "S": (31.97207, 9.0),
    "Ti": (47.94794, 21.0), "V": (50.94396, 28.0),
    "Na": (22.98977, 2.0), "K": (38.96371, 2.0), "Fe": (55.93494, 25.0),
}

# CODATA R in J/(mol K); p° = 1 bar in barye handled in cgs below.
_R = 8.31446261815324
_P_REF = 1.0e6  # 1 bar in barye (cgs)


def _q_trans_kt_over_p(mass_amu: float, T):
    """q_trans * kT / p°  =  (2 pi m k T / h^2)^{3/2} * (k T / p°), cgs.

    Evaluated in float64 numpy on host: h^2 ~ 4e-53 underflows f32, so
    this must never run in the runtime dtype.
    """
    T = np.asarray(T, np.float64)
    m = mass_amu * const.AMU
    kT = const.K_BOLTZ * T
    lam = (2.0 * np.pi * m * kT / const.H_PLANCK**2) ** 1.5
    return lam * kT / _P_REF


def gibbs_rt(species: str, T, table=None):
    """Dimensionless standard Gibbs energy g°(T)/RT (zero = free
    ground-state atoms at rest).  ``T`` may be an array.
    Returns float64 numpy (host-side; see _q_trans_kt_over_p).

    With ``table=(T_tab, g_tab)`` the value is interpolated instead
    (the reference's JANAF-table capability).
    """
    T = np.asarray(T, np.float64)
    if table is not None:
        return np.interp(T, np.asarray(table[0]), np.asarray(table[1]))

    if species in ("e-",):
        q = _q_trans_kt_over_p(5.485799e-4, T) * 2.0
        return -np.log(q)

    if species in ATOMS and species not in D0_KJ_MOL:
        mass, g_el = ATOMS[species]
        return -np.log(_q_trans_kt_over_p(mass, T) * g_el)

    mol = get_molecule(species)
    if mol.linear is None:  # registry atom (He, Na, K)
        g_el = ATOMS.get(species, (mol.mass, 1.0))[1]
        return -np.log(_q_trans_kt_over_p(mol.mass, T) * g_el)

    if species not in D0_KJ_MOL:
        raise KeyError(
            f"no atomization energy for {species!r}; add it to "
            "bart_tpu_torch/chem/thermo.py D0_KJ_MOL"
        )
    d0 = D0_KJ_MOL[species] * 1000.0  # J/mol
    # the port's torch q_approx on a float64 CPU tensor: host numbers in
    # and out, as the rest of the stage
    q_int = q_approx(mol)(torch.from_numpy(T)).numpy()
    q = _q_trans_kt_over_p(mol.mass, T) * q_int
    return -np.log(q) - d0 / (_R * T)
