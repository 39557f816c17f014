"""Chemical-formula parsing and mean molar mass.

This package's own host copy of bart_tpu/physics/stoich.py.

Host-side equivalents of the reference's stoichiometry utilities
(reference: code/makeatm.py:334-441 stoich, :445-508 mean_molar_mass).
"""

from __future__ import annotations

import re

import numpy as np

from bart_tpu_torch.io.abundances import ElementTable

__all__ = ["parse_formula", "species_mass", "mean_molar_mass", "strip_janaf"]

_TOKEN = re.compile(r"([A-Z][a-z]?)(\d*)|([+-])")

# Electron mass in amu, used for ion corrections ('+' removes, '-' adds
# one electron; matches reference treatment in code/makeatm.py:408-421
# which books ions as +/- "e" counts).
_ELECTRON_AMU = 5.48579909070e-4


def strip_janaf(name: str) -> str:
    """Strip JANAF-convention suffixes: 'H2O_g' -> 'H2O', ions
    '_ion_p'/'_ion_n' -> '+'/'-' (reference code/makeatm.py:863-876)."""
    name = name.replace("_ion_p", "+").replace("_ion_n", "-")
    return name.partition("_")[0]


def parse_formula(species: str) -> dict[str, float]:
    """Count atoms per element in a species formula.

    'H2O' -> {'H': 2, 'O': 1}; ions add an 'e' entry: 'H-' -> {'H': 1,
    'e': 1}, 'Na+' -> {'Na': 1, 'e': -1} (reference code/makeatm.py:334-441).
    """
    counts: dict[str, float] = {}
    pos = 0
    for m in _TOKEN.finditer(species):
        if m.start() != pos:
            raise ValueError(f"cannot parse formula {species!r} at {pos}")
        pos = m.end()
        if m.group(3):
            counts["e"] = counts.get("e", 0) + (1 if m.group(3) == "-" else -1)
        else:
            elem = m.group(1)
            n = int(m.group(2)) if m.group(2) else 1
            counts[elem] = counts.get(elem, 0) + n
    if pos != len(species):
        raise ValueError(f"cannot parse formula {species!r} at {pos}")
    return counts


def species_mass(species: str, elements: ElementTable) -> float:
    """Molar mass [amu] of one species from its formula."""
    counts = parse_formula(strip_janaf(species))
    mass = 0.0
    for elem, n in counts.items():
        if elem == "e":
            mass += n * _ELECTRON_AMU
        else:
            mass += n * elements.mass_of(elem)
    return mass


def mean_molar_mass(
    species: list[str], abundances: np.ndarray, elements: ElementTable
) -> np.ndarray:
    """Per-layer mean molar mass [g/mol].

    ``abundances`` has shape (nlayers, nspecies) of mole mixing ratios;
    mu[l] = sum_s m_s q_s[l] (reference code/makeatm.py:488-508).
    """
    masses = np.array([species_mass(s, elements) for s in species])
    return abundances @ masses
