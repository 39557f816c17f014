"""Atmospheric-model file I/O (TEA format and transit format).

This package's own host copy of bart_tpu/io/atm.py.

Reads/writes the layered atmosphere files of the reference pipeline:

* TEA format: ``#SPECIES`` block then ``#TEADATA`` with per-layer
  (pressure [bar], T [K], abundances), optionally with a leading radius
  column (reference: code/makeatm.py:758-837 readatm, :511-603 makeRadius).
* transit format: same data with unit headers ``ur/up/q`` and layers
  ordered bottom-to-top (reference: code/makeatm.py:841-896 reformat).

Internal convention after load: index 0 = top of atmosphere (lowest
pressure), like the rest of the package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Atmosphere", "read_atm", "write_atm_tea", "write_atm_transit"]


@dataclasses.dataclass
class Atmosphere:
    """Layered atmosphere: arrays ordered top (low p) -> bottom (high p)."""

    species: list[str]           # species names (JANAF suffixes stripped or not)
    pressure: np.ndarray         # [bar], shape (nlayers,), ascending
    temperature: np.ndarray      # [K], shape (nlayers,)
    abundances: np.ndarray       # mole mixing ratios, (nlayers, nspecies)
    radius: np.ndarray | None = None  # [km], shape (nlayers,), descending

    @property
    def nlayers(self) -> int:
        return len(self.pressure)

    @property
    def nspecies(self) -> int:
        return len(self.species)


def read_atm(path: str) -> Atmosphere:
    """Read a TEA- or transit-format atmosphere file.

    Accepts both 2+nspec and 3+nspec (with radius) column layouts and
    both layer orderings; output is always top-first (reference parsing:
    code/makeatm.py:758-837).
    """
    with open(path) as f:
        lines = f.readlines()

    # Unit factors (transit-format header; defaults bar-equivalent)
    ur = 1e5  # radius unit in cm (km)
    up = 1e6  # pressure unit in barye (bar)

    species: list[str] = []
    istart = None
    for i, line in enumerate(lines):
        s = line.strip()
        if s.startswith("ur "):
            ur = float(s.split()[1])
        elif s.startswith("up "):
            up = float(s.split()[1])
        elif s == "#SPECIES":
            species = lines[i + 1].split()
        elif s == "#TEADATA":
            istart = i + 2  # skip the column-header line
            break
    if istart is None or not species:
        raise ValueError(f"{path}: not a TEA/transit atmosphere file")

    rows = []
    for line in lines[istart:]:
        s = line.strip()
        if not s or s.startswith("#"):
            continue
        rows.append([float(x) for x in s.split()])
    data = np.asarray(rows, np.float64)

    nspec = len(species)
    if data.shape[1] == nspec + 2:
        radius = None
        pressure, temp = data[:, 0], data[:, 1]
        abund = data[:, 2:]
    elif data.shape[1] == nspec + 3:
        radius = data[:, 0]
        pressure, temp = data[:, 1], data[:, 2]
        abund = data[:, 3:]
    else:
        raise ValueError(
            f"{path}: {data.shape[1]} columns inconsistent with "
            f"{nspec} species"
        )

    # Normalize to top-first (ascending pressure):
    if pressure[0] > pressure[-1]:
        pressure, temp, abund = pressure[::-1], temp[::-1], abund[::-1]
        if radius is not None:
            radius = radius[::-1]

    return Atmosphere(
        species=list(species),
        pressure=np.ascontiguousarray(pressure),
        temperature=np.ascontiguousarray(temp),
        abundances=np.ascontiguousarray(abund),
        radius=np.ascontiguousarray(radius) if radius is not None else None,
    )


def write_atm_tea(atm: Atmosphere, path: str) -> None:
    """Write TEA-format atmosphere (top-first layers, with radius column
    if present; reference format code/makeatm.py:548-603)."""
    with open(path, "w") as f:
        f.write(
            "# TEA-format atmospheric file written by bart_tpu_torch.\n"
            "# Units: pressure (bar), temperature (K), abundance "
            "(unitless).\n\n"
        )
        f.write("#SPECIES\n" + " ".join(atm.species) + "\n\n")
        f.write("#TEADATA\n")
        cols = []
        if atm.radius is not None:
            cols.append("#Radius".ljust(11))
            cols.append("Pressure".ljust(11))
        else:
            cols.append("#Pressure".ljust(11))
        cols.append("Temp".ljust(8))
        cols += [s.ljust(14) for s in atm.species]
        f.write("".join(cols) + "\n")
        for i in range(atm.nlayers):
            row = []
            if atm.radius is not None:
                row.append("{:10.3f} ".format(atm.radius[i]))
            row.append("{:10.4e} ".format(atm.pressure[i]))
            row.append("{:7.2f} ".format(atm.temperature[i]))
            row += ["{:1.4e} ".format(q) for q in atm.abundances[i]]
            f.write("".join(row) + "\n")


def write_atm_transit(atm: Atmosphere, path: str) -> None:
    """Write transit-format atmosphere: unit headers (ur 1e5, up 1e6,
    q number) and layers bottom-to-top (reference code/makeatm.py:841-896)."""
    species = [s.replace("_ion_p", "+").replace("_ion_n", "-").partition("_")[0]
               for s in atm.species]
    with open(path, "w") as f:
        f.write("# transit-format atmospheric file written by bart_tpu_torch.\n\n")
        f.write("#Values units:\nur 1e5\nup 1e6\nq number\n")
        f.write("#SPECIES\n" + " ".join(species) + "\n\n")
        f.write("#TEADATA\n")
        cols = []
        if atm.radius is not None:
            cols.append("#Radius".ljust(11))
            cols.append("Pressure".ljust(11))
        else:
            cols.append("#Pressure".ljust(11))
        cols.append("Temp".ljust(8))
        cols += ["{:10s}".format(s) for s in species]
        f.write("".join(cols) + "\n")
        for i in reversed(range(atm.nlayers)):  # bottom first
            row = []
            if atm.radius is not None:
                row.append("{:10.3f} ".format(atm.radius[i]))
            row.append("{:10.4e} ".format(atm.pressure[i]))
            row.append("{:7.2f} ".format(atm.temperature[i]))
            row += ["{:1.4e} ".format(q) for q in atm.abundances[i]]
            f.write("".join(row) + "\n")
