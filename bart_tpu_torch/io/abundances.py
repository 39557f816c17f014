"""Elemental-abundance table I/O and transformations.

This package's own host copy of bart_tpu/io/abundances.py.

Handles the Asplund et al. (2009)-style abundance file format of the
reference (reference: inputs/abundances_Asplund2009.txt;
code/makeatm.py:86-140 read_eabun, :266-330 makeAbun).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ElementTable", "read_elements", "scale_abundances", "write_elements"]


@dataclasses.dataclass
class ElementTable:
    index: np.ndarray    # ordinal index
    symbol: np.ndarray   # chemical symbol (str)
    dex: np.ndarray      # log10 number abundance, log(H)=12
    name: np.ndarray     # element name (str)
    mass: np.ndarray     # molar mass [amu]

    def mass_of(self, symbol: str) -> float:
        i = np.where(self.symbol == symbol)[0]
        if len(i) == 0:
            raise KeyError(f"element {symbol!r} not in abundance table")
        return float(self.mass[i[0]])

    def dex_of(self, symbol: str) -> float:
        i = np.where(self.symbol == symbol)[0]
        if len(i) == 0:
            raise KeyError(f"element {symbol!r} not in abundance table")
        return float(self.dex[i[0]])


def read_elements(path: str) -> ElementTable:
    """Parse the 5-column elemental abundances file
    (ordinal, symbol, dex, name, mass; reference code/makeatm.py:86-140)."""
    idx, sym, dex, name, mass = [], [], [], [], []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            fields = s.split()
            idx.append(int(fields[0]))
            sym.append(fields[1])
            dex.append(float(fields[2]))
            name.append(fields[3])
            mass.append(float(fields[4]))
    return ElementTable(
        index=np.asarray(idx, int),
        symbol=np.asarray(sym),
        dex=np.asarray(dex, np.float64),
        name=np.asarray(name),
        mass=np.asarray(mass, np.float64),
    )


def scale_abundances(
    table: ElementTable, solar_times: float = 1.0, co_swap: bool = False
) -> ElementTable:
    """Metallicity scaling and optional C/O swap.

    Multiplies every metal abundance (all but H, He) by ``solar_times``
    and optionally swaps the C and O dex values (reference
    code/makeatm.py:306-319).
    """
    dex = table.dex.copy()
    imetals = np.where((table.symbol != "H") & (table.symbol != "He"))
    dex[imetals] += np.log10(solar_times)
    if co_swap:
        iC = np.where(table.symbol == "C")
        iO = np.where(table.symbol == "O")
        dex[iC], dex[iO] = table.dex[iO] + np.log10(solar_times), table.dex[
            iC
        ] + np.log10(solar_times)
    return ElementTable(table.index, table.symbol, dex, table.name, table.mass)


def write_elements(table: ElementTable, path: str) -> None:
    """Write an abundance file in the reference format
    (reference code/makeatm.py:321-330)."""
    with open(path, "w") as f:
        f.write(
            "# Elemental abundances:\n"
            "# Columns: ordinal, symbol, dex abundances, name, molar mass.\n"
        )
        for i in range(len(table.symbol)):
            f.write(
                "{:3d}  {:2s}  {:5.2f}  {:10s}  {:12.8f}\n".format(
                    table.index[i],
                    table.symbol[i],
                    table.dex[i],
                    table.name[i],
                    table.mass[i],
                )
            )
