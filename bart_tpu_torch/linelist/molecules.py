"""Built-in molecular data registry (this package's own copy of
bart_tpu/linelist/molecules.py).

Replaces the reference's ``transit/inputs/molecules.dat`` (molecular ID,
name, mass, collision diameter; reference scripts/broadening.py:146-188)
plus the spectroscopic constants needed for approximate
partition functions (linelist/tips.py).

Masses are the dominant-isotopologue values [amu]; diameters are
kinetic collision diameters [Angstrom]; rotational constants [cm-1];
vibrational fundamentals [(wavenumber cm-1, degeneracy), ...].
"""

from __future__ import annotations

import dataclasses

__all__ = ["Molecule", "MOLECULES", "get_molecule", "HITRAN_IDS",
           "load_molfile", "register_molecules"]


@dataclasses.dataclass(frozen=True)
class Molecule:
    name: str
    mass: float                # amu (dominant isotopologue)
    diameter: float            # collision diameter [Angstrom]
    linear: bool | None = None # None: atom (no rotation)
    sigma_rot: int = 1         # rotational symmetry number
    rot_const: tuple = ()      # (B,) linear or (A, B, C) nonlinear [cm-1]
    vib: tuple = ()            # ((wn, degeneracy), ...) fundamentals [cm-1]
    hitran_id: int | None = None


MOLECULES: dict[str, Molecule] = {
    "H2O": Molecule("H2O", 18.010565, 3.20, False, 2, (27.877, 14.512, 9.285),
                    ((3657.1, 1), (1594.7, 1), (3755.9, 1)), 1),
    "CO2": Molecule("CO2", 43.989830, 3.94, True, 2, (0.39021,),
                    ((1333.0, 1), (667.4, 2), (2349.1, 1)), 2),
    "O3": Molecule("O3", 47.984745, 4.00, False, 2, (3.5537, 0.4453, 0.3948),
                   ((1103.1, 1), (700.9, 1), (1042.1, 1)), 3),
    "N2O": Molecule("N2O", 44.001062, 3.85, True, 1, (0.41901,),
                    ((2223.8, 1), (588.8, 2), (1284.9, 1)), 4),
    "CO": Molecule("CO", 27.994915, 3.69, True, 1, (1.93128,),
                   ((2143.3, 1),), 5),
    "CH4": Molecule("CH4", 16.031300, 4.10, False, 12, (5.2412, 5.2412, 5.2412),
                    ((2916.5, 1), (1533.3, 2), (3019.5, 3), (1310.8, 3)), 6),
    "O2": Molecule("O2", 31.989830, 3.46, True, 2, (1.43768,),
                   ((1556.4, 1),), 7),
    "NO": Molecule("NO", 29.997989, 3.49, True, 1, (1.69611,),
                   ((1876.1, 1),), 8),
    "SO2": Molecule("SO2", 63.961901, 4.11, False, 2, (2.0274, 0.3442, 0.2935),
                    ((1151.4, 1), (517.9, 1), (1361.8, 1)), 9),
    "NH3": Molecule("NH3", 17.026549, 3.62, False, 3, (9.4443, 9.4443, 6.196),
                    ((3336.7, 1), (950.0, 1), (3443.8, 2), (1626.8, 2)), 11),
    "HCN": Molecule("HCN", 27.010899, 3.63, True, 1, (1.47822,),
                    ((2096.8, 1), (713.5, 2), (3311.5, 1)), 23),
    "C2H2": Molecule("C2H2", 26.015650, 4.03, True, 2, (1.17664,),
                     ((3372.8, 1), (1973.8, 1), (3294.8, 1), (612.9, 2),
                      (730.3, 2)), 26),
    "C2H4": Molecule("C2H4", 28.031300, 4.16, False, 4, (4.865, 1.0012, 0.8282),
                     ((3026.4, 1), (1623.0, 1), (1342.0, 1), (1023.0, 1),
                      (3103.0, 1), (1236.0, 1), (949.3, 1), (943.0, 1),
                      (3106.0, 1), (826.0, 1), (2989.0, 1), (1444.0, 1)), 38),
    "C2H6": Molecule("C2H6", 30.046950, 4.44, False, 6, (2.671, 0.6630, 0.6630),
                     ((2954.0, 1), (1388.0, 1), (995.0, 1), (289.0, 1),
                      (2896.0, 1), (1379.0, 1), (2969.0, 2), (1468.0, 2),
                      (821.0, 2), (2985.0, 2), (1469.0, 2), (1190.0, 2)), 27),
    "H2S": Molecule("H2S", 33.987721, 3.62, False, 2, (10.374, 9.0162, 4.7318),
                    ((2614.4, 1), (1182.6, 1), (2628.5, 1)), 31),
    "H2": Molecule("H2", 2.015650, 2.89, True, 2, (59.3344,),
                   ((4401.2, 1),), 45),
    "He": Molecule("He", 4.002602, 2.27, None),
    "N2": Molecule("N2", 28.006148, 3.64, True, 2, (1.99824,),
                   ((2358.6, 1),), 22),
    "Na": Molecule("Na", 22.989770, 3.40, None),
    "K": Molecule("K", 38.963707, 3.90, None),
    "TiO": Molecule("TiO", 63.942862, 4.20, True, 1, (0.53541,),
                    ((1009.0, 1),)),
    "VO": Molecule("VO", 66.938871, 4.20, True, 1, (1.0086,),
                   ((1011.3, 1),)),
    # atoms (for equilibrium atmospheres and mean-molar-mass bookkeeping)
    "H": Molecule("H", 1.007825, 2.40, None),
    "C": Molecule("C", 12.000000, 3.00, None),
    "N": Molecule("N", 14.003074, 3.00, None),
    "O": Molecule("O", 15.994915, 2.90, None),
    "S": Molecule("S", 31.972071, 3.50, None),
    "Fe": Molecule("Fe", 55.934942, 3.80, None),
    "Ti": Molecule("Ti", 47.947946, 3.90, None),
    "V": Molecule("V", 50.943964, 3.80, None),
    "H-": Molecule("H-", 1.008548, 2.0, None),
    "e-": Molecule("e-", 5.48579909e-4, 0.1, None),
}

#: HITRAN molecule number -> species name (2004+ format field 1)
HITRAN_IDS: dict[int, str] = {
    m.hitran_id: name for name, m in MOLECULES.items() if m.hitran_id
}


def get_molecule(name: str) -> Molecule:
    try:
        return MOLECULES[name]
    except KeyError:
        raise KeyError(
            f"species {name!r} not in the registry; add it to "
            "bart_tpu_torch/linelist/molecules.py or supply it via a "
            "molecules.dat-format `molfile` (load_molfile)"
        ) from None


def load_molfile(path: str) -> dict[str, Molecule]:
    """Parse a transit molecules.dat-format file: free-text header up to
    a line starting ``# ID``, one separator line, then rows
    ``ID  name  mass[amu]  diameter[Angstrom]`` until a blank line
    (reference: scripts/broadening.py:146-188 readmol)."""
    with open(path) as f:
        lines = f.readlines()
    start = 0
    for start, line in enumerate(lines):
        if line.startswith("# ID"):
            break
    else:
        raise ValueError(f"{path}: no '# ID' column-header line found")
    start += 2
    out: dict[str, Molecule] = {}
    while start < len(lines) and lines[start].strip():
        _id, name, mass, diam = lines[start].split()[:4]
        prev = MOLECULES.get(name)
        out[name] = Molecule(
            name, float(mass), float(diam),
            # keep any registry spectroscopic constants (the molfile
            # only carries mass + collision diameter, like the
            # reference's)
            linear=prev.linear if prev else None,
            sigma_rot=prev.sigma_rot if prev else 1,
            rot_const=prev.rot_const if prev else (),
            vib=prev.vib if prev else (),
            hitran_id=prev.hitran_id if prev else None,
        )
        start += 1
    return out


def register_molecules(source) -> None:
    """Extend/override the registry from a molecules.dat path or a
    {name: Molecule} dict (the reference's `molfile` capability,
    code/makecfg.py:36-52)."""
    mols = load_molfile(source) if isinstance(source, str) else source
    MOLECULES.update(mols)
    for name, m in mols.items():
        if m.hitran_id:
            HITRAN_IDS[m.hitran_id] = name
