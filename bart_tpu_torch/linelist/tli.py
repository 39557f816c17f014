"""TLI artifact, the packed on-disk line database, and synthetic line
lists (this package's own host copy of bart_tpu/linelist/tli.py: the
same ``.npz`` layout, and the same numpy generator calls in the same
order, so a seed gives the same lines).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bart_tpu_torch.linelist.hitran import LineList

__all__ = ["TliData", "save_tli", "load_tli", "synthetic_linelist"]

_FORMAT_VERSION = 1


@dataclasses.dataclass
class TliData:
    """A multi-species line database with wavelength coverage metadata."""

    species: list[str]
    lines: dict[str, LineList]
    wn_min: float
    wn_max: float
    # optional per-species tabulated partition functions {name: (T, Q)}
    partition: dict[str, tuple[np.ndarray, np.ndarray]] = dataclasses.field(
        default_factory=dict
    )

    def total_lines(self) -> int:
        return sum(l.nlines for l in self.lines.values())


def save_tli(data: TliData, path: str) -> None:
    arrays: dict[str, np.ndarray] = {
        "__version__": np.array(_FORMAT_VERSION),
        "__species__": np.asarray(data.species),
        "__wn_range__": np.array([data.wn_min, data.wn_max]),
    }
    for name, ll in data.lines.items():
        for f in ("wn0", "s296", "elower", "gamma_air", "gamma_self", "n_air", "iso"):
            arrays[f"{name}/{f}"] = getattr(ll, f)
    for name, (t, q) in data.partition.items():
        arrays[f"{name}/partT"] = np.asarray(t)
        arrays[f"{name}/partQ"] = np.asarray(q)
    np.savez_compressed(path, **arrays)


def load_tli(path: str) -> TliData:
    z = np.load(path, allow_pickle=False)
    species = [str(s) for s in z["__species__"]]
    wn_min, wn_max = z["__wn_range__"]
    lines = {}
    partition = {}
    for name in species:
        lines[name] = LineList(
            name,
            z[f"{name}/wn0"], z[f"{name}/s296"], z[f"{name}/elower"],
            z[f"{name}/gamma_air"], z[f"{name}/gamma_self"],
            z[f"{name}/n_air"], z[f"{name}/iso"],
        )
        if f"{name}/partT" in z:
            partition[name] = (z[f"{name}/partT"], z[f"{name}/partQ"])
    return TliData(species, lines, float(wn_min), float(wn_max), partition)


def synthetic_linelist(
    species: str,
    wn_min: float,
    wn_max: float,
    nlines: int,
    seed: int = 0,
    s_max: float = 1e-19,
    band_centers: tuple = (),
) -> LineList:
    """Generate a statistically realistic synthetic line list.

    Used by tests and the demo problems: real HITRAN data cannot ship
    with the repo.  Line centers are
    uniform (or clustered around ``band_centers``), intensities
    log-uniform over 8 dex below ``s_max``, lower-state energies 0-3000
    cm-1, air/self widths near typical 0.05/0.08 cm-1/atm.
    """
    rng = np.random.default_rng(seed)
    if band_centers:
        k = rng.integers(0, len(band_centers), nlines)
        wn0 = np.clip(
            np.asarray(band_centers)[k] + rng.normal(0.0, 40.0, nlines),
            wn_min, wn_max,
        )
    else:
        wn0 = rng.uniform(wn_min, wn_max, nlines)
    order = np.argsort(wn0)
    return LineList(
        species=species,
        wn0=wn0[order],
        s296=s_max * 10.0 ** rng.uniform(-8.0, 0.0, nlines)[order],
        elower=rng.uniform(0.0, 3000.0, nlines)[order],
        gamma_air=rng.uniform(0.03, 0.08, nlines)[order],
        gamma_self=rng.uniform(0.05, 0.12, nlines)[order],
        n_air=rng.uniform(0.4, 0.8, nlines)[order],
        iso=np.ones(nlines, np.int8),
    )
