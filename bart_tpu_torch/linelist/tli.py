"""Synthetic line lists (this package's own copy of
``synthetic_linelist`` of bart_tpu/linelist/tli.py: the same numpy
generator calls in the same order, so a seed gives the same lines).
"""

from __future__ import annotations

import numpy as np

from bart_tpu_torch.linelist.hitran import LineList

__all__ = ["synthetic_linelist"]


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
