"""Packed line data in the HITRAN S(296 K) convention (this package's
own copy of the ``LineList`` container of bart_tpu/linelist/hitran.py;
the ``.par`` parser stays with the JAX package).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LineList", "TREF"]

TREF = 296.0  # HITRAN reference temperature [K]


@dataclasses.dataclass
class LineList:
    """Packed line data for one species, sorted by line center."""

    species: str
    wn0: np.ndarray        # line centers [cm-1]
    s296: np.ndarray       # intensity at 296K [cm-1/(molec cm-2)]
    elower: np.ndarray     # lower-state energy [cm-1]
    gamma_air: np.ndarray  # air-broadened HWHM at 296K, 1 atm [cm-1/atm]
    gamma_self: np.ndarray # self-broadened HWHM [cm-1/atm]
    n_air: np.ndarray      # T exponent of gamma_air
    iso: np.ndarray        # isotopologue index (int8)

    @property
    def nlines(self) -> int:
        return len(self.wn0)

    def trim(self, wn_min: float, wn_max: float) -> "LineList":
        """Keep lines with centers inside [wn_min, wn_max] (pylineread
        iwav/fwav semantics)."""
        lo, hi = np.searchsorted(self.wn0, [wn_min, wn_max])
        return LineList(
            self.species,
            self.wn0[lo:hi], self.s296[lo:hi], self.elower[lo:hi],
            self.gamma_air[lo:hi], self.gamma_self[lo:hi],
            self.n_air[lo:hi], self.iso[lo:hi],
        )

    def strongest(self, n: int) -> "LineList":
        """Keep the n strongest lines (by S296), re-sorted by wn."""
        if n >= self.nlines:
            return self
        idx = np.sort(np.argpartition(self.s296, -n)[-n:])
        return LineList(
            self.species,
            self.wn0[idx], self.s296[idx], self.elower[idx],
            self.gamma_air[idx], self.gamma_self[idx],
            self.n_air[idx], self.iso[idx],
        )

    def cull(self, ethresh: float) -> "LineList":
        """Drop lines with S296 < ethresh * max(S296) (the reference's
        line-strength cutoff ``ethresh``, demo cfg ethresh 1e-6)."""
        keep = self.s296 >= ethresh * self.s296.max()
        return LineList(
            self.species,
            self.wn0[keep], self.s296[keep], self.elower[keep],
            self.gamma_air[keep], self.gamma_self[keep],
            self.n_air[keep], self.iso[keep],
        )

    @staticmethod
    def concatenate(lists: list["LineList"]) -> "LineList":
        """Merge line lists of the same species, re-sorted by wn
        (pylineread multi-database merge)."""
        sp = lists[0].species
        wn0 = np.concatenate([l.wn0 for l in lists])
        order = np.argsort(wn0, kind="stable")
        cat = lambda f: np.concatenate([getattr(l, f) for l in lists])[order]
        return LineList(
            sp, wn0[order], cat("s296"), cat("elower"),
            cat("gamma_air"), cat("gamma_self"), cat("n_air"), cat("iso"),
        )
