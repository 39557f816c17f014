"""Transiting-ExtrasolarPlanet (TEP) file reader (this package's own copy
of bart_tpu/io/tep.py).

Parses the 5-column ASCII format ``param value uncert unit origin``
used by the reference (reference: code/reader.py:64-137,
inputs/tep/HD209458b.tep).  Host-side, numpy only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bart_tpu_torch import constants as const

__all__ = ["TepFile", "PlanetSystem"]


class TepFile:
    """Key-value view of a TEP file.

    ``getvalue(name)`` returns the raw string value; ``getfloat(name)``
    converts to float.  Unknown keys raise KeyError (the reference's
    ``checkpar`` semantics, code/reader.py:120-137).
    """

    def __init__(self, path: str):
        self.path = path
        self._params: dict[str, tuple[str, str, str, str]] = {}
        with open(path) as f:
            for line in f:
                line = line.split("#")[0].strip()
                if not line:
                    continue
                fields = line.split()
                if len(fields) < 2:
                    continue
                name = fields[0]
                value = fields[1]
                uncert = fields[2] if len(fields) > 2 else "-1"
                unit = fields[3] if len(fields) > 3 else "-"
                origin = fields[4] if len(fields) > 4 else "-"
                self._params[name] = (value, uncert, unit, origin)

    def getvalue(self, name: str) -> str:
        return self._params[name][0]

    def getfloat(self, name: str) -> float:
        return float(self._params[name][0])

    def getuncert(self, name: str) -> float:
        return float(self._params[name][1])

    def has(self, name: str) -> bool:
        return name in self._params


@dataclasses.dataclass(frozen=True)
class PlanetSystem:
    """Derived system quantities used by the forward model (SI unless noted).

    Mirrors the values BARTfunc extracts (reference: code/BARTfunc.py:157-171)
    and the gravity computation of makeatm.get_g (reference:
    code/makeatm.py:144-180).
    """

    t_star: float      # stellar effective temperature [K]
    r_star: float      # stellar radius [m]
    logg_star: float   # log10 stellar surface gravity [cgs]
    sma: float         # semi-major axis [m]
    r_planet: float    # planetary radius [m]
    m_planet: float    # planetary mass [kg]

    @property
    def g_planet_si(self) -> float:
        """Planet surface gravity [m s-2] (g = G M / R^2)."""
        return const.G_NEWTON * self.m_planet / self.r_planet**2

    @property
    def g_planet_cgs(self) -> float:
        """Planet surface gravity [cm s-2]."""
        return 100.0 * self.g_planet_si

    @property
    def rprs(self) -> float:
        """Planet-to-star radius ratio."""
        return self.r_planet / self.r_star

    @property
    def teff_planet(self) -> float:
        """Zero-albedo uniform-dayside equilibrium temperature [K]
        (reference: code/PT.py:101-153)."""
        return self.t_star * (self.r_star / self.sma) ** 0.5 * 0.5**0.25

    @classmethod
    def from_tep(cls, path: str) -> "PlanetSystem":
        tep = TepFile(path)
        return cls(
            t_star=tep.getfloat("Ts"),
            r_star=tep.getfloat("Rs") * const.RSUN,
            logg_star=tep.getfloat("loggstar"),
            sma=tep.getfloat("a") * const.AU,
            r_planet=tep.getfloat("Rp") * const.RJUP,
            m_planet=tep.getfloat("Mp") * const.MJUP,
        )
