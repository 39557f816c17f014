"""The demo CH4 eclipse retrieval problem, from in-repo inputs only.

One builder for the tests and ``chip_smoke.py``: the synthetic planet
system and ten top-hat filters, the synthetic CH4 line list
(seed 12, bands at 2700/3100/4300 cm-1), a log-uniform pressure grid
from 1e-5 to 100 bar, a uniform wn grid over 2500-5000 cm-1, and a
uniform T grid from 400 K up to 3000 K.  The full-width shape is the
benchmark's: 100 layers x 2501 wn x 30,000 lines x 27 T-nodes.

``demo_inputs`` returns plain numpy arrays, so a test can hand the same
arrays to bart_tpu and to this package; ``build_demo_model`` builds this
package's forward model from them.  ``random_rows`` makes a random
problem in the fused eclipse kernel's own layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bart_tpu.io.kurucz import blackbody_star
from bart_tpu.io.tep import PlanetSystem
from bart_tpu.linelist.hitran import LineList
from bart_tpu.linelist.tli import synthetic_linelist
from bart_tpu.utils.grids import pressure_grid

__all__ = ["DemoInputs", "demo_inputs", "build_demo_model", "random_rows",
           "DEMO_PARAMS", "TRUTH"]

#: demo cfg parameters [log kappa, log g1, log g2, alpha, beta, log CH4]
DEMO_PARAMS = np.array([-2.0, 0.0, 1.0, 0.0, 0.98, -0.5])
#: the synthetic-retrieval truth of tests/test_end_to_end.py
TRUTH = np.array([-1.8, 0.1, 1.0, 0.0, 0.95, -0.7])


@dataclasses.dataclass
class DemoInputs:
    system: PlanetSystem
    filters: list[tuple[np.ndarray, np.ndarray]]
    pressure: np.ndarray        # [nlayer] bar, top-first
    wn: np.ndarray              # [nwave] cm-1
    species: list[str]
    base_q: np.ndarray          # [nlayer, nspecies]
    lines: LineList             # CH4
    t_grid: np.ndarray          # [nT] K, uniform
    star_flux: np.ndarray       # [nwave] blackbody stellar flux

    @property
    def config_kwargs(self) -> dict:
        """ForwardConfig arguments of the demo (either package)."""
        return dict(solution="eclipse", pt_type="line", molfit=("CH4",))


def demo_inputs(nlayer: int = 100, nwave: int = 2501, nlines: int = 30000,
                t_step: float = 100.0) -> DemoInputs:
    """The demo problem's inputs at a given size (defaults: full width).
    ``t_step`` coarsens the T grid for small test problems."""
    system = PlanetSystem(6075.0, 7.97e8, 4.37, 7.05e9, 9.44e7, 1.32e27)
    centers = np.linspace(2600.0, 4900.0, 10)
    filters = [(np.linspace(c - 60, c + 60, 50), np.ones(50))
               for c in centers]
    wn = np.linspace(2500.0, 5000.0, nwave)
    starfl, _ = blackbody_star(wn, system.t_star)
    return DemoInputs(
        system=system,
        filters=filters,
        pressure=pressure_grid(nlayer, 1e-5, 100.0),
        wn=wn,
        species=["H2", "He", "CH4"],
        base_q=np.tile([0.85, 0.149, 1e-3], (nlayer, 1)),
        lines=synthetic_linelist("CH4", 2500.0, 5000.0, nlines, seed=12,
                                 band_centers=(2700.0, 3100.0, 4300.0)),
        t_grid=np.arange(400.0, 3001.0, t_step),
        star_flux=np.asarray(starfl),
    )


def random_rows(R: int, L: int, W: int, C: int, seed: int = 7):
    """A random rows-contraction problem in the fused_eclipse layout, as
    float64 numpy arrays (tab [R, L, W], wn [W], wrows [C, L, R],
    T [C, L], drp [C, L] with drp[:, 0] = 0).

    Row weights grow seven decades from the top layer to the bottom, as
    number densities do over the demo pressure grid, so the optical
    depth crosses unity inside the atmosphere.  (Weights of one scale
    saturate tau within the first layer, and every flux then reduces
    to the top layer's term, which hides the layer recurrence.)
    """
    rng = np.random.default_rng(seed)
    tab = rng.lognormal(-46.0, 2.0, (R, L, W))
    density = 10.0 ** np.linspace(8.0, 15.0, L)
    wrows = density[None, :, None] * rng.uniform(0.0, 1.0, (C, L, R))
    T = rng.uniform(500.0, 2900.0, (C, L))
    drp = np.concatenate(
        [np.zeros((C, 1)), rng.uniform(1e6, 5e6, (C, L - 1))], axis=1)
    return tab, np.linspace(2500.0, 5000.0, W), wrows, T, drp


def build_demo_model(inp: DemoInputs, *, device: str | torch.device = "cpu",
                     dtype: torch.dtype = torch.float32, grid=None,
                     quadrature: str = "raygrid", budget_bytes: float = 2e9):
    """This package's ForwardModel for the demo problem.  The opacity
    table is built on ``device`` unless ``grid`` (an OpacityGrid) is
    given."""
    from bart_tpu_torch.obs.bands import build_band_matrix
    from bart_tpu_torch.opacity.grid import build_opacity_grid
    from bart_tpu_torch.rt.forward import ForwardConfig, ForwardModel

    if grid is None:
        grid = build_opacity_grid({"CH4": inp.lines}, inp.wn, inp.t_grid,
                                  inp.pressure, budget_bytes=budget_bytes,
                                  device=device, dtype=dtype)
    bands = build_band_matrix(inp.wn, inp.filters, star_flux=inp.star_flux,
                              rprs=inp.system.rprs, device=device,
                              dtype=dtype)
    return ForwardModel(
        ForwardConfig(quadrature=quadrature, **inp.config_kwargs),
        wn_grid=inp.wn, pressure=inp.pressure, species=inp.species,
        base_abundances=inp.base_q, opacity=grid, system=inp.system,
        bands=bands, device=device, dtype=dtype,
    )
