"""The demo CH4 eclipse and transit retrieval problems, from in-repo
inputs only.

One builder for the tests and ``chip_smoke.py``: the synthetic planet
system and ten top-hat filters, the synthetic CH4 line list
(seed 12, bands at 2700/3100/4300 cm-1), the H2-H2 CIA table of
examples/demo_inputs (14 T-nodes), a log-uniform pressure grid from
1e-5 to 100 bar, a uniform wn grid over 2500-5000 cm-1, and a uniform T
grid from 400 K up to 3000 K.  The full-width shape is the benchmark's:
100 layers x 2501 wn x 30,000 lines x 27 T-nodes.  The transit demo
(examples/demo_transit.cfg) adds the fitted radius and the CIA rows:
R = 27 + 14 = 41 table rows.

``demo_inputs`` returns plain numpy arrays, so a test can hand the same
arrays to bart_tpu and to this package; ``build_demo_model`` builds this
package's forward model from them.  ``random_rows`` and
``random_transit_rows`` make random problems in the fused kernels' own
layouts, and ``fine_structure`` the in-bin structure that turns their
tables into folded ones.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from bart_tpu_torch.io.kurucz import blackbody_star
from bart_tpu_torch.io.tep import PlanetSystem
from bart_tpu_torch.linelist.hitran import LineList
from bart_tpu_torch.linelist.tli import synthetic_linelist
from bart_tpu_torch.utils.grids import folded_fine_grid, pressure_grid
from bart_tpu_torch.opacity.cia import CiaTable, read_cia

__all__ = ["DemoInputs", "demo_inputs", "build_demo_model", "random_rows",
           "random_transit_rows", "fine_structure", "DEMO_PARAMS", "TRUTH",
           "DEMO_PARAMS_TRANSIT", "TRUTH_TRANSIT", "TRANSIT_BOUNDS",
           "PT_PARAMS", "demo_params"]

_CIA_FILE = (Path(__file__).resolve().parents[1] / "examples" / "demo_inputs"
             / "CIA_H2H2_demo.dat")
_SYSTEM = PlanetSystem(6075.0, 7.97e8, 4.37, 7.05e9, 9.44e7, 1.32e27)
#: the demo planet's radius [km], the transit radius parameter's value
R0_KM = _SYSTEM.r_planet / 1000.0

#: demo cfg parameters [log kappa, log g1, log g2, alpha, beta, log CH4]
DEMO_PARAMS = np.array([-2.0, 0.0, 1.0, 0.0, 0.98, -0.5])
#: the synthetic-retrieval truth of tests/test_end_to_end.py
TRUTH = np.array([-1.8, 0.1, 1.0, 0.0, 0.95, -0.7])
#: PT parameters of every family, in bart_tpu/physics/pt.py's order, whose
#: profiles on the demo grid stay inside [tmin, tmax] = [400, 3000] K
PT_PARAMS = {
    "iso": np.array([1400.0]),
    "line": DEMO_PARAMS[:5],
    "madhu_noinv": np.array([0.4, 0.25, 0.005, 2.0, 1500.0]),
    "madhu_inv": np.array([0.5, 0.2, 0.005, 0.1, 3.0, 1600.0]),
    "adiabatic": np.array([1500.0, 1.06, -1.0]),
    "piette": np.array([1300.0, 250.0, 150.0, 100.0, 80.0, 60.0, 40.0,
                        30.0]),
}


def demo_params(pt_type: str = "line") -> np.ndarray:
    """The eclipse demo's parameters with the PT family ``pt_type``: its
    PT_PARAMS, then log CH4."""
    return np.concatenate([PT_PARAMS[pt_type], DEMO_PARAMS[5:]])


#: transit parameters: the radius [km] inserted at index 5, as bench.py
DEMO_PARAMS_TRANSIT = np.insert(DEMO_PARAMS, 5, R0_KM)
TRUTH_TRANSIT = np.insert(TRUTH, 5, R0_KM)
#: (pmin, pmax, stepsize) of examples/demo_transit.cfg
TRANSIT_BOUNDS = (np.array([-5.0, -2.0, -2.0, 0.0, 0.55, 75000.0, -9.0]),
                  np.array([-1.0, 1.0, 1.0, 1.0, 1.2, 115000.0, 1.5]),
                  np.array([0.01, 0.01, 0.0, 0.0, 0.001, 100.0, 0.1]))


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
    cia: CiaTable               # H2-H2, examples/demo_inputs

    @property
    def config_kwargs(self) -> dict:
        """ForwardConfig arguments of the eclipse demo (either package)."""
        return dict(solution="eclipse", pt_type="line", molfit=("CH4",))

    @property
    def transit_config_kwargs(self) -> dict:
        """ForwardConfig arguments of the transit demo (either package)."""
        return dict(solution="transit", pt_type="line", molfit=("CH4",))


def demo_inputs(nlayer: int = 100, nwave: int = 2501, nlines: int = 30000,
                t_step: float = 100.0) -> DemoInputs:
    """The demo problem's inputs at a given size (defaults: full width).
    ``t_step`` coarsens the T grid for small test problems."""
    system = _SYSTEM
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
        cia=read_cia(str(_CIA_FILE)),
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


def random_transit_rows(R: int, L: int, W: int, C: int, seed: int = 7):
    """A random problem in the fused_transit layout, as float64 numpy
    arrays: tab [R, L, W], wrows [C, L, R], G [C, L, L], wgt [C, L] (from
    slant_geometry of the radii) and the radii rad [C, L] in cm.

    A slant path is ~50-100x the vertical one, so weights that make the
    vertical tau cross unity mid-atmosphere saturate the slant tau past
    the clamp, and then out = sum(wgt) whatever the extinction.  Here the
    weights grow five decades downwards and are scaled (tau is linear in
    them) so that the median slant tau of the middle impact parameter is
    1: tau crosses unity inside the atmosphere.
    """
    from bart_tpu_torch.rt.transit_geom import slant_geometry

    rng = np.random.default_rng(seed)
    tab = rng.lognormal(-46.0, 2.0, (R, L, W))
    density = 10.0 ** np.linspace(0.0, 5.0, L)
    wrows = density[None, :, None] * rng.uniform(0.0, 1.0, (C, L, R))
    rad = 9.44e9 - np.cumsum(rng.uniform(3e6, 8e6, (C, L)), axis=1)
    G, wgt = (a.numpy() for a in slant_geometry(torch.tensor(rad)))
    # tau of the middle impact parameter, sum_{l,r} G[mid, l] wrows tab,
    # as one matrix product
    v = (G[:, L // 2, :, None] * wrows).reshape(C, L * R)
    tau_mid = v @ tab.transpose(1, 0, 2).reshape(L * R, W)
    wrows = wrows / np.median(tau_mid)
    return tab, wrows, G, wgt, rad


def fine_structure(R: int, W: int, K: int, seed: int = 5) -> np.ndarray:
    """In-bin structure for a random folded problem: a factor
    [R, 1, W, K] with mean 1 over the K sub-samples of every (row, bin),
    so that ``(tab[..., None] * factor).reshape(R, L, W * K)`` is a
    bin-major fine table whose bin means are ``tab``.

    Every sub-sample carries lognormal scatter, and half of the (row,
    bin) pairs a narrow feature, a Gaussian 0.8 fine points wide and up
    to 40 times the background, as a line core inside the bin: a kernel
    that averaged the extinction before the exponential would be far off.
    """
    rng = np.random.default_rng(seed)
    amp = rng.uniform(0.0, 40.0, (R, 1, W, 1)) * (rng.random((R, 1, W, 1)) < 0.5)
    k0 = rng.uniform(0.0, K, (R, 1, W, 1))
    core = np.exp(-0.5 * ((np.arange(K) + 0.5 - k0) / 0.8) ** 2)
    factor = rng.lognormal(0.0, 0.3, (R, 1, W, K)) * (1.0 + amp * core)
    return factor / factor.mean(axis=-1, keepdims=True)


def build_demo_model(inp: DemoInputs, *, device: str | torch.device = "cuda",
                     dtype: torch.dtype = torch.float32, grid=None,
                     quadrature: str = "raygrid", budget_bytes: float = 2e9,
                     solution: str = "eclipse", cia: bool = False,
                     fold: int = 1, fold_adapt: float | None = 0.02,
                     fold_bf16: bool = False, pt_type: str = "line"):
    """This package's ForwardModel for the demo problem, on ``device``
    (the card unless the caller asks for the CPU).  The opacity table is
    built there unless ``grid`` (an OpacityGrid, e.g. another demo
    model's ``opacity``) is given.  ``solution="transit"`` builds the
    transit demo, whose bands have no stellar division; ``cia`` adds the
    H2-H2 CIA rows.  ``fold`` = K > 1 builds the folded model: the table
    on the K-times-finer folded_fine_grid(inp.wn, K), bands and outputs
    on ``inp.wn``; ``fold_adapt`` and ``fold_bf16`` as ForwardModel's.
    ``pt_type`` picks the PT family (demo_params gives its parameters)."""
    from bart_tpu_torch.obs.bands import build_band_matrix
    from bart_tpu_torch.opacity.grid import build_opacity_grid
    from bart_tpu_torch.rt.forward import ForwardConfig, ForwardModel

    if grid is None:
        grid = build_opacity_grid({"CH4": inp.lines},
                                  folded_fine_grid(inp.wn, fold), inp.t_grid,
                                  inp.pressure, budget_bytes=budget_bytes,
                                  device=device, dtype=dtype)
    if solution == "transit":
        bands = build_band_matrix(inp.wn, inp.filters, device=device,
                                  dtype=dtype)
        kwargs = inp.transit_config_kwargs
    else:
        bands = build_band_matrix(inp.wn, inp.filters,
                                  star_flux=inp.star_flux,
                                  rprs=inp.system.rprs, device=device,
                                  dtype=dtype)
        kwargs = {**inp.config_kwargs, "solution": solution}
    return ForwardModel(
        ForwardConfig(quadrature=quadrature,
                      **{**kwargs, "pt_type": pt_type}),
        wn_grid=inp.wn, pressure=inp.pressure, species=inp.species,
        base_abundances=inp.base_q, opacity=grid, system=inp.system,
        bands=bands, cia_tables=[inp.cia] if cia else [], fold_osamp=fold,
        fold_adapt=fold_adapt, fold_bf16=fold_bf16, device=device,
        dtype=dtype,
    )
