"""bart_tpu_torch transit forward model, and the CIA, Rayleigh and cloud
rows in both geometries, against bart_tpu's ``batched()`` at float64 on a
small demo problem; then a short transit retrieval.

The opacity table is built once by bart_tpu and every table is carried
over with ``tables_from_jax``, so the comparison isolates the forward
model.  The transit kernel's own output (``out``, the absorbed area) is
compared too: the depth adds r_bot^2, most of it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bart_tpu.obs.bands import build_band_matrix as jbands
from bart_tpu.opacity.grid import build_opacity_grid as jbuild
from bart_tpu.rt.forward import ForwardConfig as JConfig
from bart_tpu.rt.forward import ForwardModel as JModel

from bart_tpu_torch.demo import (DEMO_PARAMS, DEMO_PARAMS_TRANSIT,
                                 TRANSIT_BOUNDS, TRUTH_TRANSIT,
                                 build_demo_model, demo_inputs)
from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
from bart_tpu_torch.inference.retrieval import run_mcmc
from bart_tpu_torch.opacity.grid import OpacityGrid
from bart_tpu_torch.rt.forward import ForwardConfig, ForwardModel
from bart_tpu_torch.rt.fused import fused_transit
from bart_tpu_torch.rt.transit_geom import slant_geometry

F64 = torch.float64
NL, NW = 12, 256


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def demo():
    """(inputs, bart_tpu OpacityGrid) of the small demo problem."""
    inp = demo_inputs(nlayer=NL, nwave=NW, nlines=300, t_step=520.0)
    grid = jbuild({"CH4": inp.lines}, inp.wn, inp.t_grid, inp.pressure,
                  cond_batch=80, dtype=jnp.float64)
    return inp, grid


def _models(inp, grid, solution, cia=True, **cfg):
    """(bart_tpu model, this package's model, its tables carried over
    from the bart_tpu model)."""
    if solution == "transit":
        bands = jbands(inp.wn, inp.filters)
        kw = inp.transit_config_kwargs
    else:
        bands = jbands(inp.wn, inp.filters, star_flux=inp.star_flux,
                       rprs=inp.system.rprs)
        kw = inp.config_kwargs
    common = dict(wn_grid=inp.wn, pressure=inp.pressure, species=inp.species,
                  base_abundances=inp.base_q, system=inp.system,
                  cia_tables=[inp.cia] if cia else [])
    fmj = JModel(JConfig(**kw, **cfg), opacity=grid, bands=bands,
                 dtype=jnp.float64, **common)
    tgrid = OpacityGrid(grid.species, grid.t_grid, grid.pressure,
                        grid.wn_grid, torch.tensor(np.asarray(grid.sigma)))
    fmt = build_demo_model(inp, dtype=F64, grid=tgrid, solution=solution,
                           cia=cia, device="cpu")
    if cfg:
        fmt = ForwardModel(ForwardConfig(**kw, **cfg), opacity=tgrid,
                           bands=fmt.bands, dtype=F64, device="cpu",
                           **common)
    tabs = fmt.tables_from_jax({k: np.asarray(v)
                                for k, v in fmj.tables.items()})
    return fmj, fmt, tabs


def _params(base, extra=(), seed=0):
    """Four chains around ``base`` with ``extra`` (cloudtop, Rayleigh)
    inserted before the last (CH4) entry; chain 3 has T far above tmax
    (invalid).  In transit the radius (index 5) spreads by ~100 km."""
    rng = np.random.default_rng(seed)
    base = np.concatenate([base[:-1], extra, base[-1:]])
    P = np.tile(base, (4, 1)) + rng.normal(0, 0.01, (4, len(base)))
    if len(base) >= 7 and base[5] > 1e4:
        P[:, 5] += rng.normal(0, 100.0, 4)
    P[3, 4] = 3.0
    return P


def _jax_absorbed(fmj, P):
    """bart_tpu's fused_transit output per chain, through its own
    profiles, rows and slant geometry."""
    from bart_tpu.rt.fused import fused_transit as jft
    from bart_tpu.rt.transit_geom import slant_geometry as jgeom

    def one(p):
        T, q, rad, _ = fmj._profiles(p, fmj.tables)
        parts, wrows = fmj._fused_rows(p, fmj.tables, T, q, rad)
        G, wgt = jgeom(rad)
        return jft(parts[0][0], wrows, G, wgt)

    return np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(P)))


def _compare(fmj, fmt, tabs, P):
    bj, sj, vj = fmj.batched()(jnp.asarray(P))
    bt, st, vt = fmt(torch.tensor(P), tabs)
    assert bt.shape == (4, 10) and st.shape == (4, NW)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert not vt[3] and vt[:3].all()
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-9)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-9)
    return st


# ---------------------------------------------------------------------
# transit

TRANSIT_CASES = {
    "cia": ({}, ()),
    "cia+ray+cloudtop": ({"scattering": "ray", "cloudtop": True},
                         (1.0, 0.5)),
    # 'polar' keeps its (unused) parameter slot, as in bart_tpu
    "cia+polar+cloudrad": ({"scattering": "polar",
                            "cloudrad": (94000.0, 93000.0), "cloudext": 1e-4},
                           (0.0,)),
    "cia+ebalance": ({"ebalance": True}, ()),
}


@pytest.mark.parametrize("case", list(TRANSIT_CASES))
def test_transit_forward_matches_bart_tpu(demo, case):
    cfg, extra = TRANSIT_CASES[case]
    inp, grid = demo
    fmj, fmt, tabs = _models(inp, grid, "transit", **cfg)
    assert fmt.config.n_params == 7 + len(extra)
    assert tabs["frows"].shape[0] == 14 + (cfg.get("scattering") is not None) \
        + cfg.get("cloudtop", False) + ("cloudrad" in cfg)
    P = _params(DEMO_PARAMS_TRANSIT, extra)
    st = _compare(fmj, fmt, tabs, P)
    # the kernel's own output, before r_bot^2 is added
    T, q, rad, _ = fmt._profiles(torch.tensor(P), tabs)
    ((tab, folded, _, idx),), wrows = fmt._fused_rows(torch.tensor(P), tabs,
                                                      T, q, rad)
    assert not folded and idx is None
    assert tab is tabs["tab"]                 # the prepared table, as it is
    assert tab.tab.shape[0] == wrows.shape[2] \
        == np.asarray(grid.sigma).shape[1] + tabs["frows"].shape[0]
    absorbed = fused_transit(tab, wrows, *slant_geometry(rad))
    np.testing.assert_allclose(absorbed.numpy(), _jax_absorbed(fmj, P),
                               rtol=1e-9)
    rbot2 = rad[:, -1:] ** 2
    assert float((absorbed / rbot2).min()) > 1e-3   # the atmosphere absorbs
    r_star = inp.system.r_star * 100.0
    np.testing.assert_allclose(st.numpy(),
                               ((rbot2 + absorbed) / r_star**2).numpy(),
                               rtol=1e-12)


def test_transit_depths_follow_the_fitted_radius(demo):
    inp, grid = demo
    _, fmt, tabs = _models(inp, grid, "transit")
    P = np.tile(DEMO_PARAMS_TRANSIT, (2, 1))
    P[1, 5] += 500.0
    band, _, valid = fmt(torch.tensor(P), tabs)
    assert valid.all()
    assert bool((band[1] > band[0]).all())
    # rprs^2 = 1.40% at the anchor; depths in (1%, 3%)
    assert bool(((band > 0.01) & (band < 0.03)).all())


def test_tables_from_jax_carries_transit_cia_tables(demo):
    inp, grid = demo
    fmj, fmt, tabs = _models(inp, grid, "transit",
                             scattering="ray", cloudtop=True)
    assert {"cia0_temps", "cia0_wn", "cia0_abs", "frows"} <= set(tabs)
    for k, v in tabs.items():
        # the K = 1 table in the kernels' layout: compare its plain form
        v, mine = (x.plain() if k == "tab" else x
                   for x in (v, fmt.tables[k]))
        np.testing.assert_allclose(v.numpy(), mine.numpy(),
                                   rtol=1e-15, err_msg=k)
    # line rows, then the continuum rows, as views of the one table
    n_line = tabs["sigma"].shape[0] * tabs["sigma"].shape[1]
    assert tabs["tab"].tab.shape[0] == n_line + tabs["frows"].shape[0]
    assert tabs["frows"].data_ptr() == tabs["tab"].tab[n_line:].data_ptr()
    with pytest.raises(ValueError, match="keys differ"):
        fmt.tables_from_jax({k: np.asarray(v) for k, v in fmj.tables.items()
                             if k != "frows"})


# ---------------------------------------------------------------------
# eclipse with the continuum rows (tests/test_fused.py:129's case)

@pytest.mark.parametrize("cfg,extra", [
    ({"scattering": "ray", "cloudtop": True}, (0.05, 0.3)),
    ({"cloudrad": (94000.0, 93000.0), "cloudext": 1e-4,
      "quadrature": "expsum"}, ()),
])
def test_eclipse_forward_with_continuum_matches_bart_tpu(demo, cfg, extra):
    inp, grid = demo
    fmj, fmt, tabs = _models(inp, grid, "eclipse", **cfg)
    _compare(fmj, fmt, tabs, _params(DEMO_PARAMS, extra))


# ---------------------------------------------------------------------
# retrieval

def test_run_mcmc_transit_two_blocks(demo):
    inp, grid = demo
    _, fmt, _ = _models(inp, grid, "transit")
    pmin, pmax, step = TRANSIT_BOUNDS
    space = ParamSpace(pinit=DEMO_PARAMS_TRANSIT, pmin=pmin, pmax=pmax,
                       stepsize=step)
    data = fmt(torch.tensor(TRUTH_TRANSIT[None]))[0][0].numpy()
    uncert = 0.005 * data
    data = data + np.random.default_rng(42).normal(0, 1, data.shape) * uncert
    res = run_mcmc(Likelihood(fmt, space, data, uncert), space, nchains=8,
                   numit=80, burnin=5, block=5, seed=7, verbose=False)
    assert space.nfree == 5 and res.posterior.shape == (8, 5, 5)
    assert res.niter_total == 80 and np.isfinite(res.best_loglike)
    assert 0.0 < res.accept_rate <= 1.0
    assert np.all(res.posterior >= space.free_min[None, :, None])
    assert np.all(res.posterior <= space.free_max[None, :, None])
