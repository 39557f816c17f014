"""bart_tpu_torch's PT profiles against bart_tpu's, batched over chains
at float64: every family against ``jax.vmap`` of bart_tpu's function at
rtol 1e-10 over four chains, one of them invalid where the family has a
validity flag (the flags equal too); the matrix form of the Gaussian
smoothing against bart_tpu's and scipy's; the dispatcher; and a forward
model of every family against bart_tpu's ``batched()``."""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter1d

import jax
import jax.numpy as jnp

from bart_tpu.physics import pt as jpt

from bart_tpu_torch.demo import PT_PARAMS, demo_params
from bart_tpu_torch.physics import pt

P = np.logspace(-5, 2, 100)          # bar, top-first, as tests/test_pt.py
F64 = torch.float64
LINE_ARGS = (0.756 * 6.995e8, 5040.0, 100.0, 0.031 * 1.495978707e11, 2192.8)

#: per family: four chains' parameters and the index of the invalid chain
#: (None: the family is always valid)
CASES = {
    "iso": ([[1234.5], [800.0], [1500.0], [2900.0]], None),
    "line": ([[-1.5, -0.8, -0.8, 0.5, 1.0], [-2.0, 0.0, 1.0, 0.0, 0.98],
              [-1.0, -0.5, 0.3, 0.3, 0.8], [-3.0, 0.5, -0.5, 0.9, 1.1]],
             None),
    # chain 3: T2 < 0, tests/test_pt.py:89
    "madhu_inv": ([[0.5, 0.2, 0.005, 0.1, 3.0, 1600.0],
                   [0.45, 0.25, 0.003, 0.2, 5.0, 1400.0],
                   [0.6, 0.15, 0.01, 0.3, 2.0, 1800.0],
                   [0.5, 0.04, 0.005, 0.01, 50.0, 100.0]], 3),
    # chain 2: p1 > p3
    "madhu_noinv": ([[0.4, 0.25, 0.005, 2.0, 1500.0],
                     [0.35, 0.3, 0.01, 5.0, 1700.0],
                     [0.4, 0.25, 3.0, 2.0, 1500.0],
                     [0.5, 0.2, 0.002, 1.0, 1300.0]], 2),
    # chain 1: the adiabat crosses T = 0 inside the grid
    "adiabatic": ([[1500.0, 1.4, 1.0], [1500.0, 3.0, 1.0],
                   [1200.0, 1.06, -1.0], [2000.0, 1.2, 0.5]], 1),
    # chain 0: a negative temperature at the top
    "piette": ([[1300.0, 250.0, 150.0, 100.0, 80.0, 60.0, 40.0, 1500.0],
                [1300.0, 250.0, 150.0, 100.0, 80.0, 60.0, 40.0, 30.0],
                [1100.0, 300.0, 100.0, 50.0, 120.0, 40.0, 20.0, 10.0],
                [1600.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], 0),
}


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _reference(family, params):
    fn = jpt.PT_MODELS[family]
    extra = LINE_ARGS if family == "line" else ()
    T, valid = jax.vmap(lambda c: fn(jnp.asarray(P), *c, *extra))(
        tuple(jnp.asarray(params[:, i]) for i in range(params.shape[1])))
    return np.asarray(T), np.asarray(valid)


@pytest.mark.parametrize("family", list(CASES))
def test_pt_family_matches_bart_tpu(family):
    rows, bad = CASES[family]
    params = np.array(rows, np.float64)
    Tj, vj = _reference(family, params)
    fn = pt.PT_MODELS[family]
    extra = LINE_ARGS if family == "line" else ()
    T, valid = fn(torch.tensor(P), *torch.tensor(params).T, *extra)
    assert T.shape == (4, len(P)) and valid.shape == (4,)
    assert T.dtype == F64 and valid.dtype == torch.bool
    np.testing.assert_allclose(T.numpy(), Tj, rtol=1e-10)
    np.testing.assert_array_equal(valid.numpy(), vj)
    expect = np.ones(4, bool)
    if bad is not None:
        expect[bad] = False
    np.testing.assert_array_equal(valid.numpy(), expect)


@pytest.mark.parametrize("family", list(CASES))
def test_pt_generator_dispatches_every_family(family):
    params = np.array(CASES[family][0], np.float64)
    args = list(LINE_ARGS) + ["const"] if family == "line" else None
    T, valid = pt.pt_generator(torch.tensor(P), torch.tensor(params), family,
                               args)
    Tj, vj = _reference(family, params)
    np.testing.assert_allclose(T.numpy(), Tj, rtol=1e-10)
    np.testing.assert_array_equal(valid.numpy(), vj)


@pytest.mark.parametrize("sigma", [0.4, 1.0, 4.0, 2.7])
def test_gaussian_smooth_matches_bart_tpu_and_scipy(sigma):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 100))
    got = pt.gaussian_smooth(torch.tensor(x), sigma).numpy()
    for row, g in zip(x, got):
        np.testing.assert_allclose(
            g, np.asarray(jpt.gaussian_smooth(jnp.asarray(row), sigma)),
            rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(
            g, gaussian_filter1d(row, sigma, mode="nearest"), rtol=1e-12,
            atol=1e-14)


def test_traced_sigma_smoothing_matches_bart_tpu():
    """Piette's smoothing, sigma = 0.3 dex in layers of the grid, through
    the masked 129-tap matrix."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, len(P)))
    dlp = abs(np.log10(P[0]) - np.log10(P[1]))
    got = pt._smooth_traced_sigma(torch.tensor(x), torch.tensor(dlp)).numpy()
    for row, g in zip(x, got):
        np.testing.assert_allclose(
            g, np.asarray(jpt._smooth_traced_sigma(jnp.asarray(row),
                                                   jnp.asarray(dlp))),
            rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(
            g, gaussian_filter1d(row, 0.3 / dlp, mode="nearest"),
            rtol=1e-12, atol=1e-14)


def test_piette_grid_made_once_per_grid():
    """The anchors and the smoothing matrix are made at the first call
    with a grid tensor and reused while it lives."""
    p = torch.tensor(P)
    params = torch.tensor(CASES["piette"][0], dtype=F64).T
    pt.pt_piette(p, *params)
    made = pt._piette_grid(p)
    pt.pt_piette(p, *params)
    assert pt._piette_grid(p) is made
    key = id(p)
    del p
    assert key not in pt._PIETTE_GRIDS


# ---------------------------------------------------------------------
# the forward model of every family

@pytest.fixture(scope="module")
def demo():
    """(inputs, bart_tpu OpacityGrid) of the small demo problem."""
    from bart_tpu.opacity.grid import build_opacity_grid as jbuild

    from bart_tpu_torch.demo import demo_inputs

    inp = demo_inputs(nlayer=12, nwave=256, nlines=300, t_step=520.0)
    grid = jbuild({"CH4": inp.lines}, inp.wn, inp.t_grid, inp.pressure,
                  cond_batch=80, dtype=jnp.float64)
    return inp, grid


#: per family, the parameter index and value that lift chain 3's profile
#: above tmax
TOO_HOT = {"iso": (0, 5000.0), "line": (4, 3.0), "madhu_inv": (5, 4000.0),
           "madhu_noinv": (4, 4000.0), "adiabatic": (0, 5000.0),
           "piette": (0, 5000.0)}


@pytest.mark.parametrize("family", sorted(PT_PARAMS))
def test_forward_of_every_family_matches_bart_tpu(demo, family):
    from bart_tpu.obs.bands import build_band_matrix as jbands
    from bart_tpu.rt.forward import ForwardConfig as JConfig
    from bart_tpu.rt.forward import ForwardModel as JModel

    from bart_tpu_torch.demo import build_demo_model
    from bart_tpu_torch.opacity.grid import OpacityGrid

    inp, grid = demo
    bands = jbands(inp.wn, inp.filters, star_flux=inp.star_flux,
                   rprs=inp.system.rprs)
    fmj = JModel(JConfig(**{**inp.config_kwargs, "pt_type": family}),
                 wn_grid=inp.wn, pressure=inp.pressure, species=inp.species,
                 base_abundances=inp.base_q, opacity=grid, system=inp.system,
                 bands=bands, dtype=jnp.float64)
    tgrid = OpacityGrid(grid.species, grid.t_grid, grid.pressure,
                        grid.wn_grid, torch.tensor(np.asarray(grid.sigma)))
    fmt = build_demo_model(inp, dtype=F64, grid=tgrid, pt_type=family,
                           device="cpu")
    assert (fmt.pt_args is None) == (family != "line")
    base = demo_params(family)
    rng = np.random.default_rng(2)
    P4 = np.tile(base, (4, 1)) * (1.0 + rng.normal(0, 0.002, (4, len(base))))
    i, v = TOO_HOT[family]
    P4[3, i] = v
    bj, sj, vj = fmj.batched()(jnp.asarray(P4))
    bt, st, vt = fmt(torch.tensor(P4))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert vt[:3].all() and not vt[3]
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-9)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-9)
