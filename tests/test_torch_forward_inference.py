"""bart_tpu_torch forward model, likelihood, snooker sampler and
retrieval driver against bart_tpu, on a small demo problem at float64.

The opacity table is built once by bart_tpu and carried over, so the
forward comparison isolates the forward model (the table build has its
own parity test in test_torch_opacity.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bart_tpu.inference.likelihood as jlike
import bart_tpu.inference.samplers as jsamp
from bart_tpu.obs.bands import build_band_matrix as jbands
from bart_tpu.opacity.grid import build_opacity_grid as jbuild
from bart_tpu.rt.forward import ForwardConfig as JConfig
from bart_tpu.rt.forward import ForwardModel as JModel

from bart_tpu_torch.demo import DEMO_PARAMS, TRUTH, build_demo_model, demo_inputs
from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
from bart_tpu_torch.inference.retrieval import run_mcmc
from bart_tpu_torch.inference.samplers import EnsembleSampler, SamplerState
from bart_tpu_torch.opacity.grid import OpacityGrid
from bart_tpu_torch.rt.forward import ForwardConfig, ForwardModel
from bart_tpu_torch.rt.fused import RowsTable

F64 = torch.float64
PMIN = [-5.0, -2.0, -2.0, 0.0, 0.55, -9.0]
PMAX = [-1.0, 1.0, 1.0, 1.0, 1.2, 1.5]
STEP = [0.01, 0.01, 0.0, 0.0, 0.001, 0.1]


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def demo():
    """(inputs, bart_tpu OpacityGrid) of the small demo problem."""
    inp = demo_inputs(nlayer=12, nwave=256, nlines=300, t_step=520.0)
    grid = jbuild({"CH4": inp.lines}, inp.wn, inp.t_grid, inp.pressure,
                  cond_batch=80, dtype=jnp.float64)
    return inp, grid


def _jax_model(inp, grid, **cfg):
    bands = jbands(inp.wn, inp.filters, star_flux=inp.star_flux,
                   rprs=inp.system.rprs)
    return JModel(JConfig(**inp.config_kwargs, **cfg), wn_grid=inp.wn,
                  pressure=inp.pressure, species=inp.species,
                  base_abundances=inp.base_q, opacity=grid,
                  system=inp.system, bands=bands, dtype=jnp.float64)


def _torch_grid(grid):
    return OpacityGrid(grid.species, grid.t_grid, grid.pressure,
                       grid.wn_grid, torch.tensor(np.asarray(grid.sigma)))


def _torch_model(inp, grid, **cfg):
    quad = cfg.pop("quadrature", "raygrid")
    fm = build_demo_model(inp, dtype=F64, grid=_torch_grid(grid),
                          quadrature=quad, device="cpu")
    if cfg:
        fm = ForwardModel(ForwardConfig(quadrature=quad, **inp.config_kwargs,
                                        **cfg),
                          wn_grid=inp.wn, pressure=inp.pressure,
                          species=inp.species, base_abundances=inp.base_q,
                          opacity=_torch_grid(grid), system=inp.system,
                          bands=fm.bands, dtype=F64, device="cpu")
    return fm


def _params():
    rng = np.random.default_rng(0)
    P = np.tile(DEMO_PARAMS, (4, 1)) + rng.normal(0, 0.01, (4, 6))
    P[3, 4] = 3.0            # beta: T far above tmax -> invalid
    return P


# ---------------------------------------------------------------------
# forward model

def test_tables_from_jax_maps_keys_and_shapes(demo):
    inp, grid = demo
    fmj = _jax_model(inp, grid)
    fmt = _torch_model(inp, grid)
    np_tables = {k: np.asarray(v) for k, v in fmj.tables.items()}
    tabs = fmt.tables_from_jax(np_tables)
    assert set(tabs) == set(fmt.tables)
    assert isinstance(tabs["tab"], RowsTable)
    for k, v in tabs.items():
        # the K = 1 table in the kernels' layout: compare its plain form
        v, mine = (x.plain() if k == "tab" else x
                   for x in (v, fmt.tables[k]))
        assert v.shape == mine.shape and v.dtype == F64, k
        np.testing.assert_allclose(v.numpy(), mine.numpy(),
                                   rtol=1e-15, err_msg=k)
    with pytest.raises(ValueError, match="keys differ"):
        fmt.tables_from_jax({**np_tables, "frows": np.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        fmt.tables_from_jax({**np_tables, "mu": np.zeros(2)})


@pytest.mark.parametrize("cfg", [{}, {"quadrature": "expsum"},
                                 {"ebalance": True}])
def test_forward_matches_bart_tpu_batched(demo, cfg):
    inp, grid = demo
    fmj = _jax_model(inp, grid, **cfg)
    fmt = _torch_model(inp, grid, **dict(cfg))
    tabs = fmt.tables_from_jax({k: np.asarray(v)
                                for k, v in fmj.tables.items()})
    P = _params()
    bj, sj, vj = fmj.batched()(jnp.asarray(P))
    bt, st, vt = fmt(torch.tensor(P), tabs)
    assert bt.shape == (4, 10) and st.shape == (4, 256) and vt.shape == (4,)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert not vt[3] and vt[:3].all()
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-9)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-9)
    # batched() is the same plain callable on the model's own tables
    np.testing.assert_allclose(fmt.batched()(torch.tensor(P))[0].numpy(),
                               bt.numpy(), rtol=1e-12)


@pytest.mark.parametrize("cfg", [{}, {"ebalance": True},
                                 {"quadrature": "expsum"}])
def test_direct_solution_matches_bart_tpu_batched(demo, cfg):
    """solution="direct" (tests/test_rt.py:271-282): the raw emergent
    flux band-integrated with no stellar division, on bart_tpu's tables
    carried over, alone, with ebalance and with expsum."""
    from bart_tpu_torch.obs.bands import build_band_matrix

    inp, grid = demo
    bands_j = jbands(inp.wn, inp.filters)
    fmj = JModel(JConfig(**{**inp.config_kwargs, "solution": "direct"},
                         **cfg),
                 wn_grid=inp.wn, pressure=inp.pressure, species=inp.species,
                 base_abundances=inp.base_q, opacity=grid,
                 system=inp.system, bands=bands_j, dtype=jnp.float64)
    fmt = ForwardModel(
        ForwardConfig(**{**inp.config_kwargs, "solution": "direct"}, **cfg),
        wn_grid=inp.wn, pressure=inp.pressure, species=inp.species,
        base_abundances=inp.base_q, opacity=_torch_grid(grid),
        system=inp.system,
        bands=build_band_matrix(inp.wn, inp.filters, device="cpu",
                                dtype=F64),
        dtype=F64, device="cpu")
    tabs = fmt.tables_from_jax({k: np.asarray(v)
                                for k, v in fmj.tables.items()})
    P = _params()
    bj, sj, vj = fmj.batched()(jnp.asarray(P))
    bt, st, vt = fmt(torch.tensor(P), tabs)
    assert bt.shape == (4, 10) and st.shape == (4, 256)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert not vt[3] and vt[:3].all()
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-9)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-9)
    # raw fluxes, not planet-to-star ratios (tests/test_rt.py:279-282)
    assert float(bt[:3].min()) > 1.0
    # the eclipse forward computes the same emergent flux: only its band
    # matrix divides by the star
    fme = _torch_model(inp, grid, **dict(cfg))
    np.testing.assert_allclose(
        fme(torch.tensor(P))[1][:3].numpy(), st[:3].numpy(), rtol=1e-9)


@pytest.mark.parametrize("name", ["wn", "pressure", "mu", "mu_w", "sigma"])
def test_forward_views_match_bart_tpu(demo, name):
    inp, grid = demo
    fmj = _jax_model(inp, grid, quadrature="expsum")
    fmt = _torch_model(inp, grid, quadrature="expsum")
    got = getattr(fmt, name)
    assert got is fmt.tables[name]
    np.testing.assert_allclose(got.numpy(), np.asarray(getattr(fmj, name)),
                               rtol=1e-12)


@pytest.mark.parametrize("cfg,kw", [
    ({}, {"opacity": {}, "fold_osamp": 4}),   # folded on line tiles
    ({"solution": "transit"}, {"opacity": {}, "fold_osamp": 4}),
])
def test_forward_unported_options_raise(demo, cfg, kw):
    """The on-the-fly line tiles are ported; folded rtosamp on them is
    refused with bart_tpu's ValueError (rt/forward.py:192-196), in both
    geometries."""
    inp, grid = demo
    kw = {"opacity": _torch_grid(grid), **kw}
    with pytest.raises(ValueError, match="folded rtosamp requires"):
        ForwardModel(ForwardConfig(**{**inp.config_kwargs, **cfg}),
                     wn_grid=inp.wn, pressure=inp.pressure,
                     species=inp.species, base_abundances=inp.base_q,
                     system=inp.system, bands=None, dtype=F64, device="cpu",
                     **kw)


# ---------------------------------------------------------------------
# likelihood

def _spaces():
    kw = dict(pinit=DEMO_PARAMS, pmin=PMIN, pmax=PMAX, stepsize=STEP)
    return ParamSpace(**kw), jlike.ParamSpace(**kw)


def test_param_space_expand_with_shared():
    kw = dict(pinit=[1.0, 2.0, 3.0, 4.0], pmin=[0] * 4, pmax=[9] * 4,
              stepsize=[0.1, 0.0, -1.0, 0.2])
    free = np.array([[5.0, 6.0], [7.0, 8.0]])
    got = ParamSpace(**kw).expand(torch.tensor(free)).numpy()
    ref = np.asarray(jlike.ParamSpace(**kw).expand(jnp.asarray(free)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:, 2], free[:, 0])


def test_likelihood_matches_with_prior_and_bounds(demo):
    inp, grid = demo
    fmj, fmt = _jax_model(inp, grid), _torch_model(inp, grid)
    sp_t, sp_j = _spaces()
    data = np.asarray(fmj.jitted()(jnp.asarray(TRUTH))[0])
    uncert = 0.03 * data
    prior = np.array([-1.9, 0.0, 0.0, 0.0, 0.9, -1.0])
    plo = np.array([0.2, 0.0, 0.0, 0.0, 0.05, 0.0])
    pup = np.array([0.3, 0.0, 0.0, 0.0, 0.1, 0.0])
    free = np.tile(TRUTH[sp_t.ifree], (4, 1)) + np.random.default_rng(1) \
        .normal(0, 0.02, (4, sp_t.nfree))
    free[2, 0] = -6.0                        # out of bounds -> -inf
    for pr in ((None, None, None), (prior, plo, pup)):
        lt = Likelihood(fmt, sp_t, data, uncert, *pr)
        lj = jlike.Likelihood(fmj, sp_j, data, uncert, *pr)
        got, mt = lt(torch.tensor(free))
        ref, mj = jax.vmap(lj)(jnp.asarray(free))
        assert np.isneginf(got[2].item()) and np.isneginf(float(ref[2]))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9)
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-9)


def test_likelihood_chisq_matches_bart_tpu(demo):
    inp, grid = demo
    fmj, fmt = _jax_model(inp, grid), _torch_model(inp, grid)
    sp_t, sp_j = _spaces()
    data = np.asarray(fmj.jitted()(jnp.asarray(TRUTH))[0])
    free = np.tile(TRUTH[sp_t.ifree], (3, 1)) + np.random.default_rng(3) \
        .normal(0, 0.02, (3, sp_t.nfree))
    got = Likelihood(fmt, sp_t, data, 0.03 * data).chisq(torch.tensor(free))
    lj = jlike.Likelihood(fmj, sp_j, data, 0.03 * data)
    ref = [float(lj.chisq(jnp.asarray(f))) for f in free]
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9)


# ---------------------------------------------------------------------
# sampler

_MEAN = np.array([0.5, -1.0, 2.0])
_COV = np.array([[1.0, 0.6, -0.3], [0.6, 2.0, 0.4], [-0.3, 0.4, 0.5]])
_PREC = np.linalg.inv(_COV)


def _gauss_torch(x):
    d = x - torch.tensor(_MEAN, dtype=x.dtype)
    logl = -0.5 * torch.einsum("ci,ij,cj->c", d, torch.tensor(_PREC), d)
    return logl, 2.0 * x


def _gauss_jax(x):
    d = x - _MEAN
    return -0.5 * d @ (_PREC @ d), 2.0 * x


def _to_torch_state(s):
    return SamplerState(**{
        k: torch.tensor(np.asarray(v), dtype=torch.int64
                        if np.asarray(v).dtype.kind == "i" else F64)
        for k, v in s._asdict().items()})


def test_snooker_step_replays_bart_tpu():
    """Four snooker steps fed bart_tpu's draws (archive indices as the
    uniforms that map back to them): every state field at rtol 1e-12."""
    from test_torch_samplers import replay_against_bart_tpu

    st, read = replay_against_bart_tpu("snooker", snooker_frac=0.5)
    n = st.positions.shape[0]
    n_sn = sum(int((v.u_sn < 0.5).sum()) for v in read)
    assert 0 < n_sn < 4 * n and int(st.naccept.sum()) > 0


def test_snooker_recovers_correlated_gaussian():
    """Statistical check: 24 chains x 3000 steps on a 3-D correlated
    Gaussian.  Tolerances sized for an effective sample size of a few
    hundred: mean within 0.2 sigma, variances within 20%, correlations
    within 0.1."""
    n, d = 24, 3
    s = EnsembleSampler(loglike_fn=_gauss_torch, nfree=d, nmodel=d,
                        nchains=n, pmin=_MEAN - 8 * np.sqrt(np.diag(_COV)),
                        pmax=_MEAN + 8 * np.sqrt(np.diag(_COV)))
    gen = torch.Generator().manual_seed(3)
    state = s.init_state(gen)
    state, pb, lb, mb = s.run_block(state, gen, 3000)
    assert pb.shape == (3000, n, d) and lb.shape == (3000, n)
    assert mb.shape == (3000, n, d)
    x = pb[500:].reshape(-1, d).numpy()
    sd = np.sqrt(np.diag(_COV))
    assert np.all(np.abs(x.mean(0) - _MEAN) < 0.2 * sd), x.mean(0)
    cov = np.cov(x.T)
    np.testing.assert_allclose(np.diag(cov), np.diag(_COV), rtol=0.2)
    corr = cov / np.sqrt(np.outer(np.diag(cov), np.diag(cov)))
    corr0 = _COV / np.outer(sd, sd)
    assert np.all(np.abs(corr - corr0) < 0.1), corr
    acc = state.naccept.sum().item() / (3000 * n)
    assert 0.05 < acc < 0.9


# ---------------------------------------------------------------------
# retrieval driver

def test_run_mcmc_two_blocks(demo):
    inp, grid = demo
    fmt = _torch_model(inp, grid)
    sp_t, _ = _spaces()
    data = fmt(torch.tensor(TRUTH[None]))[0][0].numpy()
    uncert = 0.03 * data
    data = data + np.random.default_rng(42).normal(0, 1, data.shape) * uncert
    like = Likelihood(fmt, sp_t, data, uncert)
    res = run_mcmc(like, sp_t, nchains=8, numit=80, burnin=5, block=5,
                   seed=7, verbose=False)
    assert res.posterior.shape == (8, sp_t.nfree, 5)
    assert res.niter_total == 80 and np.isfinite(res.best_loglike)
    assert 0.0 < res.accept_rate <= 1.0
    assert res.bestp.shape == (sp_t.nfree,) and res.psrf_rank.shape == (4,)
    assert np.all(res.posterior >= sp_t.free_min[None, :, None])
    assert np.all(res.posterior <= sp_t.free_max[None, :, None])
