"""bart_tpu_torch's wavelet likelihood against bart_tpu's at float64:
the DB4 pyramid and the Carter & Winn log-likelihood, batched over
chains, at rtol 1e-12; ``Likelihood(wlike=True)`` on the small demo
forward model at 1e-9; the step a CUDA graph captures, run eagerly with
a wlike likelihood, against the eager block bit for bit; and a short
wlike retrieval."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bart_tpu.inference.likelihood as jlike
from bart_tpu.inference import wavelet as jwav

from bart_tpu_torch.inference import wavelet as wav
from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
from bart_tpu_torch.inference.retrieval import run_mcmc
from bart_tpu_torch.inference.samplers import EnsembleSampler, StepBuffers

F64 = torch.float64
X = np.linspace(0.0, 1.0, 10)


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("n", [2, 4, 16, 64])
def test_dwt_db4_matches_bart_tpu(n):
    x = np.random.default_rng(n).normal(size=(3, n))
    got = wav.dwt_db4(torch.tensor(x))
    assert [c.shape[-1] for c in got] == [max(n >> k, 1)
                                          for k in range(1, len(got))] + [1]
    for i, row in enumerate(x):
        ref = jwav.dwt_db4(jnp.asarray(row))
        assert len(ref) == len(got)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(r),
                                       rtol=1e-12, atol=1e-14)
    # orthonormal: the sum of squares is kept
    np.testing.assert_allclose(sum((c * c).sum(-1) for c in got).numpy(),
                               (x * x).sum(-1), rtol=1e-12)


def test_dwt_db4_needs_a_power_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        wav.dwt_db4(torch.zeros(2, 12))


@pytest.mark.parametrize("n", [10, 16, 37])
def test_wavelet_loglike_matches_bart_tpu(n):
    rng = np.random.default_rng(n)
    C = 5
    resid = rng.normal(0, 2e-4, (C, n))
    gamma = rng.uniform(0.5, 1.5, C)
    sigma_r = np.array([0.0, 1e-4, 3e-4, 5e-5, 2e-4])
    sigma_w = rng.uniform(1e-5, 3e-4, C)
    got = wav.wavelet_loglike(*(torch.tensor(a) for a in
                                (resid, gamma, sigma_r, sigma_w)))
    ref = jax.vmap(jwav.wavelet_loglike)(*(jnp.asarray(a) for a in
                                           (resid, gamma, sigma_r, sigma_w)))
    assert got.shape == (C,) and got.dtype == F64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)
    # sigma_r = 0: the white Gaussian log-likelihood of the padded vector
    n2 = 1 << int(np.ceil(np.log2(n)))
    white = (-0.5 * np.sum(resid[0] ** 2) / sigma_w[0] ** 2
             - 0.5 * n2 * np.log(2 * np.pi * sigma_w[0] ** 2))
    np.testing.assert_allclose(got[0].item(), white, rtol=1e-12)


# ---------------------------------------------------------------------
# Likelihood(wlike=True)

WLIKE = dict(pinit=[0.3, 1.5, 1.0, 1e-3, 2e-3],
             pmin=[-5.0, -5.0, 0.0, 0.0, 1e-5], pmax=[5.0, 5.0, 3.0, 0.1, 0.1],
             stepsize=[0.1, 0.1, 0.0, 1e-3, 1e-3])


def _line(p):
    """A straight line over X, [C, 2] -> [C, 10]."""
    m = p[:, :1] + p[:, 1:2] * torch.tensor(X, dtype=p.dtype)
    return m, m, torch.ones(p.shape[0], dtype=torch.bool)


def _line_data():
    return 0.5 + 2.0 * X + np.random.default_rng(1).normal(0, 2e-3, 10)


def test_likelihood_wlike_matches_bart_tpu_on_the_demo_model():
    from bart_tpu.obs.bands import build_band_matrix as jbands
    from bart_tpu.opacity.grid import build_opacity_grid as jbuild
    from bart_tpu.rt.forward import ForwardConfig as JConfig
    from bart_tpu.rt.forward import ForwardModel as JModel

    from bart_tpu_torch.demo import DEMO_PARAMS, build_demo_model, demo_inputs
    from bart_tpu_torch.opacity.grid import OpacityGrid

    inp = demo_inputs(nlayer=8, nwave=128, nlines=200, t_step=520.0)
    grid = jbuild({"CH4": inp.lines}, inp.wn, inp.t_grid, inp.pressure,
                  cond_batch=80, dtype=jnp.float64)
    fmj = JModel(JConfig(**inp.config_kwargs), wn_grid=inp.wn,
                 pressure=inp.pressure, species=inp.species,
                 base_abundances=inp.base_q, opacity=grid, system=inp.system,
                 bands=jbands(inp.wn, inp.filters, star_flux=inp.star_flux,
                              rprs=inp.system.rprs), dtype=jnp.float64)
    fmt = build_demo_model(inp, dtype=F64, device="cpu", grid=OpacityGrid(
        grid.species, grid.t_grid, grid.pressure, grid.wn_grid,
        torch.tensor(np.asarray(grid.sigma))))
    pinit = np.concatenate([DEMO_PARAMS, [1.0, 2e-5, 3e-5]])
    kw = dict(pinit=pinit, pmin=[-5, -2, -2, 0, 0.55, -9, 0, 0, 1e-7],
              pmax=[-1, 1, 1, 1, 1.2, 1.5, 3, 1e-3, 1e-3],
              stepsize=[0.01, 0.01, 0.0, 0.0, 0.001, 0.1, 0.0, 1e-6, 1e-6])
    sp_t, sp_j = ParamSpace(**kw), jlike.ParamSpace(**kw)
    data = np.asarray(fmj.jitted()(jnp.asarray(DEMO_PARAMS))[0])
    data = data + np.random.default_rng(0).normal(0, 3e-5, data.shape)
    free = np.tile(pinit[sp_t.ifree], (4, 1)) * (
        1.0 + np.random.default_rng(2).normal(0, 0.02, (4, sp_t.nfree)))
    free[3, -1] = 2e-3                      # sigma_w out of bounds: -inf
    lt = Likelihood(fmt, sp_t, data, np.full(10, 3e-5), wlike=True)
    lj = jlike.Likelihood(fmj, sp_j, data, np.full(10, 3e-5), wlike=True)
    got, mt = lt(torch.tensor(free))
    ref, mj = jax.vmap(lj)(jnp.asarray(free))
    assert np.isneginf(got[3].item()) and np.isneginf(float(ref[3]))
    assert np.all(np.isfinite(got[:3].numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-9)
    np.testing.assert_allclose(lt.chisq(torch.tensor(free[:3])).numpy(),
                               -2.0 * np.asarray(ref[:3]), rtol=1e-9)


def test_likelihood_wlike_on_a_callable_matches_bart_tpu():
    def jline(p):
        m = p[0] + p[1] * jnp.asarray(X)
        return m, m, jnp.asarray(True)

    data = _line_data()
    lt = Likelihood(_line, ParamSpace(**WLIKE), data, np.ones(10),
                    wlike=True, device="cpu")
    lj = jlike.Likelihood(jline, jlike.ParamSpace(**WLIKE), data,
                          np.ones(10), wlike=True)
    free = np.array([[0.5, 2.0, 1e-3, 2e-3], [0.4, 2.1, 0.0, 1e-3],
                     [0.6, 1.9, 2e-2, 5e-3]])
    got, _ = lt(torch.tensor(free))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax.vmap(lj)(jnp.asarray(free))[0]),
                               rtol=1e-12)


@pytest.mark.parametrize("walk", ["snooker", "demc"])
def test_step_counter_block_with_wlike_equals_eager_block(walk):
    """The step a CUDA graph captures (StepBuffers), run eagerly on a
    wlike likelihood: the eager block bit for bit."""
    like = Likelihood(_line, ParamSpace(**WLIKE), _line_data(), np.ones(10),
                      wlike=True, device="cpu")
    space = like.space
    s = EnsembleSampler(loglike_fn=like, nfree=space.nfree, nmodel=10,
                        nchains=8, walk=walk, pmin=space.free_min,
                        pmax=space.free_max,
                        stepsize=space.stepsize[space.ifree], z_thin=3)
    state0 = s.init_state(torch.Generator().manual_seed(4))
    assert torch.isfinite(state0.loglike).any()
    nsteps = 9
    eager = s.run_block(state0, torch.Generator().manual_seed(5), nsteps,
                        fgamma=0.8, graphed=False)
    buf = StepBuffers(s, state0, nsteps)
    s.draw_block(torch.Generator().manual_seed(5), nsteps, out=buf.variates)
    counted = buf.run(state0, 0.8)
    for k, x in counted[0]._asdict().items():
        assert torch.equal(x, getattr(eager[0], k)), k
    for a, b in zip(counted[1:], eager[1:]):
        assert torch.equal(a, b)
    assert int(eager[0].naccept.sum()) > 0


def test_wlike_retrieval_runs():
    like = Likelihood(_line, ParamSpace(**WLIKE), _line_data(), np.ones(10),
                      wlike=True, device="cpu")
    res = run_mcmc(like, like.space, nchains=8, numit=800, burnin=40,
                   block=20, seed=3, verbose=False)
    assert res.posterior.shape == (8, 4, 60)
    assert np.isfinite(res.best_loglike) and res.accept_rate > 0.0
    np.testing.assert_allclose(res.bestp[:2], [0.5, 2.0], atol=0.3)
