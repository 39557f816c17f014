"""bart_tpu_torch's run_mcmc against bart_tpu's: checkpoint and resume
(bit for bit, and the archive-size guard), the MCMC.log and its
" Best-fit params" block, savefile, savemodel and its modelper split
(with the unif subdirectory), chisqscale, the gamma adaptation's gating
on the walk and the stepsize handed to the sampler
(tests/test_inference.py:273-410); and, marked slow, the demo truth
recovered on the CPU at small shapes (tests/test_end_to_end.py:37-88)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bart_tpu.inference.likelihood as jlike
import bart_tpu.inference.retrieval as jret

import bart_tpu_torch.inference.retrieval as ret
from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
from bart_tpu_torch.inference.retrieval import (load_checkpoint, run_mcmc,
                                                save_checkpoint)


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _identity(p):
    """The port's forward protocol: params [C, n] -> (model, _, valid)."""
    return p, p, torch.ones(p.shape[0], dtype=torch.bool)


def _problem(npar=2, uncert=0.3, **space):
    kw = dict(pinit=[0.0] * npar, pmin=[-5] * npar, pmax=[5] * npar,
              stepsize=[0.1] * npar, **space)
    data = np.array([1.0, -1.0])[:npar]
    unc = np.full(npar, uncert)
    return (Likelihood(_identity, ParamSpace(**kw), data, unc),
            ParamSpace(**kw))


@pytest.mark.parametrize("walk", ["snooker", "demc"])
def test_checkpoint_resume_is_bitwise(tmp_path, walk):
    """A run cut at a block boundary and resumed from its checkpoint
    repeats the uninterrupted run's samples, models, state and best fit
    bit for bit (the generator's state travels in the checkpoint)."""
    like, space = _problem()
    ckpt = str(tmp_path / "ck.npz")
    kw = dict(nchains=4, burnin=0, walk=walk, seed=11, block=100,
              verbose=False, grtest=False)
    full = run_mcmc(like, space, numit=3200, savemodel=str(tmp_path / "a"),
                    **kw)
    run_mcmc(like, space, numit=1600, checkpoint=ckpt,
             savemodel=str(tmp_path / "b"), **kw)
    resumed = run_mcmc(like, space, numit=3200, checkpoint=ckpt,
                       resume=True, savemodel=str(tmp_path / "c"), **kw)
    assert resumed.posterior.shape == (4, 2, 800)
    np.testing.assert_array_equal(resumed.posterior, full.posterior)
    np.testing.assert_array_equal(resumed.models, full.models)
    np.testing.assert_array_equal(resumed.bestp, full.bestp)
    assert resumed.accept_rate == full.accept_rate
    state, done, gen_state, fg = load_checkpoint(ckpt, "cpu")
    assert done == 800 and fg == 1.0 and gen_state.dtype == torch.uint8


def test_checkpoint_resume_nz_mismatch(tmp_path):
    """A checkpoint whose archive size differs from the sampler's
    default resumes with the checkpoint's size, and keeps it."""
    like, space = _problem()
    ckpt = str(tmp_path / "ck.npz")
    kw = dict(nchains=4, burnin=0, walk="snooker", seed=11, block=100,
              verbose=False, grtest=False, checkpoint=ckpt)
    run_mcmc(like, space, numit=1600, **kw)
    state, done, gen_state, fg = load_checkpoint(ckpt, "cpu")
    state = state._replace(z_archive=state.z_archive[:8],
                           z_count=torch.clamp(state.z_count, max=8))
    gen = torch.Generator()
    gen.set_state(gen_state)
    save_checkpoint(ckpt, state, done, gen, fg)
    res = run_mcmc(like, space, numit=3200, resume=True, **kw)
    state2, done2, _, _ = load_checkpoint(ckpt, "cpu")
    assert state2.z_archive.shape[0] == 8
    assert done2 == 800
    assert np.all(np.isfinite(res.posterior))


def test_logfile_format(tmp_path):
    """The log parses back with the reference's bestFit.read_MCMC_out
    algorithm; its GR lines carry ``accept:``, it has the bulk ESS line,
    and savefile writes the [nchain, nfree, niter] posterior."""
    like, space = _problem(uncert=0.1, pnames=["alpha", "beta"])
    logf = str(tmp_path / "MCMC.log")
    res = run_mcmc(like, space, nchains=4, numit=4000, burnin=100,
                   walk="demc", seed=6, block=100, verbose=False,
                   logfile=logf, savefile=str(tmp_path / "output.npy"))
    lines = open(logf).readlines()
    ini = max(i for i, line in enumerate(lines)
              if line.startswith(" Best-fit params")) + 1
    vals = []
    for line in lines[ini:]:
        if not line.strip():
            break
        vals.append([float(x) for x in line.split()[:2]])
    vals = np.asarray(vals)
    assert vals.shape == (2, 2)
    np.testing.assert_allclose(vals[:, 0], [1.0, -1.0], atol=0.1)
    np.testing.assert_allclose(vals[:, 0], res.bestp, rtol=1e-7)
    assert [line.split()[-1] for line in lines[ini:ini + 2]] == [
        "alpha", "beta"]
    gr = [line for line in lines if line.startswith("iter ")]
    assert gr and all("accept: " in line for line in gr)
    assert any(line.startswith("bulk ESS: ") for line in lines)
    post = np.load(tmp_path / "output.npy")
    np.testing.assert_array_equal(post, res.posterior)
    assert post.shape == (4, 2, 900)


def test_modelper_split(tmp_path):
    like, space = _problem(npar=1)
    sm = str(tmp_path / "models.npy")
    res = run_mcmc(like, space, nchains=4, numit=1200, burnin=100,
                   walk="mrw", seed=12, block=100, verbose=False,
                   grtest=False, savemodel=sm, modelper=100)
    whole = np.load(sm)
    # the whole history, burn-in included: 1200 / 4 = 300 per chain
    assert whole.shape == (4, 1, 300)
    np.testing.assert_array_equal(whole, res.models)
    parts = [np.load(str(tmp_path / f"models{k:02d}.npy")) for k in range(3)]
    assert all(p.shape == (4, 1, 100) for p in parts)
    np.testing.assert_array_equal(np.concatenate(parts, axis=2), whole)


def test_modelper_unif_subdir(tmp_path):
    """unif sweeps move the numbered model files into a subdirectory
    named after savemodel."""
    like, space = _problem(npar=1)
    sm = str(tmp_path / "models.npy")
    res = run_mcmc(like, space, nchains=4, numit=800, burnin=0, walk="unif",
                   seed=12, block=100, verbose=False, grtest=False,
                   savemodel=sm, modelper=100)
    mdir = tmp_path / "models"
    assert mdir.is_dir()
    assert sorted(p.name for p in mdir.iterdir()) == [
        "models00.npy", "models01.npy"]
    assert res.accept_rate == 1.0       # every in-bounds draw is kept


def test_chisqscale_matches_bart_tpu():
    """Both packages scale the uncertainties to reduced chi2 = 1 at the
    initial guess, by the same factor."""
    x = np.linspace(0.0, 1.0, 7)
    y = 0.5 + 2.0 * x + np.random.default_rng(1).normal(0, 0.05, 7)
    kw = dict(pinit=[0.3, 1.5], pmin=[-5, -5], pmax=[5, 5],
              stepsize=[0.1, 0.1])

    def fwd(p):
        m = p[:, :1] + p[:, 1:] * torch.tensor(x)
        return m, m, torch.ones(p.shape[0], dtype=torch.bool)

    def jfwd(p):
        m = p[0] + p[1] * jnp.asarray(x)
        return m, m, jnp.asarray(True)

    like = Likelihood(fwd, ParamSpace(**kw), y, np.full(7, 0.01))
    jl = jlike.Likelihood(jfwd, jlike.ParamSpace(**kw), y, np.full(7, 0.01))
    run = dict(nchains=4, numit=400, burnin=0, block=100, verbose=False,
               grtest=False, chisqscale=True)
    run_mcmc(like, ParamSpace(**kw), **run)
    jret.run_mcmc(jl, jlike.ParamSpace(**kw), **run)
    assert float(like.uncert[0]) > 0.01
    np.testing.assert_allclose(like.uncert.numpy(), np.asarray(jl.uncert),
                               rtol=1e-12)


def _flat(p):
    """A flat likelihood over the box: the DE walkers' folded proposals
    are all accepted, and an adapting sampler must grow its gamma."""
    return 0.0 * p, p, torch.ones(p.shape[0], dtype=torch.bool)


def _jflat(p):
    return 0.0 * p, p, jnp.asarray(True)


@pytest.mark.parametrize("walk", ["snooker", "demc", "mrw", "unif"])
def test_gamma_adaptation_gated_as_bart_tpu(walk):
    """Only the DE walkers adapt gamma during burn-in, in both
    packages."""
    kw = dict(pinit=[0.0, 0.0], pmin=[-5, -5], pmax=[5, 5],
              stepsize=[0.1, 0.1])
    data, unc = np.zeros(2), np.ones(2)
    run = dict(nchains=8, numit=3200, burnin=400, walk=walk, seed=3,
               block=50, verbose=False, grtest=False)
    got = run_mcmc(Likelihood(_flat, ParamSpace(**kw), data, unc),
                   ParamSpace(**kw), **run)
    ref = jret.run_mcmc(jlike.Likelihood(_jflat, jlike.ParamSpace(**kw),
                                         data, unc),
                        jlike.ParamSpace(**kw), **run)
    adapts = walk in ("snooker", "demc")
    assert (got.fgamma_final != 1.0) == (ref.fgamma_final != 1.0) == adapts


def test_stepsize_handed_to_the_sampler_as_bart_tpu(monkeypatch):
    """run_mcmc gives the sampler the free parameters' stepsize, as
    bart_tpu's does (retrieval.py:216)."""
    seen = {}

    def spy(module, key):
        real = module.EnsembleSampler

        def make(**kw):
            seen[key] = kw
            return real(**kw)

        monkeypatch.setattr(module, "EnsembleSampler", make)

    spy(ret, "port")
    spy(jret, "jax")
    kw = dict(pinit=[0.0, 1.0, 0.0], pmin=[-5] * 3, pmax=[5] * 3,
              stepsize=[0.2, 0.0, 0.05])
    run = dict(nchains=4, numit=400, burnin=0, walk="mrw", block=100,
               verbose=False, grtest=False)
    fwd = lambda p: (p, p, torch.ones(p.shape[0], dtype=torch.bool))
    jfwd = lambda p: (p, p, jnp.asarray(True))
    run_mcmc(Likelihood(fwd, ParamSpace(**kw), np.zeros(3), np.ones(3)),
             ParamSpace(**kw), **run)
    jret.run_mcmc(jlike.Likelihood(jfwd, jlike.ParamSpace(**kw), np.zeros(3),
                                   np.ones(3)), jlike.ParamSpace(**kw), **run)
    np.testing.assert_array_equal(seen["port"]["stepsize"],
                                  seen["jax"]["stepsize"])
    np.testing.assert_array_equal(seen["port"]["stepsize"], [0.2, 0.05])


def test_leastsq_raises():
    like, space = _problem()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_mcmc(like, space, numit=400, nchains=4, leastsq=True,
                 verbose=False)


@pytest.mark.slow
def test_demo_truth_recovered_on_cpu():
    """The demo eclipse retrieval at small shapes (12 layers x 256 wn x
    300 lines, float64 on the CPU): synthetic data from TRUTH with 3%
    noise, 8 snooker chains x 10,000 steps from uniform starts, and
    tests/test_end_to_end.py:71-87's four criteria: pulls < 3.5 on the
    data-constrained directions, the central 99% interval covering the
    truth, chi2/dof < 3, split-R-hat < 1.35."""
    from bart_tpu_torch.demo import (DEMO_PARAMS, TRUTH, build_demo_model,
                                     demo_inputs)

    inp = demo_inputs(nlayer=12, nwave=256, nlines=300, t_step=520.0)
    fm = build_demo_model(inp, dtype=torch.float64, budget_bytes=1e8,
                          device="cpu")
    data = fm(torch.tensor(TRUTH[None]))[0][0].numpy()
    uncert = 0.03 * data
    data = data + np.random.default_rng(42).normal(0, 1, data.shape) * uncert
    space = ParamSpace(pinit=DEMO_PARAMS, pmin=[-5, -2, -2, 0, 0.55, -9],
                       pmax=[-1, 1, 1, 1, 1.2, 1.5],
                       stepsize=[0.01, 0.01, 0.0, 0.0, 0.001, 0.1])
    res = run_mcmc(Likelihood(fm, space, data, uncert), space, nchains=8,
                   numit=80000, burnin=1000, block=200, seed=7,
                   verbose=False)
    flat = res.posterior.transpose(1, 0, 2).reshape(space.nfree, -1)
    mean, std = flat.mean(1), flat.std(1)
    truth = TRUTH[space.ifree]
    constrained = std < 0.5 * (space.free_max - space.free_min) / np.sqrt(12)
    pulls = np.abs(mean - truth) / np.maximum(std, 1e-12)
    assert np.all(pulls[constrained] < 3.5), (mean, std, pulls)
    q = np.percentile(flat, [0.5, 99.5], axis=1)
    assert np.all((truth > q[0]) & (truth < q[1])), (q, truth)
    assert -2.0 * res.best_loglike / len(data) < 3.0
    assert np.all(res.psrf_rank < 1.35), res.psrf_rank
