"""bart_tpu_torch's walkers against bart_tpu's: each walk's step replayed
on the numbers bart_tpu draws, a block's pre-drawn variates against a
loop that draws each step's variates just before the step, the
step-counter block (the body a CUDA graph captures, run eagerly) against
the eager block, and bart_tpu's statistical checks of each walk
(tests/test_inference.py:35-107)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bart_tpu.inference.samplers as jsamp

from bart_tpu_torch.inference.samplers import (DemcVariates, EnsembleSampler,
                                               MrwVariates, SnookerVariates,
                                               StepBuffers, UnifVariates,
                                               _index)
from test_torch_forward_inference import (_MEAN, _gauss_jax, _gauss_torch,
                                          _to_torch_state)

F64 = torch.float64
WALKS = ["snooker", "demc", "mrw", "unif"]


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def jax_variates(walk, key, state, n, d):
    """bart_tpu's draws for one step from ``key`` (samplers.py:187-246,
    then the accept uniform at :264) as the port's Variates.  An index k
    drawn in [0, m) becomes the uniform (k + 1/2) / m, which the port maps
    back to k."""
    kp, ka = jax.random.split(key)
    f64 = jnp.float64

    def t(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=F64)

    def from_index(k, m):
        return t((np.asarray(k, np.float64) + 0.5) / float(m))

    u_acc = t(jax.random.uniform(ka, (n,), f64))
    if walk == "mrw":
        return MrwVariates(t(jax.random.normal(kp, (n, d), f64)), u_acc)
    if walk == "unif":
        return UnifVariates(t(jax.random.uniform(kp, (n, d), f64)))
    if walk == "demc":
        k1, k2, k3, k4 = jax.random.split(kp, 4)
        return DemcVariates(
            from_index(jax.random.randint(k1, (n,), 0, n - 1), n - 1),
            from_index(jax.random.randint(k2, (n,), 0, n - 2), n - 2),
            t(jax.random.uniform(k3, (n, 1), f64)),
            t(jax.random.normal(k4, (n, d), f64)), u_acc)
    keys = jax.random.split(kp, 6)
    m = jnp.maximum(state.z_count, 3)
    return SnookerVariates(
        *[from_index(jax.random.randint(keys[i], (n,), 0, m), m)
          for i in range(3)],
        t(jax.random.normal(keys[3], (n, d), f64)),
        t(jax.random.uniform(keys[4], (n, 1), f64)),      # gs - 1.2
        t(jax.random.uniform(keys[5], (n,), f64)), u_acc)


def replay_against_bart_tpu(walk, nsteps=4, **extra):
    """``nsteps`` steps of both samplers from one state, the port fed
    bart_tpu's draws; every state field equal at rtol 1e-12 after every
    step.  Returns (the port's last state, the variates it read)."""
    n, d = 8, 3
    kw = dict(nfree=d, nmodel=d, nchains=n, walk=walk, pmin=_MEAN - 4.0,
              pmax=_MEAN + 4.0, stepsize=np.full(d, 0.7), z_thin=2, **extra)
    js = jsamp.EnsembleSampler(loglike_fn=_gauss_jax, **kw)
    ts = EnsembleSampler(loglike_fn=_gauss_torch, **kw)
    assert ts.nz == js.nz == 100
    init = _MEAN + np.random.default_rng(2).normal(0, 1.5, (n, d))
    sj = js.init_state(jax.random.key(0), init, dtype=jnp.float64)
    st = _to_torch_state(sj)
    read = []
    for i in range(nsteps):
        key = jax.random.key(100 + i)
        v = jax_variates(walk, key, sj, n, d)
        read.append(v)
        sj = js._step(sj, key)
        st = ts._step(st, v)
        for k, a in sj._asdict().items():
            np.testing.assert_allclose(getattr(st, k).numpy(), np.asarray(a),
                                       rtol=1e-12, atol=1e-14,
                                       err_msg=f"{walk} step {i}: {k}")
    return st, read


@pytest.mark.parametrize("walk", ["mrw", "demc", "unif"])
def test_step_replays_bart_tpu(walk):
    st, read = replay_against_bart_tpu(walk)
    n = st.positions.shape[0]
    if walk == "unif":                  # every in-bounds draw is kept
        assert int(st.naccept.sum()) == 4 * n
        # the proposals cover the box, not the start
        assert float(st.positions.std()) > 1.0
    else:
        assert 0 < int(st.naccept.sum()) < 4 * n
    if walk == "demc":                  # full jumps were drawn and taken
        assert any(bool((v.u_jump < 0.1).any()) for v in read)


def _sampler(walk, n=6, d=3, **kw):
    return EnsembleSampler(loglike_fn=_gauss_torch, nfree=d, nmodel=d,
                           nchains=n, walk=walk, pmin=_MEAN - 4.0,
                           pmax=_MEAN + 4.0, stepsize=np.full(d, 0.7),
                           z_thin=3, **kw)


def _state(s, seed=4):
    return s.init_state(torch.Generator().manual_seed(seed),
                        _MEAN + np.random.default_rng(seed).normal(
                            0, 1.0, (s.nchains, s.nfree)))


def _assert_states_equal(a, b):
    for k, x in a._asdict().items():
        assert torch.equal(x, getattr(b, k)), k


@pytest.mark.parametrize("walk", WALKS)
def test_predrawn_block_equals_interleaved_loop(walk):
    """A block's variates drawn up front are the numbers a loop that
    draws each step's variates just before the step reads, bit for bit,
    and so is the block's result; the snooker archive indices are the
    old draw-time formula's."""
    s = _sampler(walk)
    state0 = _state(s)
    nsteps = 7
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    vb = s.draw_block(g1, nsteps)
    got, pb, lb, mb = s.run_block(state0, torch.Generator().manual_seed(11),
                                  nsteps, fgamma=0.7)
    state = state0
    for k in range(nsteps):
        # the interleaved loop: one step's draws, then the step
        one = s.draw_block(g2, 1)
        v = type(one)(*(x[0] for x in one))
        for a, b in zip(v, vb):
            assert torch.equal(a, b[k])
        if walk == "snooker":
            nz_eff = torch.clamp(state.z_count, min=3)
            old = torch.minimum((v.u_z1 * nz_eff.to(F64)).to(torch.int64),
                                nz_eff - 1)
            assert torch.equal(_index(v.u_z1, nz_eff), old)
        state = s._step(state, v, 0.7)
        assert torch.equal(pb[k], state.positions)
        assert torch.equal(lb[k], state.loglike)
        assert torch.equal(mb[k], state.models)
    _assert_states_equal(got, state)


@pytest.mark.parametrize("walk", WALKS)
def test_step_counter_block_equals_eager_block(walk):
    """The step a CUDA graph captures (static buffers, variates[i] with a
    device counter, the state copied back) run eagerly: the same block as
    run_block's eager loop, bit for bit."""
    s = _sampler(walk)
    state0 = _state(s)
    nsteps = 9
    eager = s.run_block(state0, torch.Generator().manual_seed(5), nsteps,
                        fgamma=0.8, graphed=False)
    buf = StepBuffers(s, state0, nsteps)
    s.draw_block(torch.Generator().manual_seed(5), nsteps, out=buf.variates)
    counted = buf.run(state0, 0.8)
    _assert_states_equal(counted[0], eager[0])
    for a, b in zip(counted[1:], eager[1:]):
        assert torch.equal(a, b)
    assert int(buf.i) == nsteps
    # the buffers are reused: a second block from the new state
    s.draw_block(torch.Generator().manual_seed(6), nsteps, out=buf.variates)
    again = s.run_block(eager[0], torch.Generator().manual_seed(6), nsteps,
                        fgamma=0.8, graphed=False)
    _assert_states_equal(buf.run(counted[0], 0.8)[0], again[0])


def test_unknown_walk_and_missing_arguments_raise():
    with pytest.raises(ValueError, match="unknown walk"):
        _sampler("hmc")
    with pytest.raises(ValueError, match="stepsize"):
        EnsembleSampler(loglike_fn=_gauss_torch, nfree=3, nmodel=3,
                        nchains=4, walk="mrw", pmin=_MEAN - 1,
                        pmax=_MEAN + 1)
    with pytest.raises(ValueError, match="3 chains"):
        _sampler("demc", n=2)


def _gauss_sigma(x):
    sigma = torch.tensor([1.0, 2.0, 0.5], dtype=x.dtype)
    return -0.5 * torch.sum((x / sigma) ** 2, dim=1), x[:, :1]


def _flat(x):
    # bounds enforced in the likelihood, as Likelihood does (snooker moves
    # are not folded and rely on this rejection)
    inb = torch.all((x >= -1.0) & (x <= 3.0), dim=1)
    return (torch.where(inb, torch.zeros_like(x[:, 0]),
                        torch.full_like(x[:, 0], -torch.inf)), x[:, :1])


@pytest.mark.parametrize("case,walk", [
    ("gaussian", "mrw"), ("gaussian", "demc"), ("gaussian", "snooker"),
    ("flat", "mrw"), ("flat", "demc"), ("flat", "snooker"),
    ("bounds", "unif")])
def test_walker_statistics(case, walk):
    """bart_tpu's known-answer checks of each walk (test_inference.py:
    35-107): a 3-D Gaussian target (16 chains x 4000 steps: mean within
    0.15, std within 10%, acceptance in (0.1, 0.95)); a flat posterior
    under reflection (32 chains x 3000 steps, proposals folding at the
    walls: mean within 5% of the width, std within 5% of uniform's, each
    of 10 bins within 10% of uniform occupancy); the unif sweep stays in
    its bounds and covers them."""
    gen = torch.Generator().manual_seed(1)
    if case == "gaussian":
        s = EnsembleSampler(loglike_fn=_gauss_sigma, nfree=3, nmodel=1,
                            nchains=16, walk=walk, pmin=np.full(3, -50.0),
                            pmax=np.full(3, 50.0),
                            stepsize=np.full(3, 0.7))
        state = s.init_state(gen, np.zeros((16, 3)))
        chunks = []
        for _ in range(20):
            state, pb, _, _ = s.run_block(state, gen, 200)
            chunks.append(pb.numpy())
        flat = np.concatenate(chunks)[1000:].reshape(-1, 3)
        assert np.abs(flat.mean(0)).max() < 0.15
        np.testing.assert_allclose(flat.std(0), [1.0, 2.0, 0.5], rtol=0.1)
        accept = int(state.naccept.sum()) / (16 * 4000)
        assert 0.1 < accept < 0.95
    elif case == "flat":
        lo, hi = -1.0, 3.0
        s = EnsembleSampler(loglike_fn=_flat, nfree=2, nmodel=1, nchains=32,
                            walk=walk, pmin=np.full(2, lo),
                            pmax=np.full(2, hi), stepsize=np.full(2, 2.5))
        state = s.init_state(gen)
        chunks = []
        for _ in range(10):
            state, pb, _, _ = s.run_block(state, gen, 300)
            chunks.append(pb.numpy())
        flat = np.concatenate(chunks)[500:].reshape(-1, 2)
        width = hi - lo
        assert np.abs(flat.mean(0) - (lo + hi) / 2).max() < 0.05 * width
        np.testing.assert_allclose(flat.std(0), width / np.sqrt(12.0),
                                   rtol=0.05)
        for j in range(2):
            h, _ = np.histogram(flat[:, j], bins=10, range=(lo, hi))
            np.testing.assert_allclose(h / h.mean(), 1.0, atol=0.1)
    else:
        s = EnsembleSampler(loglike_fn=_gauss_sigma, nfree=3, nmodel=1,
                            nchains=16, walk=walk, pmin=np.full(3, -50.0),
                            pmax=np.full(3, 50.0))
        state = s.init_state(gen, np.zeros((16, 3)))
        state, pb, _, _ = s.run_block(state, gen, 100)
        assert pb.min() >= -50 and pb.max() <= 50
        assert pb.std() > 10.0
        assert int(state.naccept.sum()) == 16 * 100
