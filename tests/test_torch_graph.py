"""The captured sampler step and forward on the card (marked gpu; they
skip without a CUDA card: a CUDA graph has no CPU mode).

A block replayed from the captured step (StepGraph) against the eager
block from the same state and the same variates, bit for bit: state,
positions, loglike, models, archive and best fit; and a graphed()
forward against the eager forward, for every PT family; and the block of
a madhu_inv model with the wavelet likelihood.  Small demo problems (23
layers x 300 wn), float32 forwards through the fused kernels.  On the card:
``python -m pytest --noconftest -m gpu tests/test_torch_graph.py``.
"""

import numpy as np
import pytest
import torch

from bart_tpu_torch.demo import (DEMO_PARAMS, DEMO_PARAMS_TRANSIT, PT_PARAMS,
                                 TRANSIT_BOUNDS, TRUTH, TRUTH_TRANSIT,
                                 build_demo_model, demo_inputs, demo_params)
from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
from bart_tpu_torch.inference.samplers import EnsembleSampler
from bart_tpu_torch.rt import fused

PMIN = [-5.0, -2.0, -2.0, 0.0, 0.55, -9.0]
PMAX = [-1.0, 1.0, 1.0, 1.0, 1.2, 1.5]
STEP = [0.01, 0.01, 0.0, 0.0, 0.001, 0.1]


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    from bart_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _inputs():
    return demo_inputs(nlayer=23, nwave=300, nlines=400, t_step=260.0)


@pytest.fixture(scope="module")
def models(cuda_device):
    inp = _inputs()
    ecl = build_demo_model(inp, device=cuda_device, budget_bytes=1e8)
    return {
        "eclipse": ecl,
        "transit": build_demo_model(inp, device=cuda_device,
                                    grid=ecl.opacity, solution="transit",
                                    cia=True),
        "folded eclipse": build_demo_model(
            inp, device=cuda_device, quadrature="expsum", fold=4,
            fold_bf16=True, budget_bytes=1e8),
    }


@pytest.fixture(scope="module")
def families(models):
    """An eclipse model of every PT family on the eclipse model's table."""
    ecl = models["eclipse"]
    return {f: build_demo_model(_inputs(), device=ecl.device, grid=ecl.opacity,
                                pt_type=f) for f in PT_PARAMS}


def _likelihood(fm):
    transit = fm.config.solution == "transit"
    truth, base = ((TRUTH_TRANSIT, DEMO_PARAMS_TRANSIT) if transit
                   else (TRUTH, DEMO_PARAMS))
    pmin, pmax, step = TRANSIT_BOUNDS if transit else (PMIN, PMAX, STEP)
    data = fm(torch.tensor(truth[None], dtype=torch.float32,
                           device=fm.device))[0][0].double().cpu().numpy()
    space = ParamSpace(pinit=base, pmin=pmin, pmax=pmax, stepsize=step)
    return Likelihood(fm, space, data, 0.03 * data), space


@pytest.mark.gpu
@pytest.mark.parametrize("path,walk", [
    ("eclipse", "snooker"), ("eclipse", "demc"), ("transit", "snooker"),
    ("folded eclipse", "snooker")])
def test_graphed_block_equals_eager_block(models, path, walk):
    like, space = _likelihood(models[path])
    s = EnsembleSampler(loglike_fn=like, nfree=space.nfree,
                        nmodel=int(like.data.shape[0]), nchains=32,
                        walk=walk, pmin=space.free_min, pmax=space.free_max,
                        stepsize=space.stepsize[space.ifree], z_thin=3)
    gen = torch.Generator(device=like.device)
    gen.manual_seed(3)
    state = s.init_state(gen)
    for block in range(2):          # the second replays the same graph
        saved = gen.get_state()
        eager = s.run_block(state, gen, 12, fgamma=0.9, graphed=False)
        after_eager = gen.get_state()
        gen.set_state(saved)
        before = fused.fused_eclipse.launches
        graphed = s.run_block(state, gen, 12, fgamma=0.9, graphed=True)
        torch.cuda.synchronize()
        assert torch.equal(gen.get_state(), after_eager)
        for k, x in eager[0]._asdict().items():
            assert torch.equal(getattr(graphed[0], k), x), (block, k)
        for a, b in zip(graphed[1:], eager[1:]):
            assert torch.equal(a, b), block
        if block == 1:              # replays do not count in Python
            assert fused.fused_eclipse.launches == before
        state = graphed[0]
    assert len(s._graphs) == 1
    assert int(state.naccept.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["eclipse", "transit", "folded eclipse"])
def test_graphed_forward_equals_eager(models, path):
    fm = models[path]
    base = DEMO_PARAMS_TRANSIT if path == "transit" else DEMO_PARAMS
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=fm.device)
    forward = fm.graphed()
    for _ in range(2):
        p = torch.tensor(base + rng.normal(0, 0.01, (16, len(base))), **f32)
        got = [x.clone() for x in forward(p)]
        ref = fm(p)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert list(fm._graphs) == [16]


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(PT_PARAMS))
def test_graphed_forward_equals_eager_per_pt_family(families, family):
    fm = families[family]
    base = demo_params(family)
    rng = np.random.default_rng(1)
    f32 = dict(dtype=torch.float32, device=fm.device)
    forward = fm.graphed()
    for _ in range(2):
        p = torch.tensor(base * (1.0 + rng.normal(0, 0.002, (16, len(base)))),
                         **f32)
        got = [x.clone() for x in forward(p)]
        ref = fm(p)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert bool(got[2].all())


@pytest.mark.gpu
def test_graphed_block_with_wlike_equals_eager_block(families):
    """A madhu_inv model under the wavelet likelihood: the replayed block
    equals the eager block bit for bit."""
    fm = families["madhu_inv"]
    truth = demo_params("madhu_inv")
    data = fm(torch.tensor(truth[None], dtype=torch.float32,
                           device=fm.device))[0][0].double().cpu().numpy()
    pinit = np.concatenate([truth * 1.05, [1.0, 1e-5, 3e-5]])
    space = ParamSpace(
        pinit=pinit, pmin=[0.2, 0.05, 1e-4, 0.02, 1.0, 1000.0, -3.0, 0, 0,
                           1e-7],
        pmax=[1.0, 0.5, 0.02, 0.5, 10.0, 2500.0, 1.0, 3, 1e-3, 1e-3],
        stepsize=[0.01, 0.01, 1e-4, 0.01, 0.1, 10.0, 0.1, 0.0, 1e-6, 1e-6])
    like = Likelihood(fm, space, data, np.full(10, 3e-5), wlike=True)
    s = EnsembleSampler(loglike_fn=like, nfree=space.nfree, nmodel=10,
                        nchains=32, pmin=space.free_min, pmax=space.free_max,
                        stepsize=space.stepsize[space.ifree], z_thin=3)
    gen = torch.Generator(device=like.device)
    gen.manual_seed(3)
    state = s.init_state(gen)
    saved = gen.get_state()
    eager = s.run_block(state, gen, 12, graphed=False)
    gen.set_state(saved)
    graphed = s.run_block(state, gen, 12, graphed=True)
    torch.cuda.synchronize()
    for k, x in eager[0]._asdict().items():
        assert torch.equal(getattr(graphed[0], k), x), k
    for a, b in zip(graphed[1:], eager[1:]):
        assert torch.equal(a, b)
