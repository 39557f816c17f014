"""The plain reference agrees with the program's plain CPU path at a small
size: the forward and the likelihood (float64, K = 1 and folded), the
table's entries line by line, the snooker proposal and the variates the
sampler draws."""

import os

import numpy as np
import pytest
import torch

from benchtools import CELLS, HERE, manifest, tiny_overrides
from bm import cell, walk
from bm.reference import Reference

DTYPE = torch.float64


def program(name, workdir, extra):
    """The program's likelihood, model and space on the CPU in float64 at
    the tiny size, and the table it built."""
    from bart_tpu_torch.driver.config import load_config
    from bart_tpu_torch.driver.pipeline import Pipeline
    from bart_tpu_torch.utils.grids import folded_fine_grid

    w = manifest.cell(name)
    ov = dict(tiny_overrides(name, workdir), **extra)
    raw = cell.raw_cfg(w, ov)
    raw.update(loc_dir=os.path.join(workdir, "out"), quiet="True",
               opacityfile=os.path.join(workdir, f"{name}.npz"))
    cfg = load_config(None, raw)
    pipe = Pipeline(cfg, device="cpu", dtype=DTYPE)
    p = pipe.stage_pressure()
    atm = pipe.stage_atmosphere(p, pipe.stage_abundances())
    wn = cfg.wavenumber_grid()
    wn_rt = folded_fine_grid(wn, cfg.fold_K) if cfg.fold_K > 1 else wn
    grid = pipe.stage_opacity(pipe.stage_linelist(wn_rt), wn_rt, p, atm)
    fm, like, space = pipe.stage_forward(atm, wn, grid)
    ref = Reference(w["config_obj"], dict(w["traffic_params"]["cfg"], **ov),
                    HERE, torch.device("cpu"))
    return like, space, ref, grid.sigma.numpy()


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("bf16", [False, True])
def test_forward_and_likelihood(name, bf16, tmp_path):
    folded = "fold" in name
    if bf16 and not folded:
        pytest.skip("a K = 1 cell has no bfloat16 fine table")
    extra = {"foldtable16": str(bf16)} if folded else {}
    like, space, ref, sigma = program(name, str(tmp_path), extra)
    ref.load_table(sigma, fine="bfloat16" if bf16 else None)
    free = cell.start_positions(space, 6, 0.01, 123)
    ll, model = like(torch.as_tensor(free))
    want, valid = ref.models(free)
    assert valid.sum() >= 3
    np.testing.assert_allclose(model.numpy()[valid], want[valid], rtol=1e-9)
    np.testing.assert_allclose(ll.numpy(), ref.loglike(free, want, valid),
                               rtol=1e-9)
    if folded:
        assert 0 < int(ref.mask.sum()) < len(ref.wn)


@pytest.mark.parametrize("name", CELLS)
def test_table_line_by_line(name, tmp_path):
    _, _, ref, sigma = program(name, str(tmp_path), {})
    rng = np.random.default_rng(5)
    M, nT, L, F = sigma.shape
    for _ in range(6):
        m, it, lay = rng.integers(M), rng.integers(nT), rng.integers(L)
        j = rng.integers(F, size=8)
        want, scale = ref.cross_sections(int(m), int(it), int(lay), j)
        got = sigma[m, it, lay, j]
        assert np.all(np.abs(got - want) <= 1e-4 * (np.abs(want)
                                                     + 1e-4 * scale))


def test_snooker_proposal_and_variates():
    from bart_tpu_torch.inference.samplers import EnsembleSampler

    n, d = 24, 5
    lo, hi = -np.ones(d) * 2, np.arange(1, d + 1, dtype=float)
    s = EnsembleSampler(loglike_fn=None, nfree=d, nmodel=3, nchains=n,
                        pmin=lo, pmax=hi)
    gen = torch.Generator().manual_seed(99)
    rng = np.random.default_rng(1)
    pos = lo + (hi - lo) * rng.random((n, d))
    Z = lo + (hi - lo) * rng.random((s.nz, d))
    state = torch.as_tensor
    st = gen.get_state()
    v = s.draw_block(gen, 3)
    mine = walk.draw_block(st, 3, n, d, torch.device("cpu"))
    for k in range(3):
        for f, x in zip(v._fields, v):
            np.testing.assert_array_equal(x[k].numpy(), mine[k][f])
    from bart_tpu_torch.inference.samplers import SamplerState
    z = torch.zeros(())
    S = SamplerState(state(pos), z, z, state(Z), torch.tensor(130), z, z, z,
                     torch.tensor(0))
    one = type(v)(*(x[1] for x in v))
    xp, corr = s._propose(S, one, torch.tensor(1.0, dtype=torch.float64))
    wp, wc = walk.propose(pos, Z, 130, mine[1], lo, hi)
    np.testing.assert_allclose(xp.numpy(), wp, rtol=0, atol=1e-13)
    np.testing.assert_allclose(corr.numpy(), wc, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", CELLS)
def test_own_table(name, tmp_path):
    """The reference's own table, built on the device's path, is scipy's
    line by line entry by entry and the program's to its build's
    rounding."""
    _, _, ref, sigma = program(name, str(tmp_path), {})
    own = ref.build_table().numpy()
    assert own.shape == sigma.shape
    rng = np.random.default_rng(6)
    M, nT, L, F = own.shape
    for _ in range(6):
        m, it, lay = rng.integers(M), rng.integers(nT), rng.integers(L)
        j = rng.integers(F, size=8)
        want, scale = ref.cross_sections(int(m), int(it), int(lay), j)
        np.testing.assert_allclose(own[m, it, lay, j], want, rtol=1e-8,
                                   atol=1e-12 * scale)
    assert np.all(np.abs(own - sigma) <= 1e-4 * (np.abs(own) + 1e-30))
