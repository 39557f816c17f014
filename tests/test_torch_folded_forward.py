"""bart_tpu_torch's folded forward model (fold_osamp = K > 1) against
bart_tpu's ``batched()`` at float64 on a small demo problem, in both
geometries with CIA, Rayleigh and cloud rows, with and without the
adaptive split and with float and bfloat16 fine tables; the fine-bin
mask; ``_assemble``; then a short folded retrieval.

The fine opacity table is built once by bart_tpu on the folded fine grid
and handed to both packages; each comparison runs this package's model on
its own folded tables and on the tables carried over from the bart_tpu
model with ``tables_from_jax``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bart_tpu.obs.bands import build_band_matrix as jbands
from bart_tpu.opacity.grid import build_opacity_grid as jbuild
from bart_tpu.opacity.grid import fine_bin_mask as jmask
from bart_tpu.rt.forward import ForwardConfig as JConfig
from bart_tpu.rt.forward import ForwardModel as JModel

from bart_tpu_torch.demo import (DEMO_PARAMS, DEMO_PARAMS_TRANSIT,
                                 TRANSIT_BOUNDS, TRUTH_TRANSIT,
                                 build_demo_model, demo_inputs)
from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
from bart_tpu_torch.inference.retrieval import run_mcmc
from bart_tpu_torch.opacity.grid import OpacityGrid, fine_bin_mask
from bart_tpu_torch.rt.forward import ForwardConfig, ForwardModel
from bart_tpu_torch.rt.fused import FoldedTable, RowsTable, fold_table
from bart_tpu_torch.utils.grids import folded_fine_grid

F64 = torch.float64
NL, NW, K = 12, 64, 4
#: continuum rows beside the 6 line rows: 14 CIA, Rayleigh, a cloud deck
CONTINUUM = {"scattering": "ray", "cloudtop": True}
EXTRA = (1.0, 0.5)          # cloud-top pressure [bar], log Rayleigh factor


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def demo():
    """(inputs, bart_tpu OpacityGrid on the K-times-finer grid) of the
    small demo problem: line bands at 2700/3100/4300 cm-1 and line-free
    stretches between them, so the adaptive split has both kinds of bin."""
    inp = demo_inputs(nlayer=NL, nwave=NW, nlines=300, t_step=520.0)
    grid = jbuild({"CH4": inp.lines}, folded_fine_grid(inp.wn, K),
                  inp.t_grid, inp.pressure, cond_batch=80,
                  dtype=jnp.float64)
    return inp, grid


def _torch_grid(grid):
    return OpacityGrid(grid.species, grid.t_grid, grid.pressure,
                       grid.wn_grid, torch.tensor(np.asarray(grid.sigma)))


def _models(inp, grid, solution, quadrature="raygrid", fold_adapt=0.02,
            fold_bf16=False):
    """(bart_tpu model, this package's model, its tables carried over
    from the bart_tpu model), folded by K with the continuum rows."""
    if solution == "transit":
        bands = jbands(inp.wn, inp.filters)
        kw = inp.transit_config_kwargs
    else:
        bands = jbands(inp.wn, inp.filters, star_flux=inp.star_flux,
                       rprs=inp.system.rprs)
        kw = inp.config_kwargs
    cfg = dict(quadrature=quadrature, **kw, **CONTINUUM)
    common = dict(wn_grid=inp.wn, pressure=inp.pressure, species=inp.species,
                  base_abundances=inp.base_q, system=inp.system,
                  cia_tables=[inp.cia], fold_osamp=K, fold_adapt=fold_adapt,
                  fold_bf16=fold_bf16)
    fmj = JModel(JConfig(**cfg), opacity=grid, bands=bands,
                 dtype=jnp.float64, **common)
    plain = build_demo_model(inp, dtype=F64, grid=_torch_grid(grid), fold=K,
                             solution=solution, device="cpu")
    fmt = ForwardModel(ForwardConfig(**cfg), opacity=plain.opacity,
                       bands=plain.bands, dtype=F64, device="cpu", **common)
    tabs = fmt.tables_from_jax({k: np.asarray(v)
                                for k, v in fmj.tables.items()})
    return fmj, fmt, tabs


def _params(base, seed=0):
    """Four chains around ``base`` with the cloud-top and Rayleigh
    parameters inserted before the last (CH4) entry; chain 3 has T far
    above tmax (invalid); in transit the radius spreads by ~100 km."""
    rng = np.random.default_rng(seed)
    base = np.concatenate([base[:-1], EXTRA, base[-1:]])
    P = np.tile(base, (4, 1)) + rng.normal(0, 0.01, (4, len(base)))
    if base[5] > 1e4:
        P[:, 5] += rng.normal(0, 100.0, 4)
    P[3, 4] = 3.0
    return P


# ---------------------------------------------------------------------
# the fine-bin mask

@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("delta", [0.02, 0.5])
def test_fine_bin_mask_matches_bin_for_bin(demo, delta, dtype):
    _, grid = demo
    sig = torch.tensor(np.asarray(grid.sigma)).to(dtype)
    got = fine_bin_mask(sig, K, delta=delta)
    ref = jmask(sig.numpy(), K, delta=delta)
    assert got.dtype == torch.bool and got.shape == (NW,)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < int(got.sum()) < NW          # both kinds of bin
    # [rows, L, W K] is read as one molecule
    np.testing.assert_array_equal(
        fine_bin_mask(sig[0], K, delta=delta).numpy(), ref)
    with pytest.raises(ValueError, match="multiple of K"):
        fine_bin_mask(sig[..., :-1], K)


# ---------------------------------------------------------------------
# the forward model

@pytest.mark.parametrize("fold_bf16", [False, True], ids=["f64", "bf16"])
@pytest.mark.parametrize("fold_adapt", [None, 0.02], ids=["all", "split"])
@pytest.mark.parametrize("geometry", ["eclipse-raygrid", "eclipse-expsum",
                                      "transit"])
def test_folded_forward_matches_bart_tpu(demo, geometry, fold_adapt,
                                         fold_bf16):
    inp, grid = demo
    solution, _, quad = geometry.partition("-")
    fmj, fmt, tabs = _models(inp, grid, solution, quad or "raygrid",
                             fold_adapt, fold_bf16)
    transit = solution == "transit"
    assert fmt.config.n_params == (9 if transit else 8) and fmt.fold == K
    P = _params(DEMO_PARAMS_TRANSIT if transit else DEMO_PARAMS)
    bj, sj, vj = fmj.batched()(jnp.asarray(P))

    # the split, and the dispatch parts' tables in this package's layout
    split = fold_adapt is not None
    assert (fmt._idx_fine is not None) == split
    assert set(fmt.tables) == set(tabs)
    assert ("tabs" in tabs) == ("wn_f" in tabs) == ("wn_s" in tabs) == split
    n_f = len(fmj._idx_fine) if split else NW
    if split:
        np.testing.assert_array_equal(fmt._idx_fine, fmj._idx_fine)
        np.testing.assert_array_equal(fmt._idx_smooth, fmj._idx_smooth)
        assert 0 < n_f < NW
        for t in (tabs, fmt.tables):
            assert isinstance(t["tabs"], RowsTable)
            assert t["tabs"].plain().shape == (6 + 16, NL, NW - n_f)
            assert t["tabs"].tab.dtype == F64   # the K = 1 part stays wide
    for t in (tabs, fmt.tables):
        ft = t["tabk"]
        assert isinstance(ft, FoldedTable) and (ft.K, ft.W) == (K, n_f)
        assert ft.tab.shape == (6 + 16, NL, -(-n_f * K // 8) * 8)
        assert ft.tab.dtype == (torch.bfloat16 if fold_bf16 else F64)
    # bart_tpu's sigmak and frowsk, row for row, in its own layout
    np.testing.assert_array_equal(
        fold_table(ft.tab[..., :n_f * K], K).double().numpy(),
        np.concatenate([np.asarray(fmj.tables["sigmak"]).astype(np.float64),
                        np.asarray(fmj.tables["frowsk"]).astype(np.float64)],
                       axis=1))

    for t in (None, tabs):              # its own tables, then the carried
        bt, st, vt = fmt(torch.tensor(P), t)
        assert bt.shape == (4, 10) and st.shape == (4, NW)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        assert not vt[3] and vt[:3].all()
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-9)
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-9)


@pytest.mark.parametrize("solution", ["eclipse", "transit"])
def test_folded_forward_differs_from_the_bin_mean_model(demo, solution):
    """Folding moves the spectrum where bins have line structure and
    leaves the smooth bins at the K = 1 result on the bin-mean table."""
    inp, grid = demo
    _, fmt, _ = _models(inp, grid, solution)
    coarse = OpacityGrid(grid.species, grid.t_grid, grid.pressure, inp.wn,
                         fmt.tables["sigma"])
    kw = inp.transit_config_kwargs if solution == "transit" \
        else inp.config_kwargs
    fm1 = ForwardModel(ForwardConfig(**kw, **CONTINUUM), wn_grid=inp.wn,
                       pressure=inp.pressure, species=inp.species,
                       base_abundances=inp.base_q, system=inp.system,
                       cia_tables=[inp.cia], opacity=coarse, bands=fmt.bands,
                       dtype=F64, device="cpu")
    P = torch.tensor(_params(DEMO_PARAMS_TRANSIT if solution == "transit"
                             else DEMO_PARAMS)[:3])
    folded, mean = fmt(P)[1], fm1(P)[1]
    rel = ((folded - mean) / mean).abs()
    # the transit depth is mostly r_bot^2, so its relative change is small
    assert float(rel[:, fmt._idx_fine].max()) > (
        1e-4 if solution == "transit" else 1e-3)
    # (up to the curvature of the continuum rows inside a bin: the folded
    # model's smooth rows are bin means, the K = 1 model's bin centres)
    np.testing.assert_allclose(folded[:, fmt._idx_smooth].numpy(),
                               mean[:, fmt._idx_smooth].numpy(), rtol=1e-6)


def test_assemble_puts_the_pieces_back_in_wn_order():
    idx_f, idx_s = torch.tensor([1, 2, 5]), torch.tensor([0, 3, 4, 6])
    full = torch.arange(14.0).reshape(2, 7)
    out = ForwardModel._assemble([(full[:, idx_f], idx_f),
                                  (full[:, idx_s], idx_s)], 7)
    np.testing.assert_array_equal(out.numpy(), full.numpy())
    # a single piece without indices is the spectrum itself
    assert ForwardModel._assemble([(full, None)], 7) is full


def test_folded_model_checks_widths_and_carried_tables(demo):
    inp, grid = demo
    fmj, fmt, _ = _models(inp, grid, "eclipse")
    with pytest.raises(ValueError, match="opacity grid has"):
        build_demo_model(inp, dtype=F64, grid=_torch_grid(grid), fold=2,
                         device="cpu")
    np_tables = {k: np.asarray(v) for k, v in fmj.tables.items()}
    with pytest.raises(ValueError, match="keys differ"):
        fmt.tables_from_jax({k: v for k, v in np_tables.items()
                             if k != "wn_f"})
    with pytest.raises(ValueError, match="shape"):
        fmt.tables_from_jax({**np_tables,
                             "sigmak": np_tables["sigmak"][..., :-1],
                             "frowsk": np_tables["frowsk"][..., :-1]})


def test_build_demo_model_builds_the_fine_table_itself():
    """build_demo_model(fold=K) tabulates on folded_fine_grid with this
    package's own build; bands and outputs stay on the output grid."""
    inp = demo_inputs(nlayer=6, nwave=NW, nlines=60, t_step=1300.0)
    fm = build_demo_model(inp, dtype=F64, fold=K, fold_bf16=True,
                          budget_bytes=1e7, device="cpu")
    assert fm.opacity.sigma.shape == (1, 3, 6, NW * K)
    np.testing.assert_array_equal(fm.opacity.wn_grid,
                                  folded_fine_grid(inp.wn, K))
    assert fm.tables["sigma"].shape == (1, 3, 6, NW)
    assert fm.tables["tabk"].tab.dtype == torch.bfloat16
    band, spec, valid = fm(torch.tensor(DEMO_PARAMS[None]))
    assert band.shape == (1, 10) and spec.shape == (1, NW) and valid.all()
    assert bool(torch.isfinite(spec).all()) and float(spec.min()) > 0.0


# ---------------------------------------------------------------------
# retrieval

def test_run_mcmc_folded_two_blocks(demo):
    inp, grid = demo
    _, fmt, _ = _models(inp, grid, "transit", fold_bf16=True)
    pmin, pmax, step = (np.concatenate([a[:-1], b, a[-1:]]) for a, b in zip(
        TRANSIT_BOUNDS, ([1e-4, -3.0], [10.0, 3.0], [0.0, 0.0])))
    pinit = np.concatenate([DEMO_PARAMS_TRANSIT[:-1], EXTRA,
                            DEMO_PARAMS_TRANSIT[-1:]])
    truth = np.concatenate([TRUTH_TRANSIT[:-1], EXTRA, TRUTH_TRANSIT[-1:]])
    space = ParamSpace(pinit=pinit, pmin=pmin, pmax=pmax, stepsize=step)
    data = fmt(torch.tensor(truth[None]))[0][0].numpy()
    uncert = 0.005 * data
    data = data + np.random.default_rng(42).normal(0, 1, data.shape) * uncert
    res = run_mcmc(Likelihood(fmt, space, data, uncert), space, nchains=8,
                   numit=80, burnin=5, block=5, seed=7, verbose=False)
    assert space.nfree == 5 and res.posterior.shape == (8, 5, 5)
    assert res.niter_total == 80 and np.isfinite(res.best_loglike)
    assert 0.0 < res.accept_rate <= 1.0
    assert np.all(res.posterior >= space.free_min[None, :, None])
    assert np.all(res.posterior <= space.free_max[None, :, None])
