"""bart_tpu_torch's on-the-fly line-by-line opacity against bart_tpu's at
float64 on the small demo problem: ``tile_lines`` array for array,
``cross_section_grid`` at osamp 1, 4 and 16 at rtol 1e-10,
``voigt_profile`` against bart_tpu and scipy, the osamp = 4 table build
at two budgets (one chunks), the on-the-fly ``ForwardModel`` (eclipse
raygrid and expsum, transit; CIA, Rayleigh and a cloud deck) against
bart_tpu's ``jitted()`` at rtol 1e-9 with the tables carried over by
``tables_from_jax``, its ``diagnostics`` and ``spectrum_from_profiles``,
and both pipelines at osamp = 4 on tests/test_torch_pipeline.py's tiny
cfgs."""

import shutil

import numpy as np
import pytest
import scipy.special
import torch

import jax
import jax.numpy as jnp

import bart_tpu.opacity.extinction as jext
from bart_tpu import constants as const
from bart_tpu.driver.pipeline import Pipeline as JPipeline
from bart_tpu.linelist.molecules import get_molecule
from bart_tpu.obs.bands import build_band_matrix as jbands
from bart_tpu.opacity.grid import build_opacity_grid as jbuild
from bart_tpu.opacity.grid import load_grid as jload_grid
from bart_tpu.physics.voigt import voigt_profile as jvoigt
from bart_tpu.rt.forward import ForwardConfig as JConfig
from bart_tpu.rt.forward import ForwardModel as JModel

import bart_tpu_torch.opacity.extinction as ext
from bart_tpu_torch.demo import DEMO_PARAMS, DEMO_PARAMS_TRANSIT, demo_inputs
from bart_tpu_torch.obs.bands import build_band_matrix
from bart_tpu_torch.opacity.grid import build_opacity_grid
from bart_tpu_torch.physics.voigt import voigt_profile
from bart_tpu_torch.rt.forward import ForwardConfig, ForwardModel

from test_torch_pipeline import OPACITY, cfgs, port, work  # noqa: F401
from test_torch_transit_forward import _params

F64 = torch.float64
NL, NW = 12, 256
#: case -> (solution, ForwardConfig options, base parameters, the
#: cloud-top/Rayleigh parameters inserted before log CH4); CIA throughout
CASES = {
    "eclipse": ("eclipse", {"scattering": "ray", "cloudtop": True},
                DEMO_PARAMS, (1.0, 0.5)),
    "eclipse-expsum": ("eclipse", {"scattering": "ray", "cloudtop": True,
                                   "quadrature": "expsum"},
                       DEMO_PARAMS, (1.0, 0.5)),
    "transit": ("transit", {"scattering": "ray", "cloudtop": True},
                DEMO_PARAMS_TRANSIT, (1.0, 0.5)),
}


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def demo():
    return demo_inputs(nlayer=NL, nwave=NW, nlines=300, t_step=520.0)


def _cutoff(inp, spec):
    """The wing reach build_opacity_grid buckets with."""
    mol = get_molecule("CH4")
    return jext.wing_cutoff(20.0, float(inp.wn[-1]), float(inp.t_grid[0]),
                            float(inp.pressure[-1]) * const.BAR_TO_BARYE,
                            mol.mass * const.AMU, mol.diameter * 1e-8, spec)


def _tiles(inp, spec=None, ethresh=0.0, tile_size=256, pad=128):
    """(bart_tpu's LineTiles, the port's) of the demo lines."""
    cut = _cutoff(inp, spec or jext.BroadeningSpec())
    kw = dict(tile_size=tile_size, pad_lines_to=pad, ethresh=ethresh)
    return (jext.tile_lines(inp.lines, inp.wn, cut, **kw),
            ext.tile_lines(inp.lines, inp.wn, cut, device="cpu", **kw))


@pytest.mark.parametrize("ethresh,tile_size,pad", [(0.0, 256, 128),
                                                   (1e-3, 64, 16)])
def test_tile_lines_matches(demo, ethresh, tile_size, pad):
    """Every array of the uniform tiling, exactly; grid_mask also of the
    bucketed tiling."""
    inp = demo_inputs(nlayer=4, nwave=900, nlines=2000)
    ref, got = _tiles(inp, ethresh=ethresh, tile_size=tile_size, pad=pad)
    assert got.shape == ref.shape and got.n_grid == ref.n_grid == 900
    assert got.cutoff == ref.cutoff
    for f in ("wn_tiles", "grid_mask", "wn0", "s296", "elower", "gamma_air",
              "n_air", "weight"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert got.grid_mask.dtype == torch.bool
    for (_, t), (_, t_r) in zip(
            ext.tile_lines_bucketed(inp.lines, inp.wn, 7.5, tile_size=64,
                                    pad_lines_to=16, device="cpu"),
            jext.tile_lines_bucketed(inp.lines, inp.wn, 7.5, tile_size=64,
                                     pad_lines_to=16)):
        np.testing.assert_array_equal(t.grid_mask.numpy(),
                                      np.asarray(t_r.grid_mask))


@pytest.mark.parametrize("osamp", [1, 4, 16])
@pytest.mark.parametrize("mode", ["collision", "air"])
def test_cross_section_grid_matches(demo, osamp, mode):
    """cross_section_grid at float64, point-sampled and bin-averaged, with
    the nwidth truncation, at rtol 1e-10."""
    spec_j = jext.BroadeningSpec(mode=mode)
    spec_t = ext.BroadeningSpec(mode=mode)
    tj, tt = _tiles(demo, spec_j)
    T = np.array([400.0, 1000.0, 2200.0, 3000.0])
    p = np.array([1e-5, 0.1, 3.0, 100.0]) * 1e6
    wndelt = float(demo.wn[1] - demo.wn[0])
    got = ext.cross_section_grid(tt, torch.tensor(T), torch.tensor(p),
                                 spec_t, nwidth=20.0, osamp=osamp,
                                 wndelt=wndelt)
    ref = np.asarray(jext.cross_section_grid(
        tj, jnp.asarray(T), jnp.asarray(p), spec_j, nwidth=20.0,
        osamp=osamp, wndelt=wndelt))
    assert got.shape == ref.shape == (4, NW) and got.dtype == F64
    assert ref.max() > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10,
                               atol=1e-10 * ref.max())


def test_bin_average_conserves_line_mass(demo):
    """osamp 16: the bin-averaged sigma integrates to the strengths of
    the lines whose wings lie inside the grid, as the point-sampled one
    does not have to (tests/test_opacity.py:357-361)."""
    _, tt = _tiles(demo)
    wndelt = float(demo.wn[1] - demo.wn[0])
    T, p = torch.tensor([1500.0], dtype=F64), torch.tensor([1e3], dtype=F64)
    sig = ext.cross_section_grid(tt, T, p, ext.BroadeningSpec(), osamp=16,
                                 wndelt=wndelt)[0].numpy()
    s = ext._line_strength(tt, T, ext.partition_function("CH4"))[0].numpy()
    lines = tt.wn0.numpy()
    inside = ((lines > demo.wn[0] + 5.0) & (lines < demo.wn[-1] - 5.0)
              & (tt.weight.numpy() > 0))
    np.testing.assert_allclose(sig.sum() * wndelt, s[inside].sum(),
                               rtol=1e-3)


def test_voigt_profile_matches():
    rng = np.random.default_rng(3)
    dx = rng.normal(0, 0.3, 200)
    sigma = rng.uniform(1e-3, 0.2, 200)
    gamma = rng.uniform(1e-4, 0.3, 200)
    got = voigt_profile(*(torch.tensor(a) for a in (dx, sigma, gamma)))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jvoigt(dx, sigma, gamma)),
                               rtol=1e-12)
    np.testing.assert_allclose(got.numpy(),
                               scipy.special.voigt_profile(dx, sigma, gamma),
                               rtol=1e-10)
    assert float(voigt_profile(torch.tensor(0.0, dtype=F64),
                               torch.tensor(0.1, dtype=F64),
                               torch.tensor(0.05, dtype=F64))) \
        == pytest.approx(2.7895547039, rel=1e-10)


@pytest.mark.parametrize("budget", [2e9, 2e6])
def test_build_opacity_grid_osamp_matches(demo, budget):
    """The osamp = 4 float32 table within float32 rounding of bart_tpu's;
    the small budget (with the sub-sample axis counted) splits the
    conditions and the line axis."""
    ref = np.asarray(jbuild({"CH4": demo.lines}, demo.wn, demo.t_grid,
                            demo.pressure, cond_batch=80, dtype=jnp.float64,
                            osamp=4).sigma)
    got = build_opacity_grid({"CH4": demo.lines}, demo.wn, demo.t_grid,
                             demo.pressure, budget_bytes=budget, osamp=4,
                             dtype=F64, device="cpu").sigma.numpy()
    assert got.dtype == ref.dtype == np.float32
    assert got.shape == ref.shape == (1, 6, NL, NW)
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6 * ref.max())


def _models(inp, case, osamp=1, budget_bytes=2e9):
    """(bart_tpu's on-the-fly model, the port's, the port's tables
    carried over from bart_tpu's, the parameters)."""
    solution, cfg, base, extra = CASES[case]
    if solution == "transit":
        kw, bj = inp.transit_config_kwargs, jbands(inp.wn, inp.filters)
        bt = build_band_matrix(inp.wn, inp.filters, device="cpu", dtype=F64)
    else:
        kw = inp.config_kwargs
        bj = jbands(inp.wn, inp.filters, star_flux=inp.star_flux,
                    rprs=inp.system.rprs)
        bt = build_band_matrix(inp.wn, inp.filters, star_flux=inp.star_flux,
                               rprs=inp.system.rprs, device="cpu", dtype=F64)
    tj, tt = _tiles(inp)
    common = dict(wn_grid=inp.wn, pressure=inp.pressure, species=inp.species,
                  base_abundances=inp.base_q, system=inp.system,
                  cia_tables=[inp.cia], nwidth=20.0, osamp=osamp)
    fmj = JModel(JConfig(**kw, **cfg), opacity={"CH4": tj}, bands=bj,
                 broadening=jext.BroadeningSpec(), dtype=jnp.float64,
                 **common)
    fmt = ForwardModel(ForwardConfig(**kw, **cfg), opacity={"CH4": tt},
                       bands=bt, broadening=ext.BroadeningSpec(),
                       budget_bytes=budget_bytes, dtype=F64, device="cpu",
                       **common)
    tabs = fmt.tables_from_jax({k: np.asarray(v)
                                for k, v in fmj.tables.items()})
    return fmj, fmt, tabs, _params(base, extra)


@pytest.mark.parametrize("case", list(CASES))
def test_onthefly_forward_matches_jitted(demo, case):
    """Bands, spectrum and valid of each chain against bart_tpu's
    ``jitted()`` at 1e-9, on the port's own tiles and on bart_tpu's
    carried over (bit for bit the same)."""
    fmj, fmt, tabs, P = _models(demo, case)
    assert set(tabs) == set(fmt.tables) and "tab" not in tabs
    assert tabs["lt0_grid_mask"].dtype == torch.bool
    ref = [fmj.jitted()(jnp.asarray(p)) for p in P]
    got = fmt(torch.tensor(P), tabs)
    own = fmt(torch.tensor(P))
    for i, name in enumerate(("band", "spectrum", "valid")):
        r = np.stack([np.asarray(x[i]) for x in ref])
        if name == "valid":
            np.testing.assert_array_equal(got[i].numpy(), r)
            assert not r[3] and r[:3].all()
        else:
            assert got[i].dtype == F64
            np.testing.assert_allclose(got[i].numpy(), r, rtol=1e-9,
                                       err_msg=name)
        np.testing.assert_array_equal(own[i].numpy(), got[i].numpy())


def test_onthefly_osamp_chunks_and_diagnostics(demo):
    """osamp = 4 on the fly against bart_tpu's ``batched()``; a budget of
    one condition a call changes no bit; ``diagnostics`` against bart_tpu's
    ``diagnostics_batch()`` (jit of vmap) and ``spectrum_from_profiles``
    against bart_tpu's, at 1e-9."""
    fmj, fmt, tabs, P = _models(demo, "transit", osamp=4)
    _, fm1, _, _ = _models(demo, "transit", osamp=4, budget_bytes=1.0)
    assert fmt._cond_chunk >= 4 * NL and fm1._cond_chunk == 1
    got = fmt(torch.tensor(P), tabs)
    ref = fmj.batched()(jnp.asarray(P))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-9)
    for a, b in zip(fm1(torch.tensor(P), tabs), got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    diag = fmt.diagnostics(torch.tensor(P))
    dref = fmj.diagnostics_batch()(jnp.asarray(P))
    for a, b in zip(diag[:4], dref[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9)
    np.testing.assert_array_equal(diag[4].numpy(), np.asarray(dref[4]))
    batch = fmt.diagnostics_batch()(torch.tensor(P[:2]))
    np.testing.assert_allclose(batch[3].numpy(), diag[3][:2].numpy(),
                               rtol=1e-12)
    T, q, rad = diag[0][0].numpy(), diag[1][0].numpy(), diag[2][0].numpy()
    spec = fmt.spectrum_from_profiles(T[None], q[None], rad[None])
    np.testing.assert_allclose(
        spec[0].numpy(),
        np.asarray(jax.jit(fmj.spectrum_from_profiles)(T, q, rad)),
        rtol=1e-9)


def test_pipelines_at_osamp4(work):  # noqa: F811
    """Both pipelines' --justOpacity at osamp = 4 (each its own float32
    table, at test_torch_pipeline.py's 2e-6), then the port's
    --justSpectrum on bart_tpu's table at 1e-9."""
    jloc, ploc = work / "jax_osamp4", work / "port_osamp4"
    cfg, jcfg = cfgs(work, "eclipse", ploc, osamp="4")
    _, jcfg = cfgs(work, "eclipse", jloc, osamp="4")
    ref = JPipeline(jcfg, just_opacity=True).run()
    grid = port(cfg, just_opacity=True).run()
    got, want = grid.sigma.numpy(), np.asarray(ref.sigma)
    assert got.shape == want.shape == (1, 5, 16, 101)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6 * want.max())
    jload = np.asarray(jload_grid(str(jloc / OPACITY)).sigma)
    np.testing.assert_array_equal(jload, want)
    _, jspec = JPipeline(jcfg, just_spectrum=True).run()
    shutil.copy(jloc / OPACITY, ploc / OPACITY)
    _, spec = port(cfg, just_spectrum=True).run()
    np.testing.assert_allclose(spec, np.asarray(jspec), rtol=1e-9)
