"""bart_tpu_torch opacity build against bart_tpu's: tile bucketing, wing
cutoff, per-tile cross-sections at float64, the float32 table, the
runtime T-interpolation, and reading a table bart_tpu saved.

Both packages get the same synthetic line list (demo_inputs, small).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bart_tpu.opacity.extinction as jext
import bart_tpu.opacity.grid as jgrid
from bart_tpu import constants as const
from bart_tpu.linelist.molecules import get_molecule

import bart_tpu_torch.opacity.extinction as ext
import bart_tpu_torch.opacity.grid as grid
from bart_tpu_torch.demo import demo_inputs

F64 = torch.float64


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def small():
    return demo_inputs(nlayer=12, nwave=256, nlines=300, t_step=520.0)


@pytest.fixture(scope="module")
def jax_grid(small):
    return jgrid.build_opacity_grid({"CH4": small.lines}, small.wn,
                                    small.t_grid, small.pressure,
                                    cond_batch=80, dtype=jnp.float64)


def _cutoff(spec):
    mol = get_molecule("CH4")
    return (mol, ext.wing_cutoff(20.0, 5000.0, 400.0, 100.0 * 1e6,
                                 mol.mass * const.AMU, mol.diameter * 1e-8,
                                 spec))


def test_wing_cutoff_matches():
    spec = ext.BroadeningSpec()
    mol, got = _cutoff(spec)
    ref = jext.wing_cutoff(20.0, 5000.0, 400.0, 100.0 * 1e6,
                           mol.mass * const.AMU, mol.diameter * 1e-8,
                           jext.BroadeningSpec())
    assert got == pytest.approx(ref, rel=1e-12)
    assert ext.wing_cutoff(1e4, 5000.0, 400.0, 1e8, mol.mass * const.AMU,
                           mol.diameter * 1e-8, spec) == 25.0


def test_tile_lines_bucketed_matches(small):
    lines = demo_inputs(nlayer=4, nwave=900, nlines=2000).lines
    wn = np.linspace(2500.0, 5000.0, 900)
    got = ext.tile_lines_bucketed(lines, wn, 7.5, tile_size=64,
                                  pad_lines_to=16, device="cpu")
    ref = jext.tile_lines_bucketed(lines, wn, 7.5, tile_size=64,
                                   pad_lines_to=16)
    assert len(got) == len(ref) > 1
    for (sel, t), (sel_r, t_r) in zip(got, ref):
        np.testing.assert_array_equal(sel, sel_r)
        for f in ("wn_tiles", "wn0", "s296", "elower",
                  "gamma_air", "n_air", "weight"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(t_r, f)))


@pytest.mark.parametrize("mode", ["collision", "air"])
def test_cross_section_tiles_match_f64(small, mode):
    spec_t = ext.BroadeningSpec(mode=mode)
    spec_j = jext.BroadeningSpec(mode=mode)
    _, cut = _cutoff(spec_t)
    (sel, tiles), = ext.tile_lines_bucketed(small.lines, small.wn, cut,
                                            device="cpu")
    (_, tiles_j), = jext.tile_lines_bucketed(small.lines, small.wn, cut)
    T = np.array([400.0, 1000.0, 2200.0, 3000.0])
    p = np.array([1e-5, 0.1, 3.0, 100.0]) * 1e6
    got = ext.cross_section_tiles(tiles, torch.tensor(T), torch.tensor(p),
                                  spec_t, nwidth=20.0)
    ref = jext.cross_section_tiles(tiles_j, jnp.asarray(T), jnp.asarray(p),
                                   spec_j, nwidth=20.0)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == F64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10,
                               atol=1e-10 * ref.max())


def test_cross_section_osamp_raises(small):
    """osamp = 4, the bin-averaged cross-sections (once not ported: the
    name stays), against bart_tpu's at float64."""
    (_, tiles), = ext.tile_lines_bucketed(small.lines, small.wn, 25.0,
                                          device="cpu")
    (_, tiles_j), = jext.tile_lines_bucketed(small.lines, small.wn, 25.0)
    T, p = np.array([600.0, 2500.0]), np.array([1e-3, 10.0]) * 1e6
    wndelt = float(small.wn[1] - small.wn[0])
    got = ext.cross_section_tiles(tiles, torch.tensor(T), torch.tensor(p),
                                  ext.BroadeningSpec(), osamp=4,
                                  wndelt=wndelt)
    ref = np.asarray(jext.cross_section_tiles(
        tiles_j, jnp.asarray(T), jnp.asarray(p), jext.BroadeningSpec(),
        osamp=4, wndelt=wndelt))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10,
                               atol=1e-10 * ref.max())


@pytest.mark.parametrize("budget", [2e9, 2e6])
def test_build_opacity_grid_matches(small, jax_grid, budget):
    """The f32 table within f32 rounding; the small budget exercises the
    condition batching and the line-axis split."""
    got = grid.build_opacity_grid({"CH4": small.lines}, small.wn,
                                  small.t_grid, small.pressure,
                                  budget_bytes=budget, dtype=F64, device="cpu")
    ref = np.asarray(jax_grid.sigma)
    assert got.sigma.dtype == torch.float32 and ref.dtype == np.float32
    assert got.sigma.shape == ref.shape == (1, 6, 12, 256)
    np.testing.assert_allclose(got.sigma.numpy(), ref, rtol=2e-6,
                               atol=2e-6 * ref.max())
    assert got.species == jax_grid.species
    np.testing.assert_array_equal(got.t_grid, jax_grid.t_grid)


def test_interp_opacity_matches(jax_grid):
    rng = np.random.default_rng(4)
    sig = np.asarray(jax_grid.sigma, np.float64)
    T = rng.uniform(300, 3100, (3, sig.shape[2]))
    got = grid.interp_opacity(torch.tensor(sig), 400.0, 520.0, 6,
                              torch.tensor(T))
    for c in range(3):
        ref = jgrid.interp_opacity(jnp.asarray(sig), 400.0, 520.0, 6,
                                   jnp.asarray(T[c]))
        np.testing.assert_allclose(got[c].numpy(), np.asarray(ref),
                                   rtol=1e-12)


def test_load_grid_reads_bart_tpu_file(tmp_path, jax_grid):
    path = str(tmp_path / "jax_grid.npz")
    jgrid.save_grid(jax_grid, path)
    g = grid.load_grid(path, device="cpu")
    np.testing.assert_array_equal(g.sigma.numpy(), np.asarray(jax_grid.sigma))
    assert g.species == jax_grid.species
    assert g.t_min == jax_grid.t_min and g.t_step == jax_grid.t_step
    # the port saves uncompressed and reads its own file back
    path2 = str(tmp_path / "torch_grid.npz")
    grid.save_grid(g, path2)
    import zipfile

    with zipfile.ZipFile(path2) as z:
        assert all(i.compress_type == zipfile.ZIP_STORED
                   for i in z.infolist())
    g2 = grid.load_grid(path2, device="cpu")
    np.testing.assert_array_equal(g2.sigma.numpy(), g.sigma.numpy())
    np.testing.assert_array_equal(g2.pressure, jax_grid.pressure)
