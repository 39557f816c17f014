"""The folded (K sub-samples per bin) fused functions of
bart_tpu_torch.rt.fused against bart_tpu.rt.fused.

(a) ``fold_table``/``unfold_table``/``folded_table`` layouts;
(b) ``eclipse_folded_plain`` at float64 against ``jax.vmap`` of
    ``_single_folded`` and at float32 against the Pallas ``_fkernel`` run
    in interpret mode, as tests/test_fused.py runs it;
(c) ``transit_folded_plain`` likewise against ``_tsingle_folded`` and the
    Pallas ``_ftkernel``;
(d) the fixture has structure inside its bins: the folded results differ
    from the K = 1 results on the bin-mean table;
(e) bfloat16 fine tables against the float64 result of the float32 table;
(f) the CUDA kernels against their plain versions on the card (marked
    gpu, skipped without one).

Fixture scale as tests/test_fused.py's folded one: K = 4, R = 18, L = 23,
W = 75 output bins (300 fine points), C = 6.

The card has no JAX, so this module imports jax only inside the tests
that compare with bart_tpu; the card tests run there with
``python -m pytest --noconftest -m gpu tests/test_torch_folded.py``.
"""

import re

import numpy as np
import pytest
import torch

import bart_tpu_torch.rt.fused as fused
from bart_tpu_torch import constants as const
from bart_tpu_torch.demo import (demo_inputs, fine_structure, random_rows,
                                 random_transit_rows)
from bart_tpu_torch.obs.bands import band_integrate, build_band_matrix
from bart_tpu_torch.rt.eclipse import expsum_weights, raygrid_weights
from bart_tpu_torch.rt.planck import C1

F64, F32, BF16 = torch.float64, torch.float32, torch.bfloat16
QUADS = {"raygrid": (raygrid_weights([0.0, 20.0, 40.0, 60.0, 80.0]), False),
         "expsum": (expsum_weights(8), True)}
SHAPE = (18, 23, 75, 6)                                  # (R, L, W, C)
K = 4


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def jx():
    """(jax, jax.numpy, bart_tpu.rt.fused), imported on first use."""
    import jax
    import jax.numpy as jnp

    import bart_tpu.rt.fused as jfused

    return jax, jnp, jfused


class _pallas_interpret:
    """Run bart_tpu's fused entries through their Pallas kernels in
    interpret mode, as tests/test_fused.py does."""

    def __init__(self, jfused):
        self.jfused = jfused

    def __enter__(self):
        self.old = self.jfused.FORCE_PALLAS, self.jfused.INTERPRET
        self.jfused.FORCE_PALLAS, self.jfused.INTERPRET = True, True

    def __exit__(self, *exc):
        self.jfused.FORCE_PALLAS, self.jfused.INTERPRET = self.old


def _fine(tab, k=K, seed=5):
    """tab [R, L, W] -> the bin-major fine table [R, L, W k] (numpy)
    whose bin means are ``tab``."""
    R, L, W = tab.shape
    return (tab[..., None] * fine_structure(R, W, k, seed)).reshape(R, L, W * k)


def _eclipse(quad="raygrid", shape=SHAPE, k=K):
    """(fine [R, L, W k], K = 1 args (tab, wn, mu, muw, wrows, T, drp),
    powers), all numpy float64."""
    (mu, muw), powers = QUADS[quad]
    tab, wn, wrows, T, drp = random_rows(*shape)
    return _fine(tab, k), (tab, wn, mu, muw, wrows, T, drp), powers


def _transit(shape=SHAPE, k=K):
    """(fine, K = 1 args (tab, wrows, G, wgt)), all numpy float64."""
    tab, wrows, G, wgt, _ = random_transit_rows(*shape)
    return _fine(tab, k), (tab, wrows, G, wgt)


def _t(a, dtype=F64, device="cpu"):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _ft(fine, k=K, dtype=F64, table_dtype=None, device="cpu"):
    return fused.folded_table(_t(fine, dtype, device), k, table_dtype)


# ---------------------------------------------------------------------
# (a) layouts

def test_fold_table_matches_and_unfolds(jx):
    _, jnp, jfused = jx
    fine, _, _ = _eclipse()
    got = fused.fold_table(_t(fine), K)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfused.fold_table(jnp.asarray(fine), K)))
    assert got.shape == (K, 18, 23, 75)
    np.testing.assert_array_equal(fused.unfold_table(got).numpy(), fine)


@pytest.mark.parametrize("k,W", [(4, 75), (2, 7), (32, 3)])
def test_folded_table_pads_the_fine_axis_with_zeros(k, W):
    fine = np.random.default_rng(0).uniform(1.0, 2.0, (3, 5, W * k))
    ft = fused.folded_table(_t(fine), k, BF16)
    assert (ft.K, ft.W) == (k, W) and ft.tab.dtype == BF16
    assert ft.tab.shape[2] % 8 == 0 and ft.tab.shape[2] - W * k < 8
    assert ft.tab.is_contiguous()
    assert float(ft.tab[..., W * k:].float().abs().sum()) == 0.0
    np.testing.assert_array_equal(
        ft.bins().float().numpy(),
        _t(fine).to(BF16).float().reshape(3, 5, W, k).numpy())
    with pytest.raises(ValueError, match="multiple of K"):
        fused.folded_table(_t(fine[..., :-1]), k)


# ---------------------------------------------------------------------
# (b) eclipse

@pytest.mark.parametrize("quad", ["raygrid", "expsum"])
def test_eclipse_folded_plain_matches_vmap_single_folded_f64(jx, quad):
    jax, jnp, jfused = jx
    fine, args, powers = _eclipse(quad)
    tabk = jfused.fold_table(jnp.asarray(fine), K)
    ref = jax.vmap(
        lambda w, t, d: jfused._single_folded(
            tabk, *[jnp.asarray(a) for a in args[1:4]], w, t, d,
            powers=powers)
    )(*[jnp.asarray(a) for a in args[4:]])
    got = fused.eclipse_folded_plain(_ft(fine), *[_t(a) for a in args[1:]],
                                     powers=powers)
    assert got.dtype == F64 and got.shape == (6, 75)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10)


@pytest.mark.parametrize("quad", ["raygrid", "expsum"])
def test_eclipse_folded_plain_f32_matches_pallas_interpret(jx, quad):
    jax, jnp, jfused = jx
    fine, args, powers = _eclipse(quad)
    f32 = [jnp.asarray(a, jnp.float32) for a in args]
    tabk = jfused.fold_table(jnp.asarray(fine, jnp.float32), K)
    with _pallas_interpret(jfused):
        ref = jax.vmap(
            lambda w, t, d: jfused.fused_eclipse_folded(
                tabk, *f32[1:4], w, t, d, powers=powers)
        )(*f32[4:])
    got = fused.eclipse_folded_plain(
        _ft(fine, dtype=F32), *[_t(a, F32) for a in args[1:]], powers=powers)
    assert got.dtype == F32
    # both compute in f32, summing in other orders over 23 layers, 18
    # rows and 4 sub-samples
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-5)


def test_eclipse_folded_isothermal_limit():
    """F = pi B(bin centre) for an isothermal atmosphere, whatever the
    in-bin structure."""
    fine, args, _ = _eclipse(shape=(5, 8, 20, 2))
    _, wn, _, _, wrows, T, drp = [_t(a) for a in args]
    for (mu, muw), powers in QUADS.values():
        F = fused.eclipse_folded_plain(_ft(fine), wn, _t(mu), _t(muw), wrows,
                                       torch.full_like(T, 1700.0), drp,
                                       powers=powers)
        piB = np.pi * C1 * wn**3 / torch.expm1(const.C2 * wn / 1700.0)
        np.testing.assert_allclose(F.numpy(), np.broadcast_to(piB, F.shape),
                                   rtol=1e-12)


# ---------------------------------------------------------------------
# (c) transit

def test_transit_folded_plain_matches_vmap_tsingle_folded_f64(jx):
    jax, jnp, jfused = jx
    fine, args = _transit()
    tabk = jfused.fold_table(jnp.asarray(fine), K)
    ref = jax.vmap(jfused._tsingle_folded, in_axes=(None, 0, 0, 0))(
        tabk, *[jnp.asarray(a) for a in args[1:]])
    got = fused.transit_folded_plain(_ft(fine), *[_t(a) for a in args[1:]])
    assert got.dtype == F64 and got.shape == (6, 75)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9)


def test_transit_folded_plain_f32_matches_pallas_interpret(jx):
    jax, jnp, jfused = jx
    fine, args = _transit()
    tabk = jfused.fold_table(jnp.asarray(fine, jnp.float32), K)
    with _pallas_interpret(jfused):
        ref = jax.vmap(
            lambda w, g, wt: jfused.fused_transit_folded(tabk, w, g, wt)
        )(*[jnp.asarray(a, jnp.float32) for a in args[1:]])
    got = fused.transit_folded_plain(_ft(fine, dtype=F32),
                                     *[_t(a, F32) for a in args[1:]])
    assert got.dtype == F32
    # both f32, summing in other orders (tests/test_fused.py: 2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4)


def test_transit_folded_plain_ignores_the_upper_triangle():
    fine, (tab, wrows, G, wgt) = _transit((5, 9, 10, 3))
    noisy = G + np.triu(np.ones_like(G), 1)
    np.testing.assert_array_equal(
        fused.transit_folded_plain(_ft(fine), _t(wrows), _t(noisy),
                                   _t(wgt)).numpy(),
        fused.transit_folded_plain(_ft(fine), _t(wrows), _t(G),
                                   _t(wgt)).numpy())


# ---------------------------------------------------------------------
# (d) the fixture tests the folding

def test_fine_structure_keeps_the_bin_means():
    f = fine_structure(7, 11, 32)
    assert f.shape == (7, 1, 11, 32) and f.min() > 0.0
    np.testing.assert_allclose(f.mean(-1), 1.0, rtol=1e-12)
    # narrow features: the largest sub-sample is several times the mean
    assert np.mean(f.max(-1) > 5.0) > 0.3


@pytest.mark.parametrize("geometry", ["eclipse", "transit"])
def test_folded_differs_from_k1_on_the_bin_mean_table(geometry):
    """Averaging after the exponential is not the K = 1 result on the
    bin-mean table: a function that averaged ext first would pass every
    comparison on a fixture without in-bin structure."""
    if geometry == "eclipse":
        fine, args, powers = _eclipse()
        folded = fused.eclipse_folded_plain(
            _ft(fine), *[_t(a) for a in args[1:]], powers=powers)
        mean = fused.eclipse_plain(*[_t(a) for a in args], powers=powers)
    else:
        fine, args = _transit()
        folded = fused.transit_folded_plain(_ft(fine),
                                            *[_t(a) for a in args[1:]])
        mean = fused.transit_plain(*[_t(a) for a in args])
    np.testing.assert_allclose(
        _t(fine).reshape(18, 23, 75, K).mean(-1).numpy(), args[0], rtol=1e-12)
    rel = ((folded - mean) / mean).abs()
    assert float(rel.max()) > 1e-3 and float(rel.median()) > 1e-4
    # a constant table inside the bins folds to the K = 1 result
    flat = np.repeat(args[0], K, axis=-1)
    if geometry == "eclipse":
        same = fused.eclipse_folded_plain(
            _ft(flat), *[_t(a) for a in args[1:]], powers=powers)
    else:
        same = fused.transit_folded_plain(_ft(flat),
                                          *[_t(a) for a in args[1:]])
    np.testing.assert_allclose(same.numpy(), mean.numpy(), rtol=1e-12)


# ---------------------------------------------------------------------
# (e) bfloat16 fine tables

@pytest.mark.parametrize("geometry", ["eclipse", "transit"])
def test_bf16_table_against_the_f64_result_of_the_f32_table(geometry):
    """The table element is widened and everything else stays in the
    weights' dtype: the result moves by the table's rounding only, which
    the bands average down (tests/test_fused.py: band rtol 2e-3)."""
    filters = demo_inputs(nlayer=2, nwave=8, nlines=2, t_step=1300.0).filters
    bands = build_band_matrix(np.linspace(2500.0, 5000.0, 75), filters,
                              device="cpu")
    if geometry == "eclipse":
        fine, args, powers = _eclipse()
        rest = [_t(a) for a in args[1:]]
        run = lambda ft: fused.eclipse_folded_plain(ft, *rest, powers=powers)
    else:
        fine, args = _transit()
        rest = [_t(a) for a in args[1:]]
        run = lambda ft: fused.transit_folded_plain(ft, *rest)
    ref = run(fused.FoldedTable(_ft(fine, dtype=F32).tab.double(), K, 75))
    ft16 = _ft(fine, dtype=F32, table_dtype=BF16)
    assert ft16.tab.dtype == BF16
    got = run(ft16)
    assert got.dtype == F64
    np.testing.assert_allclose(band_integrate(bands, got).numpy(),
                               band_integrate(bands, ref).numpy(), rtol=2e-3)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=3e-2)
    assert float((got - ref).abs().max()) > 0.0


# ---------------------------------------------------------------------
# the wrappers on the CPU, and the sources

def test_folded_entries_on_cpu_are_the_plain_path():
    fine, args, powers = _eclipse(shape=(5, 9, 10, 3))
    ft, rest = _ft(fine), [_t(a) for a in args[1:]]
    before = (fused.fused_eclipse_folded.launches,
              fused.fused_transit_folded.launches)
    np.testing.assert_array_equal(
        fused.fused_eclipse_folded(ft, *rest, powers=powers).numpy(),
        fused.eclipse_folded_plain(ft, *rest, powers=powers).numpy())
    tfine, targs = _transit((5, 9, 10, 3))
    tft, trest = _ft(tfine), [_t(a) for a in targs[1:]]
    np.testing.assert_array_equal(
        fused.fused_transit_folded(tft, *trest).numpy(),
        fused.transit_folded_plain(tft, *trest).numpy())
    assert before == (fused.fused_eclipse_folded.launches,
                      fused.fused_transit_folded.launches)   # no launch
    with pytest.raises(ValueError, match="unsupported device"):
        fused.fused_eclipse_folded(ft, *[t.to("meta") for t in rest])
    with pytest.raises(ValueError, match="unsupported device"):
        fused.fused_transit_folded(tft, *[t.to("meta") for t in trest])


def test_folded_kernel_source_constants_match_python():
    src = (fused._CSRC / "fused_eclipse_folded.cu").read_text()

    def lit(name):
        return float(re.search(rf"{name} = ([0-9.e+-]+)f;", src).group(1))

    np.testing.assert_allclose(lit("kC1"), C1, rtol=1e-15)
    np.testing.assert_allclose(lit("kC2"), const.C2, rtol=1e-15)
    assert lit("kTauClamp") == fused.TAU_CLAMP
    # any quadrature: the node ceiling is gone from source and wrapper
    assert "MAX_NMU" not in src and not hasattr(fused, "_MAX_NMU")
    for macro, value in (("MTILE_F", fused._F_MTILE_F),
                         ("CBM", fused._F_CBM), ("NSTAGE", fused._F_NSTAGE),
                         ("MTHREADS", fused._F_MTHREADS)):
        assert re.search(rf"#define {macro} (\d+)", src).group(1) == str(value)
    assert "extern \"C\" int bart_fused_eclipse_folded(" in src
    tsrc = (fused._CSRC / "fused_transit_folded.cu").read_text()
    assert "extern \"C\" int bart_fused_transit_folded(" in tsrc
    assert '#include "fused_transit_mma.cuh"' in tsrc
    tsrc = (fused._CSRC / "fused_transit_mma.cuh").read_text()
    for macro, value in (("FT_W", fused._FT_W), ("FT_CB", fused._FT_CB),
                         ("FT_NS", fused._FT_NS), ("FT_MT", fused._FT_MT)):
        assert re.search(rf"#define {macro} (\d+)", tsrc).group(1) == str(value)
    # both tensor-core kernels contract split_bf16's parts in steps of 16
    # on a bfloat16 table and split_tf32's in steps of 8 on a float32 one:
    # one kernel template each, no float32-pipe fill
    assert fused._MMA_K == 16 and "mma_bf16(" in src and "mma_bf16(" in tsrc
    assert fused._MMA_K32 == 8 and "mma_tf32(" in src and "mma_tf32(" in tsrc
    assert len(re.findall(r"__global__", src)) == 1
    # one kernel template: table type, quadrature, whether the row axis
    # streams through the ring in chunks of RCH rows and whether a bin's
    # sub-samples are neighbouring lanes (K a power of two up to 32)
    assert ("template <typename TabT, bool POWERS, int NMU, bool CHUNKED, "
            "bool LANES>" in src)
    assert re.search(r"#define RCH (\d+)", src).group(1) == str(fused._RCH)
    assert set(fused._KERNELS) == {p.stem for p in fused._CSRC.glob("*.cu")}
    # any K >= 2: both folded kernels include the second launch that adds
    # the partial sums of the bins their tiles cut, and the wrappers give
    # it a scratch exactly where K does not divide the tile
    assert not hasattr(fused, "_FOLD_K")
    for text in (src, tsrc):
        assert '#include "fold_straddle.cuh"' in text
        assert "launch_fold_straddle<" in text
    cpu = torch.device("cpu")
    for k in (2, 3, 4, 6, 8, 12, 16, 32, 48, 64, 128):
        for tile in (fused._F_MTILE_F, fused._FT_W):
            part = fused._straddle_part(5, 75 * k, k, tile, cpu)
            assert (part is None) == (tile % k == 0)
            if part is not None:
                assert part.shape == (5, -(-75 * k // tile), 2)
                assert part.dtype == F32


# ---------------------------------------------------------------------
# (f) on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from bart_tpu_torch.device import resolve_device

    return resolve_device("cuda")


#: every K the card tests take: the powers of two whose bins the tiles
#: hold whole, and K that straddle the eclipse kernel's 64-point and the
#: transit kernel's 32-point tiles (64: whole eclipse tiles, two transit
#: tiles a bin; 128: two eclipse tiles a bin)
CARD_K = [2, 4, 8, 32, 3, 6, 12, 48, 64, 128]


@pytest.mark.gpu
@pytest.mark.parametrize("table_dtype", [F32, BF16])
@pytest.mark.parametrize("k", CARD_K)
@pytest.mark.parametrize("quad", ["raygrid", "expsum"])
def test_eclipse_folded_kernel_matches_plain_on_card(cuda_device, quad, k,
                                                     table_dtype):
    fine, args, powers = _eclipse(quad, (19, 23, 75, 6), k)
    ft = _ft(fine, k, F32, table_dtype, cuda_device)
    rest = [_t(a, F32, cuda_device) for a in args[1:]]
    before = fused.fused_eclipse_folded.launches
    got = fused.fused_eclipse_folded(ft, *rest, powers=powers)
    ref = fused.eclipse_folded_plain(ft, *rest, powers=powers)
    torch.cuda.synchronize()
    assert fused.fused_eclipse_folded.launches == before + 1
    # f32 sums in other orders; the expsum Horner polynomial sits at the
    # f32 floor (tests/test_torch_fused.py)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-4 if powers else 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("table_dtype", [F32, BF16])
@pytest.mark.parametrize("k", [4, 3, 48])
@pytest.mark.parametrize("step", [5.0, 1.0])
def test_eclipse_folded_kernel_many_nodes_on_card(cuda_device, step, k,
                                                  table_dtype):
    """Past the old 16-node ceiling: a raygrid every 5 degrees (18
    nodes) and every degree (90 nodes), read by the runtime-count
    instance through the read-only cache."""
    fine, args, _ = _eclipse("raygrid", (19, 23, 75, 6), k)
    mu, muw = raygrid_weights(np.arange(0.0, 90.0, step))
    assert len(mu) == round(90 / step)
    ft = _ft(fine, k, F32, table_dtype, cuda_device)
    rest = [_t(a, F32, cuda_device)
            for a in (args[1], mu, muw, *args[4:])]
    got = fused.fused_eclipse_folded(ft, *rest)
    ref = fused.eclipse_folded_plain(ft, *rest)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("table_dtype", [F32, BF16])
@pytest.mark.parametrize("k", CARD_K)
def test_transit_folded_kernel_matches_plain_on_card(cuda_device, k,
                                                     table_dtype):
    fine, args = _transit((41, 23, 75, 6), k)
    ft = _ft(fine, k, F32, table_dtype, cuda_device)
    rest = [_t(a, F32, cuda_device) for a in args[1:]]
    before = fused.fused_transit_folded.launches
    got = fused.fused_transit_folded(ft, *rest)
    ref = fused.transit_folded_plain(ft, *rest)
    torch.cuda.synchronize()
    assert fused.fused_transit_folded.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5)


# shapes (R, L, W, C, k) that the tensor-core tiles make ragged: chains
# one past a multiple of 16 and of 32, R exactly 16 and 48 (one and three
# products deep), W k one bin short of and one past a fine tile (64
# points for the eclipse, 32 for the transit), K = 16
_RAGGED_ECLIPSE = [(16, 23, 15, 17, 4), (48, 23, 17, 33, 4),
                   (16, 23, 31, 17, 4), (48, 23, 33, 33, 4),
                   (19, 23, 75, 6, 16), (27, 9, 7, 33, 16),
                   (33, 12, 9, 17, 16),
                   # past the old row ceiling: chunks of 64 rows, the
                   # last one short
                   (226, 23, 17, 33, 4), (137, 12, 9, 17, 32),
                   # K that straddle the tiles, with ragged chains and rows
                   (16, 23, 31, 17, 3), (48, 23, 9, 33, 48),
                   (137, 12, 5, 17, 128)]
_RAGGED_TRANSIT = [(16, 23, 7, 17, 4), (48, 23, 9, 33, 4),
                   (41, 23, 75, 6, 16), (17, 100, 5, 9, 32),
                   (33, 104, 3, 17, 16),
                   # past the old layer ceiling: the streamed variant
                   (17, 113, 5, 9, 32), (226, 130, 7, 17, 4),
                   # K that straddle the 32-point tiles, resident and
                   # streamed (L = 113, 200)
                   (16, 23, 11, 17, 3), (41, 100, 7, 9, 48),
                   (17, 113, 5, 9, 3), (33, 200, 3, 17, 48),
                   (17, 113, 3, 9, 128), (48, 200, 5, 9, 6)]


@pytest.mark.gpu
@pytest.mark.parametrize("table_dtype", [F32, BF16])
@pytest.mark.parametrize("shape", _RAGGED_ECLIPSE)
@pytest.mark.parametrize("quad", ["raygrid", "expsum"])
def test_eclipse_folded_kernel_ragged_shapes_on_card(cuda_device, quad, shape,
                                                     table_dtype):
    fine, args, powers = _eclipse(quad, shape[:4], shape[4])
    ft = _ft(fine, shape[4], F32, table_dtype, cuda_device)
    rest = [_t(a, F32, cuda_device) for a in args[1:]]
    got = fused.fused_eclipse_folded(ft, *rest, powers=powers)
    ref = fused.eclipse_folded_plain(ft, *rest, powers=powers)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-4 if powers else 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("table_dtype", [F32, BF16])
@pytest.mark.parametrize("shape", _RAGGED_TRANSIT)
def test_transit_folded_kernel_ragged_shapes_on_card(cuda_device, shape,
                                                     table_dtype):
    fine, args = _transit(shape[:4], shape[4])
    ft = _ft(fine, shape[4], F32, table_dtype, cuda_device)
    rest = [_t(a, F32, cuda_device) for a in args[1:]]
    got = fused.fused_transit_folded(ft, *rest)
    ref = fused.transit_folded_plain(ft, *rest)
    prepared = fused.fused_transit_folded(
        ft, rest[0], fused.prepare_slant(rest[1]), rest[2])
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5)
    assert torch.equal(prepared, got)


@pytest.mark.gpu
@pytest.mark.parametrize("geometry, table_dtype",
                         [("eclipse", BF16), ("eclipse", F32),
                          ("transit", BF16)])
def test_tensor_core_fill_keeps_tiny_weights_on_card(cuda_device, geometry,
                                                     table_dtype):
    """bfloat16 table: weights of 1e-32..1e-25 are normal float32 numbers
    whose smallest bfloat16 part is subnormal (and still exact:
    split_bf16 holds down to 2^-109).  float32 table (3xTF32): weights
    of 1e-35..1e-28, whose TF32 remainders (2^-11 of them) are subnormal.
    The table is scaled up to match, so ext is as in the unscaled
    problem.  The fill must keep what the float32 FMAs of the plain
    version keep."""
    scale = 2.0 ** (-133 if table_dtype == BF16 else -143)
    if geometry == "eclipse":
        fine, args, powers = _eclipse("raygrid", (19, 23, 75, 6), 4)
        args = list(args)
        args[4] = args[4] * scale                      # wrows, in float64
        run, plain = fused.fused_eclipse_folded, fused.eclipse_folded_plain
        kw, rtol = dict(powers=powers), 1e-4
    else:
        fine, args = _transit((41, 23, 75, 6), 4)
        args = list(args)
        args[1] = args[1] * scale
        run, plain = fused.fused_transit_folded, fused.transit_folded_plain
        kw, rtol = {}, 1e-5
    rest = [_t(a, F32, cuda_device) for a in args[1:]]
    ft = _ft(fine / scale, 4, F32, table_dtype, cuda_device)
    assert bool(torch.isfinite(ft.tab.float()).all())
    if table_dtype == F32:
        small = fused.split_tf32(rest[3])[1]
        tiny = torch.finfo(F32).tiny
        assert bool(((small != 0) & (small.abs() < tiny)).any())
    got, ref = run(ft, *rest, **kw), plain(ft, *rest, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [3, 48])
@pytest.mark.parametrize("geometry", ["eclipse", "transit"])
def test_straddling_k_repeats_its_bits_and_graphs_on_card(cuda_device,
                                                          geometry, k):
    """The partial sums of a cut bin are added in tile order, without
    atomics: two launches give the same bits, and so does a replay of a
    captured launch."""
    if geometry == "eclipse":
        fine, args, powers = _eclipse("expsum", (19, 23, 75, 40), k)
        run = lambda ft, r: fused.fused_eclipse_folded(ft, *r, powers=powers)
    else:
        fine, args = _transit((41, 23, 75, 40), k)
        run = lambda ft, r: fused.fused_transit_folded(ft, *r)
    ft = _ft(fine, k, F32, BF16, cuda_device)
    rest = [_t(a, F32, cuda_device) for a in args[1:]]
    first, second = run(ft, rest), run(ft, rest)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(ft, rest)                                       # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run(ft, rest)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, captured)


@pytest.mark.gpu
def test_folded_kernels_raise_on_what_they_do_not_take(cuda_device):
    fine, args, _ = _eclipse(shape=(5, 9, 12, 3), k=4)
    rest = [_t(a, F32, cuda_device) for a in args[1:]]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused.fused_eclipse_folded(_ft(fine, 4, F64, None, cuda_device), *rest)
    # K = 3 is taken (it used to raise); K = 1 and 0 are not folded
    fine3, args3, _ = _eclipse(shape=(5, 9, 12, 3), k=3)
    ft3 = _ft(fine3, 3, F32, None, cuda_device)
    rest3 = [_t(a, F32, cuda_device) for a in args3[1:]]
    np.testing.assert_allclose(
        fused.fused_eclipse_folded(ft3, *rest3).cpu().numpy(),
        fused.eclipse_folded_plain(ft3, *rest3).cpu().numpy(), rtol=1e-4)
    for k in (1, 0):
        flat = fused.FoldedTable(_t(np.ones((5, 9, 16)), F32, cuda_device),
                                 k, 12)
        with pytest.raises(ValueError, match=f"K = {k}; the folded kernels"):
            fused.fused_eclipse_folded(flat, *rest)
    # past the resident kernel's 112 layers: the streamed variant takes
    # them; the annulus weights' shared memory caps L at 10,176
    for L, table_dtype in ((200, F32), (200, BF16), (113, BF16)):
        tfine, targs = _transit((3, L, 8, 2), 4)
        ft = _ft(tfine, 4, F32, table_dtype, cuda_device)
        targs = [_t(a, F32, cuda_device) for a in targs[1:]]
        np.testing.assert_allclose(
            fused.fused_transit_folded(ft, *targs).cpu().numpy(),
            fused.transit_folded_plain(ft, *targs).cpu().numpy(), rtol=1e-5)
    L = 10400
    ft = fused.folded_table(torch.ones(1, L, 32, dtype=F32,
                                       device=cuda_device), 4, BF16)
    with pytest.raises(ValueError, match="shared memory"):
        fused.fused_transit_folded(
            ft, torch.ones(2, L, 1, dtype=F32, device=cuda_device),
            torch.zeros(2, L, L, dtype=F32, device=cuda_device),
            torch.ones(2, L, dtype=F32, device=cuda_device))


# past the card's old ceilings: a table of 2^31 elements or more (86 rows
# x 100 layers x ~250,000 fine points, bfloat16) and a fine axis past
# 65,535 tiles (4.2 M eclipse points, 2.2 M transit points), at K = 128
# (a bin spans two eclipse tiles) and K = 48 (cut by the transit tiles),
# each held against launches on bin-aligned slices under both old
# ceilings (bit for bit) and against the plain version on a few chains
_FOLD_CEILINGS = {
    "eclipse-table": ("fused_eclipse_folded", 86, 100, 1954, 128, 16),
    "eclipse-axis": ("fused_eclipse_folded", 8, 16, 33000, 128, 16),
    "transit-table": ("fused_transit_folded", 86, 100, 5210, 48, 16),
    "transit-axis": ("fused_transit_folded", 8, 16, 45000, 48, 16)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_FOLD_CEILINGS))
def test_folded_kernels_past_the_old_ceilings_on_card(cuda_device, case):
    from bart_tpu_torch.utils import slices

    name, R, L, W, k, C = _FOLD_CEILINGS[case]
    pb = slices.problem(name, R, L, W, k, C, BF16, 3, cuda_device)
    assert (pb.raw.numel() >= 2**31 if case.endswith("table")
            else -(-W * k // slices.TILE[name]) > slices.OLD_MAX_TILES)
    got = pb.launch(pb.tab, 0, W)
    edges = slices.slice_edges(W, k, slices.TILE[name], R * L)
    assert len(edges) > 2
    assert torch.equal(got, slices.launch_by_slices(pb.launch, pb.tab,
                                                    edges))
    b1 = edges[1]
    ref = pb.plain(slices.table_slice(pb.tab, 0, b1), 0, b1, 4)
    np.testing.assert_allclose(got[:4, :b1].cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5 if "transit" in name else 2e-4)
