"""The operand splits behind the tensor-core folded kernels of
bart_tpu_torch.rt.fused, held on the CPU.

(a) ``split_bf16`` (three bfloat16 parts that sum to the float32 weight
    bit for bit) and ``split_tf32`` (big + small within 2^-21);
(b) a plain torch emulation of the kernels' arithmetic -- the parts times
    the bfloat16 table summed in float32, the fill of a float32 table and
    the slant product as small x big + big x small + big x big -- against
    ``eclipse_folded_plain``/``transit_folded_plain`` and against
    bart_tpu's ``_single_folded``/``_tsingle_folded`` under vmap at
    float64: the splits keep the port on the JAX package's numbers;
(c) the sources' macros and shared-memory formulas against the Python
    constants and calculators, the limits the wrappers raise on, and
    ``prepare_slant``'s layout against the plain form.

Fixture scale as tests/test_fused.py's folded one: K = 4, R = 18, L = 23,
W = 75 output bins, C = 6.
"""

import re

import numpy as np
import pytest
import torch

import bart_tpu_torch.rt.fused as fused
from bart_tpu_torch.demo import (fine_structure, random_rows,
                                 random_transit_rows)
from bart_tpu_torch.rt.eclipse import expsum_weights, raygrid_weights
from bart_tpu_torch.rt.planck import planck_wn
from bart_tpu_torch.rt.tau import TAU_CLAMP

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


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _fine(tab, k=K, seed=5):
    R, L, W = tab.shape
    return (tab[..., None] * fine_structure(R, W, k, seed)).reshape(R, L, W * k)


def _bf16_table(fine, k=K):
    """The bfloat16 FoldedTable of ``fine`` and its float64 widening."""
    ft = fused.folded_table(_t(fine, F32), k, BF16)
    return ft, fused.FoldedTable(ft.tab.double(), k, ft.W)


# ---------------------------------------------------------------------
# (a) the splits

def _wide_range(n=20000, seed=3, low=-30.0):
    rng = np.random.default_rng(seed)
    x = 10.0 ** rng.uniform(low, 10.0, n) * rng.choice([-1.0, 1.0], n)
    return torch.tensor(x, dtype=F32)


def test_split_bf16_parts_sum_back_bit_for_bit():
    x = _wide_range()
    lo, mid, hi = fused.split_bf16(x)
    assert lo.dtype == mid.dtype == hi.dtype == BF16
    # in float32, smallest first, as the tensor core accumulates them
    assert torch.equal(lo.float() + mid.float() + hi.float(), x)
    assert torch.equal((hi.double() + mid.double() + lo.double()).float(), x)
    assert float((mid.float().abs() / x.abs()).max()) <= 2.0 ** -8
    assert float((lo.float().abs() / x.abs()).max()) <= 2.0 ** -16
    with pytest.raises(TypeError, match="float32"):
        fused.split_bf16(x.double())


def test_split_bf16_of_zeros_and_padding_is_zero():
    for part in fused.split_bf16(torch.zeros(5, dtype=F32)):
        assert float(part.float().abs().sum()) == 0.0
    wrows = _wide_range(6 * 5 * 19).reshape(6, 5, 19)
    parts = fused._split_rows(wrows, 32)
    assert parts.shape == (3, 6, 5, 32) and parts.dtype == BF16
    assert parts.is_contiguous()
    assert float(parts[..., 19:].float().abs().sum()) == 0.0
    assert torch.equal(parts[..., :19].float().sum(0), wrows)
    for got, want in zip(parts, fused.split_bf16(wrows)):
        assert torch.equal(got[..., :19], want)


def test_split_bf16_products_with_a_bf16_table_are_exact_in_f32():
    x = _wide_range(4000, seed=4, low=-20.0)   # products stay normal
    tab = (10.0 ** torch.linspace(-3.0, 3.0, 4000)).to(BF16)
    for part in fused.split_bf16(x):
        prod32 = part.float() * tab.float()
        assert torch.equal(prod32.double(), part.double() * tab.double())


def test_split_tf32_is_within_two_to_the_minus_21():
    x = _wide_range()
    big, small = fused.split_tf32(x)
    assert big.dtype == small.dtype == F32
    low13 = (1 << 13) - 1
    assert int((big.view(torch.int32) & low13).abs().max()) == 0
    assert int((small.view(torch.int32) & low13).abs().max()) == 0
    err = (big.double() + small.double() - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -21
    assert float(((big - x).abs() / x.abs()).max()) <= 2.0 ** -11
    z = torch.zeros(3, dtype=F32)
    assert all(float(p.abs().sum()) == 0.0 for p in fused.split_tf32(z))
    with pytest.raises(TypeError, match="float32"):
        fused.split_tf32(x.double())


# ---------------------------------------------------------------------
# (b) the kernels' arithmetic, emulated

def _emulated_ext(ft, wrows32, k):
    """ext [C, L, W] of sub-sample k as the tensor-core fill forms it.
    bfloat16 table: the three bfloat16 parts times the table, summed in
    float32, smallest part first.  float32 table: 3xTF32, the two small
    products summed, then the big one added, all in float32."""
    tab = ft.bins()[..., k].float()
    if ft.tab.dtype == F32:
        tb, ts = fused.split_tf32(tab)
        wb, ws = fused.split_tf32(wrows32)
        small = (torch.einsum("clr,rlw->clw", wb, ts)
                 + torch.einsum("clr,rlw->clw", ws, tb))
        return small + torch.einsum("clr,rlw->clw", wb, tb)
    ext = None
    for part in fused.split_bf16(wrows32):
        term = torch.einsum("clr,rlw->clw", part.float(), tab)
        ext = term if ext is None else ext + term
    return ext


def _emulated_eclipse(ft, wn, mu, muw, wrows32, T, drp, powers):
    """eclipse_folded_plain with the emulated fill; the recurrence, the
    quadrature and the flux in float64."""
    sbar = 0.0
    for k in range(ft.K):
        ext = _emulated_ext(ft, wrows32, k).double()
        seg = 0.5 * (ext[:, :-1] + ext[:, 1:]) * drp[:, 1:, None]
        tau = torch.cat([torch.zeros_like(ext[:, :1]),
                         torch.cumsum(seg, dim=1)], dim=1)
        sbar = sbar + fused.smix(tau, mu, muw, powers)
    sbar = sbar / ft.K
    B = planck_wn(wn, T[..., None])
    Bmid = 0.5 * (B[:, :-1] + B[:, 1:])
    flux = torch.sum(Bmid * (sbar[:, :-1] - sbar[:, 1:]), dim=1)
    return 2.0 * np.pi * (flux + B[:, -1] * sbar[:, -1])


def _emulated_transit(ft, wrows32, G32, wgt):
    """transit_folded_plain with the emulated fill and the 3xTF32 slant
    product, both summed in float32; the exponential in float64."""
    Gb, Gs = fused.split_tf32(torch.tril(G32))
    abar = 0.0
    for k in range(ft.K):
        eb, es = fused.split_tf32(_emulated_ext(ft, wrows32, k))
        tau = torch.bmm(Gs, eb) + torch.bmm(Gb, es) + torch.bmm(Gb, eb)
        abar = abar + (1.0 - torch.exp(-torch.clamp(tau.double(),
                                                    max=TAU_CLAMP)))
    return torch.bmm(wgt[:, None, :], abar / ft.K)[:, 0]


def _eclipse_case(quad, table_dtype=BF16):
    (mu, muw), powers = QUADS[quad]
    tab, wn, wrows, T, drp = random_rows(*SHAPE)
    if table_dtype == BF16:
        ft, ft64 = _bf16_table(_fine(tab))
    else:
        ft = fused.folded_table(_t(_fine(tab), F32), K)
        ft64 = fused.FoldedTable(ft.tab.double(), K, ft.W)
    wrows32 = _t(wrows, F32)
    rest = [_t(wn), _t(mu), _t(muw), wrows32.double(), _t(T), _t(drp)]
    return ft, ft64, wrows32, rest, powers


@pytest.mark.parametrize("quad", ["raygrid", "expsum"])
def test_emulated_eclipse_fill_agrees_with_the_plain_version(quad):
    ft, ft64, wrows32, rest, powers = _eclipse_case(quad)
    got = _emulated_eclipse(ft, *rest[:3], wrows32, *rest[4:], powers)
    ref = fused.eclipse_folded_plain(ft64, *rest, powers=powers)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6)
    # the fill itself: float32 sums of exact products
    ext = _emulated_ext(ft, wrows32, 1)
    ext64 = torch.einsum("clr,rlw->clw", wrows32.double(),
                         ft64.bins()[..., 1])
    np.testing.assert_allclose(ext.numpy(), ext64.numpy(), rtol=2e-6)


@pytest.mark.parametrize("quad", ["raygrid", "expsum"])
def test_emulated_eclipse_fill_agrees_with_bart_tpu(jx, quad):
    jax, jnp, jfused = jx
    ft, ft64, wrows32, rest, powers = _eclipse_case(quad)
    tabk = jfused.fold_table(jnp.asarray(ft64.tab[..., :75 * K].numpy()), K)
    ref = jax.vmap(
        lambda w, t, d: jfused._single_folded(
            tabk, *[jnp.asarray(a.numpy()) for a in rest[:3]], w, t, d,
            powers=powers)
    )(*[jnp.asarray(a.numpy()) for a in rest[3:]])
    got = _emulated_eclipse(ft, *rest[:3], wrows32, *rest[4:], powers)
    # tests/test_torch_folded.py's float32 tolerance for the eclipse
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-5)


@pytest.mark.parametrize("quad", ["raygrid", "expsum"])
def test_emulated_tf32_fill_of_a_float32_table_agrees_with_the_plain_version(
        quad):
    ft, ft64, wrows32, rest, powers = _eclipse_case(quad, F32)
    assert ft.tab.dtype == F32
    got = _emulated_eclipse(ft, *rest[:3], wrows32, *rest[4:], powers)
    ref = fused.eclipse_folded_plain(ft64, *rest, powers=powers)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6)
    # the fill itself: 3xTF32 within a few 2^-21 of the float64 sum
    ext = _emulated_ext(ft, wrows32, 2)
    ext64 = torch.einsum("clr,rlw->clw", wrows32.double(),
                         ft64.bins()[..., 2])
    np.testing.assert_allclose(ext.numpy(), ext64.numpy(), rtol=2e-6)


@pytest.mark.parametrize("quad", ["raygrid", "expsum"])
def test_emulated_tf32_fill_of_a_float32_table_agrees_with_bart_tpu(jx, quad):
    jax, jnp, jfused = jx
    ft, ft64, wrows32, rest, powers = _eclipse_case(quad, F32)
    tabk = jfused.fold_table(jnp.asarray(ft64.tab[..., :75 * K].numpy()), K)
    ref = jax.vmap(
        lambda w, t, d: jfused._single_folded(
            tabk, *[jnp.asarray(a.numpy()) for a in rest[:3]], w, t, d,
            powers=powers)
    )(*[jnp.asarray(a.numpy()) for a in rest[3:]])
    got = _emulated_eclipse(ft, *rest[:3], wrows32, *rest[4:], powers)
    # tests/test_torch_folded.py's float32 tolerance for the eclipse
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-5)


def test_one_tf32_pass_would_not_hold_the_tolerance():
    """The check can fail: big x big alone (plain TF32) is 2^-11 off,
    beyond the 2e-6 the 3xTF32 fill is held to."""
    ft, ft64, wrows32, _, _ = _eclipse_case("raygrid", F32)
    tab = ft.bins()[..., 2]
    one = torch.einsum("clr,rlw->clw", fused.split_tf32(wrows32)[0],
                       fused.split_tf32(tab)[0])
    ext64 = torch.einsum("clr,rlw->clw", wrows32.double(),
                         ft64.bins()[..., 2])
    assert float(((one.double() - ext64).abs() / ext64).max()) > 2e-6


def _transit_case(shape=SHAPE):
    tab, wrows, G, wgt, _ = random_transit_rows(*shape)
    ft, ft64 = _bf16_table(_fine(tab))
    wrows32, G32 = _t(wrows, F32), _t(G, F32)
    return ft, ft64, wrows32, G32, _t(wgt)


def test_emulated_transit_agrees_with_the_plain_version():
    ft, ft64, wrows32, G32, wgt = _transit_case()
    got = _emulated_transit(ft, wrows32, G32, wgt)
    ref = fused.transit_folded_plain(ft64, wrows32.double(), G32.double(),
                                     wgt)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6)
    # the problem is not saturated: tau of order one is where a wrong
    # slant product shows
    tau = torch.bmm(G32.double(), torch.einsum(
        "clr,rlw->clw", wrows32.double(), ft64.bins()[..., 0]))
    assert float(((tau > 0.1) & (tau < 10.0)).double().mean()) > 0.2


def test_emulated_transit_agrees_with_bart_tpu(jx):
    jax, jnp, jfused = jx
    ft, ft64, wrows32, G32, wgt = _transit_case()
    tabk = jfused.fold_table(jnp.asarray(ft64.tab[..., :75 * K].numpy()), K)
    ref = jax.vmap(jfused._tsingle_folded, in_axes=(None, 0, 0, 0))(
        tabk, *[jnp.asarray(a.double().numpy()) for a in (wrows32, G32, wgt)])
    got = _emulated_transit(ft, wrows32, G32, wgt)
    # tests/test_torch_folded.py's float32 tolerance for the transit
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4)


def test_a_two_part_split_would_not_hold_the_tolerance():
    """The check can fail: without the smallest part the fill is 2^-16
    off, beyond the 1e-6 the emulation is held to."""
    ft, ft64, wrows32, _, _ = _eclipse_case("raygrid")
    lo, mid, hi = fused.split_bf16(wrows32)
    tab = ft.bins()[..., 0].float()
    two = torch.einsum("clr,rlw->clw", mid.float() + hi.float(), tab)
    ext64 = torch.einsum("clr,rlw->clw", wrows32.double(),
                         ft64.bins()[..., 0])
    assert float(((two.double() - ext64).abs() / ext64).max()) > 1e-6


# ---------------------------------------------------------------------
# (c) sources, shared memory, limits, the prepared slant matrix

def _macros(src):
    return {m: int(v) for m, v in re.findall(r"#define (\w+) (\d+)\b", src)}


def _cxx_return(src, name, env):
    """Evaluate the single return expression of the constexpr function
    ``name`` of a source, with ``env`` for its parameters and helpers."""
    body = re.search(rf"constexpr size_t {name}\([^)]*\) {{\s*return (.*?);\s*}}",
                     src, re.S).group(1)
    expr = re.sub(r"\(size_t\)", "", body).replace("/", "//")
    return eval(f"({expr})", {"__builtins__": {}}, env)


def test_eclipse_mma_source_constants_and_smem_match_python():
    src = (fused._CSRC / "fused_eclipse_folded.cu").read_text()
    env = _macros(src)
    assert set(env) >= {"MTILE_F", "CBM", "NSTAGE", "MTHREADS", "MAX_NMU"}
    for macro, value in (("MTILE_F", fused._F_MTILE_F), ("CBM", fused._F_CBM),
                         ("NSTAGE", fused._F_NSTAGE),
                         ("MTHREADS", fused._F_MTHREADS)):
        assert env[macro] == value
    # the float32-pipe kernel's tile is gone
    assert not {"TILE_F", "TY", "CPT"} & set(env)
    assert '#include "hopper.cuh"' in src
    env["mma_stage_bytes"] = lambda rp, eb, np_: _cxx_return(
        src, "mma_stage_bytes", {**env, "Rp": rp, "eb": eb, "np": np_})
    for bf16, eb, parts, depth in ((True, 2, 3, 16), (False, 4, 1, 8)):
        for R, k in ((27, 32), (19, 2), (16, 4), (48, 8), (41, 16)):
            Rp = -(-R // depth) * depth
            want = _cxx_return(src, "mma_smem_bytes",
                               {**env, "Rp": Rp, "K": k, "eb": eb,
                                "np": parts})
            assert fused._eclipse_folded_smem(R, k, bf16) == want
            # two blocks an SM (228 KB, 1 KB of it reserved a block)
            assert 2 * (want + 1024) <= 233472
    assert fused._eclipse_folded_smem(27, 32, True) == 49664
    # float32: 4 stages of [32][72] + [32][36] words, the Planck means
    assert fused._eclipse_folded_smem(27, 32, False) == 55808
    assert fused._eclipse_folded_smem(41, 32, False) == 82432
    # the epilogue's [CBM][MTILE_F + 4] sums fit the smallest ring
    epi = 4 * fused._F_CBM * (fused._F_MTILE_F + 4)
    assert fused._F_NSTAGE * env["mma_stage_bytes"](16, 2, 3) >= epi
    assert fused._F_NSTAGE * env["mma_stage_bytes"](8, 4, 1) >= epi
    # the float32 fragment loads: lane (g, t) reads row t, column g of the
    # table tile (stride MTILE_F + 8 words) and row g, column t of the
    # weights (stride Rp + 4): 32 different banks for every Rp
    g, t = np.divmod(np.arange(32), 4)
    assert len(set(((fused._F_MTILE_F + 8) * t + g) % 32)) == 32
    for Rp in range(8, 129, 8):
        assert len(set(((Rp + 4) * g + t) % 32)) == 32
    # every sub-sample count divides the fine tile, and the Planck pairs
    # of a block fit the threads' registers (PP per thread)
    assert all(fused._F_MTILE_F % k == 0 for k in fused._FOLD_K)
    assert fused._F_CBM * (fused._F_MTILE_F // 2) % fused._F_MTHREADS == 0
    # a warp per 16 fine points x 16 chains
    assert fused._F_MTHREADS == 32 * (fused._F_MTILE_F // 16) * (
        fused._F_CBM // 16)


def test_transit_mma_source_constants_and_smem_match_python():
    src = (fused._CSRC / "fused_transit_mma.cuh").read_text()
    env = _macros(src)
    for macro, value in (("FT_W", fused._FT_W), ("FT_CB", fused._FT_CB),
                         ("FT_NS", fused._FT_NS), ("FT_MT", fused._FT_MT)):
        assert env[macro] == value
    for name in ("kES", "kTS", "kGS", "kWF", "kWF32", "kUnitBytes",
                 "kUnitBytes32"):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
        env[name] = eval(expr, {"__builtins__": {}}, env)
    assert (env["kES"], env["kTS"], env["kGS"], env["kWF"]) == (32, 40, 8, 24)
    assert (env["kUnitBytes"], env["kUnitBytes32"]) == (2048, 1664)
    # the float32 tile's fragment loads: lane (g, t) -> bank 8 t + g of the
    # table tile and 12 g + t of the weights, all different
    g, t = np.divmod(np.arange(32), 4)
    assert len(set((env["kTS"] * t + g) % 32)) == 32
    assert len(set((env["kWF32"] * g + t) % 32)) == 32
    for L in (100, 23, 104, 9, 112):
        for bf16, unit in ((True, "kUnitBytes"), (False, "kUnitBytes32")):
            want = (_cxx_return(src, "ft_ext_bytes", {**env, "L": L})
                    + max(env["FT_CB"] * env["FT_NS"] * env[unit],
                          _cxx_return(src, "ft_slant_bytes", {**env, "L": L})))
            assert fused._transit_mma_smem(L, bf16) == want
    assert fused._transit_mma_smem(100, True) == 192128
    assert fused._transit_mma_smem(100, False) == 176768
    assert all(fused._FT_W % k == 0 for k in fused._FOLD_K)


def test_limits_the_wrappers_raise_on():
    # L beyond the shared-memory cap of the tensor-core transit kernel
    # (tau's registers cap it at 16 FT_MT layers before shared memory does)
    for bf16 in (True, False):
        assert fused._transit_mma_smem(16 * fused._FT_MT, bf16) \
            <= fused._SMEM_LIMIT < fused._transit_mma_smem(200, bf16)
        fused._check_transit_fit("fn", 16 * fused._FT_MT, 80032, bf16)
        with pytest.raises(ValueError, match="register blocks"):
            fused._check_transit_fit("fn", 16 * fused._FT_MT + 1, 300, bf16)
        with pytest.raises(ValueError, match="shared memory"):
            fused._check_transit_fit("fn", 200, 300, bf16)
        with pytest.raises(ValueError, match="exceed the grid"):
            fused._check_transit_fit("fn", 100, 32 * 65535 + 1, bf16)
    # K outside _FOLD_K, a table that is not folded_table's
    cpu = torch.device("cpu")
    odd = fused.FoldedTable(torch.ones(5, 9, 16, dtype=F32), 3, 5)
    with pytest.raises(ValueError, match="K = 3"):
        fused._check_folded("fn", odd, cpu)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused._check_folded("fn", fused.FoldedTable(
            torch.ones(5, 9, 16, dtype=F64), 4, 4), cpu)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused._check_folded("fn", fused.FoldedTable(
            torch.ones(5, 9, 12, dtype=F32), 4, 3), cpu)
    assert fused._check_folded("fn", fused.folded_table(
        torch.ones(5, 9, 12), 4, BF16), cpu) == 1


@pytest.mark.parametrize("L", [9, 23, 24])
def test_prepared_slant_matrix_equals_the_plain_form(L):
    tab, wrows, G, wgt, _ = random_transit_rows(5, L, 10, 3)
    noisy = _t(G + np.triu(np.ones_like(G), 1))
    sm = fused.prepare_slant(noisy, F64)
    Lp = -(-L // 4) * 4
    assert sm.G.shape == (3, L, Lp) and sm.L == L and sm.G.is_contiguous()
    np.testing.assert_array_equal(sm.plain().numpy(), np.tril(G))
    assert float(sm.G[..., L:].abs().sum()) == 0.0
    assert fused.prepare_slant(noisy).G.dtype == F32
    ts = [_t(a) for a in (tab, wrows)]
    np.testing.assert_array_equal(
        fused.fused_transit(*ts, sm, _t(wgt)).numpy(),
        fused.fused_transit(*ts, _t(G), _t(wgt)).numpy())
    ft = fused.folded_table(_t(_fine(tab)), K)
    np.testing.assert_array_equal(
        fused.fused_transit_folded(ft, ts[1], sm, _t(wgt)).numpy(),
        fused.fused_transit_folded(ft, ts[1], _t(G), _t(wgt)).numpy())
    # the wrappers' check of the prepared form
    cpu = torch.device("cpu")
    assert fused._slant32("fn", fused.prepare_slant(noisy), 3, L, cpu
                          ).data_ptr() != 0
    with pytest.raises(ValueError, match="prepare_slant"):
        fused._slant32("fn", sm, 3, L, cpu)             # float64
    with pytest.raises(ValueError, match="shape"):
        fused._slant32("fn", fused.prepare_slant(noisy), 4, L, cpu)
    with pytest.raises(ValueError, match=r"\[C, L, L\]"):
        fused.prepare_slant(noisy[:, :-1])
