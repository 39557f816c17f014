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

def _emulated_ext(ft, wrows32, k, chunk=None):
    """ext [C, L, W] of sub-sample k as the tensor-core fill forms it.
    bfloat16 table: the three bfloat16 parts times the table, summed in
    float32, smallest part first.  float32 table: 3xTF32, the two small
    products summed, then the big one added, all in float32.  ``chunk``:
    the rows in the kernel's chunked order, the accumulators carried from
    chunk to chunk of that many rows."""
    tab = ft.bins()[..., k].float()
    R = tab.shape[0]

    def mm(w, t, rows):
        return torch.einsum("clr,rlw->clw", w[..., rows], t[rows])

    chunks = [slice(r0, r0 + (chunk or R)) for r0 in range(0, R, chunk or R)]
    if ft.tab.dtype == F32:
        tb, ts = fused.split_tf32(tab)
        wb, ws = fused.split_tf32(wrows32)
        small = big = 0.0
        for rows in chunks:
            small = small + mm(wb, ts, rows) + mm(ws, tb, rows)
            big = big + mm(wb, tb, rows)
        return small + big
    ext = 0.0
    for rows in chunks:
        for part in fused.split_bf16(wrows32):
            ext = ext + mm(part.float(), tab, rows)
    return ext


def _emulated_eclipse(ft, wn, mu, muw, wrows32, T, drp, powers, chunk=None):
    """eclipse_folded_plain with the emulated fill; the recurrence, the
    quadrature and the flux in float64."""
    sbar = 0.0
    for k in range(ft.K):
        ext = _emulated_ext(ft, wrows32, k, chunk).double()
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


def _eclipse_case(quad, table_dtype=BF16, shape=SHAPE, k=K):
    (mu, muw), powers = QUADS[quad]
    tab, wn, wrows, T, drp = random_rows(*shape)
    wrows = wrows * min(1.0, 27.0 / shape[0])   # tau of order one inside
    if table_dtype == BF16:
        ft, ft64 = _bf16_table(_fine(tab, k), k)
    else:
        ft = fused.folded_table(_t(_fine(tab, k), F32), k)
        ft64 = fused.FoldedTable(ft.tab.double(), k, ft.W)
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


#: past the folded eclipse kernel's old 136/160-row ceiling (226 rows in
#: chunks of RCH) and the folded transit kernel's 112 layers
MANY_ROWS, MANY_LAYERS = (226, 23, 20, 5), (12, 130, 20, 5)


@pytest.mark.parametrize("table_dtype", [BF16, F32])
def test_emulated_folded_eclipse_in_the_chunked_order_at_226_rows(
        table_dtype):
    ft, ft64, wrows32, rest, powers = _eclipse_case("expsum", table_dtype,
                                                    MANY_ROWS)
    got = _emulated_eclipse(ft, *rest[:3], wrows32, *rest[4:], powers,
                            chunk=fused._RCH)
    ref = fused.eclipse_folded_plain(ft64, *rest, powers=powers)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6)
    ext = _emulated_ext(ft, wrows32, 3, chunk=fused._RCH)
    ext64 = torch.einsum("clr,rlw->clw", wrows32.double(),
                         ft64.bins()[..., 3])
    np.testing.assert_allclose(ext.numpy(), ext64.numpy(), rtol=2e-6)


def test_emulated_folded_transit_at_130_layers():
    ft, ft64, wrows32, G32, wgt = _transit_case(MANY_LAYERS)
    got = _emulated_transit(ft, wrows32, G32, wgt)
    ref = fused.transit_folded_plain(ft64, wrows32.double(), G32.double(),
                                     wgt)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6)
    tau = torch.bmm(G32.double(), torch.einsum(
        "clr,rlw->clw", wrows32.double(), ft64.bins()[..., 0]))
    assert float(((tau > 0.1) & (tau < 10.0)).double().mean()) > 0.2


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


def _transit_case(shape=SHAPE, k=K):
    tab, wrows, G, wgt, _ = random_transit_rows(*shape)
    ft, ft64 = _bf16_table(_fine(tab, k), k)
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
# (b') a K that does not divide the kernels' fine tiles: the tile-order
# sum of partials (csrc/fold_straddle.cuh)

def _tile_order_sum(v, k, tile, mul, div):
    """out [C, W] from per-fine-point values v [C, W k] (float32) as the
    folded kernels' epilogue and second launch form it for a K that does
    not divide their ``tile`` fine points: each tile sums its part of a
    bin in the order of the fine points; a bin inside one tile is written
    as (its sum) times mul / div, a cut bin's partial sums are added in
    tile order, then scaled the same way.  All in float32.  Returns (out,
    the number of cut bins)."""
    v = v.numpy()
    C, F = v.shape
    W, one = F // k, np.float32
    out = np.empty((C, W), np.float32)
    cut = 0
    for b in range(W):
        parts = []
        for t in range(b * k // tile, ((b + 1) * k - 1) // tile + 1):
            acc = np.zeros(C, np.float32)
            for f in range(max(b * k, t * tile), min((b + 1) * k,
                                                     (t + 1) * tile)):
                acc = acc + v[:, f]
            parts.append(acc)
        tot = parts[0]
        for p_ in parts[1:]:
            tot = tot + p_
        cut += len(parts) > 1
        out[:, b] = tot * one(mul) / one(div)
    return torch.tensor(out), cut


def _emulated_eclipse_fine(ft, wn, mu, muw, wrows32, T, drp, powers):
    """The flux of every fine point, F_f + B_{L-1} S_{L-1, f}, with the
    emulated fill (Planck at the bin centre), in float64: the values the
    kernel sums over a bin's sub-samples."""
    B = planck_wn(wn, T[..., None])                           # [C, L, W]
    Bmid = 0.5 * (B[:, :-1] + B[:, 1:])
    out = []
    for k in range(ft.K):
        ext = _emulated_ext(ft, wrows32, k).double()
        seg = 0.5 * (ext[:, :-1] + ext[:, 1:]) * drp[:, 1:, None]
        tau = torch.cat([torch.zeros_like(ext[:, :1]),
                         torch.cumsum(seg, dim=1)], dim=1)
        S = fused.smix(tau, mu, muw, powers)
        out.append(torch.sum(Bmid * (S[:, :-1] - S[:, 1:]), dim=1)
                   + B[:, -1] * S[:, -1])
    return torch.stack(out, -1).flatten(1)                    # [C, W K]


@pytest.mark.parametrize("k", [3, 48])
def test_emulated_straddling_eclipse_agrees_with_the_plain_version(k):
    """The eclipse kernel's 64-point tiles: at K = 3 a bin is cut by a
    tile boundary every 64 / 3 bins, at K = 48 every other bin is."""
    ft, ft64, wrows32, rest, powers = _eclipse_case("expsum", k=k)
    v = _emulated_eclipse_fine(ft, *rest[:3], wrows32, *rest[4:], powers)
    got, cut = _tile_order_sum(v.float(), k, fused._F_MTILE_F,
                               2.0 * np.float32(np.pi) / np.float32(k), 1.0)
    assert cut > 0 and fused._F_MTILE_F % k
    ref = fused.eclipse_folded_plain(ft64, *rest, powers=powers)
    # float32 sums of up to K positive fluxes
    np.testing.assert_allclose(got.double().numpy(), ref.numpy(), rtol=5e-6)


@pytest.mark.parametrize("k", [3, 48])
def test_emulated_straddling_transit_agrees_with_the_plain_version(k):
    """The transit kernel's 32-point tiles: at K = 48 every bin spans two
    or three tiles."""
    ft, ft64, wrows32, G32, wgt = _transit_case(k=k)
    Gb, Gs = fused.split_tf32(torch.tril(G32))
    a = []
    for j in range(k):
        eb, es = fused.split_tf32(_emulated_ext(ft, wrows32, j))
        tau = torch.bmm(Gs, eb) + torch.bmm(Gb, es) + torch.bmm(Gb, eb)
        absorb = 1.0 - torch.exp(-torch.clamp(tau.double(), max=TAU_CLAMP))
        a.append(torch.bmm(wgt[:, None, :], absorb)[:, 0])
    v = torch.stack(a, -1).flatten(1)                         # [C, W K]
    got, cut = _tile_order_sum(v.float(), k, fused._FT_W, 1.0, k)
    assert cut > 0 and fused._FT_W % k
    ref = fused.transit_folded_plain(ft64, wrows32.double(), G32.double(),
                                     wgt)
    np.testing.assert_allclose(got.double().numpy(), ref.numpy(), rtol=5e-6)


def test_tile_order_sum_of_a_dividing_k_is_the_bin_sum():
    """Where K divides the tile no bin is cut, and the sum is the plain
    one of the bin's sub-samples in their order."""
    v = torch.rand(3, 16 * 24, generator=torch.Generator().manual_seed(2))
    got, cut = _tile_order_sum(v, 16, 64, 1.0, 16.0)
    assert cut == 0
    want = v.reshape(3, 24, 16)
    acc = want[..., 0].clone()
    for j in range(1, 16):
        acc = acc + want[..., j]
    assert torch.equal(got, acc / 16.0)


# ---------------------------------------------------------------------
# (c) sources, shared memory, limits, the prepared slant matrix

def _macros(src):
    return {m: int(v) for m, v in re.findall(r"#define (\w+) (\d+)\b", src)}


def _cxx_return(src, name, env, kind="size_t"):
    """Evaluate the single return expression of the constexpr function
    ``name`` of a source, with ``env`` for its parameters and helpers
    (one conditional ``a ? b : c`` at the top is read as Python's)."""
    body = re.search(
        rf"constexpr {kind} {name}\([^)]*\) {{\s*return (.*?);\s*}}", src,
        re.S).group(1)
    expr = re.sub(r"\(size_t\)", "", body).replace("/", "//")
    cond = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr, re.S)
    if cond:
        expr = f"({cond.group(2)}) if ({cond.group(1)}) else ({cond.group(3)})"
    return eval(f"({expr})", {"__builtins__": {}}, env)


def test_eclipse_mma_source_constants_and_smem_match_python():
    src = (fused._CSRC / "fused_eclipse_folded.cu").read_text()
    env = _macros(src)
    assert set(env) >= {"MTILE_F", "CBM", "NSTAGE", "MTHREADS"}
    # any quadrature: no node ceiling is left in the source
    assert "MAX_NMU" not in src and not hasattr(fused, "_MAX_NMU")
    for macro, value in (("MTILE_F", fused._F_MTILE_F), ("CBM", fused._F_CBM),
                         ("NSTAGE", fused._F_NSTAGE),
                         ("MTHREADS", fused._F_MTHREADS), ("RCH", fused._RCH)):
        assert env[macro] == value
    # the float32-pipe kernel's tile is gone
    assert not {"TILE_F", "TY", "CPT"} & set(env)
    assert '#include "hopper.cuh"' in src
    env["fold_bins"] = lambda k: _cxx_return(src, "fold_bins",
                                             {**env, "K": k}, "int")
    for k in range(2, 257):
        assert fused._fold_bins(k) == env["fold_bins"](k)
    # a stage: the table tile [RS][MTILE_F] and the weights
    # [parts][CBM][RS] as the TMA writes them (no padding), RS a power of
    # two (a chunk of RCH rows when the row axis is chunked); NSTAGE of
    # them, the Planck means, the stages' mbarriers
    env["mma_stage_bytes"] = lambda rs, eb, np_: _cxx_return(
        src, "mma_stage_bytes", {**env, "RS": rs, "eb": eb, "np": np_})
    for bf16, eb, parts, depth in ((True, 2, 3, 16), (False, 4, 1, 8)):
        for R, k in ((27, 32), (19, 2), (16, 4), (48, 8), (41, 16),
                     (122, 32), (137, 32), (226, 32), (512, 32), (226, 4),
                     (27, 3), (27, 6), (27, 12), (27, 48), (27, 64),
                     (27, 128), (122, 128), (512, 3)):
            Rp = -(-R // depth) * depth
            RS = fused._eclipse_stage_rows(Rp, eb)
            assert RS == min(1 << (Rp - 1).bit_length(), env["RCH"])
            assert RS >= max(32 // eb, min(Rp, env["RCH"]))
            stage = env["mma_stage_bytes"](RS, eb, parts)
            assert stage == eb * RS * (fused._F_MTILE_F + parts * fused._F_CBM)
            want = _cxx_return(src, "mma_smem_bytes",
                               {**env, "RS": RS, "K": k, "eb": eb,
                                "np": parts})
            assert want == (1024 + fused._F_NSTAGE * stage
                            + 2 * 4 * env["fold_bins"](k) * fused._F_CBM
                            + 8 * fused._F_NSTAGE)
            assert fused._eclipse_folded_smem(R, k, bf16) == want
            # two blocks an SM (228 KB, 1 KB of it reserved a block)
            assert 2 * (want + 1024) <= 233472
        # every row count and every K fits a block: shared memory stops
        # growing at a chunk of RCH rows, and K = 2 has the most bins a
        # tile
        for R in range(1, 513):
            for k in range(2, 129):
                assert fused._eclipse_folded_smem(R, k, bf16) \
                    <= fused._eclipse_folded_smem(R, 2, bf16) \
                    <= fused._SMEM_LIMIT
            assert fused._eclipse_folded_smem(R, 32, bf16) \
                == fused._eclipse_folded_smem(min(R, 64), 32, bf16)
    # a chunk is whole k-steps of either table
    assert env["RCH"] % 16 == 0
    # bfloat16 at R = 27: 4 stages of 32 rows ([32][64] + [3][32][32]
    # bfloat16), the Planck means, the barriers
    assert fused._eclipse_folded_smem(27, 32, True) == 42528
    # float32: 4 stages of [32][64] + [32][32] words at R = 27; of 64 rows
    # at R = 41
    assert fused._eclipse_folded_smem(27, 32, False) == 50720
    assert fused._eclipse_folded_smem(41, 32, False) == 99872
    # the epilogue's [CBM][MTILE_F + 4] sums fit the smallest ring
    epi = 4 * fused._F_CBM * (fused._F_MTILE_F + 4)
    assert fused._F_NSTAGE * env["mma_stage_bytes"](16, 2, 3) >= epi
    assert fused._F_NSTAGE * env["mma_stage_bytes"](8, 4, 1) >= epi
    # the float32 fragment loads: lane (g, t) reads row t (+ 4), fine
    # point col32(m, h, g) of the 128-byte-swizzled table rows and row t
    # (+ 4), chain g of the weights' swizzled rows of 8, 16 or 32 words:
    # 32 different banks for every stage's rows
    g, t = np.divmod(np.arange(32), 4)

    def swz(o, m):
        return o ^ (((o >> 7) & m) << 4)

    pt = 16 * (g >> 2) + (g & 3)
    assert len(set(swz(128 * t + 4 * pt, 7) // 4 % 32)) == 32
    for rsi in (8, 16, 32):
        m = rsi * 4 // 16 - 1
        assert len(set(swz(4 * (g * rsi + t), m) // 4 % 32)) == 32
    # the bins a tile touches: K dividing the tile keeps its old count
    # (the same buffers as before any K was taken), every other K at most
    # a bin cut at each end; at most MTILE_F / 2, the size of the bins'
    # wavenumbers in shared memory, so the Planck pairs of a block fit
    # the threads' registers (PP per thread) for every K
    for k in (2, 4, 8, 16, 32, 64):
        assert fused._fold_bins(k) == fused._F_MTILE_F // k
    T = fused._F_MTILE_F
    for k in range(2, 513):
        # the tile at f0 touches bins f0 / K .. (f0 + T - 1) / K; f0 runs
        # over every residue mod K within K tiles
        nb = max((f0 + T - 1) // k - f0 // k + 1 for f0 in range(0, T * k, T))
        assert nb <= fused._fold_bins(k) <= T // 2
    assert "wn_s[MTILE_F / 2]" in src
    assert fused._F_CBM * (fused._F_MTILE_F // 2) % fused._F_MTHREADS == 0
    # a warp per 16 fine points x 16 chains
    assert fused._F_MTHREADS == 32 * (fused._F_MTILE_F // 16) * (
        fused._F_CBM // 16)


def test_transit_mma_source_constants_and_smem_match_python():
    src = (fused._CSRC / "fused_transit_mma.cuh").read_text()
    env = _macros(src)
    for macro, value in (("FT_W", fused._FT_W), ("FT_CB", fused._FT_CB),
                         ("FT_NS", fused._FT_NS), ("FT_MT", fused._FT_MT),
                         ("FT_NF", fused._FT_NF), ("FT_NS32", fused._FT_NS32),
                         ("FT_UR", fused._FT_UR), ("FT_NE", fused._FT_NE),
                         ("FT_CX", fused._FT_CX),
                         ("FT_SG", fused._FT_SG), ("FT_SW", fused._FT_SW),
                         ("FT_SNS", fused._FT_SNS)):
        assert env[macro] == value
    for name in ("kES", "kGS", "kWF32", "kUnitBytes", "kUnitBytes32", "kECS",
                 "kEStep", "kSCB", "kTS2", "kSWF", "kSUnitBytes",
                 "kSUnitBytes32", "kNT", "kNBar"):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
        env[name] = eval(expr, {"__builtins__": {}}, env)
    assert (env["kES"], env["kGS"]) == (32, 8)
    # the resident kernel's units: a layer pair's 32 table rows and the
    # block's 8 chains' weights, whole 1024-byte swizzle periods; the ext
    # ring's step of 8 rows a chain, chains 4 words apart; 12 warps (8
    # slant, 3 fill, the producer: 168 registers a thread at most)
    assert (env["kUnitBytes"], env["kUnitBytes32"]) == (6144, 10240)
    assert env["kUnitBytes"] % 1024 == env["kUnitBytes32"] % 1024 == 0
    assert (env["kECS"], env["kEStep"]) == (260, 2080)
    assert env["kNT"] == 32 * (8 + 3 + 1) == 384
    assert env["kNBar"] == 2 * 3 * 7 + 2 * 4 + 4 * 8
    # the streamed variant's units: the table rows of two tiles (rows 72
    # elements apart: 144-byte bfloat16 rows hit all banks, float32 lane
    # (g, t) -> bank 8 t + g), the weights of 32 chains
    assert env["kSCB"] == fused._FT_SG * fused._FT_CB == 32
    assert env["kTS2"] == 72
    assert (env["kSUnitBytes"], env["kSUnitBytes32"]) == (4352, 3840)
    assert len({(env["kTS2"] * 2 * r // 4) % 32 for r in range(8)}) == 8
    gl, tl = np.divmod(np.arange(32), 4)
    assert len(set((env["kTS2"] * tl + gl) % 32)) == 32
    # its bfloat16 weight rows of 16 floats, halves swapped by bit 1 of
    # the chain: a half-warp's 8-byte loads of (chain 8 s + g, rows 2 t,
    # 2 t + 1), and of rows 2 t + 8, 2 t + 9, each hit all 32 banks
    g16, t16 = np.divmod(np.arange(16), 4)
    sw = ((g16 >> 1) & 1) * 8
    for s in range(fused._FT_SG):
        for half in (0, 8):
            words = (8 * s + g16) * env["kSWF"] + ((2 * t16 + half) ^ sw)
            banks = np.concatenate([words % 32, (words + 1) % 32])
            assert len(set(banks)) == 32
    # and its float32 weights: lane (g, t) -> bank 12 g + t, all different
    g, t = np.divmod(np.arange(32), 4)
    assert len(set((env["kWF32"] * g + t) % 32)) == 32
    # the resident kernel's shared memory: 1024 to align the rings, the
    # fill warps' rings, the barriers, the G stages, the ext ring and the
    # slant warps' words for the bins
    for L in (100, 23, 104, 9, 112, 1):
        for bf16, unit, ns in ((True, "kUnitBytes", "FT_NS"),
                               (False, "kUnitBytes32", "FT_NS32")):
            lenv = {**env, "L": L}
            want = (1024 + env["FT_NF"] * env[ns] * env[unit]
                    + 8 * env["kNBar"]
                    + _cxx_return(src, "ft_slant_bytes", lenv)
                    + _cxx_return(src, "ft_ext_bytes", env))
            assert fused._transit_mma_smem(L, bf16) == want
            assert not fused._transit_streamed(L)
    # the streamed variant (L > 16 FT_MT): the annulus weights of a warp
    # pair's chain, then the larger of the pairs' fill rings (FT_SNS
    # streamed units each) and the slant's stages (two of a group's G rows
    # a pair, two of a step's ext rows a warp)
    pairs = env["FT_CB"] // env["FT_SW"]
    stage = _cxx_return(src, "ft_stream_stage_words", env)
    assert stage == (pairs * 2 * 16 * env["FT_MT"] * env["kGS"]
                     + env["FT_CB"] * 2 * 8 * env["kES"])
    for L in (113, 130, 150, 200, 400):
        for bf16, unit in ((True, "kSUnitBytes"), (False, "kSUnitBytes32")):
            want = (_cxx_return(src, "ft_wgt_bytes", {**env, "L": L})
                    + max(pairs * env["FT_SNS"] * env[unit], 4 * stage))
            assert fused._transit_mma_smem(L, bf16) == want
            assert fused._transit_streamed(L)
    assert fused._transit_mma_smem(100, True) == 222352
    assert fused._transit_mma_smem(100, False) == 216208
    # a K that does not divide the 32-point tile: lane j of the warp sums
    # the tile's j-th bin, and a tile touches at most (FT_W - 1) / K + 2
    # bins, fewer than the warp's lanes for every K >= 2
    assert "if (FT_W % K == 0)" in src
    assert '#include "fold_straddle.cuh"' in src
    assert all((fused._FT_W - 1) // k + 2 <= 32 for k in range(2, 4097))


def test_limits_the_wrappers_raise_on():
    # every layer count up to 400 (and well beyond: the annulus weights
    # bound the streamed variant at 10,176 layers, 10,688 on a float32
    # table) fits the transit kernels, and so does a fine axis past the
    # 65,535 tiles a grid's y extent holds (the tiles spread over y and
    # z); the streamed variant's int item index bounds its items
    for bf16 in (True, False):
        for L in range(1, 401):
            assert fused._transit_mma_smem(L, bf16) <= fused._SMEM_LIMIT
            fused._check_transit_fit("fn", L, 80032, bf16)
        fused._check_transit_fit("fn", 4000, 300, bf16)
        with pytest.raises(ValueError, match="shared memory"):
            fused._check_transit_fit("fn", 12000, 300, bf16)
        for L in (100, 200):
            fused._check_transit_fit("fn", L, 32 * 65535 + 1, bf16, 512)
        fused._check_transit_fit("fn", 100, 2**31 - 128, bf16, 10**6)
        with pytest.raises(ValueError, match="fewer than 2\\^31"):
            fused._check_transit_fit("fn", 200, 2**31 - 128, bf16, 10**6)
    # any K >= 2 is taken (K = 1 is the K = 1 kernels'); a table that is
    # not folded_table's raises
    cpu = torch.device("cpu")
    odd = fused.FoldedTable(torch.ones(5, 9, 16, dtype=F32), 3, 5)
    assert fused._check_folded("fn", odd, cpu) == 0
    for k in (1, 0):
        with pytest.raises(ValueError, match=f"K = {k}; the folded kernels"):
            fused._check_folded("fn", fused.FoldedTable(
                torch.ones(5, 9, 16, dtype=F32), k, 5), cpu)
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
