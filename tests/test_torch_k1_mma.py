"""The K = 1 tensor-core kernels of bart_tpu_torch.rt.fused and the
prepared K = 1 table, held on the CPU.

(a) a plain torch emulation of the kernels' arithmetic -- both operands
    of the rows contraction split as ``split_tf32`` splits them, the two
    small products and the big one summed in float32 (3xTF32), the slant
    product likewise -- against ``eclipse_plain``/``transit_plain`` and
    against bart_tpu's ``_single``/``_tsingle`` under vmap at float64, as
    tests/test_fused.py runs them: the split keeps the port on the JAX
    package's numbers, and a pass fewer would not;
(b) the sources' macros, shared-memory formulas and bank patterns against
    the Python constants and calculators;
(c) ``rows_table``/``RowsTable``: the prepared table equals the plain
    form, a forward on prepared tables equals one on plain tensors bit for
    bit, and the forward hands the kernels the prepared table itself;
(d) the CUDA kernels against the plain versions on the card (marked gpu,
    skipped without one), at ragged shapes, with subnormal weights, in
    both quadratures.

Fixture scale as tests/test_fused.py: M = 2, nT = 9 (R = 18), L = 23,
W = 300, C = 6; ragged cases C = 17 with R = 16 and R = 48.

The card has no JAX, so this module imports jax only inside the tests
that compare with bart_tpu; the card tests run there with
``python -m pytest --noconftest -m gpu tests/test_torch_k1_mma.py``.
"""

import re

import numpy as np
import pytest
import torch

import bart_tpu_torch.rt.fused as fused
from bart_tpu_torch.demo import (DEMO_PARAMS, DEMO_PARAMS_TRANSIT,
                                 build_demo_model, demo_inputs, random_rows,
                                 random_transit_rows)
from bart_tpu_torch.rt.eclipse import expsum_weights, raygrid_weights
from bart_tpu_torch.rt.planck import planck_wn
from bart_tpu_torch.rt.tau import TAU_CLAMP
from bart_tpu_torch.rt.transit_geom import slant_geometry

F64, F32 = torch.float64, torch.float32
QUADS = {"raygrid": (raygrid_weights([0.0, 20.0, 40.0, 60.0, 80.0]), False),
         "expsum": (expsum_weights(8), True)}
SHAPES = [(18, 23, 300, 6), (16, 23, 300, 17), (48, 23, 70, 17)]  # R, L, W, C
# The emulated kernels against the float64 plain versions.  3xTF32 keeps
# each product to 2^-21 an operand (1e-6 for the two) and the sums over
# the rows, the layers and the slant paths are float32; tau of order one
# carries that into the flux once.  Measured here: 3.5e-8..3.3e-7 (a pass
# fewer: 2.3e-5..8.2e-4).
EMU_RTOL = 2e-6


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


# ---------------------------------------------------------------------
# (a) the kernels' arithmetic, emulated

def _ext_3xtf32(tab32, wrows32, passes=3, chunk=None):
    """ext [C, L, W] as the kernels' fill forms it: table and weights
    split into big + small, small x big + big x small in one float32
    accumulator and big x big in another, added at the end.  ``passes``
    = 2 leaves out the table's small part, 1 both.  ``chunk``: the rows
    in the eclipse kernel's chunked order, the accumulators carried from
    chunk to chunk of that many rows."""
    tb, ts = fused.split_tf32(tab32)
    wb, ws = fused.split_tf32(wrows32)

    def mm(w, t):
        return torch.einsum("clr,rlw->clw", w, t)

    R = tab32.shape[0]
    small = big = torch.zeros(())
    for r0 in range(0, R, chunk or R):
        rows = slice(r0, r0 + (chunk or R))
        if passes >= 2:
            small = small + mm(ws[..., rows], tb[rows])
        if passes >= 3:
            small = small + mm(wb[..., rows], ts[rows])
        big = big + mm(wb[..., rows], tb[rows])
    return small + big


def _emulated_eclipse(tab32, wn, mu, muw, wrows32, T, drp, powers, passes=3,
                      chunk=None):
    """eclipse_plain with the emulated fill; the recurrence, Planck, the
    quadrature and the flux in float64."""
    ext = _ext_3xtf32(tab32, wrows32, passes, chunk).double()
    seg = 0.5 * (ext[:, :-1] + ext[:, 1:]) * drp[:, 1:, None]
    tau = torch.cat([torch.zeros_like(ext[:, :1]),
                     torch.cumsum(seg, dim=1)], dim=1)
    S = fused.smix(tau, mu, muw, powers)
    B = planck_wn(wn, T[..., None])
    flux = torch.sum(0.5 * (B[:, :-1] + B[:, 1:]) * (S[:, :-1] - S[:, 1:]),
                     dim=1)
    return 2.0 * np.pi * (flux + B[:, -1] * S[:, -1])


def _emulated_transit(tab32, wrows32, G32, wgt, passes=3):
    """transit_plain with the emulated fill and the 3xTF32 slant product,
    both summed in float32; the exponential in float64."""
    Gb, Gs = fused.split_tf32(torch.tril(G32))
    eb, es = fused.split_tf32(_ext_3xtf32(tab32, wrows32, passes))
    tau = torch.bmm(Gs, eb) + torch.bmm(Gb, es) + torch.bmm(Gb, eb)
    absorb = 1.0 - torch.exp(-torch.clamp(tau.double(), max=TAU_CLAMP))
    return torch.bmm(wgt[:, None, :], absorb)[:, 0]


def _eclipse_case(quad, shape):
    (mu, muw), powers = QUADS[quad]
    tab, wn, wrows, T, drp = random_rows(*shape)
    tab32, wrows32 = _t(tab, F32), _t(wrows, F32)
    rest = [_t(wn), _t(mu), _t(muw), wrows32.double(), _t(T), _t(drp)]
    return tab32, wrows32, rest, powers


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("quad", ["raygrid", "expsum"])
def test_emulated_eclipse_agrees_with_the_plain_version(quad, shape):
    tab32, wrows32, rest, powers = _eclipse_case(quad, shape)
    got = _emulated_eclipse(tab32, *rest[:3], wrows32, *rest[4:], powers)
    ref = fused.eclipse_plain(tab32.double(), *rest, powers=powers)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=EMU_RTOL)
    # the fill itself: 2^-21 an operand and float32 sums over the rows
    ext64 = torch.einsum("clr,rlw->clw", wrows32.double(), tab32.double())
    np.testing.assert_allclose(_ext_3xtf32(tab32, wrows32).numpy(),
                               ext64.numpy(), rtol=3e-6)


@pytest.mark.parametrize("quad", ["raygrid", "expsum"])
def test_emulated_eclipse_agrees_with_bart_tpu(jx, quad):
    jax, jnp, jfused = jx
    tab32, wrows32, rest, powers = _eclipse_case(quad, SHAPES[0])
    ref = jax.vmap(
        lambda w, t, d: jfused._single(
            jnp.asarray(tab32.double().numpy()),
            *[jnp.asarray(a.numpy()) for a in rest[:3]], w, t, d,
            powers=powers)
    )(*[jnp.asarray(a.numpy()) for a in rest[3:]])
    got = _emulated_eclipse(tab32, *rest[:3], wrows32, *rest[4:], powers)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=EMU_RTOL)


def _transit_case(shape):
    tab, wrows, G, wgt, _ = random_transit_rows(*shape)
    return _t(tab, F32), _t(wrows, F32), _t(G, F32), _t(wgt)


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_transit_agrees_with_the_plain_version(shape):
    tab32, wrows32, G32, wgt = _transit_case(shape)
    got = _emulated_transit(tab32, wrows32, G32, wgt)
    ref = fused.transit_plain(tab32.double(), wrows32.double(), G32.double(),
                              wgt)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=EMU_RTOL)
    # the problem is not saturated: tau of order one is where a wrong
    # product shows
    tau = torch.bmm(G32.double(), torch.einsum(
        "clr,rlw->clw", wrows32.double(), tab32.double()))
    assert float(((tau > 0.1) & (tau < 10.0)).double().mean()) > 0.2


def test_emulated_transit_agrees_with_bart_tpu(jx):
    jax, jnp, jfused = jx
    tab32, wrows32, G32, wgt = _transit_case(SHAPES[0])
    ref = jax.vmap(jfused._tsingle, in_axes=(None, 0, 0, 0))(
        *[jnp.asarray(a.double().numpy())
          for a in (tab32, wrows32, G32, wgt)])
    got = _emulated_transit(tab32, wrows32, G32, wgt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=EMU_RTOL)


#: past the eclipse kernels' old ceiling: 226 rows (the flagship at
#: tempdelt = 50) in chunks of RCH rows; the transit kernels' at 130
#: layers (its streamed variant: the slant product in groups of 16 FT_MT
#: annuli, each tau summed over the layers as the resident kernel sums it)
MANY_ECLIPSE, MANY_TRANSIT = (226, 23, 40, 5), (12, 130, 40, 5)


@pytest.mark.parametrize("quad", ["raygrid", "expsum"])
def test_emulated_eclipse_in_the_chunked_order_at_226_rows(quad):
    (mu, muw), powers = QUADS[quad]
    tab, wn, wrows, T, drp = random_rows(*MANY_ECLIPSE)
    wrows = wrows * 27.0 / MANY_ECLIPSE[0]     # tau of order one inside
    tab32, wrows32 = _t(tab, F32), _t(wrows, F32)
    rest = [_t(wn), _t(mu), _t(muw), wrows32.double(), _t(T), _t(drp)]
    got = _emulated_eclipse(tab32, *rest[:3], wrows32, *rest[4:], powers,
                            chunk=fused._RCH)
    ref = fused.eclipse_plain(tab32.double(), *rest, powers=powers)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=EMU_RTOL)
    ext64 = torch.einsum("clr,rlw->clw", wrows32.double(), tab32.double())
    np.testing.assert_allclose(
        _ext_3xtf32(tab32, wrows32, chunk=fused._RCH).numpy(),
        ext64.numpy(), rtol=3e-6)
    # four chunks, the last one 40 rows (226 rounded up to 232, less 192)
    assert -(-MANY_ECLIPSE[0] // fused._RCH) == 4


def test_emulated_transit_at_130_layers():
    tab, wrows, G, wgt, _ = random_transit_rows(*MANY_TRANSIT)
    tab32, wrows32, G32 = _t(tab, F32), _t(wrows, F32), _t(G, F32)
    got = _emulated_transit(tab32, wrows32, G32, _t(wgt))
    ref = fused.transit_plain(tab32.double(), wrows32.double(), G32.double(),
                              _t(wgt))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=EMU_RTOL)
    tau = torch.bmm(G32.double(), torch.einsum(
        "clr,rlw->clw", wrows32.double(), tab32.double()))
    assert float(((tau > 0.1) & (tau < 10.0)).double().mean()) > 0.2
    assert fused._transit_streamed(MANY_TRANSIT[1])


@pytest.mark.parametrize("passes", [1, 2])
def test_a_pass_fewer_would_not_hold_the_tolerance(passes):
    """The check can fail: without the table's small part (two passes)
    or both small parts (plain TF32) the fill is 2^-11 off, far beyond
    what the emulation, and the kernels on the card, are held to."""
    tab32, wrows32, rest, powers = _eclipse_case("raygrid", SHAPES[0])
    ref = fused.eclipse_plain(tab32.double(), *rest, powers=powers)
    got = _emulated_eclipse(tab32, *rest[:3], wrows32, *rest[4:], powers,
                            passes=passes)
    assert float(((got - ref).abs() / ref).max()) > 1e-4 > EMU_RTOL
    tab32, wrows32, G32, wgt = _transit_case(SHAPES[0])
    ref = fused.transit_plain(tab32.double(), wrows32.double(), G32.double(),
                              wgt)
    got = _emulated_transit(tab32, wrows32, G32, wgt, passes=passes)
    assert float(((got - ref).abs() / ref).max()) > 1e-5 > 0.1 * EMU_RTOL


# ---------------------------------------------------------------------
# (b) sources, shared memory, bank patterns

def _macros(src):
    return {m: int(v) for m, v in re.findall(r"#define (\w+) (\d+)\b", src)}


def _cxx_return(src, name, env):
    """Evaluate the single return expression of the constexpr function
    ``name`` of a source, with ``env`` for its parameters and helpers."""
    body = re.search(rf"constexpr size_t {name}\([^)]*\) {{\s*return (.*?);\s*}}",
                     src, re.S).group(1)
    expr = re.sub(r"\(size_t\)", "", body).replace("/", "//")
    return eval(f"({expr})", {"__builtins__": {}}, env)


def test_eclipse_source_constants_and_smem_match_python():
    src = (fused._CSRC / "fused_eclipse.cu").read_text()
    env = _macros(src)
    for macro, value in (("TILE_W", fused._TILE_W), ("CB", fused._CB),
                         ("NSTAGE", fused._NSTAGE),
                         ("NTHREADS", fused._NTHREADS), ("RCH", fused._RCH)):
        assert env[macro] == value
    # the quadrature has no node ceiling: shared memory does not hold it
    # beyond the unrolled instances' own NMU nodes
    assert "MAX_NMU" not in env and not hasattr(fused, "_MAX_NMU")
    assert '#include "hopper.cuh"' in src and "mma_tf32(" in src
    assert "extern \"C\" int bart_fused_eclipse(" in src
    env["kTS"] = eval(re.search(r"constexpr int kTS = ([^;]+);", src).group(1),
                      {"__builtins__": {}}, env)
    assert env["kTS"] == fused._TILE_W + 8
    env["stage_words"] = lambda rs: _cxx_return(
        src, "stage_words", {**env, "Rs": rs})
    for R in (27, 41, 18, 1, 8, 48, 100, 122, 137, 226, 512):
        # a stage holds a chunk of min(Rp, RCH) rows
        Rs = min(-(-R // 8) * 8, env["RCH"])
        want = _cxx_return(src, "smem_bytes", {**env, "Rs": Rs})
        assert fused._eclipse_smem(R) == want
        # lane (g, t) of a fragment load -> bank 8 t + g of the table tile
        # and (Rs + 4) g + t of the weights: all different
        g, t = np.divmod(np.arange(32), 4)
        assert len(set((env["kTS"] * t + g) % 32)) == 32
        assert len(set(((Rs + 4) * g + t) % 32)) == 32
    # the pinned sizes at the full-width shapes: unchanged by the chunks
    assert fused._eclipse_smem(27) == 56320
    assert fused._eclipse_smem(41) == 82944
    # a layer's chunks: the last one takes the rest of the k-steps, and a
    # full chunk's weights are two 16-byte copies a thread
    assert env["RCH"] % 8 == 0
    assert env["CB"] * env["RCH"] // 4 <= 2 * env["NTHREADS"]
    # two blocks of every row count fit an SM's 228 KB (1 KB of it
    # reserved a block): shared memory no longer grows with R
    for R in range(1, 513):
        assert 2 * (fused._eclipse_smem(R) + 1024) <= 233472
    assert fused._eclipse_smem(512) == fused._eclipse_smem(64) == 109568
    # a warp per 16 wavenumbers x 16 chains
    assert fused._NTHREADS == 32 * (fused._TILE_W // 16) * (fused._CB // 16)


def test_kernel_entry_points_take_the_arguments_python_passes():
    """The ctypes signatures against the extern "C" declarations: the
    pointers, then the ints, then the stream."""
    for name, argtypes in fused._KERNELS.items():
        src = (fused._CSRC / f"{name}.cu").read_text()
        decl = re.search(rf'extern "C" int bart_{name}\((.*?)\)', src,
                         re.S).group(1)
        args = [a.strip() for a in decl.split(",")]
        want = [fused._VP if "*" in a or "cudaStream_t" in a else fused._CI
                for a in args]
        assert want == argtypes, name
        assert args[-1].startswith("cudaStream_t")


# ---------------------------------------------------------------------
# (c) the prepared K = 1 table

@pytest.mark.parametrize("W", [300, 301, 70, 1])
def test_rows_table_equals_the_plain_form(W):
    rng = np.random.default_rng(3)
    a, b = _t(rng.random((5, 7, W))), _t(rng.random((3, 7, W)))
    rt = fused.rows_table([a, b])
    Wp = -(-W // 4) * 4
    assert isinstance(rt, fused.RowsTable) and rt.W == W
    assert rt.tab.shape == (8, 7, Wp) and rt.tab.is_contiguous()
    np.testing.assert_array_equal(rt.plain().numpy(),
                                  torch.cat([a, b]).numpy())
    assert float(rt.tab[..., W:].abs().sum()) == 0.0
    assert fused.rows_table(a, F32).tab.dtype == F32
    # nothing to pad or cast: taken as it is
    same = fused.rows_table(a)
    assert (same.tab.data_ptr() == a.data_ptr()) == (W % 4 == 0)
    # the kernels' checked form
    cpu = torch.device("cpu")
    t32, w = fused._rows32("fn", rt, cpu)
    assert w == W and t32.dtype == F32 and t32.shape == rt.tab.shape
    t32b, _ = fused._rows32("fn", torch.cat([a, b]), cpu)   # on the spot
    np.testing.assert_array_equal(t32.numpy(), t32b.numpy())
    ready = fused.rows_table(a, F32)
    assert fused._rows32("fn", ready, cpu)[0].data_ptr() == ready.tab.data_ptr()
    with pytest.raises(ValueError, match="rows_table"):
        fused._rows32("fn", fused.RowsTable(rt.tab[..., :-1], W), cpu)
    with pytest.raises(ValueError, match=r"\[R, L, W\]"):
        fused._rows32("fn", a[0], cpu)
    with pytest.raises(ValueError, match="blocks"):
        fused.rows_table([a, b[:, :-1]])


def test_padded_weights_equal_the_plain_form():
    w = _t(np.random.default_rng(4).random((6, 5, 19)))
    p = fused._pad_rows(w, 24)
    assert p.shape == (6, 5, 24) and p.dtype == F32 and p.is_contiguous()
    np.testing.assert_array_equal(p[..., :19].numpy(), w.float().numpy())
    assert float(p[..., 19:].abs().sum()) == 0.0
    w32 = w.float()
    assert fused._pad_rows(w32, 19).data_ptr() == w32.data_ptr()


def test_wrappers_take_a_rows_table_on_the_cpu():
    tab, wn, wrows, T, drp = (_t(a) for a in random_rows(18, 9, 41, 3))
    (mu, muw), powers = QUADS["raygrid"]
    rt = fused.rows_table(tab)
    assert rt.tab.shape[2] == 44
    np.testing.assert_array_equal(
        fused.fused_eclipse(rt, wn, _t(mu), _t(muw), wrows, T, drp).numpy(),
        fused.eclipse_plain(tab, wn, _t(mu), _t(muw), wrows, T, drp).numpy())
    tab, wrows, G, wgt = (_t(a) for a in random_transit_rows(5, 9, 41, 3)[:4])
    np.testing.assert_array_equal(
        fused.fused_transit(fused.rows_table(tab), wrows, G, wgt).numpy(),
        fused.transit_plain(tab, wrows, G, wgt).numpy())


@pytest.fixture(scope="module")
def small_models():
    """Eclipse and transit demo models with CIA rows at a width that is
    not a multiple of 4 (so the prepared table is padded), float64."""
    inp = demo_inputs(nlayer=6, nwave=61, nlines=120, t_step=520.0)
    fme = build_demo_model(inp, device="cpu", dtype=F64, cia=True)
    fmt = build_demo_model(inp, device="cpu", dtype=F64, grid=fme.opacity,
                           solution="transit", cia=True)
    return inp, fme, fmt


@pytest.mark.parametrize("solution", ["eclipse", "transit"])
def test_forward_on_prepared_tables_equals_plain_tensors(small_models,
                                                         solution):
    inp, fme, fmt = small_models
    fm = fme if solution == "eclipse" else fmt
    base = DEMO_PARAMS if solution == "eclipse" else DEMO_PARAMS_TRANSIT
    P = torch.tensor(np.tile(base, (3, 1))
                     + np.random.default_rng(1).normal(0, 0.01,
                                                       (3, len(base))))
    t = fm.tables
    tab = t["tab"]
    M, nT, L, W = t["sigma"].shape
    assert isinstance(tab, fused.RowsTable) and (tab.W, W) == (61, 61)
    assert tab.tab.shape == (M * nT + t["frows"].shape[0], L, 64)
    # sigma and frows are views of the one table, not copies
    assert t["sigma"].data_ptr() == tab.tab.data_ptr()
    assert t["frows"].data_ptr() == tab.tab[M * nT:].data_ptr()
    np.testing.assert_array_equal(
        t["sigma"].numpy(),
        fm.opacity.sigma.to(F64).numpy())
    plain = torch.cat([t["sigma"].reshape(M * nT, L, W), t["frows"]]
                      ).contiguous()
    np.testing.assert_array_equal(tab.plain().numpy(), plain.numpy())
    got = fm(P)
    ref = fm(P, {**t, "tab": plain})       # a plain tensor is still taken
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_forward_hands_the_kernels_the_prepared_table(small_models,
                                                      monkeypatch):
    """No per-call copy of a table: ``_fused_rows`` returns the model's
    RowsTable itself, and the wrappers receive that very storage."""
    import bart_tpu_torch.rt.forward as forward

    inp, fme, fmt = small_models
    seen = []

    def spy(real):
        def wrapper(tab, *args, **kw):
            seen.append(tab)
            return real(tab, *args, **kw)
        return wrapper

    monkeypatch.setattr(forward, "fused_eclipse", spy(fused.fused_eclipse))
    monkeypatch.setattr(forward, "fused_transit", spy(fused.fused_transit))
    for fm, base in ((fme, DEMO_PARAMS), (fmt, DEMO_PARAMS_TRANSIT)):
        P = torch.tensor(np.tile(base, (2, 1)))
        T, q, rad, _ = fm._profiles(P, fm.tables)
        ((tab, folded, _, idx),), wrows = fm._fused_rows(P, fm.tables, T, q,
                                                         rad)
        assert tab is fm.tables["tab"] and not folded and idx is None
        assert wrows.shape[2] == tab.tab.shape[0]
        fm(P)
        assert seen[-1] is fm.tables["tab"]
        assert seen[-1].tab.data_ptr() == fm.tables["tab"].tab.data_ptr()
    assert len(seen) == 2


def test_folded_model_prepares_its_smooth_bin_table():
    inp = demo_inputs(nlayer=6, nwave=61, nlines=120, t_step=520.0)
    fm = build_demo_model(inp, device="cpu", dtype=F64, cia=True, fold=4,
                          fold_adapt=0.02, quadrature="expsum")
    assert fm._idx_smooth is not None
    tabs = fm.tables["tabs"]
    n_s = len(fm._idx_smooth)
    assert isinstance(tabs, fused.RowsTable) and tabs.W == n_s
    assert tabs.tab.shape[2] == -(-n_s // 4) * 4 and tabs.tab.is_contiguous()
    P = torch.tensor(np.tile(DEMO_PARAMS, (2, 1)))
    T, q, rad, _ = fm._profiles(P, fm.tables)
    parts, _ = fm._fused_rows(P, fm.tables, T, q, rad)
    assert parts[1][0] is tabs and parts[0][0] is fm.tables["tabk"]
    got = fm(P)
    ref = fm(P, {**fm.tables, "tabs": tabs.plain().contiguous()})
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------
# (d) on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from bart_tpu_torch.device import resolve_device

    return resolve_device("cuda")


# ragged in every axis: wavenumbers one short of and one past a tile, of a
# 16-byte piece; chains around a block; rows around a k-step; one layer
CARD_SHAPES = [(18, 23, 300, 6), (16, 23, 63, 17), (48, 23, 65, 33),
               (27, 100, 2501, 64), (1, 1, 1, 1), (9, 5, 129, 31)]


@pytest.mark.gpu
@pytest.mark.parametrize("quad", ["raygrid", "expsum"])
@pytest.mark.parametrize("shape", CARD_SHAPES + [(226, 23, 300, 17),
                                                 (137, 30, 65, 33)])
def test_eclipse_kernel_matches_plain_on_card(cuda_device, quad, shape):
    (mu, muw), powers = QUADS[quad]
    tab, wn, wrows, T, drp = (_t(a, F32).to(cuda_device)
                              for a in random_rows(*shape))
    args = [wn, _t(mu, F32).to(cuda_device), _t(muw, F32).to(cuda_device),
            wrows, T, drp]
    before = fused.fused_eclipse.launches
    got = fused.fused_eclipse(tab, *args, powers=powers)
    got_rt = fused.fused_eclipse(fused.rows_table(tab), *args, powers=powers)
    ref = fused.eclipse_plain(tab, *args, powers=powers)
    torch.cuda.synchronize()
    assert fused.fused_eclipse.launches == before + 2
    assert torch.equal(got, got_rt)      # prepared or not: the same bits
    # chip_smoke.py's SPEC_RTOL
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-4 if powers else 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("nmu", [1, 3, 16, 17, 90])
def test_eclipse_kernel_takes_any_quadrature_size(cuda_device, nmu):
    """The instances without an unrolled quadrature, past the old
    16-node ceiling too (the nodes through the read-only cache)."""
    rng = np.random.default_rng(nmu)
    mu = _t(np.sort(rng.uniform(0.1, 1.0, nmu)), F32).to(cuda_device)
    muw = _t(rng.uniform(0.1, 1.0, nmu) / nmu, F32).to(cuda_device)
    tab, wn, wrows, T, drp = (_t(a, F32).to(cuda_device)
                              for a in random_rows(18, 23, 300, 6))
    for powers in (False, True):
        got = fused.fused_eclipse(tab, wn, mu, muw, wrows, T, drp, powers)
        ref = fused.eclipse_plain(tab, wn, mu, muw, wrows, T, drp, powers)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=2e-4 if powers else 1e-4)
    with pytest.raises(ValueError, match="no quadrature node"):
        fused.fused_eclipse(tab, wn, mu[:0], muw[:0], wrows, T, drp)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES[:4] + [(9, 5, 129, 31),
                                                     (20, 130, 65, 17),
                                                     (226, 113, 40, 9)])
def test_transit_kernel_matches_plain_on_card(cuda_device, shape):
    tab, wrows, G, wgt = (_t(a, F32).to(cuda_device)
                          for a in random_transit_rows(*shape)[:4])
    before = fused.fused_transit.launches
    got = fused.fused_transit(tab, wrows, G, wgt)
    got_rt = fused.fused_transit(fused.rows_table(tab), wrows,
                                 fused.prepare_slant(G), wgt)
    ref = fused.transit_plain(tab, wrows, G, wgt)
    torch.cuda.synchronize()
    assert fused.fused_transit.launches == before + 2
    assert torch.equal(got, got_rt)      # prepared or not: the same bits
    # chip_smoke.py's OUT_RTOL
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5)


@pytest.mark.gpu
def test_kernels_keep_subnormal_weights_on_card(cuda_device):
    """Weights of 1e-40 are subnormal in float32 and their TF32 small
    parts smaller still: the products must come out as the plain
    versions', not as NaN or zero where those are not."""
    (mu, muw), _ = QUADS["raygrid"]
    tab, wn, wrows, T, drp = (_t(a, F32).to(cuda_device)
                              for a in random_rows(18, 23, 300, 6))
    tab = tab * 1e30                     # ext of the order of the fixture's
    wrows = wrows * 1e-30
    wrows[:, ::3] = 1e-40
    args = [wn, _t(mu, F32).to(cuda_device), _t(muw, F32).to(cuda_device),
            wrows, T, drp]
    got = fused.fused_eclipse(tab, *args)
    ref = fused.eclipse_plain(tab, *args)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-4)
    tab, wrows, G, wgt = (_t(a, F32).to(cuda_device)
                          for a in random_transit_rows(17, 23, 300, 6)[:4])
    tab = tab * 1e30
    wrows = wrows * 1e-30
    wrows[:, ::3] = 1e-40
    got = fused.fused_transit(tab, wrows, G, wgt)
    ref = fused.transit_plain(tab, wrows, G, wgt)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5)


@pytest.mark.gpu
def test_forward_on_card_copies_no_table(cuda_device):
    """A forward allocates less than one table's bytes beyond its other
    work: the prepared table goes to the kernel as it is."""
    inp = demo_inputs(nlayer=24, nwave=1001, nlines=300, t_step=100.0)
    fm = build_demo_model(inp, device=cuda_device, dtype=F32,
                          solution="transit", cia=True)
    tab = fm.tables["tab"].tab
    assert tab.shape[2] == 1004
    P = torch.tensor(np.tile(DEMO_PARAMS_TRANSIT, (4, 1)), dtype=F32,
                     device=cuda_device)
    fm(P)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fm(P)
    torch.cuda.synchronize()
    table_bytes = tab.numel() * tab.element_size()
    assert torch.cuda.max_memory_allocated() - base < table_bytes


# past the card's old ceilings: a table of 2^31 elements or more (86 rows
# x 100 layers x 250,000 wavenumbers, float32, 8.6 GB) and a fine axis
# past 65,535 tiles (4.2 M eclipse points in 64-point tiles, 2.2 M
# transit points in 32-point ones), each held against launches on
# bin-aligned slices under both old ceilings (bit for bit: each
# wavenumber's output depends only on its own columns) and against the
# plain version on a few chains
_K1_CEILINGS = {"eclipse-table": ("fused_eclipse", 86, 100, 250000, 16),
                "eclipse-axis": ("fused_eclipse", 8, 16, 4200000, 16),
                "transit-table": ("fused_transit", 86, 100, 250000, 16),
                "transit-axis": ("fused_transit", 8, 16, 2200000, 16)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_K1_CEILINGS))
def test_k1_kernels_past_the_old_ceilings_on_card(cuda_device, case):
    from bart_tpu_torch.utils import slices

    name, R, L, W, C = _K1_CEILINGS[case]
    pb = slices.problem(name, R, L, W, 1, C, F32, 3, cuda_device)
    assert (pb.raw.numel() >= 2**31 if case.endswith("table")
            else -(-W // slices.TILE[name]) > slices.OLD_MAX_TILES)
    got = pb.launch(pb.tab, 0, W)
    edges = slices.slice_edges(W, 1, slices.TILE[name], R * L)
    assert len(edges) > 2
    assert torch.equal(got, slices.launch_by_slices(pb.launch, pb.tab,
                                                    edges))
    b1 = edges[1]
    ref = pb.plain(slices.table_slice(pb.tab, 0, b1), 0, b1, 4)
    np.testing.assert_allclose(got[:4, :b1].cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5 if "transit" in name else 2e-4)
