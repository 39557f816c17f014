"""The deep-atmosphere transit path: transit forwards past the transit
kernels' 112-layer resident kernel, which their streamed variant takes.

On the CPU: the port's transit forward, K = 1 and folded (the plain
versions), at 120 and 200 layers against bart_tpu's forward on the same
seeded inputs and tables carried over with ``tables_from_jax``; the
200-layer twin cfgs of examples/torch_demo against their originals; the
Python reckoning of the streamed variant's items, scratch, shared memory
and layer limits against the source.  On the card (``gpu``): the
streamed variant against the plain versions at 113 to 400 layers, K = 1
and folded at K = 3, 32, 48, 128 on both table types with ragged chain
counts, and its graphed launch against its eager one bit for bit.

The card has no JAX: jax and bart_tpu are imported inside the CPU tests.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import bart_tpu_torch.rt.fused as fused
from bart_tpu_torch.demo import (DEMO_PARAMS_TRANSIT, build_demo_model,
                                 demo_inputs, fine_structure,
                                 random_transit_rows)
from bart_tpu_torch.driver.config import load_config
from bart_tpu_torch.opacity.grid import OpacityGrid
from bart_tpu_torch.rt.forward import ForwardConfig, ForwardModel
from bart_tpu_torch.utils.grids import folded_fine_grid

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
REPO = Path(__file__).resolve().parents[1]
DEMO = REPO / "examples" / "torch_demo"
#: layers past the resident kernel's 112; output bins of the K = 1 and
#: the folded problems (the folded fine axis is NW_FOLD x K = 256 points)
DEEP_LS, NW, NW_FOLD, K = (120, 200), 128, 64, 4


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------
# (a) the forward at 120 and 200 layers against bart_tpu

def _params(seed=0):
    """Four chains around the demo transit parameters, the radius spread
    by ~100 km; chain 3 has T far above tmax (invalid)."""
    rng = np.random.default_rng(seed)
    P = np.tile(DEMO_PARAMS_TRANSIT, (4, 1)) + rng.normal(0, 0.01, (4, 7))
    P[:, 5] += rng.normal(0, 100.0, 4)
    P[3, 4] = 3.0
    return P


def _models(nlayer: int, fold: int | None):
    """(bart_tpu model, this package's model, its tables carried over
    from the bart_tpu model) of the demo transit problem (CH4 lines and
    H2-H2 CIA) at ``nlayer`` layers; folded by ``fold`` with the
    adaptive split, or K = 1."""
    import jax.numpy as jnp

    from bart_tpu.obs.bands import build_band_matrix as jbands
    from bart_tpu.opacity.grid import build_opacity_grid as jbuild
    from bart_tpu.rt.forward import ForwardConfig as JConfig
    from bart_tpu.rt.forward import ForwardModel as JModel

    nw = NW_FOLD if fold else NW
    inp = demo_inputs(nlayer=nlayer, nwave=nw, nlines=300, t_step=520.0)
    wn = folded_fine_grid(inp.wn, fold) if fold else inp.wn
    grid = jbuild({"CH4": inp.lines}, wn, inp.t_grid, inp.pressure,
                  cond_batch=80, dtype=jnp.float64)
    kw = inp.transit_config_kwargs
    common = dict(wn_grid=inp.wn, pressure=inp.pressure, species=inp.species,
                  base_abundances=inp.base_q, system=inp.system,
                  cia_tables=[inp.cia])
    if fold:
        common.update(fold_osamp=fold, fold_adapt=0.02)
    fmj = JModel(JConfig(**kw), opacity=grid,
                 bands=jbands(inp.wn, inp.filters), dtype=jnp.float64,
                 **common)
    tgrid = OpacityGrid(grid.species, grid.t_grid, grid.pressure,
                        grid.wn_grid, torch.tensor(np.asarray(grid.sigma)))
    plain = build_demo_model(inp, dtype=F64, grid=tgrid, fold=fold or 1,
                             solution="transit", device="cpu")
    fmt = ForwardModel(ForwardConfig(**kw), opacity=plain.opacity,
                       bands=plain.bands, dtype=F64, device="cpu", **common)
    tabs = fmt.tables_from_jax({k: np.asarray(v)
                                for k, v in fmj.tables.items()})
    return fmj, fmt, tabs


@pytest.mark.parametrize("fold", [None, K], ids=["k1", "folded"])
@pytest.mark.parametrize("nlayer", DEEP_LS)
def test_deep_transit_forward_matches_bart_tpu(nlayer, fold):
    import jax.numpy as jnp

    fmj, fmt, tabs = _models(nlayer, fold)
    assert fused._transit_streamed(nlayer)
    assert fmt.fold == (fold or 1)
    if fold:
        # the split leaves both kinds of bin: the folded and the K = 1
        # transit kernels' paths
        assert 0 < len(fmt._idx_fine) < NW_FOLD
        np.testing.assert_array_equal(fmt._idx_fine, fmj._idx_fine)
    P = _params()
    bj, sj, vj = fmj.batched()(jnp.asarray(P))
    for t in (None, tabs):              # its own tables, then the carried
        bt, st, vt = fmt(torch.tensor(P), t)
        assert bt.shape == (4, 10) and st.shape == (4, len(fmt.wn))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        assert not vt[3] and vt[:3].all()
        # float64 on both sides (test_torch_transit_forward.py's 1e-9)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-9)
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-9)


# ---------------------------------------------------------------------
# (b) the twin cfgs

@pytest.mark.parametrize("name", ["transit", "transit_fold"])
def test_200_layer_twins_differ_only_in_layers_and_outputs(name):
    orig = load_config(str(DEMO / f"{name}.cfg"))
    twin = load_config(str(DEMO / f"{name}_l200.cfg"))
    assert (orig.n_layers, twin.n_layers) == (100, 200)
    for field in dataclasses.fields(orig):
        a, b = getattr(orig, field.name), getattr(twin, field.name)
        if field.name in ("n_layers", "loc_dir", "opacityfile"):
            assert a != b, field.name
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name
    assert twin.loc_dir.endswith(f"demo_out_{name}_l200")
    # the publication path: 32 sub-samples a bin, the split, bf16 rows
    if name == "transit_fold":
        assert (twin.fold_K, twin.rtadapt, twin.foldtable16) == (32, True,
                                                                  True)
    # the rest of the file, line for line
    lines = [(DEMO / f"{n}.cfg").read_text().splitlines()
             for n in (name, f"{name}_l200")]
    keys = ("n_layers", "loc_dir", "opacityfile", ";")
    body = [[x for x in ls if not x.startswith(keys)] for ls in lines]
    assert body[0] == body[1]


# ---------------------------------------------------------------------
# (c) the streamed variant's reckoning against the source

def _src():
    return (fused._CSRC / "fused_transit_mma.cuh").read_text()


def _const(src, name, env):
    expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
    return eval(expr, {"__builtins__": {}}, env)


def test_streamed_items_scratch_and_smem_match_the_source():
    src = _src()
    env = {m: int(v) for m, v in re.findall(r"#define (\w+) (\d+)\b", src)}
    assert (env["FT_SG"], env["FT_SW"], env["FT_SNS"]) == (
        fused._FT_SG, fused._FT_SW, fused._FT_SNS)
    for name in ("kES", "kGS", "kWF32", "kSCB", "kTS2", "kSWF",
                 "kSUnitBytes", "kSUnitBytes32"):
        env[name] = _const(src, name, env)
    # an item is FT_SG chain groups of FT_CB x FT_SW tiles: 32 chains x 64
    # points, a warp pair's; the launcher counts its chain blocks by 32
    # and bounds the (chain block, 32-point tile) pairs
    assert env["kSCB"] == fused._FT_SG * fused._FT_CB == 32
    assert "const int cb = stream_ext ? kSCB : FT_CB;" in src
    for L, C, F in ((113, 512, 2501), (200, 512, 36000), (400, 37, 300),
                    (100, 512, 2501)):
        cb = 32 if L > 112 else 8
        assert fused._transit_items(L, C, F) == -(-C // cb) * -(-F // 32)
    # the scratch: FT_SW tiles x FT_SG FT_CB chains x Lk layers x FT_W
    # points a slot
    assert "ext_g + ((size_t)blockIdx.x * FT_SW + h) * kSCB * CS" in src
    assert "bar.sync %0, 64;" in src
    assert fused._ext_scratch(100, 512, 2501, torch.device("cpu")) == (None,
                                                                       0)
    # shared memory: a pair's annulus weights, then the larger of the
    # pairs' rings (FT_SNS units: two tiles' table rows, 32 chains'
    # weights) and the slant stages (G a pair, ext a warp)
    pairs = env["FT_CB"] // env["FT_SW"]
    slant = 4 * (pairs * 2 * 16 * env["FT_MT"] * env["kGS"]
                 + env["FT_CB"] * 2 * 8 * env["kES"])
    for L in (113, 200, 400, 1000, 4704, 10000):
        for bf16 in (True, False):
            unit = env["kSUnitBytes" if bf16 else "kSUnitBytes32"]
            want = (4 * pairs * (-(-L // 16) * 16)
                    + max(pairs * env["FT_SNS"] * unit, slant))
            assert fused._transit_mma_smem(L, bf16) == want


def test_layer_limits_are_no_lower_than_before():
    for bf16, floor in ((True, 4704), (False, 4960)):
        top = max(L for L in range(4600, 11000)
                  if fused._transit_mma_smem(L, bf16) <= fused._SMEM_LIMIT)
        assert top >= floor
        fused._check_transit_fit("fn", floor, 300, bf16, 512)
        with pytest.raises(ValueError, match="shared memory"):
            fused._check_transit_fit("fn", top + 16, 300, bf16, 512)
    # 16 bytes a layer (a pair's annulus weights) beside the rings
    assert [max(L for L in range(9000, 11000)
                if fused._transit_mma_smem(L, bf16) <= fused._SMEM_LIMIT)
            for bf16 in (True, False)] == [10176, 10688]


# ---------------------------------------------------------------------
# (d) on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from bart_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _t(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


#: (R, L, W bins, C chains, K): 113 to 400 layers, chain counts that
#: leave the last 32-chain item ragged (3, 37) or full (64), fine axes
#: that leave an item's second tile partly or wholly past the last point,
#: K = 1, 3 and 48 (cut by the 32-point tiles), 32, 128; and 5,000 layers,
#: past the 8-chain variant's 4,704 / 4,960
DEEP_CASES = [(12, 113, 300, 37, 1), (27, 130, 200, 3, 1),
              (41, 200, 257, 64, 1), (9, 400, 100, 37, 1),
              (12, 113, 40, 37, 3), (27, 130, 9, 37, 32),
              (41, 200, 7, 64, 32), (9, 400, 5, 3, 48),
              (12, 200, 11, 37, 48), (12, 130, 3, 37, 128),
              (9, 400, 4, 64, 128), (4, 5000, 40, 3, 1),
              (4, 5000, 9, 3, 4)]


def _rows(R, L, W, C, seed=7):
    """demo.random_transit_rows' problem (tab, wrows, G, wgt); past 400
    layers with its radius steps scaled by 200 / L, so that the
    atmosphere keeps its height (5,000 of the demo's steps would take the
    radii below zero)."""
    if L <= 400:
        return random_transit_rows(R, L, W, C, seed)[:4]
    from bart_tpu_torch.rt.transit_geom import slant_geometry

    rng = np.random.default_rng(seed)
    tab = rng.lognormal(-46.0, 2.0, (R, L, W))
    density = 10.0 ** np.linspace(0.0, 5.0, L)
    wrows = density[None, :, None] * rng.uniform(0.0, 1.0, (C, L, R))
    rad = 9.44e9 - np.cumsum(rng.uniform(3e6, 8e6, (C, L)) * (200.0 / L),
                             axis=1)
    G, wgt = (a.numpy() for a in slant_geometry(torch.tensor(rad)))
    v = (G[:, L // 2, :, None] * wrows).reshape(C, L * R)
    tau_mid = v @ tab.transpose(1, 0, 2).reshape(L * R, W)
    return tab, wrows / np.median(tau_mid), G, wgt


def test_rows_past_400_layers_keep_the_radii_positive():
    tab, wrows, G, wgt = _rows(2, 1000, 8, 2)
    assert np.isfinite(G).all() and np.isfinite(wgt).all()
    assert (np.diag(G[0])[1:] > 0).all() and (wgt > 0).all()
    # the slant tau of the middle impact parameter is of order one
    tau = np.einsum("cl,clr,rlw->cw", G[:, 500], wrows, tab)
    assert 0.01 < float(np.median(tau)) < 100.0


def _deep(shape, device):
    """(kernel, plain) closures of one deep case, on float32 and bfloat16
    fine tables where K > 1."""
    R, L, W, C, k = shape
    tab, wrows, G, wgt = _rows(R, L, W, C)
    rest = [_t(a, F32, device) for a in (wrows, G, wgt)]
    if k == 1:
        tab32 = _t(tab, F32, device)
        rt = fused.rows_table(tab32)
        yield "k1", (lambda: fused.fused_transit(rt, *rest),
                     lambda: fused.transit_plain(tab32, *rest))
        return
    fine = (tab[..., None] * fine_structure(R, W, k)).reshape(R, L, W * k)
    for name, dt in (("float32", F32), ("bfloat16", BF16)):
        ft = fused.folded_table(_t(fine, F32, device), k, dt)
        yield name, (lambda ft=ft: fused.fused_transit_folded(ft, *rest),
                     lambda ft=ft: fused.transit_folded_plain(ft, *rest))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", DEEP_CASES)
def test_streamed_variant_matches_plain_on_card(cuda_device, shape):
    assert fused._transit_streamed(shape[1])
    wrapper = fused.fused_transit if shape[4] == 1 else \
        fused.fused_transit_folded
    for _, (kernel, plain) in _deep(shape, cuda_device):
        before = wrapper.launches
        got = kernel()
        ref = plain()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert bool(torch.isfinite(got).all())
        # 3xTF32 (or exact bfloat16) products summed in float32 in other
        # orders over up to 400 layers (chip_smoke.py's OUT_RTOL)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", DEEP_CASES[::2])
def test_streamed_variant_graphed_equals_eager_on_card(cuda_device, shape):
    for _, (kernel, _) in _deep(shape, cuda_device):
        eager = kernel()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kernel()                     # warm-up off the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = kernel()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static, eager)
        # and a second replay, after the scratch held the first one's ext
        static.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static, eager)
