"""The card's two old refusals, lifted: tables of 2^31 elements or more
and fine axes past the 65,535 tiles a grid's y extent holds, held on the
CPU.

(a) a torch emulation of the kernels' tile decomposition
    (csrc/hopper.cuh: tile_grid; ``fused._tile_grid``): every tile is
    visited once, the blocks past the last one do nothing, the straddle
    scratch is indexed by the tile's number, and up to 65,535 tiles the
    grid is the y-only grid of before;
(b) the wrappers' checks on meta-device tensors, which allocate nothing:
    the flagship's rtosamp = 128 table (3.3e9 elements), a 2.2 M-point
    transit axis, a 4.2 M-point eclipse axis are taken, while the limits
    that stay (the eclipse kernels' 32-bit weight offsets, fewer than
    2^31 - 64 points a row, the streamed transit variant's int item
    index) raise with their messages;
(c) the sources: no 65535 or 1ll << 31 guard is left in the launchers
    but the stated ones, and the tile index is read through grid_tile;
(d) the fold set-up written a few rows at a time (``folded_blocks``,
    the bin means in row chunks) equals the one-piece set-up bit for
    bit, and a folded forward at K = 128 on the small demo problem
    matches bart_tpu's ``batched()`` at float64, on its own tables and on
    the tables carried over with ``tables_from_jax``;
(e) the slice helpers of ``utils.slices`` that the card tests and
    ``chip_smoke.py --ceilings`` use.

The kernels themselves run only on the card: tests/test_torch_k1_mma.py
and tests/test_torch_folded.py hold them past both ceilings there (marked
gpu), and ``chip_smoke.py --ceilings`` at full width.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bart_tpu.obs.bands import build_band_matrix as jbands
from bart_tpu.opacity.grid import build_opacity_grid as jbuild
from bart_tpu.rt.forward import ForwardConfig as JConfig
from bart_tpu.rt.forward import ForwardModel as JModel

import bart_tpu_torch.rt.fused as fused
from bart_tpu_torch.demo import (DEMO_PARAMS, DEMO_PARAMS_TRANSIT,
                                 build_demo_model, demo_inputs)
from bart_tpu_torch.rt.forward import ForwardConfig, ForwardModel
from bart_tpu_torch.utils import slices
from bart_tpu_torch.utils.grids import folded_fine_grid

from test_torch_folded_forward import CONTINUUM, _params, _torch_grid

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
META = torch.device("meta")
CSRC = Path(fused.__file__).resolve().parents[1] / "csrc"


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------
# (a) the tile decomposition

@pytest.mark.parametrize("tile_w", [fused._F_MTILE_F, fused._FT_W])
@pytest.mark.parametrize("ntile", [1, 65535, 65536, 200001])
def test_tile_grid_visits_every_tile_once(ntile, tile_w):
    ny, nz = fused._tile_grid(ntile)
    assert 1 <= ny <= fused._MAX_GRID_YZ and 1 <= nz <= fused._MAX_GRID_YZ
    if ntile <= fused._MAX_GRID_YZ:
        assert (ny, nz) == (ntile, 1)        # the y-only grid of before
    # every block (y, z) as grid_tile() numbers it
    y = torch.arange(ny, dtype=torch.int64)
    z = torch.arange(nz, dtype=torch.int64)
    tile = (y[None, :] + ny * z[:, None]).reshape(-1)
    live = tile < ntile                      # the rest return at once
    assert int((~live).sum()) == ny * nz - ntile < nz
    np.testing.assert_array_equal(tile[live].sort().values.numpy(),
                                  np.arange(ntile))
    # the live tiles cover the fine axis once: F points in whole tiles
    # but the last
    F = ntile * tile_w - tile_w // 2
    f0 = tile[live] * tile_w
    hi = torch.clamp(f0 + tile_w, max=F)
    assert int((hi - f0).sum()) == F and int(f0.max()) < F
    # the straddle scratch [C][ntile][2]: a tile's partial sums sit at
    # c ntile + f0 / tile_w, its own number (the kernels' index)
    for c in (0, 3):
        idx = c * ntile + f0 // tile_w
        np.testing.assert_array_equal(idx.sort().values.numpy(),
                                      c * ntile + np.arange(ntile))


def test_tile_grid_matches_the_source():
    src = (CSRC / "hopper.cuh").read_text()
    assert "constexpr int kMaxGridYZ = 65535;" in src
    assert fused._MAX_GRID_YZ == 65535
    assert "const int nz = (ntile + kMaxGridYZ - 1) / kMaxGridYZ;" in src
    assert "return dim3(nx, (ntile + nz - 1) / nz, nz);" in src
    assert "return (int)(blockIdx.y + gridDim.y * blockIdx.z);" in src
    assert "constexpr int kMaxRow = 2147483647 - 63;" in src
    assert fused._MAX_ROW == 2147483647 - 63


# ---------------------------------------------------------------------
# (b) the wrappers' checks on meta tensors

def _m(*shape, dtype=F32):
    return torch.empty(*shape, dtype=dtype, device=META)


def _eclipse_meta(R, L, W, C, nmu=8):
    return (_m(W), _m(nmu), _m(nmu), _m(C, L, R), _m(C, L), _m(C, L))


@pytest.mark.parametrize("tdt,depth", [(BF16, 16), (F32, 8)])
def test_folded_eclipse_takes_the_flagship_at_k128(tdt, depth):
    # 122 rows x 100 layers x 2,088 bins x 128: 3.26e9 elements
    ft = fused.FoldedTable(_m(122, 100, 2088 * 128, dtype=tdt), 128, 2088)
    assert ft.tab.numel() > 1.5 * 2**31
    bf16, Rp = fused._eclipse_folded_args(ft, *_eclipse_meta(122, 100, 2088,
                                                             512), META)
    assert (bf16, Rp) == (int(tdt == BF16), -(-122 // depth) * depth)
    # 4.2 M fine points: 66,000 tiles of 64
    ft = fused.FoldedTable(_m(8, 16, 33000 * 128, dtype=tdt), 128, 33000)
    fused._eclipse_folded_args(ft, *_eclipse_meta(8, 16, 33000, 64), META)


def test_k1_eclipse_takes_a_big_table_and_a_long_axis():
    for R, L, W in ((122, 100, 176100), (8, 16, 4200000)):
        rt = fused.RowsTable(_m(R, L, W), W)
        tab32, w, Rp = fused._eclipse_args(rt, *_eclipse_meta(R, L, W, 512),
                                           META)
        assert w == W and tab32.shape == (R, L, W)
        assert -(-W // fused._TILE_W) > 65535 or R * L * W >= 2**31


@pytest.mark.parametrize("W", [2200000, 176100])
def test_transit_takes_a_long_axis_and_a_big_table(W):
    R = 41 if W > 1e6 else 122
    G = fused.prepare_slant(_m(512, 100, 100))
    rt = fused.RowsTable(_m(R, 100, W), W)
    assert fused._transit_args(rt, _m(512, 100, R), G, _m(512, 100),
                               META)[1] == W
    # a plain [R, L, W] table is prepared on the spot, padded to 16 bytes
    tab32 = fused._transit_args(_m(R, 100, W + 1), _m(512, 100, R), G,
                                _m(512, 100), META)[0]
    assert tab32.shape == (R, 100, W + 4)
    # folded: 2.2 M fine points at K = 128 and at K = 48 (a bin cut by
    # the 32-point tiles); a bfloat16 table of 2.2e9 elements
    for k, nb, rows in ((128, 17000, 8), (48, 45000, 8), (128, 4200, 41)):
        ft = fused.FoldedTable(_m(rows, 100, nb * k, dtype=BF16), k, nb)
        bf16, _, Rk = fused._transit_folded_args(
            ft, _m(512, 100, rows), G, _m(512, 100), META)
        assert bf16 == 1 and Rk == -(-rows // 16) * 16


def test_the_limits_that_stay_raise_with_their_messages():
    # the eclipse kernels' weights are indexed in 32 bits: C L Rp < 2^31
    C = 2**31 // (100 * 128) + 1
    rt = fused.RowsTable(_m(122, 100, 2000), 2000)
    with pytest.raises(ValueError, match="32-bit offsets"):
        fused._eclipse_args(rt, *_eclipse_meta(122, 100, 2000, C), META)
    ft = fused.FoldedTable(_m(122, 100, 2000 * 4, dtype=BF16), 4, 2000)
    with pytest.raises(ValueError, match="32-bit offsets"):
        fused._eclipse_folded_args(
            ft, *_eclipse_meta(122, 100, 2000, C // 3 + 1), META)
    # the transit kernels take 64-bit weight offsets
    G = fused.prepare_slant(_m(C, 4, 4))
    fused._transit_args(fused.RowsTable(_m(122, 4, 64), 64), _m(C, 4, 122),
                        G, _m(C, 4), META)
    # fewer than 2^31 - 64 points a row (they travel as int)
    n = fused._MAX_ROW
    with pytest.raises(ValueError, match="points a row"):
        fused._eclipse_args(fused.RowsTable(_m(1, 1, n), n),
                            *_eclipse_meta(1, 1, n, 1), META)
    fused._eclipse_args(fused.RowsTable(_m(1, 1, n - 4), n - 4),
                        *_eclipse_meta(1, 1, n - 4, 1), META)
    with pytest.raises(ValueError, match="points a row"):
        fused._transit_folded_args(
            fused.FoldedTable(_m(1, 4, n, dtype=BF16), 2, n // 2),
            _m(1, 4, 1), fused.prepare_slant(_m(1, 4, 4)), _m(1, 4), META)
    # the streamed transit variant's (chain block, tile) items are an int:
    # (32-chain block, 32-point tile) pairs
    with pytest.raises(ValueError, match="items"):
        fused._check_transit_fit("fn", 200, 2**28, True, 2**14)
    fused._check_transit_fit("fn", 200, 2**28, True, 2**13 - 32)
    fused._check_transit_fit("fn", 100, 2**28, True, 2**14)


# ---------------------------------------------------------------------
# (c) the sources

def test_no_grid_or_table_guard_is_left_but_the_stated_ones():
    stated = {
        "fused_eclipse.cu": ["(long long)C * L * Rp >= (1ll << 31))"],
        "fused_eclipse_folded.cu": [
            "Fp >= kMaxRow || (long long)NP * C * L * Rp >= (1ll << 31) ||"],
        "fused_transit_mma.cuh": [
            "if (stream_ext && (long long)ncb * ntile >= (1ll << 31))"],
        "hopper.cuh": ["constexpr int kMaxGridYZ = 65535;"],
    }
    found = {}
    for path in sorted(CSRC.iterdir()):
        for line in path.read_text().splitlines():
            code = line.split("//")[0]
            if "65535" in code or "1ll << 31" in code:
                found.setdefault(path.name, []).append(code.strip())
    assert found == stated
    # the eclipse kernels read their tile through grid_tile (no blockIdx.y
    # alone) and spread their tiles with tile_grid; the resident transit
    # kernel's persistent clusters walk (chain-block pair, tile) items
    # counted in 64 bits (the streamed variant its items)
    for name in ("fused_eclipse.cu", "fused_eclipse_folded.cu",
                 "fused_transit_mma.cuh"):
        src = (CSRC / name).read_text()
        if name == "fused_transit_mma.cuh":
            assert "const long long nitem = (long long)npair * ntile;" in src
            assert "blockIdx.y" not in src
        else:
            assert "grid_tile()" in src and "tile_grid(" in src
        assert not re.search(r"blockIdx\.y\s*\*", src)
        assert "gridDim.y" not in src
    # ... and the launchers refuse a row past kMaxRow
    for name in ("fused_eclipse.cu", "fused_eclipse_folded.cu",
                 "fused_transit_mma.cuh"):
        assert ">= kMaxRow" in (CSRC / name).read_text()
    py = Path(fused.__file__).read_text()
    assert "_MAX_GRID_Y " not in py and "beyond 2^31" not in py


# ---------------------------------------------------------------------
# (d) the fold set-up in pieces, and the forward at K = 128

def test_folded_blocks_in_pieces_equal_one_piece(monkeypatch):
    rng = np.random.default_rng(0)
    sig = torch.tensor(rng.lognormal(-46.0, 2.0, (7, 5, 9, 6)), dtype=F32)
    frows = torch.tensor(rng.uniform(0, 1, (3, 1, 9, 6)), dtype=F32
                         ).expand(3, 5, 9, 6)
    bins = torch.tensor([0, 2, 3, 8])
    whole = fused.folded_blocks([sig, frows], 6, BF16, bins)
    assert (whole.K, whole.W) == (6, 4) and whole.tab.shape == (10, 5, 24)
    ref = torch.cat([sig[:, :, bins], frows[:, :, bins]]).flatten(2)
    assert torch.equal(whole.tab, ref.to(BF16))
    monkeypatch.setattr(fused, "_COPY_ELEMS", 50)     # a row a piece
    assert fused._row_step(5 * 24) == 1
    pieces = fused.folded_blocks([sig, frows], 6, BF16, bins)
    assert torch.equal(pieces.tab, whole.tab)
    # folded_table pads the fine axis to 16 bytes with zeros, in pieces too
    ft = fused.folded_table(sig.flatten(2)[..., :54], 6, F32)
    assert ft.tab.shape == (7, 5, 56) and float(ft.tab[..., 54:].abs().sum()) == 0
    assert torch.equal(ft.bins(), sig)


NL, NW, K128 = 8, 64, 128


@pytest.fixture(scope="module")
def demo128():
    """The small demo problem on the 128-times-finer grid, its table
    built once by bart_tpu."""
    inp = demo_inputs(nlayer=NL, nwave=NW, nlines=300, t_step=520.0)
    grid = jbuild({"CH4": inp.lines}, folded_fine_grid(inp.wn, K128),
                  inp.t_grid, inp.pressure, cond_batch=80,
                  dtype=jnp.float64)
    return inp, grid


@pytest.mark.parametrize("geometry", ["eclipse", "transit"])
def test_folded_forward_at_k128_matches_bart_tpu(demo128, geometry,
                                                 monkeypatch):
    inp, grid = demo128
    transit = geometry == "transit"
    if transit:
        bands = jbands(inp.wn, inp.filters)
        kw = inp.transit_config_kwargs
    else:
        bands = jbands(inp.wn, inp.filters, star_flux=inp.star_flux,
                       rprs=inp.system.rprs)
        kw = inp.config_kwargs
    cfg = dict(quadrature="expsum", **kw, **CONTINUUM)
    common = dict(wn_grid=inp.wn, pressure=inp.pressure, species=inp.species,
                  base_abundances=inp.base_q, system=inp.system,
                  cia_tables=[inp.cia], fold_osamp=K128, fold_adapt=0.02)
    fmj = JModel(JConfig(**cfg), opacity=grid, bands=bands,
                 dtype=jnp.float64, **common)
    plain = build_demo_model(inp, dtype=F64, grid=_torch_grid(grid),
                             fold=K128, solution=geometry, device="cpu")

    def model():
        return ForwardModel(ForwardConfig(**cfg), opacity=plain.opacity,
                            bands=plain.bands, dtype=F64, device="cpu",
                            **common)

    fmt = model()
    ft = fmt.tables["tabk"]
    assert (ft.K, fmt.fold) == (K128, K128) and 0 < ft.W < NW
    np.testing.assert_array_equal(fmt._idx_fine, fmj._idx_fine)
    # the set-up a row at a time (as at the flagship's 3.3e9 elements)
    # gives the same tables bit for bit
    monkeypatch.setattr(fused, "_COPY_ELEMS", 1)
    pieces = model()
    monkeypatch.undo()
    assert fused._row_step(NL * NW * K128) > 1
    for key in ("tabk", "tabs"):
        assert torch.equal(pieces.tables[key].tab, fmt.tables[key].tab)
    assert torch.equal(pieces.tables["sigma"], fmt.tables["sigma"])
    tabs = fmt.tables_from_jax({k: np.asarray(v)
                                for k, v in fmj.tables.items()})
    P = _params(DEMO_PARAMS_TRANSIT if transit else DEMO_PARAMS)
    bj, sj, vj = fmj.batched()(jnp.asarray(P))
    for t in (None, tabs):              # its own tables, then the carried
        bt, st, vt = fmt(torch.tensor(P), t)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-9)
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-9)


# ---------------------------------------------------------------------
# (e) the slice helpers

@pytest.mark.parametrize("W,K,tile,per_row", [
    (2088, 128, 64, 12200), (176100, 1, 64, 12200), (176100, 1, 32, 12200),
    (4200000, 1, 64, 128), (2200000, 1, 32, 128), (45000, 48, 32, 128),
    (4200, 128, 32, 4100), (33000, 128, 64, 128), (300, 3, 32, 10)])
def test_slice_edges_cut_on_tiles_under_both_old_ceilings(W, K, tile,
                                                          per_row):
    edges = slices.slice_edges(W, K, tile, per_row)
    assert edges[0] == 0 and edges[-1] == W
    assert all(a < b for a, b in zip(edges, edges[1:]))
    for a, b in zip(edges, edges[1:]):
        assert (b - a) * K * per_row < 2**31
        assert -(-(b - a) * K // tile) <= 65535
        assert a * K % tile == 0              # a slice starts a tile
    past = W * K * per_row >= 2**31 or -(-W * K // tile) > 65535
    assert (len(edges) > 2) == past


def test_table_slices_and_launch_by_slices():
    rng = np.random.default_rng(1)
    raw = torch.tensor(rng.uniform(0, 1, (3, 4, 40 * 6)), dtype=F32)
    ft = fused.FoldedTable(raw, 6, 40)
    part = slices.table_slice(ft, 16, 32)
    assert isinstance(part, fused.FoldedTable) and (part.K, part.W) == (6, 16)
    assert torch.equal(part.bins(), ft.bins()[:, :, 16:32])
    rt = fused.RowsTable(raw, 240)
    p = slices.table_slice(rt, 64, 130)
    assert isinstance(p, fused.RowsTable) and p.tab.shape == (3, 4, 68)
    assert torch.equal(p.plain(), raw[..., 64:130])
    # a launch that reads each bin's own columns gives the whole's bits
    got = slices.launch_by_slices(
        lambda t, b0, b1: t.bins().sum((0, 3)), ft, [0, 16, 32, 40])
    assert torch.equal(got, ft.bins().sum((0, 3)))
    tab = slices.random_table((2, 3, 1000), BF16, 5, torch.device("cpu"))
    assert tab.dtype == BF16 and bool((tab > 0).all())
    assert torch.equal(tab, slices.random_table((2, 3, 1000), BF16, 5,
                                                torch.device("cpu")))


@pytest.mark.parametrize("name", sorted(slices.TILE))
def test_problem_on_the_cpu_is_the_plain_path(name):
    K = 4 if "folded" in name else 1
    pb = slices.problem(name, 5, 6, 40, K, 7, F32, 2, torch.device("cpu"))
    got = pb.launch(pb.tab, 0, 40)
    assert got.shape == (7, 40) and bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(pb.plain(pb.tab, 0, 40, 3).numpy(),
                                  got[:3].numpy())
