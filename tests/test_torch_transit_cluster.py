"""The resident transit kernel as thread-block clusters
(csrc/fused_transit_mma.cuh): the grid padded to whole clusters, the
hand-offs between the producer, the fill warps and the slant warps, and
the shared-memory layouts the TMA writes (swizzled boxes, no padding),
checked against the source on the CPU; the kernel itself on the card
(``-m gpu``)."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from bart_tpu_torch.demo import fine_structure, random_transit_rows
from bart_tpu_torch.rt import fused

F32 = torch.float32


def _src() -> str:
    return (fused._CSRC / "fused_transit_mma.cuh").read_text()


def _macros(src):
    return {m: int(v) for m, v in re.findall(r"#define (\w+) (\d+)\b", src)}


# ---------------------------------------------------------------------
# (a) the persistent clusters' items

ITEM_CASES = [(512, 1125), (512, 79), (6, 79), (17, 3), (33, 65535),
              (64, 65536), (64, 68750), (1, 1), (9, 131071),
              (10**6, 2**26 - 2)]


def _cxx_items(src, ncb, ntile):
    """The launcher's item count as the source computes it."""
    env = {**_macros(src), "ncb": ncb, "ntile": ntile}
    npair = re.search(r"const int npair = ([^;]+);", src).group(1)
    env["npair"] = eval(npair.replace("/", "//"), {"__builtins__": {}}, env)
    nitem = re.search(r"const long long nitem = \(long long\)([^;]+);",
                      src).group(1)
    return env["npair"], eval(nitem, {"__builtins__": {}}, env)


@pytest.mark.parametrize("C,ntile", ITEM_CASES)
def test_cluster_items_cover_every_chain_block_and_tile(C, ntile):
    npair, nitem = fused._transit_cluster_items(C, ntile)
    ncb = -(-C // fused._FT_CB)
    # pairs of chain blocks (the last one may be half past C), every tile
    assert npair * fused._FT_CX >= ncb > (npair - 1) * fused._FT_CX
    assert nitem == npair * ntile
    assert (npair, nitem) == _cxx_items(_src(), ncb, ntile)
    # a cluster's items, and the chain block and tile of each, as the
    # kernel walks them (k0 + n ncl, pairs fastest): every (chain block,
    # tile) once, over a few cluster counts
    if nitem <= 5000:
        for ncl in sorted({1, 7, min(66, nitem), nitem}):
            seen = []
            for k0 in range(ncl):
                nit = (nitem - 1 - k0) // ncl + 1
                for n in range(nit):
                    it = k0 + n * ncl
                    for cx in range(fused._FT_CX):
                        seen.append(((it % npair) * fused._FT_CX + cx,
                                     it // npair))
            assert sorted(seen) == sorted(
                (cb, tl) for cb in range(npair * fused._FT_CX)
                for tl in range(ntile))


def test_cluster_launch_is_the_resident_launch():
    src = _src()
    assert re.search(r"cudaLaunchKernelEx\(\s*&cfg, fused_transit_mma_kernel",
                     src)
    assert "cudaLaunchAttributeClusterDimension" in src
    assert "attr[0].val.clusterDim.x = FT_CX;" in src
    assert "attr[0].val.clusterDim.y = 1;" in src
    # as many clusters as the card holds at once, or as there are items
    assert "cudaOccupancyMaxActiveClusters(n, kernel, &cfg)" in src
    assert "const int ncl = nitem < nmax ? (int)nitem : nmax;" in src
    # no block returns before the cluster's barriers (the parent's early
    # return past the last tile is gone): one barrier at each end
    kernel = src[src.index("fused_transit_mma_kernel("):
                 src.index("fused_transit_stream_kernel(")]
    assert "tile >= ntile) return;" not in kernel
    assert kernel.count("cluster_sync();") == 2
    # the refused launch returns its error: no other path is taken
    assert "if (el != cudaSuccess) return (int)el;" in src
    assert fused.transit_cluster_info.__doc__


# ---------------------------------------------------------------------
# (b) the hand-offs: who copies to whom, who releases to whom


def test_every_release_goes_to_a_block_that_sent_bytes():
    src = _src()
    cx_n = fused._FT_CX
    # the source's release ranks and slot counts
    assert "const unsigned rel_rank = lane < FT_CX ? lane : cx;" in src
    assert "if (lane <= FT_CX) mbar_arrive_cluster(empty_f + s, rel_rank);" \
        in src
    assert "mbar_init(empty_f + i, FT_CX + 1);" in src
    for cx in range(cx_n):
        # a unit reaches block cx from both blocks (the table's halves) and
        # from itself (its weights): its lanes 0 .. FT_CX release to these
        senders = set(range(cx_n)) | {cx}
        rel = [lane for lane in range(cx_n)] + [cx]
        assert set(rel) == senders
    # each block's slot completes after exactly the arrivals it receives
    for x in range(cx_n):
        got = sum(([lane for lane in range(cx_n)] + [cx]).count(x)
                  for cx in range(cx_n))
        assert got == cx_n + 1


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("L,Rp", [(1, 8), (2, 16), (100, 48), (23, 16),
                                  (112, 232), (57, 512), (9, 48)])
def test_producer_lanes_take_every_unit_once(bf16, L, Rp):
    nf = fused._FT_NF
    ns = fused._FT_NS if bf16 else fused._FT_NS32
    nch = -(-Rp // fused._FT_UR)
    lp_n = (L + 1) // 2
    jb = min(ns, nch)
    assert nf * jb <= 32                      # one lane a (ring, jj)
    issued = {}
    for lane in range(32):
        fw, jj = lane % nf, lane // nf
        nu = ((lp_n - fw + nf - 1) // nf) * nch if jj < jb else 0
        for i in range(jj, nu, jb):
            assert (fw, i) not in issued
            issued[(fw, i)] = (fw + nf * (i // nch), i % nch)
    # the fill warps take exactly these units, in this order
    want = {}
    for fw in range(nf):
        i = 0
        for lp in range(fw, lp_n, nf):
            for j in range(nch):
                want[(fw, i)] = (lp, j)
                i += 1
    assert issued == want
    # the lanes of one ring never wait on one slot at once
    assert jb <= ns
    # across items, each lane's counters (item n, unit i, slot sm, use sd)
    # run without division as the source keeps them: they equal divmod
    for lane in range(nf * jb):
        fw, jj = lane % nf, lane // nf
        nu = ((lp_n - fw + nf - 1) // nf) * nch if lp_n > fw else 0
        if not nu:
            continue
        n, i, sm, sd = 0, jj, jj, 0
        for gi in range(jj, 4 * nu, jb):
            while i >= nu:
                i -= nu
                n += 1
            assert (n, i, sm, sd) == (gi // nu, gi % nu, gi % ns, gi // ns)
            i += jb
            sm += jb
            if sm >= ns:
                sm -= ns
                sd += 1


def test_ext_ring_and_fill_warps_cover_every_step():
    # every fill warp writes a layer in every step of 8 layers (so no ext
    # slot can lag two phases behind a writer), and the ring is deeper
    # than the two phases a wait tells apart
    nf, ne = fused._FT_NF, fused._FT_NE
    for s in range(2 * fused._FT_MT):
        pairs = range(4 * s, 4 * s + 4)
        assert {lp % nf for lp in pairs} == set(range(nf))
    assert ne >= 2 and ne % 2 == 0


# ---------------------------------------------------------------------
# (c) the layouts the TMA writes: swizzled, and every load hits all banks


def _tab_off(bf16, r, c):
    return (64 * r + 16 * (c ^ ((r >> 1) & 3)) if bf16
            else 128 * r + 16 * (c ^ (r & 7)))


def _wgt_off(q, c):
    return 128 * q + 16 * (c ^ (q & 7))


def _col32(m, h, g):
    return 16 * (g >> 2) + 8 * m + 4 * h + (g & 3)


def _sig(n):
    return ((n & 3) << 1) | (n >> 2)


def test_swizzle_helpers_are_the_sources():
    src = _src()
    assert ("return kBf16 ? 64 * r + 16 * (c ^ ((r >> 1) & 3)) : 128 * r + "
            "16 * (c ^ (r & 7));") in src
    assert "return 128 * q + 16 * (c ^ (q & 7));" in src
    assert "return 16 * (g >> 2) + 8 * m + 4 * h + (g & 3);" in src
    assert "const int qg = ((g & 3) << 1) | (g >> 2);" in src
    assert "CU_TENSOR_MAP_SWIZZLE_64B" in src and \
        "CU_TENSOR_MAP_SWIZZLE_128B" in src
    # bijections: the float32 fill's wavenumbers and the chains
    assert sorted(_col32(m, h, g) for m in range(2) for h in range(2)
                  for g in range(8)) == list(range(32))
    assert sorted(_sig(n) for n in range(8)) == list(range(8))


@pytest.mark.parametrize("bf16", [True, False])
def test_fill_loads_hit_every_bank(bf16):
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    if bf16:
        # ldmatrix.x4.trans: matrix j's 8 rows (lanes 8 j .. 8 j + 7) are
        # 16-byte rows of distinct bank groups
        for kk in range(2):
            for m in range(2):
                r = 16 * kk + (lanes & 7) + ((lanes >> 4) << 3)
                c = 2 * m + ((lanes >> 3) & 1)
                offs = np.array([_tab_off(True, int(a), int(b))
                                 for a, b in zip(r, c)])
                for j in range(4):
                    units = (offs[8 * j:8 * j + 8] // 16) % 8
                    assert len(set(units)) == 8
        # the weights' 8-byte loads, a half-warp at a time: 32 banks
        for kk in range(2):
            for half in (0, 8):
                k0 = 16 * kk + 2 * t + half
                words = np.array([_wgt_off(_sig(int(a)), int(b) >> 2) // 4
                                  for a, b in zip(g, k0)]) + (k0 & 3)
                for hw in (slice(0, 16), slice(16, 32)):
                    w = words[hw]
                    assert len(set(np.concatenate([w % 32, (w + 1) % 32]))) \
                        == 32
    else:
        # the A fragment's four loads: 32 distinct banks each
        for kk in range(4):
            for m in range(2):
                for h in range(2):
                    for dr in (0, 4):
                        row = 8 * kk + t + dr
                        col = np.array([_col32(m, h, int(a)) for a in g])
                        words = np.array([_tab_off(False, int(a), int(b) >> 2)
                                          // 4 for a, b in zip(row, col)]) \
                            + (col & 3)
                        assert len(set(words % 32)) == 32
        # the B fragment's two loads
        for kk in range(4):
            for dr in (0, 4):
                k0 = 8 * kk + t + dr
                words = np.array([_wgt_off(_sig(int(a)), int(b) >> 2) // 4
                                  for a, b in zip(g, k0)]) + (k0 & 3)
                assert len(set(words % 32)) == 32
    # the slant's G loads from dense 8-float rows: a lane reads k = t + h0
    # first, so rows g and g + 8 hit all banks in either load
    h0 = 4 * ((g >> 2) & 1)
    for mt in range(fused._FT_MT):
        for rows in (16 * mt + g, 16 * mt + g + 8):
            for first in (True, False):
                words = rows * 8 + t + (h0 if first else 4 - h0)
                assert len(set(words % 32)) == 32


# ---------------------------------------------------------------------
# (d) on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from bart_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _rows(R, L, W, C, device, dtype=F32):
    # one layer: the first layer of a two-layer problem (the generator
    # needs two)
    tab, wrows, G, wgt = [torch.tensor(a, dtype=dtype, device=device)
                          for a in random_transit_rows(R, max(L, 2), W,
                                                       C)[:4]]
    return [tab[:, :L].contiguous(), wrows[:, :L].contiguous(),
            G[:, :L, :L].contiguous(), wgt[:, :L].contiguous()]


def _folded(tab, K, table_dtype):
    R, L, W = tab.shape
    factor = torch.tensor(fine_structure(R, W, K), dtype=F32,
                          device=tab.device)
    fine = (tab[..., None] * factor).reshape(R, L, W * K)
    return fused.folded_table(fine, K, table_dtype)


@pytest.mark.gpu
def test_cluster_info_on_card(cuda_device):
    for L, bf16 in ((100, True), (100, False), (112, True), (1, False)):
        info = fused.transit_cluster_info(L, bf16)
        assert info["cluster"] == (fused._FT_CX, 1)
        assert info["max_active_clusters"] >= 1
        assert info["smem_bytes"] == fused._transit_mma_smem(L, bf16)


@pytest.mark.gpu
@pytest.mark.parametrize("L", range(1, 113))
def test_every_resident_layer_count_matches_plain_on_card(cuda_device, L):
    tab, wrows, G, wgt = _rows(9, L, 70, 5, cuda_device)
    np.testing.assert_allclose(
        fused.fused_transit(tab, wrows, G, wgt).cpu().numpy(),
        fused.transit_plain(tab, wrows, G, wgt).cpu().numpy(), rtol=1e-5)
    for table_dtype in (torch.bfloat16, F32):
        ft = _folded(tab, 2, table_dtype)
        np.testing.assert_allclose(
            fused.fused_transit_folded(ft, wrows, G, wgt).cpu().numpy(),
            fused.transit_folded_plain(ft, wrows, G, wgt).cpu().numpy(),
            rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 6, 17, 33])
@pytest.mark.parametrize("K", [1, 3, 8, 48])
def test_padded_chains_tiles_and_straddles_on_card(cuda_device, C, K):
    # chain blocks not a multiple of the cluster's, tiles cut by K (a
    # straddling K's second launch), a last tile cut by the row's end
    W = 97 if K == 1 else 41
    tab, wrows, G, wgt = _rows(23, 37, W, C, cuda_device)
    before = (fused.fused_transit.launches,
              fused.fused_transit_folded.launches)
    if K == 1:
        got = fused.fused_transit(tab, wrows, G, wgt)
        ref = fused.transit_plain(tab, wrows, G, wgt)
    else:
        ft = _folded(tab, K, torch.bfloat16)
        got = fused.fused_transit_folded(ft, wrows, G, wgt)
        ref = fused.transit_folded_plain(ft, wrows, G, wgt)
    torch.cuda.synchronize()
    assert (fused.fused_transit.launches,
            fused.fused_transit_folded.launches) == (
        before[0] + (K == 1), before[1] + (K > 1))
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5)


@pytest.mark.gpu
def test_grid_past_65535_tiles_in_a_cluster_launch(cuda_device):
    # 65,539 tiles of 32 points: the persistent clusters walk them as items
    W = 32 * 65539 - 5
    assert fused._transit_cluster_items(3, -(-W // 32))[1] > 65535
    tab, wrows, G, wgt = _rows(2, 3, W, 3, cuda_device)
    got = fused.fused_transit(tab, wrows, G, wgt)
    ref = fused.transit_plain(tab, wrows, G, wgt)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5)


@pytest.mark.gpu
def test_graphed_cluster_launch_equals_eager_on_card(cuda_device):
    tab, wrows, G, wgt = _rows(41, 100, 300, 17, cuda_device)
    ft = _folded(tab, 32, torch.bfloat16)
    Gp = fused.prepare_slant(G)
    rt = fused.rows_table(tab)
    eager = (fused.fused_transit(rt, wrows, Gp, wgt),
             fused.fused_transit_folded(ft, wrows, Gp, wgt))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = (fused.fused_transit(rt, wrows, Gp, wgt),
                fused.fused_transit_folded(ft, wrows, Gp, wgt))
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager, outs):
        assert torch.equal(a, b)
