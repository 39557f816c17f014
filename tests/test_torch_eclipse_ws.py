"""The folded eclipse kernel's blocks on the TMA and mbarriers
(csrc/fused_eclipse_folded.cu): the grid over chain blocks and tiles, the
stage ring's hand-offs between the issuing thread and the eight warps
(the bfloat16 fill's products issued a layer ahead), its shared memory,
the layouts the TMA writes (swizzled boxes, no padding) with the float32
fragment loads' banks and the bfloat16 wgmma descriptors that read them,
checked against the source on the CPU; the kernel itself on the card
(``-m gpu``)."""

from __future__ import annotations

import random
import re

import numpy as np
import pytest
import torch

from bart_tpu_torch.demo import fine_structure, random_rows
from bart_tpu_torch.rt import fused
from bart_tpu_torch.rt.eclipse import expsum_weights, raygrid_weights

F32, BF16 = torch.float32, torch.bfloat16


def _src() -> str:
    return (fused._CSRC / "fused_eclipse_folded.cu").read_text()


def _macros(src):
    return {m: int(v) for m, v in re.findall(r"#define (\w+) (\d+)\b", src)}


def _py(expr: str) -> str:
    """A C expression of the source as Python: casts dropped, integer
    division, right-nested ``a ? b : c`` as conditionals."""
    return _ternary(re.sub(r"\((size_t|int)\)", "", expr).replace("/", "//"))


def _ternary(expr: str) -> str:
    expr = expr.strip()
    depth, q = 0, None
    for i, ch in enumerate(expr):
        depth += ch == "("
        depth -= ch == ")"
        if ch == "?" and depth == 0:
            q = i
            break
    if q is None:
        return expr
    depth, nest = 0, 0
    for i in range(q + 1, len(expr)):
        ch = expr[i]
        depth += ch == "("
        depth -= ch == ")"
        if depth == 0 and ch == "?":
            nest += 1
        elif depth == 0 and ch == ":":
            if nest == 0:
                return (f"(({_ternary(expr[q + 1:i])}) if ({expr[:q]}) "
                        f"else ({_ternary(expr[i + 1:])}))")
            nest -= 1
    raise ValueError(expr)


def _functions(src):
    """The source's constexpr helpers and constants as Python: env with
    the macros and the functions fold_bins, stage_rows, mma_stage_bytes,
    mma_smem_bytes, col32."""
    env = {**_macros(src), "__builtins__": {}}
    for name in ("fold_bins", "stage_rows", "mma_stage_bytes",
                 "mma_smem_bytes", "col32"):
        m = re.search(rf"constexpr \w+ {name}\(([^)]*)\) {{\s*return "
                      rf"(.*?);\s*}}", src, re.S)
        params = [p.split()[-1] for p in m.group(1).split(",")]
        body = _py(" ".join(m.group(2).split()))
        env[name] = eval(f"lambda {', '.join(params)}: {body}", env)
    return env


# ---------------------------------------------------------------------
# (a) the grid: chain blocks x tiles

GRID_CASES = [(512, 1125 * 32 // 64), (512, 1044), (6, 79), (17, 3),
              (33, 65535), (64, 65536), (64, 66000), (1, 1), (9, 131071)]


@pytest.mark.parametrize("C,ntile", GRID_CASES)
def test_grid_covers_every_chain_block_and_tile(C, ntile):
    src = _src()
    # the parent's grid: x the chain blocks, the tiles over y and z
    # (hopper.cuh: tile_grid); a block past the last tile returns before
    # its barriers are set up
    assert ("<<<tile_grid((C + CBM - 1) / CBM, ntile), MTHREADS, smem, "
            "stream>>>(") in src
    flat = " ".join(src.split())
    assert ("const int tile = grid_tile(); if (tile >= ntile) return; "
            "// past the last tile (tile_grid) constexpr bool kBf16") in flat
    assert "const int c0 = blockIdx.x * CBM;" in src
    nchb = -(-C // fused._F_CBM)
    ny, nz = fused._tile_grid(ntile)
    assert ny * nz >= ntile > ny * nz - nz
    # every (chain block, tile) once; a chain block past C is whole
    # blocks of padded chains (zero weights, nothing written)
    assert nchb * fused._F_CBM >= C > (nchb - 1) * fused._F_CBM
    if ntile <= 70000:
        tiles = sorted(y + ny * z for z in range(nz) for y in range(ny)
                       if y + ny * z < ntile)
        assert tiles == list(range(ntile))


# ---------------------------------------------------------------------
# (b) the stage ring's hand-offs, modelled


class _Bar:
    """An mbarrier: ``count`` arrivals and the transaction bytes complete
    a phase; wait(parity) passes once the phase of that parity completed
    (a fresh barrier counts the phase before the first as completed)."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, tx=0):
        self.tx += tx
        self.pending -= 1
        assert self.pending >= 0, "more arrivals than the phase expects"
        self._check()

    def land(self, nbytes):
        self.tx -= nbytes
        self._check()

    def _check(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def ready(self, parity):
        return (self.phase & 1) != parity


def _schedule(L, nch, ahead, seed, SB=1000):
    """Run the source's block under a random interleaving of its 8 warps
    and the TMA's copies.  Stage s (chunk s % nch of layer s / nch) lands
    in slot s % NSTAGE and completes that slot's full mbarrier; thread 0
    (warp 0) sends, after the block's barrier:
    - a stage at a time: stage s + NSTAGE - 1 after the barrier of stage
      s, whose wait every warp passed first;
    - ``ahead`` (bfloat16, a layer's products issued a layer before its
      recurrence): layer l + NSTAGE / nch's stages after the barrier of
      layer l, which every warp reaches once its products of layer l are
      complete.
    A warp is done with a stage once its products of it are complete (a
    stage at a time: at once; ahead: at the next layer's wait).  Every
    stage must be sent once and read by every warp once, in order, no
    slot refilled before every warp is done with it, nothing waiting
    forever."""
    ns, nw = fused._F_NSTAGE, fused._F_MTHREADS // 32
    full = [_Bar(1) for _ in range(ns)]
    ring = [None] * ns
    done = [set() for _ in range(ns)]  # warps done with the slot's stage
    landing, sent = [], []
    nstage = L * nch
    sync = {"count": 0, "gen": 0}

    def send(s):
        if s >= nstage:
            return
        slot = s % ns
        assert ring[slot] is None or len(done[slot]) == nw
        full[slot].arrive(SB)
        landing.append((slot, s))
        sent.append(s)

    def barrier():
        gen = sync["gen"]
        sync["count"] += 1
        if sync["count"] == nw:
            sync["count"], sync["gen"] = 0, gen + 1
        yield ("bar", gen)

    def wait(s):
        yield (full[s % ns], (s // ns) & 1)
        assert ring[s % ns] == s

    def warp(w):
        if not ahead:
            if w == 0:
                for s in range(ns - 1):
                    send(s)
            for s in range(nstage):
                yield from wait(s)
                yield from barrier()
                if w == 0:
                    send(s + ns - 1)
                done[s % ns].add(w)
            return
        la = ns // nch
        if w == 0:
            for s in range(min(ns, nstage)):
                send(s)
        issued = list(range(nch))                 # layer 0's stages
        for s in issued:
            yield from wait(s)
        for l in range(L):
            for s in issued:                      # products complete
                done[s % ns].add(w)
            yield from barrier()
            if w == 0 and l + la < L:
                for k in range(nch):
                    send((l + la) * nch + k)
            issued = [(l + 1) * nch + k for k in range(nch)] \
                if l + 1 < L else []
            for s in issued:
                yield from wait(s)

    roles = {f"w{w}": warp(w) for w in range(nw)}
    waits = {}
    for name, gen in roles.items():
        try:
            waits[name] = next(gen)
        except StopIteration:
            pass
    rng = random.Random(seed)

    def ready(cond):
        if cond[0] == "bar":
            return sync["gen"] > cond[1]
        return cond[0].ready(cond[1])

    while waits or landing:
        runnable = [n for n, c in waits.items() if ready(c)]
        if landing and (not runnable or rng.random() < 0.3):
            slot, stage = landing.pop(rng.randrange(len(landing)))
            ring[slot], done[slot] = stage, set()
            full[slot].land(SB)
            continue
        assert runnable, f"deadlock: {sorted(waits)}"
        name = rng.choice(runnable)
        try:
            waits[name] = next(roles[name])
        except StopIteration:
            del waits[name]
    return sent


@pytest.mark.parametrize("L,nch,ahead", [
    (3, 1, True), (5, 2, True), (1, 1, True), (100, 1, True), (7, 2, True),
    (1, 2, True), (4, 8, False), (9, 1, False), (5, 2, False),
    (100, 2, False), (2, 1, False), (1, 3, False)])
def test_stage_ring_sends_and_reads_every_stage_once(L, nch, ahead):
    for seed in range(3):
        assert _schedule(L, nch, ahead, seed) == list(range(L * nch))


def test_stage_ring_is_the_sources():
    src = _src()
    flat = " ".join(src.split())
    for line in ("mbar_init(full + i, 1);",
                 "mbar_arrive_expect_tx(bar, (unsigned)SB);",
                 "mbar_wait(full + s % NSTAGE, (unsigned)(s / NSTAGE) & 1);"
                 " __syncthreads();",
                 "if (tid == 0) send_next(s + NSTAGE - 1);",
                 "if (kBf16 && 2 * nch <= NSTAGE) {",
                 "const int LA = NSTAGE / nch;",
                 "if (tid == 0 && l + LA < L) for (int k = 0; k < nch; ++k) "
                 "copy_stage((l + LA) * nch + k, l + LA, k * RS);",
                 "wgmma_wait0(); fence_acc(acc); float ext[8]; "
                 "take_ext(ext); __syncthreads();",
                 "if (l + 1 < L) issue_layer(l + 1); layer_step(l, ext);"):
        assert line in flat, line
    # the bfloat16 layers of the flagship's 122 rows (two chunks) run
    # ahead in the ring; 137 and 512 rows (three, eight) a stage at a time
    for R, ahead in ((16, True), (27, True), (64, True), (122, True),
                     (128, True), (137, False), (512, False)):
        Rp = -(-R // 16) * 16
        nch = -(-Rp // fused._eclipse_stage_rows(Rp, 2))
        assert (2 * nch <= fused._F_NSTAGE) == ahead


# ---------------------------------------------------------------------
# (c) shared memory

SMEM_RS = (8, 16, 27, 41, 64, 65, 122, 512)


@pytest.mark.parametrize("bf16", [True, False])
def test_smem_formula_is_the_sources(bf16):
    src = _src()
    fn = _functions(src)
    for macro, value in (("MTILE_F", fused._F_MTILE_F), ("CBM", fused._F_CBM),
                         ("NSTAGE", fused._F_NSTAGE),
                         ("MTHREADS", fused._F_MTHREADS), ("RCH", fused._RCH)):
        assert fn[macro] == value, macro
    eb, parts, depth = (2, 3, 16) if bf16 else (4, 1, 8)
    for R in SMEM_RS:
        Rp = -(-R // depth) * depth
        RS = fn["stage_rows"](Rp, eb)
        assert RS == fused._eclipse_stage_rows(Rp, eb)
        # a power of two, whole k-steps, at least Rp or a chunk
        assert RS & (RS - 1) == 0 and RS % depth == 0
        assert RS >= Rp or RS == fused._RCH
        for K in range(2, 257):
            want = fn["mma_smem_bytes"](RS, K, eb, parts)
            assert fused._eclipse_folded_smem(R, K, bf16) == want
            # two blocks an SM (228 KB, 1 KB of it reserved a block)
            assert 2 * (want + 1024) <= 233472
        sb = fn["mma_stage_bytes"](RS, eb, parts)
        # the boxes keep the swizzle's 1024-byte period: stages, their
        # table tiles, their weights (float32: each 32-row box)
        assert sb % 1024 == 0 and (RS * 64 * eb) % 1024 == 0
        rsi = RS if RS * eb <= 128 else 128 // eb
        assert (fused._F_CBM * rsi * eb) % 1024 == 0 or bf16
        assert (parts * fused._F_CBM * RS * eb) % 1024 == 0
        # the epilogue's sums [CBM][MTILE_F + 4] reuse the ring
        assert fused._F_NSTAGE * sb >= 4 * fused._F_CBM * (
            fused._F_MTILE_F + 4)
        # K = 2 (32 bins a tile) takes the most
        assert fused._eclipse_folded_smem(R, 2, bf16) == max(
            fused._eclipse_folded_smem(R, K, bf16) for K in range(2, 257))
    assert "float* v_s = reinterpret_cast<float*>(ring);     // [CBM][VS]" \
        in src
    assert fused._eclipse_folded_smem(27, 32, True) == 42528
    assert fused._eclipse_folded_smem(27, 32, False) == 50720
    assert fused._eclipse_folded_smem(122, 32, True) == 83488


# ---------------------------------------------------------------------
# (d) the swizzled layouts: float32 fragment loads, bfloat16 descriptors


def _swz(o, m):
    return o ^ (((o >> 7) & m) << 4)


def test_swizzle_helpers_are_the_sources():
    src = _src()
    assert "return o ^ (((o >> 7) & m) << 4);" in src
    assert "return 16 * (g >> 2) + 8 * m + 4 * h + (g & 3);" in src
    fn = _functions(src)
    assert sorted(fn["col32"](m, h, gi) for m in range(2) for h in range(2)
                  for gi in range(8)) == list(range(32))
    # the TMA's swizzle of each weight row width (SWIZZLE_32B, 64B, 128B)
    assert "wrow == 32   ? CU_TENSOR_MAP_SWIZZLE_32B" in src
    assert ": wrow == 64 ? CU_TENSOR_MAP_SWIZZLE_64B" in src
    assert "const int WM = RSI * EB / 16 - 1;" in src


@pytest.mark.parametrize("RS", [8, 16, 32, 64])
def test_f32_fragment_loads_hit_every_bank(RS):
    # A from the warp's 32-point box of the tile (128-byte swizzled rows;
    # mma row g + 8 h of the m-tile of warp pair member m is point
    # col32(m, h, g)), B from chain q = ch + 8 nt + g's swizzled row of rsi
    # floats (two boxes of 32 rows at RS = 64)
    g, t = np.divmod(np.arange(32), 4)
    rsi = min(RS, 32)
    WM = rsi * 4 // 16 - 1
    for ks in range(RS // 8):
        for dk in (0, 4):
            row = t + dk
            for m in range(2):
                for h in range(2):
                    pt = 16 * (g >> 2) + 8 * m + 4 * h + (g & 3)
                    a = [1024 * ks + _swz(128 * int(r) + 4 * int(p), 7)
                         for r, p in zip(row, pt)]
                    assert len({x // 4 % 32 for x in a}) == 32
            k = 8 * ks + t + dk
            for Q0 in range(0, 32, 8):
                q = Q0 + g
                b = [(int(kk) >> (rsi.bit_length() - 1)) * (32 * rsi * 4)
                     + _swz(4 * (int(qq) * rsi + int(kk) % rsi), WM)
                     for qq, kk in zip(q, k)]
                assert len({x // 4 % 32 for x in b}) == 32


def _tma_offset(row, col, row_bytes, eb):
    """Byte offset of element (row, col) of a box of rows of ``row_bytes``
    written by the TMA with the swizzle of that width."""
    return _swz(row * row_bytes + col * eb, row_bytes // 16 - 1)


def _gmma_offset(desc, mn, k, mn_major, row_bytes):
    """The canonical wgmma layout's byte offset of element (mn, k) of a
    bfloat16 operand whose descriptor has (start, lbo, sbo) and a swizzle
    of rows of ``row_bytes``: K-major, 8-row groups of MN sbo apart, K
    within the row; MN-major, 8-row groups of K sbo apart, MN within the
    row (one atom of 64 elements), before the swizzle of the address."""
    start, lbo, sbo = desc
    if mn_major:
        o = start + (k // 8) * sbo + (k % 8) * row_bytes + 2 * mn
    else:
        o = start + (mn // 8) * sbo + (mn % 8) * row_bytes + 2 * k
    return _swz(o, row_bytes // 16 - 1)


@pytest.mark.parametrize("RS", [16, 32, 64])
def test_bf16_wgmma_descriptors_read_the_tma_layout(RS):
    src = _src()
    assert "gmma_desc(st + 2048 * ks, 1024, 1024, 1)" in src
    assert " ".join("""gmma_desc(wb + 2 * (((p * CBM + 16 * wg) << RSH)
        + 16 * ks), 16, 16 * RS, wsw);""".split()) in " ".join(src.split())
    assert "const unsigned wsw = RS == 64 ? 1u : RS == 32 ? 2u : 3u;" in src
    assert "%8, %9, p, 1, 1, 1, 0;" in src      # A transposed (M-major)
    # A: the table tile [RS][64 points], 128-byte rows; k-step ks reads
    # rows 16 ks .. + 15 for all 64 points
    for ks in range(RS // 16):
        for m in range(64):
            for k in range(16):
                assert _gmma_offset((2048 * ks, 1024, 1024), m, k, True,
                                    128) == _tma_offset(16 * ks + k, m, 128,
                                                        2)
    # B: part p's chains 16 wg .. + 15, rows of RS bfloat16 (RS * 2 bytes)
    wb = 2 * RS
    for p in range(3):
        for wg in range(2):
            for ks in range(RS // 16):
                start = 2 * ((p * 32 + 16 * wg) * RS + 16 * ks)
                for n in range(16):
                    for k in range(16):
                        got = _gmma_offset((start, 16, 8 * wb), n, k, False,
                                           wb)
                        want = _tma_offset(p * 32 + 16 * wg + n, 16 * ks + k,
                                           wb, 2)
                        assert got == want


def test_wgmma_fragment_is_the_pairs():
    # the m64n16 accumulator of warp w of a warpgroup: d[4 j + i] is
    # (point 16 w + g + 8 (i / 2), chain 8 j + 2 t + (i & 1)), the pairs
    # the recurrence of the design before held; the warpgroups take
    # chains 0-15 and 16-31; every (point, chain) of the tile once
    seen = []
    for warp in range(8):
        P0, Q0 = 16 * (warp & 3), 16 * (warp >> 2)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for e in range(8):
                seen.append((P0 + g + 8 * ((e >> 1) & 1),
                             Q0 + 8 * (e >> 2) + 2 * t + (e & 1)))
    assert sorted(seen) == [(p, c) for p in range(64) for c in range(32)]
    # float32: warps of 16 points x 16 chains as mma.sync's m-tile x two
    # n-tiles, the m-tile's rows g + 8 h the points 32 (wp / 2) +
    # col32(wp % 2, h, g) of the 32-point box (wp = warp % 4): every pair
    # once
    seen = []
    for warp in range(8):
        wp, ch = warp % 4, 16 * (warp // 4)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for e in range(8):
                h = (e >> 1) & 1
                pt = 32 * (wp >> 1) + 16 * (g >> 2) + 8 * (wp & 1) + 4 * h \
                    + (g & 3)
                seen.append((pt, ch + 8 * (e >> 2) + 2 * t + (e & 1)))
    assert sorted(seen) == [(p, c) for p in range(64) for c in range(32)]
    src = _src()
    assert ("const int pt_lo = kBf16 ? 16 * wp + g : 32 * (wp >> 1) + "
            "col32(wp & 1, 0, g);") in src


# ---------------------------------------------------------------------
# (e) on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from bart_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _problem(R, L, W, C, K, table_dtype, device):
    tab, wn, wrows, T, drp = [torch.tensor(a, dtype=F32, device=device)
                              for a in random_rows(R, L, W, C, seed=3)]
    factor = torch.tensor(fine_structure(R, W, K), dtype=F32, device=device)
    fine = (tab[..., None] * factor).reshape(R, L, W * K)
    return fused.folded_table(fine, K, table_dtype), wn, wrows, T, drp


def _quad(nodes, device):
    if nodes == 8:
        (mu, muw), powers = expsum_weights(8), True
    elif nodes == 5:
        (mu, muw), powers = raygrid_weights([0.0, 20.0, 40.0, 60.0, 80.0]), \
            False
    else:
        (mu, muw), powers = raygrid_weights(
            np.arange(0.0, 90.0, 90.0 / nodes)), False
    return (torch.tensor(mu, dtype=F32, device=device),
            torch.tensor(muw, dtype=F32, device=device), powers)


#: rows per K: unchunked (16, 27, 41), chunked (65, 122)
_CARD_R = {2: 27, 3: 65, 4: 16, 32: 122, 48: 41, 128: 27}


@pytest.mark.gpu
@pytest.mark.parametrize("table_dtype", [F32, BF16])
@pytest.mark.parametrize("K", [2, 3, 4, 32, 48, 128])
@pytest.mark.parametrize("nodes", [1, 5, 8, 18, 90])
def test_kernel_matches_plain_on_card(cuda_device, nodes, K, table_dtype):
    # padded chains (one chain block, one past it, two past), rows that
    # run in one stage and in chunks
    C = (6, 17, 33)[(K + nodes) % 3]
    ft, wn, wrows, T, drp = _problem(_CARD_R[K], 23, 37, C, K, table_dtype,
                                     cuda_device)
    mu, muw, powers = _quad(nodes, cuda_device)
    before = fused.fused_eclipse_folded.launches
    got = fused.fused_eclipse_folded(ft, wn, mu, muw, wrows, T, drp, powers)
    ref = fused.eclipse_folded_plain(ft, wn, mu, muw, wrows, T, drp, powers)
    torch.cuda.synchronize()
    assert fused.fused_eclipse_folded.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-4 if powers else 1e-4)


@pytest.mark.gpu
def test_grid_past_65535_tiles_on_card(cuda_device):
    # 66,000 tiles of 64 points: the grid spreads them over y and z
    W, K = 33000, 128
    assert fused._tile_grid(W * K // 64)[1] > 1
    ft, wn, wrows, T, drp = _problem(8, 4, W, 3, K, BF16, cuda_device)
    mu, muw, powers = _quad(8, cuda_device)
    got = fused.fused_eclipse_folded(ft, wn, mu, muw, wrows, T, drp, powers)
    ref = fused.eclipse_folded_plain(ft, wn, mu, muw, wrows, T, drp, powers)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("table_dtype", [F32, BF16])
def test_graphed_launch_equals_eager_on_card(cuda_device, table_dtype):
    outs = []
    for R, K in ((27, 32), (122, 3)):
        ft, wn, wrows, T, drp = _problem(R, 30, 300, 33, K, table_dtype,
                                         cuda_device)
        mu, muw, powers = _quad(8, cuda_device)
        eager = fused.fused_eclipse_folded(ft, wn, mu, muw, wrows, T, drp,
                                           powers)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = fused.fused_eclipse_folded(ft, wn, mu, muw, wrows, T,
                                                drp, powers)
        graph.replay()
        torch.cuda.synchronize()
        outs.append(torch.equal(eager, static))
    assert all(outs)
