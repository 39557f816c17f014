"""Fused rows-contraction forwards: eclipse and transit, K = 1 and folded
(port of bart_tpu/rt/fused.py).

Every absorber is separable into (per-chain-per-layer weight) x (static
table row over wn), so the whole extinction is one contraction

    ext[c, l, w] = sum_r wrows[c, l, r] tab[r, l, w]

Eclipse: the flux follows by the layer recurrence

    tau_l = tau_{l-1} + 0.5 (ext_{l-1} + ext_l) drp_l
    S_l   = sum_q w_q mu_q e^{-min(tau_l, 88)/mu_q}
    F    += 0.5 (B_{l-1} + B_l) (S_{l-1} - S_l)

closed by F += B_bot S_bot and scaled by 2 pi (the exact isothermal
limit).  In ``powers`` mode (expsum quadrature, mu_q = 1/(q+1)) S is a
Horner polynomial of u = e^{-tau}: one exponential per point.

Transit: with (G, wgt) = rt.transit_geom.slant_geometry of the radii,

    tau[c, b, w] = sum_l G[c, b, l] ext[c, l, w]
    out[c, w]    = sum_b wgt[c, b] (1 - e^{-min(tau, 88)})

and the caller forms depth = (r_bot^2 + out) / r_star^2.

Folded (K sub-samples per output bin, docs/LINE_SAMPLING.md): the table
lives on the K-times-finer midpoint grid of utils.grids.folded_fine_grid,
ext and tau are evaluated per fine point, and the output is the mean
over each bin's K sub-samples taken AFTER the exponential: of S_l
(eclipse, with the Planck function at the bin centre) or of
1 - e^{-tau} (transit).  This package keeps the fine table bin-major,
[R, L, W K] with fine index f = b K + k (``FoldedTable``), so that a
bin's sub-samples are neighbours in memory; ``fold_table`` gives
bart_tpu's sub-sample-major layout and ``unfold_table`` undoes it.

A K = 1 table is handed to the kernels as a ``RowsTable`` (``rows_table``:
[R, L, Wp] contiguous, the wn axis zero-padded to 16 bytes), made once at
model set-up; a plain [R, L, W] tensor is also taken and prepared on the
spot.

``fused_eclipse``, ``fused_transit``, ``fused_eclipse_folded`` and
``fused_transit_folded`` are the entry points.  On CPU tensors they run
the batched torch versions ``eclipse_plain``, ``transit_plain``,
``eclipse_folded_plain`` and ``transit_folded_plain``; on CUDA tensors
they launch the hand-written kernels in csrc/, or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from bart_tpu_torch.rt.planck import planck_wn
from bart_tpu_torch.rt.tau import TAU_CLAMP
from bart_tpu_torch.utils import build

__all__ = ["fused_eclipse", "eclipse_plain", "fused_transit",
           "transit_plain", "fused_eclipse_folded", "eclipse_folded_plain",
           "fused_transit_folded", "transit_folded_plain", "FoldedTable",
           "folded_table", "fold_table", "unfold_table", "interp_weights",
           "smix", "load_kernel", "build_kernels", "split_bf16",
           "split_tf32", "SlantMatrix", "prepare_slant", "RowsTable",
           "rows_table"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")
_SMEM_LIMIT = 232448   # bytes of shared memory a block may use on sm_90
# fused_eclipse.cu: TILE_W, CB, NSTAGE, NTHREADS, MAX_NMU (the tests check
# the source)
_MAX_NMU = 16          # the kernel keeps the quadrature in shared memory
_TILE_W, _CB, _NSTAGE, _NTHREADS = 64, 32, 4, 256
# fused_eclipse_folded.cu: MTILE_F, CBM, NSTAGE, MTHREADS
_F_MTILE_F, _F_CBM, _F_NSTAGE, _F_MTHREADS = 64, 32, 4, 256
# fused_transit_mma.cuh (the K = 1 and the folded transit kernel): FT_W,
# FT_CB, FT_NS, FT_MT
_FT_W, _FT_CB, _FT_NS, _FT_MT = 32, 8, 5, 7
#: the tensor-core kernels pad the row axis to the depth of one product:
#: 16 rows in bfloat16, 8 in TF32
_MMA_K, _MMA_K32 = 16, 8
#: a RowsTable's wn axis is padded to 16 bytes of float32
_ROWS_ALIGN = 4
_MAX_GRID_Y = 65535
#: sub-samples per bin the folded kernels take: the K lanes of a warp
_FOLD_K = (2, 4, 8, 16, 32)
#: the fine axis of a FoldedTable is padded to 16 bytes of bfloat16
_FOLD_ALIGN = 8

_VP, _CI = ctypes.c_void_p, ctypes.c_int
#: kernel name -> the argtypes of its extern "C" entry ``bart_<name>``
#: (pointers, ints, the stream); the source is csrc/<name>.cu
_KERNELS = {
    "fused_eclipse": [_VP] * 8 + [_CI] * 8 + [_VP],
    "fused_transit": [_VP] * 5 + [_CI] * 6 + [_VP],
    "fused_eclipse_folded": [_VP] * 8 + [_CI] * 10 + [_VP],
    "fused_transit_folded": [_VP] * 5 + [_CI] * 8 + [_VP],
}

_libs: dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def interp_weights(n_nodes: int, t_min: float, t_step: float,
                   T: torch.Tensor) -> torch.Tensor:
    """Uniform-grid linear-interpolation weights w[..., n_nodes]: floor
    bracket clipped to [0, n-2], fraction clipped to [0, 1] (T above the
    last node gives f = 1 on the top bracket)."""
    x = (T - t_min) / t_step
    i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, n_nodes - 2)
    f = torch.clamp(x - i0, 0.0, 1.0)
    iota = torch.arange(n_nodes, device=T.device)
    zero = torch.zeros((), dtype=T.dtype, device=T.device)
    w = torch.where(iota == i0[..., None], (1.0 - f)[..., None], zero)
    return torch.where(iota == i0[..., None] + 1, w + f[..., None], w)


def smix(tau: torch.Tensor, mu: torch.Tensor, muw: torch.Tensor,
         powers: bool) -> torch.Tensor:
    """S[...] = sum_q w_q mu_q e^{-min(tau, 88)/mu_q}; in powers mode
    the Horner polynomial sum_q a_q u^{q+1} of u = e^{-tau}."""
    tau_c = torch.clamp(tau, max=TAU_CLAMP)
    a = muw * mu
    if powers:
        u = torch.exp(-tau_c)
        acc = torch.zeros_like(u)
        for q in reversed(range(mu.shape[0])):
            acc = u * (a[q] + acc)
        return acc
    minv = 1.0 / mu
    S = torch.zeros_like(tau_c)
    for q in range(mu.shape[0]):
        S = S + a[q] * torch.exp(-tau_c * minv[q])
    return S


def eclipse_plain(tab: torch.Tensor, wn: torch.Tensor, mu: torch.Tensor,
                  muw: torch.Tensor, wrows: torch.Tensor, T: torch.Tensor,
                  drp: torch.Tensor, powers: bool = False) -> torch.Tensor:
    """Plain batched torch version of the kernel (bart_tpu's ``_single``
    under vmap): tab [R, L, W], wrows [C, L, R], T [C, L], drp [C, L]
    with drp[:, 0] == 0 -> flux [C, W], in the inputs' dtype."""
    ext = torch.einsum("clr,rlw->clw", wrows, tab)
    seg = 0.5 * (ext[:, :-1] + ext[:, 1:]) * drp[:, 1:, None]
    tau = torch.cat([torch.zeros_like(ext[:, :1]),
                     torch.cumsum(seg, dim=1)], dim=1)          # [C, L, W]
    S = smix(tau, mu, muw, powers)
    B = planck_wn(wn, T[..., None])                             # [C, L, W]
    Bmid = 0.5 * (B[:, :-1] + B[:, 1:])
    flux = torch.sum(Bmid * (S[:, :-1] - S[:, 1:]), dim=1)
    return 2.0 * np.pi * (flux + B[:, -1] * S[:, -1])


def transit_plain(tab: torch.Tensor, wrows: torch.Tensor, G: torch.Tensor,
                  wgt: torch.Tensor) -> torch.Tensor:
    """Plain batched torch version of the transit kernel (bart_tpu's
    ``_tsingle`` under vmap): tab [R, L, W], wrows [C, L, R],
    G [C, L, L], wgt [C, L] -> out [C, W], in the inputs' dtype.

    G is taken as lower-triangular, as slant_geometry's is exactly:
    entries above the diagonal are ignored here and by the kernel.
    """
    ext = torch.einsum("clr,rlw->clw", wrows, tab)
    tau = torch.bmm(torch.tril(G), ext)                         # [C, L, W]
    absorb = 1.0 - torch.exp(-torch.clamp(tau, max=TAU_CLAMP))
    return torch.bmm(wgt[:, None, :], absorb)[:, 0]


@dataclasses.dataclass(frozen=True)
class FoldedTable:
    """A fine table in the folded kernels' layout: ``tab`` [R, L, Fp],
    bin-major (fine point f = b K + k is sub-sample k of output bin b),
    whose first W K columns are in use and the rest zero."""

    tab: torch.Tensor
    K: int
    W: int

    def bins(self) -> torch.Tensor:
        """The columns in use as a view [R, L, W, K]."""
        return self.tab[..., :self.W * self.K].unflatten(-1, (self.W, self.K))


def folded_table(tab_fine: torch.Tensor, K: int,
                 dtype: torch.dtype | None = None) -> FoldedTable:
    """[R, L, W K] bin-major fine table -> FoldedTable in ``dtype``
    (default: as given), the fine axis zero-padded to a multiple of
    16 bytes as the transit kernel's copies need.  Done once, at model
    set-up: the fine table is K times the K = 1 table."""
    R, L, F = tab_fine.shape
    K = int(K)
    if K < 2 or F % K:
        raise ValueError(f"folded_table: fine axis {F} is not a multiple of "
                         f"K = {K} >= 2")
    Fp = -(-F // _FOLD_ALIGN) * _FOLD_ALIGN
    tab = torch.zeros((R, L, Fp), dtype=dtype or tab_fine.dtype,
                      device=tab_fine.device)
    tab[..., :F] = tab_fine
    return FoldedTable(tab, K, F // K)


def fold_table(tab_fine: torch.Tensor, K: int) -> torch.Tensor:
    """[R, L, W K] bin-major fine table -> [K, R, L, W], bart_tpu's
    sub-sample-major layout (bart_tpu.rt.fused.fold_table)."""
    R, L, WK = tab_fine.shape
    return tab_fine.reshape(R, L, WK // K, K).permute(3, 0, 1, 2)


def unfold_table(tabk: torch.Tensor) -> torch.Tensor:
    """[K, R, L, W] -> [R, L, W K] bin-major: the inverse of fold_table."""
    K, R, L, W = tabk.shape
    return tabk.permute(1, 2, 3, 0).reshape(R, L, W * K)


@dataclasses.dataclass(frozen=True)
class RowsTable:
    """A K = 1 table in the kernels' layout: ``tab`` [R, L, Wp]
    contiguous, whose first W columns are in use and the rest zero (Wp is
    W rounded up to 16 bytes of float32, so that every row of the table
    can be copied in 16-byte pieces)."""

    tab: torch.Tensor
    W: int

    def plain(self) -> torch.Tensor:
        """The columns in use as a view [R, L, W]."""
        return self.tab[..., :self.W]


def rows_table(rows, dtype: torch.dtype | None = None) -> RowsTable:
    """[R, L, W] (or a sequence of such blocks of rows, stacked along the
    row axis) -> RowsTable in ``dtype`` (default: as given).  Done once,
    at model set-up; a single contiguous block that needs no padding and
    no cast is taken as it is, not copied."""
    blocks = [rows] if isinstance(rows, torch.Tensor) else list(rows)
    first = blocks[0]
    if any(b.dim() != 3 or b.shape[1:] != first.shape[1:] for b in blocks):
        raise ValueError("rows_table: expected [R, L, W] blocks of one "
                         f"[L, W], got {[tuple(b.shape) for b in blocks]}")
    dtype = dtype or first.dtype
    _, L, W = first.shape
    Wp = -(-W // _ROWS_ALIGN) * _ROWS_ALIGN
    if (len(blocks) == 1 and Wp == W and first.dtype == dtype
            and first.is_contiguous()):
        return RowsTable(first, W)
    tab = torch.zeros((sum(b.shape[0] for b in blocks), L, Wp), dtype=dtype,
                      device=first.device)
    r = 0
    for b in blocks:
        tab[r:r + b.shape[0], :, :W] = b
        r += b.shape[0]
    return RowsTable(tab, W)


def _plain_rows(tab) -> torch.Tensor:
    """The [R, L, W] tensor the plain versions take."""
    return tab.plain() if isinstance(tab, RowsTable) else tab


def eclipse_folded_plain(ft: FoldedTable, wn_out: torch.Tensor,
                         mu: torch.Tensor, muw: torch.Tensor,
                         wrows: torch.Tensor, T: torch.Tensor,
                         drp: torch.Tensor, powers: bool = False
                         ) -> torch.Tensor:
    """Plain batched torch version of the folded eclipse kernel
    (bart_tpu's ``_single_folded`` under vmap): wn_out [W] the output bin
    centres, wrows [C, L, R], T, drp [C, L] -> flux [C, W] in wrows'
    dtype.  The table is widened to that dtype (a bfloat16 table to
    float32: exact) and the sub-samples are walked one at a time, so the
    largest temporary is [C, L, W], not [C, K, L, W]."""
    tabv = ft.bins()
    sbar = None
    for k in range(ft.K):
        ext = torch.einsum("clr,rlw->clw", wrows,
                           tabv[..., k].to(wrows.dtype))
        seg = 0.5 * (ext[:, :-1] + ext[:, 1:]) * drp[:, 1:, None]
        tau = torch.cat([torch.zeros_like(ext[:, :1]),
                         torch.cumsum(seg, dim=1)], dim=1)
        S = smix(tau, mu, muw, powers)
        sbar = S if sbar is None else sbar + S
    sbar = sbar / ft.K                                          # [C, L, W]
    B = planck_wn(wn_out, T[..., None])
    Bmid = 0.5 * (B[:, :-1] + B[:, 1:])
    flux = torch.sum(Bmid * (sbar[:, :-1] - sbar[:, 1:]), dim=1)
    return 2.0 * np.pi * (flux + B[:, -1] * sbar[:, -1])


def transit_folded_plain(ft: FoldedTable, wrows: torch.Tensor,
                         G: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """Plain batched torch version of the folded transit kernel
    (bart_tpu's ``_tsingle_folded`` under vmap): wrows [C, L, R],
    G [C, L, L] (taken as lower-triangular), wgt [C, L] -> out [C, W] in
    wrows' dtype; the table is widened and walked as in
    ``eclipse_folded_plain``."""
    tabv = ft.bins()
    Gl = torch.tril(G)
    abar = None
    for k in range(ft.K):
        ext = torch.einsum("clr,rlw->clw", wrows,
                           tabv[..., k].to(wrows.dtype))
        tau = torch.bmm(Gl, ext)
        absorb = 1.0 - torch.exp(-torch.clamp(tau, max=TAU_CLAMP))
        abar = absorb if abar is None else abar + absorb
    return torch.bmm(wgt[:, None, :], abar / ft.K)[:, 0]


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """float32 x -> (lo, mid, hi), three bfloat16 tensors, smallest
    first, with hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid):
    3 x 8 significant bits, so hi + mid + lo == x bit for bit in float32
    (down to where lo leaves bfloat16's subnormal range, |x| < 2^-109).
    Each part times a bfloat16 table element is exact in float32: the
    tensor-core kernels contract the parts and sum in float32."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_bf16: {x.dtype}, expected float32")
    bf = torch.bfloat16
    hi = x.to(bf)
    rest = x - hi.float()
    mid = rest.to(bf)
    return (rest - mid.float()).to(bf), mid, hi


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 x -> (big, small) as the tensor-core kernels feed their
    3xTF32 products (every contraction of a float32 table, and the
    transit slant product): big is x rounded to TF32's 10 mantissa bits
    (to nearest, ties away from zero), small is x - big (exact) cut to
    10 bits as the unit reads it.  |x - (big + small)| <= 2^-21 |x|."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_tf32: {x.dtype}, expected float32")
    keep = -(1 << 13)                    # 0xffffe000 as an int32
    big = ((x.contiguous().view(torch.int32) + (1 << 12)) & keep
           ).view(torch.float32)
    small = ((x - big).view(torch.int32) & keep).view(torch.float32)
    return big, small


def _pad_rows(wrows: torch.Tensor, Rp: int) -> torch.Tensor:
    """wrows [C, L, R] -> [C, L, Rp] float32 contiguous, zero-padded
    along the row axis, as the kernels copy them in 16-byte pieces (the
    weights are the only operand laid out per call)."""
    C, L, R = wrows.shape
    if R == Rp:
        return wrows.to(torch.float32).contiguous()
    out = torch.zeros((C, L, Rp), dtype=torch.float32, device=wrows.device)
    out[..., :R] = wrows
    return out


def _split_rows(wrows: torch.Tensor, Rp: int) -> torch.Tensor:
    """wrows [C, L, R] -> [3, C, L, Rp] bfloat16: split_bf16's parts,
    zero-padded along the row axis, as the tensor-core kernels read them."""
    C, L, R = wrows.shape
    parts = torch.zeros((3, C, L, Rp), dtype=torch.bfloat16,
                        device=wrows.device)
    for dst, part in zip(parts, split_bf16(wrows.to(torch.float32))):
        dst[..., :R] = part
    return parts


@dataclasses.dataclass(frozen=True)
class SlantMatrix:
    """slant_geometry's G in the transit kernels' layouts, made by
    ``prepare_slant`` once per forward, so that the launches of one
    forward share it.  ``G`` [C, L, Lp] contiguous, Lp = L rounded up to
    4, the upper triangle and the padding zero (the plain versions' form).
    ``tiles`` [C, Lk / 8, Lm, 8] contiguous, Lk, Lm = L rounded up to 8,
    16: tile s holds G[c, :, 8 s : 8 s + 8], zero-padded, which the
    kernels stream one tile a step."""

    G: torch.Tensor
    L: int
    tiles: torch.Tensor

    def plain(self) -> torch.Tensor:
        """The [C, L, L] view the plain versions take."""
        return self.G[..., :self.L]


def _slant_tiles(G: torch.Tensor, L: int) -> torch.Tensor:
    """[C, L, Lp] lower-triangular -> SlantMatrix.tiles."""
    C = G.shape[0]
    Lk, Lm = -(-L // 8) * 8, -(-L // 16) * 16
    full = torch.zeros((C, Lm, Lk), dtype=G.dtype, device=G.device)
    full[:, :L, :G.shape[2]] = G
    return full.view(C, Lm, Lk // 8, 8).permute(0, 2, 1, 3).contiguous()


def prepare_slant(G: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> SlantMatrix:
    """G [C, L, L] -> SlantMatrix in ``dtype`` (the kernels read
    float32)."""
    C, L, L2 = G.shape
    if L != L2:
        raise ValueError(f"prepare_slant: G has shape {tuple(G.shape)}, "
                         "expected [C, L, L]")
    out = torch.zeros((C, L, -(-L // 4) * 4), dtype=dtype, device=G.device)
    out[..., :L] = torch.tril(G)
    return SlantMatrix(out, L, _slant_tiles(out, L))


def _slant32(fn: str, G, C: int, L: int, dev: torch.device) -> torch.Tensor:
    """G as the kernels read it: the tiled layout, float32.  A
    SlantMatrix is checked and passed on as it is, a plain [C, L, L]
    tensor prepared."""
    if not isinstance(G, SlantMatrix):
        _check(fn, "G", G, (C, L, L), dev)
        G = prepare_slant(G)
    _check(fn, "G", G.G, (C, L, -(-L // 4) * 4), dev)
    if G.L != L or G.G.dtype != torch.float32 or not G.G.is_contiguous():
        raise ValueError(f"{fn}: the SlantMatrix is not prepare_slant's "
                         f"contiguous float32 layout for L = {L}")
    _check(fn, "G tiles", G.tiles,
           (C, -(-L // 8), -(-L // 16) * 16, 8), dev)
    if G.tiles.dtype != torch.float32 or not G.tiles.is_contiguous():
        raise ValueError(f"{fn}: the SlantMatrix's tiles are not "
                         "contiguous float32")
    return G.tiles


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home
                 else []) + [shutil.which("nvcc") or "",
                             "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _so_path(name: str) -> Path:
    """bart_tpu_torch/build/<name>_<hash>.so, keyed on the source, the
    csrc headers it includes (``#include "x.cuh"``, and those they
    include) and the flags."""
    todo, seen, src = [f"{name}.cu"], set(), b""
    while todo:
        fname = todo.pop()
        if fname in seen:
            continue
        seen.add(fname)
        text = (_CSRC / fname).read_bytes()
        src += text
        todo += sorted(h.decode() for h in re.findall(
            rb'^\s*#include\s+"([^"]+)"', text, re.M))
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode())
    return build.BUILD_DIR / f"{name}_{key.hexdigest()[:16]}.so"


def build_kernels(names=tuple(_KERNELS),
                  ptxas_verbose: bool = False) -> dict[str, str]:
    """Compile csrc/<name>.cu for every name whose library is missing,
    one nvcc each, all started together; raise if any fails.  Returns
    what nvcc wrote to stderr for each name it built: with
    ``ptxas_verbose`` the registers, shared memory and spills of every
    kernel."""
    todo = [(n, _so_path(n)) for n in names]
    todo = [(n, so) for n, so in todo if not so.is_file()]
    if not todo:
        return {}
    build.build_dir()
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if ptxas_verbose else ()
    procs = []
    for name, so in todo:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, so, tmp, subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, *extra, "-o", str(tmp),
             str(_CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed, logs = [], {}
    for name, so, tmp, proc in procs:
        _, err = proc.communicate()
        logs[name] = err
        if proc.returncode == 0:
            os.replace(tmp, so)
        else:
            failed.append(f"{name}.cu ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load_kernel(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu with nvcc (once per source hash, into
    ``bart_tpu_torch/build/``) and load it with ctypes."""
    with _lib_lock:
        if name in _libs:
            return _libs[name]
        if name not in _KERNELS:
            raise KeyError(f"no kernel {name!r}; have {sorted(_KERNELS)}")
        build_kernels([name])
        lib = ctypes.CDLL(str(_so_path(name)))
        fn = getattr(lib, f"bart_{name}")
        fn.argtypes = _KERNELS[name]
        fn.restype = _CI
        _libs[name] = lib
        return lib


def _check(fn, name, x, shape, device):
    if x.device != device:
        raise ValueError(f"{fn}: {name} on {x.device}, expected {device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_floating_point():
        raise TypeError(f"{fn}: {name} has dtype {x.dtype}, expected a "
                        "floating-point tensor")


def _rows32(fn: str, tab, dev: torch.device) -> tuple[torch.Tensor, int]:
    """(tab [R, L, Wp] float32 contiguous, W) as the K = 1 kernels read
    the table.  A RowsTable is checked and passed on as it is (cast if it
    is not float32), a plain [R, L, W] tensor prepared on the spot."""
    if not isinstance(tab, RowsTable):
        if tab.dim() != 3:
            raise ValueError(f"{fn}: tab has shape {tuple(tab.shape)}, "
                             "expected [R, L, W]")
        _check(fn, "tab", tab, tab.shape, dev)
        tab = rows_table(tab, torch.float32)
    t, W = tab.tab, tab.W
    _check(fn, "tab", t, t.shape, dev)
    if (t.dim() != 3 or not t.is_contiguous() or W < 1
            or t.shape[2] != -(-W // _ROWS_ALIGN) * _ROWS_ALIGN):
        raise ValueError(f"{fn}: table of shape {tuple(t.shape)} is not a "
                         f"contiguous [R, L, Wp] with Wp = {W} rounded up to "
                         f"{_ROWS_ALIGN} (rows_table)")
    if t.numel() >= 2**31:
        raise ValueError(f"{fn}: table beyond 2^31 elements")
    return t.to(torch.float32), W


def _eclipse_smem(R: int) -> int:
    """Bytes of dynamic shared memory a block of the K = 1 eclipse kernel
    needs (as its launcher counts them): NSTAGE stages of the table tile
    [Rp][TILE_W + 8], the weights [CB][Rp + 4] and the chains' two
    scalars [2][CB], in float32; Rp = R rounded up to 8."""
    Rp = -(-R // _MMA_K32) * _MMA_K32
    return 4 * _NSTAGE * (Rp * (_TILE_W + 8) + _CB * (Rp + 4) + 2 * _CB)


def fused_eclipse(tab, wn: torch.Tensor, mu: torch.Tensor,
                  muw: torch.Tensor, wrows: torch.Tensor, T: torch.Tensor,
                  drp: torch.Tensor, powers: bool = False) -> torch.Tensor:
    """Eclipse flux [C, W] from extinction rows, batched over chains.

    tab the static absorber rows, a RowsTable (``rows_table``, made once)
    or a plain [R, L, W] tensor (prepared on the spot); wrows [C, L, R]
    per-chain weights; T [C, L] K; drp [C, L] cm with drp[:, 0] == 0
    (drp[:, l] = r_{l-1} - r_l); mu, muw [nmu] the angular quadrature
    (``powers=True`` requires rt.eclipse.expsum_weights).

    A CPU ``T`` runs ``eclipse_plain``.  A CUDA ``T`` launches the
    kernel in float32 on the current stream, without synchronising, and
    returns the result cast to ``T.dtype``: the contraction in 3xTF32 on
    tensor cores (``split_tf32``), the rest on the float32 pipes.  It
    raises on any input the kernel does not take, and never falls back.
    """
    if T.device.type == "cpu":
        return eclipse_plain(_plain_rows(tab), wn, mu, muw, wrows, T, drp,
                             powers)
    if T.device.type != "cuda":
        raise ValueError(f"fused_eclipse: unsupported device {T.device}")

    dev = T.device
    tab32, W = _rows32("fused_eclipse", tab, dev)
    R, L, Wp = tab32.shape
    C = T.shape[0]
    nmu = int(mu.shape[0])
    for name, x, shape in (("wn", wn, (W,)),
                           ("mu", mu, (nmu,)), ("muw", muw, (nmu,)),
                           ("wrows", wrows, (C, L, R)), ("T", T, (C, L)),
                           ("drp", drp, (C, L))):
        _check("fused_eclipse", name, x, shape, dev)
    if not 1 <= nmu <= _MAX_NMU:
        raise ValueError(f"fused_eclipse: {nmu} quadrature nodes, the "
                         f"kernel takes 1..{_MAX_NMU}")
    if min(R, L, C) < 1:
        raise ValueError("fused_eclipse: empty row, layer or chain axis")
    Rp = -(-R // _MMA_K32) * _MMA_K32
    smem = _eclipse_smem(R)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_eclipse: {R} rows need {smem} B of shared "
                         f"memory, more than a block has ({_SMEM_LIMIT})")
    if -(-W // _TILE_W) > _MAX_GRID_Y:
        raise ValueError(f"fused_eclipse: {W} wavenumbers exceed the "
                         f"grid's {_MAX_GRID_Y * _TILE_W}")
    if max(C * L * Rp, C * W) >= 2**31:
        raise ValueError("fused_eclipse: tensors beyond 2^31 elements")

    # per call only the weights are padded
    f32 = torch.float32
    wrows32 = _pad_rows(wrows, Rp)
    T32 = T.to(f32).contiguous()
    drp32 = drp.to(f32).contiguous()
    wn32 = wn.to(f32).contiguous()
    mu32 = mu.to(f32)
    minv = (1.0 / mu32).contiguous()
    wmu = (muw.to(f32) * mu32).contiguous()
    out = torch.empty((C, W), dtype=f32, device=dev)

    lib = load_kernel("fused_eclipse")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bart_fused_eclipse(
            tab32.data_ptr(), wrows32.data_ptr(), T32.data_ptr(),
            drp32.data_ptr(), wn32.data_ptr(), minv.data_ptr(),
            wmu.data_ptr(), out.data_ptr(),
            R, Rp, L, W, Wp, C, nmu, int(bool(powers)), stream)
    if err != 0:
        raise RuntimeError(f"fused_eclipse kernel launch failed: CUDA "
                           f"error {err}")
    fused_eclipse.launches += 1
    return out.to(T.dtype)


#: kernel launches made by fused_eclipse, counted in Python at each launch
#: (plain-path calls do not count): a CUDA graph capture counts once, its
#: replays never (chip_smoke.py counts those in a profiler trace)
fused_eclipse.launches = 0


def _transit_mma_smem(L: int, bf16: bool) -> int:
    """Bytes of shared memory a block of the transit kernel needs (as its
    launcher counts them): ext for all layers [FT_CB][Lk FT_W + 4] and
    the annulus weights [FT_CB][Lm] in float32, then the larger of the
    warps' fill rings (FT_NS units each; a bfloat16 table's unit: 16
    table rows [16][FT_W + 8] in bfloat16 and weights [FT_CB][24] in
    float32; a float32 table's: [8][FT_W + 8] and [FT_CB][12] in float32)
    and their G stages (2 x [Lm][8] float32 each).  The row count does
    not enter."""
    Lk, Lm = -(-L // 8) * 8, -(-L // 16) * 16
    unit = (2 * 16 * (_FT_W + 8) + 4 * _FT_CB * 24 if bf16
            else 4 * 8 * (_FT_W + 8) + 4 * _FT_CB * 12)
    fill = _FT_CB * _FT_NS * unit
    slant = _FT_CB * 2 * Lm * 8 * 4
    return 4 * (_FT_CB * (Lk * _FT_W + 4) + _FT_CB * Lm) + max(fill, slant)


def _check_transit_fit(fn: str, L: int, F: int, bf16: bool) -> None:
    """Raise if L layers or F (fine) wavenumbers exceed what a block or
    the grid of the transit kernel holds."""
    smem = _transit_mma_smem(L, bf16)
    if smem > _SMEM_LIMIT or L > 16 * _FT_MT:
        raise ValueError(f"{fn}: {L} layers need {smem} B of shared memory "
                         f"and {-(-L // 16)} register blocks, more than a "
                         f"block has ({_SMEM_LIMIT}, {_FT_MT})")
    if -(-F // _FT_W) > _MAX_GRID_Y:
        raise ValueError(f"{fn}: {F} wavenumbers exceed the grid's "
                         f"{_MAX_GRID_Y * _FT_W}")


def fused_transit(tab, wrows: torch.Tensor, G: torch.Tensor,
                  wgt: torch.Tensor) -> torch.Tensor:
    """Annulus-integrated absorption out [C, W], batched over chains.

    tab the static absorber rows, a RowsTable (``rows_table``, made once)
    or a plain [R, L, W] tensor (prepared on the spot); wrows [C, L, R]
    per-chain weights; (G [C, L, L], wgt [C, L]) from slant_geometry of
    each chain's radii.  G is taken as lower-triangular (as
    slant_geometry's is exactly): entries above the diagonal are ignored.
    G may also be ``prepare_slant``'s SlantMatrix, which is then not
    copied.

    A CPU ``wgt`` runs ``transit_plain``.  A CUDA ``wgt`` launches the
    kernel in float32 on the current stream, without synchronising, and
    returns the result cast to ``wgt.dtype``: both contractions in 3xTF32
    on tensor cores (``split_tf32``).  It raises on any input the kernel
    does not take, and never falls back.
    """
    if wgt.device.type == "cpu":
        return transit_plain(
            _plain_rows(tab), wrows,
            G.plain() if isinstance(G, SlantMatrix) else G, wgt)
    if wgt.device.type != "cuda":
        raise ValueError(f"fused_transit: unsupported device {wgt.device}")

    fn = "fused_transit"
    dev = wgt.device
    tab32, W = _rows32(fn, tab, dev)
    R, L, Wp = tab32.shape
    C = wgt.shape[0]
    for name, x, shape in (("wrows", wrows, (C, L, R)), ("wgt", wgt, (C, L))):
        _check(fn, name, x, shape, dev)
    Gt = _slant32(fn, G, C, L, dev)
    if min(R, L, C) < 1:
        raise ValueError(f"{fn}: empty row, layer or chain axis")
    _check_transit_fit(fn, L, W, False)
    Rp = -(-R // _MMA_K32) * _MMA_K32
    if max(C * L * Rp, C * W) >= 2**31:
        raise ValueError(f"{fn}: tensors beyond 2^31 elements")

    # per call only the weights are padded
    f32 = torch.float32
    wrows32 = _pad_rows(wrows, Rp)
    wgt32 = wgt.to(f32).contiguous()
    out = torch.empty((C, W), dtype=f32, device=dev)

    lib = load_kernel(fn)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bart_fused_transit(
            tab32.data_ptr(), wrows32.data_ptr(), Gt.data_ptr(),
            wgt32.data_ptr(), out.data_ptr(), R, Rp, L, W, Wp, C, stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")
    fused_transit.launches += 1
    return out.to(wgt.dtype)


#: kernel launches made by fused_transit, counted in Python at each launch
#: (plain-path calls do not count): a CUDA graph capture counts once, its
#: replays never (chip_smoke.py counts those in a profiler trace)
fused_transit.launches = 0


def _eclipse_folded_smem(R: int, K: int, bf16: bool) -> int:
    """Bytes of dynamic shared memory a block of the folded eclipse
    kernel needs (as its launcher counts them): NSTAGE stages of the
    table tile [Rp][MTILE_F + 8] and the weights, then two buffers of
    Planck means [MTILE_F / K][CBM] in float32.  bfloat16: the weights'
    three parts [3][CBM][Rp + 8] in bfloat16, Rp = R rounded up to 16;
    float32: [CBM][Rp + 4] in float32, Rp = R rounded up to 8."""
    eb, parts, depth = (2, 3, _MMA_K) if bf16 else (4, 1, _MMA_K32)
    Rp = -(-R // depth) * depth
    stage = eb * (Rp * (_F_MTILE_F + 8) + parts * _F_CBM * (Rp + 16 // eb))
    return _F_NSTAGE * stage + 2 * 4 * (_F_MTILE_F // K) * _F_CBM


def _check_folded(fn: str, ft: FoldedTable, dev: torch.device) -> int:
    """Raise unless the kernels take ``ft``; 1 for a bfloat16 table."""
    if not isinstance(ft, FoldedTable):
        raise TypeError(f"{fn}: the fine table must be a FoldedTable "
                        "(folded_table), not " + type(ft).__name__)
    tab = ft.tab
    if tab.device != dev:
        raise ValueError(f"{fn}: table on {tab.device}, expected {dev}")
    if tab.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: the kernel reads float32 or bfloat16 "
                        f"tables, not {tab.dtype}")
    if ft.K not in _FOLD_K:
        raise ValueError(f"{fn}: K = {ft.K}; the kernel takes {_FOLD_K}")
    if (tab.dim() != 3 or not tab.is_contiguous()
            or tab.shape[2] % _FOLD_ALIGN or ft.W * ft.K > tab.shape[2]
            or ft.W < 1):
        raise ValueError(f"{fn}: table of shape {tuple(tab.shape)} is not a "
                         f"contiguous [R, L, Fp >= {ft.W} x {ft.K}] with Fp "
                         f"a multiple of {_FOLD_ALIGN} (folded_table)")
    if tab.numel() >= 2**31:
        raise ValueError(f"{fn}: table beyond 2^31 elements")
    return int(tab.dtype == torch.bfloat16)


def fused_eclipse_folded(ft: FoldedTable, wn_out: torch.Tensor,
                         mu: torch.Tensor, muw: torch.Tensor,
                         wrows: torch.Tensor, T: torch.Tensor,
                         drp: torch.Tensor, powers: bool = False
                         ) -> torch.Tensor:
    """Eclipse flux [C, W] on the output bins from a K-times-finer table,
    batched over chains: ``fused_eclipse`` with the fine table ``ft``
    (``folded_table``) in place of ``tab`` and the bin centres ``wn_out``
    [W] in place of ``wn``.

    A CPU ``T`` runs ``eclipse_folded_plain``.  A CUDA ``T`` launches the
    kernel on the current stream, without synchronising: the table is
    read as stored (float32 or bfloat16), everything else in float32,
    and the result is cast to ``T.dtype``.  The fill runs on tensor
    cores: on a bfloat16 table exactly, on the weights' three bfloat16
    parts (``split_bf16``); on a float32 table in 3xTF32, table and
    weights split in the kernel (``split_tf32``).  It raises on any input
    the kernel does not take, and never falls back.
    """
    if T.device.type == "cpu":
        return eclipse_folded_plain(ft, wn_out, mu, muw, wrows, T, drp,
                                    powers)
    if T.device.type != "cuda":
        raise ValueError(f"fused_eclipse_folded: unsupported device "
                         f"{T.device}")
    fn = "fused_eclipse_folded"
    dev = T.device
    bf16 = _check_folded(fn, ft, dev)
    R, L, Fp = ft.tab.shape
    W, K = ft.W, ft.K
    C = T.shape[0]
    nmu = int(mu.shape[0])
    for name, x, shape in (("wn_out", wn_out, (W,)), ("mu", mu, (nmu,)),
                           ("muw", muw, (nmu,)), ("wrows", wrows, (C, L, R)),
                           ("T", T, (C, L)), ("drp", drp, (C, L))):
        _check(fn, name, x, shape, dev)
    if not 1 <= nmu <= _MAX_NMU:
        raise ValueError(f"{fn}: {nmu} quadrature nodes, the kernel takes "
                         f"1..{_MAX_NMU}")
    if min(R, L, C) < 1:
        raise ValueError(f"{fn}: empty row, layer or chain axis")
    smem = _eclipse_folded_smem(R, K, bool(bf16))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{fn}: {R} rows need {smem} B of shared memory, "
                         f"more than a block has ({_SMEM_LIMIT})")
    if -(-W * K // _F_MTILE_F) > _MAX_GRID_Y:
        raise ValueError(f"{fn}: {W * K} fine wavenumbers exceed the grid's "
                         f"{_MAX_GRID_Y * _F_MTILE_F}")
    # the row axis padded to the depth of one product; the weights as
    # the kernel reads them: three bfloat16 parts (split_bf16) for a
    # bfloat16 table, float32 for a float32 one
    depth = _MMA_K if bf16 else _MMA_K32
    Rp = -(-R // depth) * depth
    if max((3 if bf16 else 1) * C * L * Rp, C * W) >= 2**31:
        raise ValueError(f"{fn}: tensors beyond 2^31 elements")

    f32 = torch.float32
    w = _split_rows(wrows, Rp) if bf16 else _pad_rows(wrows, Rp)
    T32 = T.to(f32).contiguous()
    drp32 = drp.to(f32).contiguous()
    wn32 = wn_out.to(f32).contiguous()
    mu32 = mu.to(f32)
    minv = (1.0 / mu32).contiguous()
    wmu = (muw.to(f32) * mu32).contiguous()
    out = torch.empty((C, W), dtype=f32, device=dev)

    lib = load_kernel(fn)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bart_fused_eclipse_folded(
            ft.tab.data_ptr(), w.data_ptr(), T32.data_ptr(),
            drp32.data_ptr(), wn32.data_ptr(), minv.data_ptr(),
            wmu.data_ptr(), out.data_ptr(),
            R, Rp, L, W, Fp, C, K, nmu, int(bool(powers)), bf16, stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")
    fused_eclipse_folded.launches += 1
    return out.to(T.dtype)


#: kernel launches made by fused_eclipse_folded, counted in Python at each launch
#: (plain-path calls do not count): a CUDA graph capture counts once, its
#: replays never (chip_smoke.py counts those in a profiler trace)
fused_eclipse_folded.launches = 0


def fused_transit_folded(ft: FoldedTable, wrows: torch.Tensor,
                         G: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """Annulus-integrated absorption out [C, W] on the output bins from a
    K-times-finer table, batched over chains: ``fused_transit`` with the
    fine table ``ft`` (``folded_table``) in place of ``tab``.

    A CPU ``wgt`` runs ``transit_folded_plain``.  A CUDA ``wgt`` launches
    the kernel on the current stream, without synchronising: the table
    is read as stored (float32 or bfloat16), everything else in float32,
    and the result is cast to ``wgt.dtype``.  The fill of a bfloat16
    table is exact, on the weights' three bfloat16 parts (``split_bf16``'s
    rule, applied in the kernel); that of a float32 table and the slant
    product are in 3xTF32 (``split_tf32``).  G may be
    ``prepare_slant``'s SlantMatrix, which is then not copied.  It raises
    on any input the kernel does not take, and never falls back.
    """
    if wgt.device.type == "cpu":
        return transit_folded_plain(
            ft, wrows, G.plain() if isinstance(G, SlantMatrix) else G, wgt)
    if wgt.device.type != "cuda":
        raise ValueError(f"fused_transit_folded: unsupported device "
                         f"{wgt.device}")
    fn = "fused_transit_folded"
    dev = wgt.device
    bf16 = _check_folded(fn, ft, dev)
    R, L, Fp = ft.tab.shape
    W, K = ft.W, ft.K
    C = wgt.shape[0]
    for name, x, shape in (("wrows", wrows, (C, L, R)), ("wgt", wgt, (C, L))):
        _check(fn, name, x, shape, dev)
    Gt = _slant32(fn, G, C, L, dev)
    if min(R, L, C) < 1:
        raise ValueError(f"{fn}: empty row, layer or chain axis")
    _check_transit_fit(fn, L, W * K, bool(bf16))
    # the row axis as the kernel reads it: padded to the depth of one
    # product (the kernel splits the float32 weights in registers)
    pad = _MMA_K if bf16 else _MMA_K32
    Rk = -(-R // pad) * pad
    if max(C * L * Rk, C * W) >= 2**31:
        raise ValueError(f"{fn}: tensors beyond 2^31 elements")

    # per call only the weights are padded
    f32 = torch.float32
    wrows32 = _pad_rows(wrows, Rk)
    wgt32 = wgt.to(f32).contiguous()
    out = torch.empty((C, W), dtype=f32, device=dev)

    lib = load_kernel(fn)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bart_fused_transit_folded(
            ft.tab.data_ptr(), wrows32.data_ptr(), Gt.data_ptr(),
            wgt32.data_ptr(), out.data_ptr(), R, Rk, L, W, Fp, C, K, bf16,
            stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")
    fused_transit_folded.launches += 1
    return out.to(wgt.dtype)


#: kernel launches made by fused_transit_folded, counted in Python at each launch
#: (plain-path calls do not count): a CUDA graph capture counts once, its
#: replays never (chip_smoke.py counts those in a profiler trace)
fused_transit_folded.launches = 0
