"""Fused rows-contraction forwards: eclipse and transit, K = 1 (port of
bart_tpu/rt/fused.py).

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

``fused_eclipse`` and ``fused_transit`` are the entry points.  On CPU
tensors they run the batched torch versions ``eclipse_plain`` and
``transit_plain``; on CUDA tensors they launch the hand-written kernels
in csrc/fused_eclipse.cu and csrc/fused_transit.cu, or raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from bart_tpu_torch.rt.planck import planck_wn
from bart_tpu_torch.rt.tau import TAU_CLAMP

__all__ = ["fused_eclipse", "eclipse_plain", "fused_transit",
           "transit_plain", "interp_weights", "smix", "load_kernel",
           "build_kernels"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")
_SMEM_LIMIT = 232448   # bytes of shared memory a block may use on sm_90
# fused_eclipse.cu: TILE_W, CB, MAX_NMU (the tests check the source)
_MAX_NMU = 16          # the kernel keeps the quadrature in shared memory
_TILE_W, _CB = 128, 4
# fused_transit.cu: TILE_W, CB, NB, RC
_T_TILE_W, _T_CB, _T_NB, _T_RC = 32, 8, 16, 24
_MAX_GRID_Y = 65535

_VP, _CI = ctypes.c_void_p, ctypes.c_int
#: kernel name -> the argtypes of its extern "C" entry ``bart_<name>``
#: (pointers, ints, the stream); the source is csrc/<name>.cu
_KERNELS = {
    "fused_eclipse": [_VP] * 8 + [_CI] * 6 + [_VP],
    "fused_transit": [_VP] * 5 + [_CI] * 4 + [_VP],
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


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home
                 else []) + [shutil.which("nvcc") or "",
                             "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _so_path(name: str) -> Path:
    """build/<name>_<hash>.so, keyed on the source and the flags."""
    src = (_CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode())
    return _BUILD_DIR / f"{name}_{key.hexdigest()[:16]}.so"


def build_kernels(names=tuple(_KERNELS)) -> None:
    """Compile csrc/<name>.cu for every name whose library is missing,
    one nvcc each, all started together; raise if any fails."""
    todo = [(n, _so_path(n)) for n in names]
    todo = [(n, so) for n, so in todo if not so.is_file()]
    if not todo:
        return
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, so in todo:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, so, tmp, subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, so)
        else:
            failed.append(f"{name}.cu ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load_kernel(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu with nvcc (once per source hash, into
    ``build/``) and load it with ctypes."""
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


def fused_eclipse(tab: torch.Tensor, wn: torch.Tensor, mu: torch.Tensor,
                  muw: torch.Tensor, wrows: torch.Tensor, T: torch.Tensor,
                  drp: torch.Tensor, powers: bool = False) -> torch.Tensor:
    """Eclipse flux [C, W] from extinction rows, batched over chains.

    tab [R, L, W] static absorber rows; wrows [C, L, R] per-chain
    weights; T [C, L] K; drp [C, L] cm with drp[:, 0] == 0
    (drp[:, l] = r_{l-1} - r_l); mu, muw [nmu] the angular quadrature
    (``powers=True`` requires rt.eclipse.expsum_weights).

    A CPU ``T`` runs ``eclipse_plain``.  A CUDA ``T`` launches the
    kernel in float32 on the current stream, without synchronising, and
    returns the result cast to ``T.dtype``; it raises on any input the
    kernel does not take, and never falls back.
    """
    if T.device.type == "cpu":
        return eclipse_plain(tab, wn, mu, muw, wrows, T, drp, powers)
    if T.device.type != "cuda":
        raise ValueError(f"fused_eclipse: unsupported device {T.device}")

    R, L, W = tab.shape
    C = T.shape[0]
    nmu = int(mu.shape[0])
    dev = T.device
    for name, x, shape in (("tab", tab, (R, L, W)), ("wn", wn, (W,)),
                           ("mu", mu, (nmu,)), ("muw", muw, (nmu,)),
                           ("wrows", wrows, (C, L, R)), ("T", T, (C, L)),
                           ("drp", drp, (C, L))):
        _check("fused_eclipse", name, x, shape, dev)
    if not 1 <= nmu <= _MAX_NMU:
        raise ValueError(f"fused_eclipse: {nmu} quadrature nodes, the "
                         f"kernel takes 1..{_MAX_NMU}")
    if L < 1 or R < 1:
        raise ValueError("fused_eclipse: empty layer or row axis")
    smem = 4 * (R * _TILE_W + _CB * R)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_eclipse: {R} rows need {smem} B of shared "
                         f"memory, more than a block has ({_SMEM_LIMIT})")
    if max(R * L * W, C * L * R) >= 2**31:
        raise ValueError("fused_eclipse: tensors beyond 2^31 elements")

    f32 = torch.float32
    tab32 = tab.to(f32).contiguous()
    wrows32 = wrows.to(f32).contiguous()
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
            R, L, W, C, nmu, int(bool(powers)), stream)
    if err != 0:
        raise RuntimeError(f"fused_eclipse kernel launch failed: CUDA "
                           f"error {err}")
    fused_eclipse.launches += 1
    return out.to(T.dtype)


#: kernel launches made by fused_eclipse (plain-path calls do not count)
fused_eclipse.launches = 0


def fused_transit(tab: torch.Tensor, wrows: torch.Tensor, G: torch.Tensor,
                  wgt: torch.Tensor) -> torch.Tensor:
    """Annulus-integrated absorption out [C, W], batched over chains.

    tab [R, L, W] static absorber rows; wrows [C, L, R] per-chain
    weights; (G [C, L, L], wgt [C, L]) from slant_geometry of each
    chain's radii.  G is taken as lower-triangular (as slant_geometry's
    is exactly): entries above the diagonal are ignored.

    A CPU ``wgt`` runs ``transit_plain``.  A CUDA ``wgt`` launches the
    kernel in float32 on the current stream, without synchronising, and
    returns the result cast to ``wgt.dtype``; it raises on any input the
    kernel does not take, and never falls back.
    """
    if wgt.device.type == "cpu":
        return transit_plain(tab, wrows, G, wgt)
    if wgt.device.type != "cuda":
        raise ValueError(f"fused_transit: unsupported device {wgt.device}")

    R, L, W = tab.shape
    C = wgt.shape[0]
    dev = wgt.device
    for name, x, shape in (("tab", tab, (R, L, W)),
                           ("wrows", wrows, (C, L, R)),
                           ("G", G, (C, L, L)), ("wgt", wgt, (C, L))):
        _check("fused_transit", name, x, shape, dev)
    if min(R, L, W, C) < 1:
        raise ValueError("fused_transit: empty row, layer, wn or chain axis")
    Rp, Lp, Wp = (-(-n // 4) * 4 for n in (R, L, W))
    # ext for all layers, the annulus weights, two stage buffers (as the
    # kernel's launcher counts them)
    smem = 4 * (_T_CB * Lp * _T_TILE_W + -(-_T_CB * L // 4) * 4
                + 2 * _T_CB * max(_T_RC * (_T_TILE_W + _T_CB), _T_NB * Lp))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_transit: {L} layers need {smem} B of "
                         f"shared memory, more than a block has "
                         f"({_SMEM_LIMIT})")
    if -(-W // _T_TILE_W) > _MAX_GRID_Y:
        raise ValueError(f"fused_transit: {W} wavenumbers exceed the "
                         f"grid's {_MAX_GRID_Y * _T_TILE_W}")
    if max(Rp * L * Wp, C * L * Lp, C * L * Rp, C * W) >= 2**31:
        raise ValueError("fused_transit: tensors beyond 2^31 elements")

    # The kernel copies rows in 16-byte pieces: zero-pad R (tab, wrows),
    # W (tab) and G's last axis to multiples of 4.  G's upper triangle is
    # zeroed, so the kernel, like transit_plain, ignores it.
    f32 = torch.float32
    tab32 = torch.zeros((Rp, L, Wp), dtype=f32, device=dev)
    tab32[:R, :, :W] = tab
    wrows32 = torch.zeros((C, L, Rp), dtype=f32, device=dev)
    wrows32[..., :R] = wrows
    G32 = torch.zeros((C, L, Lp), dtype=f32, device=dev)
    G32[..., :L] = torch.tril(G)
    wgt32 = wgt.to(f32).contiguous()
    out = torch.empty((C, W), dtype=f32, device=dev)

    lib = load_kernel("fused_transit")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bart_fused_transit(
            tab32.data_ptr(), wrows32.data_ptr(), G32.data_ptr(),
            wgt32.data_ptr(), out.data_ptr(), Rp, L, W, C, stream)
    if err != 0:
        raise RuntimeError(f"fused_transit kernel launch failed: CUDA "
                           f"error {err}")
    fused_transit.launches += 1
    return out.to(wgt.dtype)


#: kernel launches made by fused_transit (plain-path calls do not count)
fused_transit.launches = 0
