"""Fused eclipse forward: the rows-contraction extinction, vertical tau,
Planck and emergent flux in one pass over the layers (port of
bart_tpu/rt/fused.py, eclipse K=1).

Every absorber is separable into (per-chain-per-layer weight) x (static
table row over wn), so the whole extinction is one contraction

    ext[c, l, w] = sum_r wrows[c, l, r] tab[r, l, w]

and the flux follows by the layer recurrence

    tau_l = tau_{l-1} + 0.5 (ext_{l-1} + ext_l) drp_l
    S_l   = sum_q w_q mu_q e^{-min(tau_l, 88)/mu_q}
    F    += 0.5 (B_{l-1} + B_l) (S_{l-1} - S_l)

closed by F += B_bot S_bot and scaled by 2 pi (the exact isothermal
limit).  In ``powers`` mode (expsum quadrature, mu_q = 1/(q+1)) S is a
Horner polynomial of u = e^{-tau}: one exponential per point.

``fused_eclipse`` is the entry point.  On a CPU tensor it runs
``eclipse_plain``, the batched torch version; on a CUDA tensor it
launches the hand-written kernel in csrc/fused_eclipse.cu, or raises.
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

__all__ = ["fused_eclipse", "eclipse_plain", "interp_weights", "smix",
           "load_kernel"]

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "fused_eclipse.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")
_MAX_NMU = 16          # the kernel keeps the quadrature in shared memory
_SMEM_LIMIT = 232448   # bytes of shared memory a block may use on sm_90
_TILE_W, _CB = 128, 4  # must match TILE_W and CB in the .cu source

_lib = None
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


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home
                 else []) + [shutil.which("nvcc") or "",
                             "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load_kernel() -> ctypes.CDLL:
    """Build csrc/fused_eclipse.cu with nvcc (once per source hash, into
    ``build/``) and load it with ctypes."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        src = _SRC.read_bytes()
        key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode())
        so = _BUILD_DIR / f"fused_eclipse_{key.hexdigest()[:16]}.so"
        if not so.is_file():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.bart_fused_eclipse.argtypes = [vp] * 8 + [ci] * 6 + [vp]
        lib.bart_fused_eclipse.restype = ci
        _lib = lib
        return lib


def _check(name, x, shape, device):
    if x.device != device:
        raise ValueError(f"fused_eclipse: {name} on {x.device}, "
                         f"expected {device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"fused_eclipse: {name} has shape "
                         f"{tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_floating_point():
        raise TypeError(f"fused_eclipse: {name} has dtype {x.dtype}, "
                        "expected a floating-point tensor")


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
        _check(name, x, shape, dev)
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

    lib = load_kernel()
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
