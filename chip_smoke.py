#!/usr/bin/env python3
"""Drive bart_tpu_torch's main paths once on one CUDA card and check them.

The main paths are the MCMC hot loops of the demo CH4 retrievals at the
benchmark's full width (100 layers x 2501 wn x 30,000 lines x 27
T-nodes, 512 chains): PT profile -> abundances -> hydrostatic radii ->
rows -> a fused CUDA kernel -> bands -> likelihood -> snooker step.
Eclipse runs the fused eclipse kernel on the 27 line rows; transit
(examples/demo_transit.cfg: a fitted radius and the in-repo H2-H2 CIA
table, 27 + 14 = 41 rows) runs slant_geometry and the fused transit
kernel, on the same opacity table.  The folded paths are the
publication-accuracy configuration (rtosamp = 32, adaptive split 0.02,
bfloat16 fine tables; eclipse with the expsum quadrature, transit with
CIA): the table lives on the 32-times-finer grid (80,032 wn), the folded
kernels average each output bin's 32 sub-samples after the exponential
on the bins that have line structure, and the K = 1 kernels take the
smooth bins.  Phases:

  0. the card's name and power limit (nvidia-smi); no card -> exit 2
  1. build the four kernels from bart_tpu_torch/csrc with nvcc, in
     parallel, and print each kernel's registers and spills
  2. each kernel vs its plain torch version on random rows at the bench
     shape and a ragged one (eclipse: both quadratures; transit: rows
     whose slant tau crosses unity inside the atmosphere; folded: float32
     and bfloat16 tables with narrow features inside the bins, and the
     result must differ from the K = 1 result on the bin-mean table)
  3. the port's own opacity build on the card, then one 512-chain
     forward batch through ForwardModel.batched() per geometry; folded:
     the fine build, the fine share of bins, a forward per geometry held
     against the plain versions part by part and against the K = 1
     forward
  4. a short snooker retrieval (run_mcmc) per path on synthetic data
  5. serialized times per path: kernel, plain version, whole forward,
     forward less the kernels
  6. with ``--trace`` only: a torch.profiler trace of a few forwards per
     path: the device-busy share of the wall time, the five device
     operations that took most time and the five stages of the forward
     during which the device idled longest

Each path's launch counts are zeroed just before its phase 3 and read
just after its phase 4.  Any failed check raises and exits non-zero.
The last two lines of stdout are the kernels' JSON record (with the
share of each kernel's FMAs that runs on tensor cores) and the result
JSON.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels   # phases 0-2, then the kernels' times
    python3 chip_smoke.py --trace     # all phases, then phase 6
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# Kernel vs plain version, both float32, summing in other orders over
# 100 layers.  Spectra: raygrid 1e-4 (measured ~2e-6); expsum 2e-4,
# because its 8-term Horner polynomial (|a_q| up to 28 against
# S(0) = 1/2) sits at the float32 floor: the plain version alone is
# ~7e-5 from its float64 result.  Bands average the per-wn rounding down.
SPEC_RTOL = {False: 1e-4, True: 2e-4}    # keyed by powers (expsum) mode
BAND_RTOL = 2e-5
KERNEL_REPLACES = "bart_tpu/rt/fused.py:159"   # def _kernel
# Transit kernel vs plain version on ``out`` (the absorbed area, not the
# depth, whose r_bot^2 would hide a wrong out), both float32: the kernel
# sums the rows, then the layers of each slant path, in other orders
# than the plain version's two matrix products; measured 3.3e-7..7.8e-7
# at the shapes here on the H100, so 1e-5 leaves ~13x.  Bands as above.
OUT_RTOL = 1e-5
TRANSIT_REPLACES = "bart_tpu/rt/fused.py:341"  # def _tkernel
# share of (chain, b, w) points whose slant tau must lie in [0.1, 10] in
# a transit comparison: with saturated tau, out = sum(wgt) whatever ext
MIXED_SHARE = 0.2
# The folded kernels against their plain versions: the same tolerances
# (both sides read the same float32 or bfloat16 table and differ in the
# order of sums only, now also over the K sub-samples of a bin).
FOLDED_REPLACES = "bart_tpu/rt/fused.py:535"          # def _fkernel
FOLDED_TRANSIT_REPLACES = "bart_tpu/rt/fused.py:780"  # def _ftkernel
FOLD_K = 32
# a folded result must differ from the K = 1 result on the bin-mean table
# by more than this somewhere: averaging ext before the exponential fails
FOLD_MIN_DIFF = 1e-3
# folded forward vs K = 1 forward on the 2501-point table: a sanity bound
# on the bands (the two differ by the sampling error folding removes)
FOLD_K1_BAND_RTOL = 0.05

# The card's peak rates for ``bound_ms`` (NVIDIA H100 SXM data sheet):
# HBM3 bytes/s, float32 FLOP/s outside the tensor cores (an FMA is two),
# and special-function results/s at the same clock as that float32 peak:
# an SM has 16 special-function lanes beside 128 float32 lanes of 2 FLOP
# (Hopper architecture white paper), so 1/16 of the FLOP rate.
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
SFU_PS = F32_FLOPS / 16
# dense tensor-core peaks of the same data sheet, FLOP/s
BF16_FLOPS, TF32_FLOPS = 989e12, 495e12


def bound(fmas: float, exps: float, nbytes: float) -> tuple[float, str, str]:
    """(least ms the card could take, "operations" or "bytes", the term
    that binds): the largest of the FMAs at the float32 peak, the
    exponentials at the special-function rate and the bytes at the HBM
    rate."""
    terms = {"fmas": 2e3 * fmas / F32_FLOPS,
             "exponentials": 1e3 * exps / SFU_PS,
             "bytes": 1e3 * nbytes / HBM_BPS}
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def eclipse_bound(R, L, F, C, nmu, powers, K, nbytes_in):
    """Bound of one eclipse launch, K = 1 or folded over F = W K fine
    points: per (chain, layer, fine point) R FMAs for ext, 4 for the
    recurrence and the flux, nmu for the quadrature, and 1 (powers) or
    nmu exponentials; one Planck exponential per (chain, layer, output
    bin).  Bytes: every input as stored and the output, once each."""
    pts = C * L * F
    return bound(pts * (R + nmu + 4),
                 pts * (1 if powers else nmu) + pts // K,
                 nbytes_in + 4 * C * (F // K))


def transit_bound(R, L, F, C, K, nbytes_in):
    """Bound of one transit launch, K = 1 or folded over F = W K fine
    points: per (chain, fine point) L R FMAs for ext, L (L + 1) / 2 for
    the triangle of slant paths and L for the annulus sum, and L
    exponentials."""
    return bound(C * F * (L * R + L * (L + 1) // 2 + L), C * F * L,
                 nbytes_in + 4 * C * (F // K))


def tensor_share(fill_fmas: float, slant_fmas: float, all_fmas: float,
                 fill_type: str):
    """What a kernel runs on tensor cores: (share of the bound's FMAs,
    their types, ms those FMAs take at the types' dense peaks times the
    passes used).  The fill is three passes: bfloat16 on a bfloat16 table
    (the weights' three parts, ``fill_type`` "bf16"), TF32 on a float32
    table (big and small parts of both operands, "tf32", every K = 1
    launch); the slant product three TF32 passes."""
    fill_peak = {"bf16": BF16_FLOPS, "tf32": TF32_FLOPS}[fill_type]
    ms = 2e3 * 3 * (fill_fmas / fill_peak + slant_fmas / TF32_FLOPS)
    kinds = [f"{fill_type} x 3 passes (fill)"] + (
        ["tf32 x 3 passes (slant)"] if slant_fmas else [])
    return (fill_fmas + slant_fmas) / all_fmas, " + ".join(kinds), ms


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def rel_err(a, b) -> float:
    return float(((a.double() - b.double()).abs()
                  / b.double().abs().clamp_min(1e-300)).max())


def abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def cuda_ms(fn, nrep: int) -> float:
    """Mean ms per call from CUDA events over ``nrep`` launches (after
    one warm-up), ending in a synchronise."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(nrep):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / nrep


def serialized_ms(step, params, nrep: int, rounds: int = 3):
    """bench.py's serialized timing: each call's input depends on the
    last call's output and every round ends in a host read.  Returns
    (best ms per call, per-round ms)."""
    out = step(params)
    float(out.sum())
    times = []
    for _ in range(rounds):
        p = params
        t0 = time.perf_counter()
        for _ in range(nrep):
            out = step(p)
            p = params + 0.0 * out.sum()
        float(out.sum())
        times.append(1e3 * (time.perf_counter() - t0) / nrep)
    return min(times), times


def mixed_share(tab, wrows, G) -> float:
    """Share of (chain, b, w) points whose slant tau lies in [0.1, 10]."""
    import torch

    tau = torch.bmm(torch.tril(G), torch.einsum("clr,rlw->clw", wrows, tab))
    return float(((tau >= 0.1) & (tau <= 10.0)).double().mean())


def transit_kernel_vs_plain(fused, filters, f32: dict) -> float:
    """Phase 2, transit: fused_transit vs transit_plain on random rows at
    the transit bench shape and a ragged one.  Returns the kernel's max
    abs error at the bench shape."""
    import torch

    from bart_tpu_torch.demo import random_transit_rows
    from bart_tpu_torch.obs.bands import band_integrate, build_band_matrix

    max_abs = 0.0
    for (R, L, W, C) in ((41, 100, 2501, 512), (17, 23, 300, 6),
                         (48, 23, 301, 33)):
        args = [torch.tensor(a, **f32)
                for a in random_transit_rows(R, L, W, C, seed=7)[:4]]
        got = fused.fused_transit(*args)
        ref = fused.transit_plain(*args)
        ref64 = fused.transit_plain(*(x.double() for x in args))
        torch.cuda.synchronize()
        mixed = mixed_share(*args[:3])
        bands = build_band_matrix(np.linspace(2500.0, 5000.0, W), filters,
                                  device=f32["device"], dtype=torch.float32)
        e_out = rel_err(got, ref)
        e_band = rel_err(band_integrate(bands, got),
                         band_integrate(bands, ref))
        if W == 2501:
            max_abs = abs_err(got, ref)
        print(f"# phase 2: R={R} L={L} W={W} C={C} transit: slant tau in "
              f"[0.1, 10] at {mixed:.3f} of points; out max rel err "
              f"{e_out:.3e}, band {e_band:.3e}, max abs "
              f"{abs_err(got, ref):.3e}; vs float64 plain: kernel "
              f"{rel_err(got, ref64):.3e}, float32 plain "
              f"{rel_err(ref, ref64):.3e}")
        del ref64
        check(mixed >= MIXED_SHARE, f"saturated test problem ({mixed})")
        check(bool(torch.isfinite(got).all()), "non-finite kernel output")
        check(e_out < OUT_RTOL, f"transit out rel err {e_out}")
        check(e_band < BAND_RTOL, f"transit band rel err {e_band}")
    return max_abs


def transit_path(fused, fm, inp, nchain: int, f32: dict) -> dict:
    """Phases 3 and 4 of the transit path on the eclipse model's opacity
    table: a 512-chain forward, then a short snooker retrieval.  Returns
    what phase 5 times."""
    import torch

    from bart_tpu_torch.demo import (DEMO_PARAMS_TRANSIT, TRANSIT_BOUNDS,
                                     TRUTH_TRANSIT, build_demo_model)
    from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
    from bart_tpu_torch.inference.retrieval import run_mcmc
    from bart_tpu_torch.obs.bands import band_integrate
    from bart_tpu_torch.rt.transit_geom import slant_geometry

    fmt = build_demo_model(inp, device=f32["device"], dtype=torch.float32,
                           grid=fm.opacity, solution="transit", cia=True)
    check(fmt.opacity.sigma.data_ptr() == fm.opacity.sigma.data_ptr(),
          "the transit model holds a second opacity grid")
    check(fmt.tables["tab"].tab.shape[0] == 27 + 14,
          "the transit model's prepared table lacks the CIA rows")
    fused.fused_transit.launches = 0          # the transit path starts here
    rng = np.random.default_rng(1)
    spread = np.where(np.arange(7) == 5, 10.0, 0.005)    # radius in km
    params = torch.tensor(np.tile(DEMO_PARAMS_TRANSIT, (nchain, 1))
                          + rng.normal(0, 1, (nchain, 7)) * spread, **f32)
    forward = fmt.batched()
    band, spec, valid = forward(params)
    torch.cuda.synchronize()
    check(tuple(band.shape) == (nchain, 10), f"band shape {band.shape}")
    check(tuple(spec.shape) == (nchain, len(inp.wn)),
          f"spectrum shape {spec.shape}")
    check(bool(valid.all()), "invalid transit forward samples")
    check(bool(torch.isfinite(band).all() & torch.isfinite(spec).all()),
          "non-finite transit forward output")
    check(fused.fused_transit.launches >= 1,
          "transit forward did not launch the kernel")
    # the forward's own rows through the plain version, on out itself
    t = fmt.tables
    T_safe, q, rad_cm, _ = fmt._profiles(params, t)
    ((rtab, _, _, _),), wrows = fmt._fused_rows(params, t, T_safe, q, rad_cm)
    check(rtab is t["tab"], "the forward does not use the prepared table")
    tab = rtab.plain().contiguous()      # for the plain version
    G, wgt = slant_geometry(rad_cm)
    n = fused.fused_transit.launches
    got = fused.fused_transit(rtab, wrows, G, wgt)
    fused.fused_transit.launches = n     # a comparison, not the path's
    plain = fused.transit_plain(tab, wrows, G, wgt)
    r_star2 = (fmt.system.r_star * 100.0) ** 2
    plain_spec = (rad_cm[:, -1:] ** 2 + plain) / r_star2
    e_out = rel_err(got, plain)
    e_spec = rel_err(spec, plain_spec)
    e_band = rel_err(band, band_integrate(t["band_w"], plain_spec))
    mixed = mixed_share(tab, wrows, G)
    print(f"# phase 3: {nchain}-chain transit forward (R={tab.shape[0]} "
          f"rows, the eclipse model's opacity table): depths "
          f"{float(band.min()):.4e}..{float(band.max()):.4e}; slant tau in "
          f"[0.1, 10] at {mixed:.3f} of points; kernel vs plain out "
          f"{e_out:.3e}, depth {e_spec:.3e}, band {e_band:.3e}")
    check(e_out < OUT_RTOL, f"transit forward out rel err {e_out}")
    check(e_band < BAND_RTOL, f"transit forward band rel err {e_band}")
    check(bool(((band > 0.01) & (band < 0.03)).all()),
          "transit depths outside (1%, 3%)")

    # phase 4: a short transit retrieval
    data = forward(torch.tensor(TRUTH_TRANSIT[None], **f32))[0][0]
    data = data.double().cpu().numpy()
    uncert = 0.005 * data
    data = data + np.random.default_rng(42).normal(0, 1, data.shape) * uncert
    pmin, pmax, step = TRANSIT_BOUNDS
    space = ParamSpace(pinit=DEMO_PARAMS_TRANSIT, pmin=pmin, pmax=pmax,
                       stepsize=step)
    like = Likelihood(fmt, space, data, uncert)
    before = fused.fused_transit.launches
    t0 = time.perf_counter()
    res = run_mcmc(like, space, nchains=nchain, numit=nchain * 30,
                   burnin=10, block=10, seed=7, verbose=False)
    mcmc_s = time.perf_counter() - t0
    launches = fused.fused_transit.launches   # the transit path ends here
    print(f"# phase 4: transit snooker {nchain} chains x "
          f"{res.niter_total // nchain} steps in {mcmc_s:.2f} s: best chi2 "
          f"{-2 * res.best_loglike:.3f}, accept {res.accept_rate:.3f}; "
          f"kernel launches {launches} ({launches - before} in the "
          f"retrieval)")
    check(np.isfinite(res.best_loglike), "non-finite transit best loglike")
    check(res.accept_rate > 0.0, "no accepted transit proposal")
    check(launches > before, "transit retrieval did not launch the kernel")
    return dict(fm=fmt, forward=forward, params=params, launches=launches,
                rows=(tab, wrows, G, wgt), rtab=rtab)


def transit_times(fused, path: dict):
    """Phase 5, transit: (kernel ms, transit_plain ms, forward ms and its
    rounds, forward less the kernel ms and its rounds)."""
    import torch

    from bart_tpu_torch.obs.bands import band_integrate
    from bart_tpu_torch.rt.transit_geom import slant_geometry

    fmt, rows = path["fm"], path["rows"]
    t = fmt.tables
    # as the forward launches it: the prepared table and slant matrix
    Gp = fused.prepare_slant(rows[2])
    k_ms = cuda_ms(lambda: fused.fused_transit(path["rtab"], rows[1], Gp,
                                               rows[3]), 20)
    p_ms = cuda_ms(lambda: fused.transit_plain(*rows), 5)
    fwd = serialized_ms(lambda p: path["forward"](p)[0], path["params"], 20)
    zero_spec = torch.zeros(rows[1].shape[0], rows[0].shape[2],
                            dtype=rows[0].dtype, device=rows[0].device)

    def no_kernel(p):
        # the forward's own work around the kernel: profiles, rows, the
        # slant geometry and the band integration
        Ts, qq, rr, _ = fmt._profiles(p, t)
        _, wr = fmt._fused_rows(p, t, Ts, qq, rr)
        G, wgt = slant_geometry(rr)
        return band_integrate(t["band_w"], zero_spec + 0.0 * (
            wr.sum() + G.sum() + wgt.sum()))

    rest = serialized_ms(no_kernel, path["params"], 20)
    return k_ms, p_ms, fwd, rest


def folded_kernels_vs_plain(fused, filters, f32: dict, quads: dict) -> dict:
    """Phase 2, folded: each folded kernel vs its plain version on random
    rows at the full-width shape (K = 32, float32 and bfloat16 tables)
    and a ragged one (K = 4).  Returns each kernel's max abs error at the
    full-width shape."""
    import torch

    from bart_tpu_torch.demo import (fine_structure, random_rows,
                                     random_transit_rows)
    from bart_tpu_torch.obs.bands import band_integrate, build_band_matrix

    def fine_table(tab, K):
        R, L, W = tab.shape
        factor = torch.tensor(fine_structure(R, W, K), **f32)
        return (tab[..., None] * factor).reshape(R, L, W * K)

    def report(what, got, ref, ref64, mean, bands, rtol, extra=""):
        e, e_band = rel_err(got, ref), rel_err(band_integrate(bands, got),
                                               band_integrate(bands, ref))
        diff = rel_err(got, mean)
        print(f"# phase 2: {what}: max rel err {e:.3e}, band {e_band:.3e}, "
              f"max abs {abs_err(got, ref):.3e}; vs float64 plain: kernel "
              f"{rel_err(got, ref64):.3e}, float32 plain "
              f"{rel_err(ref, ref64):.3e}; differs from K = 1 on the "
              f"bin-mean table by up to {diff:.3e}{extra}")
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
        check(e < rtol, f"{what}: rel err {e}")
        check(e_band < BAND_RTOL, f"{what}: band rel err {e_band}")
        check(diff > FOLD_MIN_DIFF, f"{what}: no in-bin structure ({diff})")

    max_abs = {"eclipse": 0.0, "transit": 0.0}
    for (R, Rt, L, W, C, K) in ((27, 41, 100, 1125, 512, FOLD_K),
                                (18, 17, 23, 75, 6, 4)):
        bands = build_band_matrix(np.linspace(2500.0, 5000.0, W), filters,
                                  device=f32["device"], dtype=torch.float32)
        # ---- eclipse
        tab, wn, wrows, T, drp = (torch.tensor(a, **f32)
                                  for a in random_rows(R, L, W, C, seed=7))
        fine = fine_table(tab, K)
        for tdt in (torch.float32, torch.bfloat16):
            ft = fused.folded_table(fine, K, tdt)
            ft64 = fused.FoldedTable(ft.tab.double(), K, W)
            for quad, ((mu, muw), powers) in quads.items():
                rest = [torch.tensor(mu, **f32), torch.tensor(muw, **f32),
                        wrows, T, drp]
                got = fused.fused_eclipse_folded(ft, wn, *rest, powers)
                ref = fused.eclipse_folded_plain(ft, wn, *rest, powers)
                ref64 = fused.eclipse_folded_plain(
                    ft64, wn.double(), *(x.double() for x in rest), powers)
                mean = fused.fused_eclipse(tab, wn, *rest, powers)
                torch.cuda.synchronize()
                report(f"folded eclipse R={R} L={L} W={W} C={C} K={K} "
                       f"{str(tdt)[6:]} {quad}", got, ref, ref64, mean, bands,
                       SPEC_RTOL[powers])
                if K == FOLD_K:
                    max_abs["eclipse"] = max(max_abs["eclipse"],
                                             abs_err(got, ref))
                del ref64
        del tab, wrows, fine, ft, ft64
        # ---- transit
        tab, wrows, G, wgt = (
            torch.tensor(a, **f32)
            for a in random_transit_rows(Rt, L, W, C, seed=7)[:4])
        fine = fine_table(tab, K)
        nc = min(C, 16)
        mixed = mixed_share(fine, wrows[:nc], G[:nc])
        check(mixed >= MIXED_SHARE, f"saturated folded problem ({mixed})")
        for tdt in (torch.float32, torch.bfloat16):
            ft = fused.folded_table(fine, K, tdt)
            ft64 = fused.FoldedTable(ft.tab.double(), K, W)
            got = fused.fused_transit_folded(ft, wrows, G, wgt)
            ref = fused.transit_folded_plain(ft, wrows, G, wgt)
            ref64 = fused.transit_folded_plain(ft64, wrows.double(),
                                               G.double(), wgt.double())
            mean = fused.fused_transit(tab, wrows, G, wgt)
            torch.cuda.synchronize()
            report(f"folded transit R={Rt} L={L} W={W} C={C} K={K} "
                   f"{str(tdt)[6:]}", got, ref, ref64, mean, bands, OUT_RTOL,
                   f"; slant tau in [0.1, 10] at {mixed:.3f} of points")
            if K == FOLD_K:
                max_abs["transit"] = max(max_abs["transit"],
                                         abs_err(got, ref))
            del ref64
        del tab, wrows, G, wgt, fine, ft, ft64
    return max_abs


def ptxas_summary(log: str):
    """(kernel, registers, spill bytes) for every entry function in the
    output of ``nvcc -Xptxas -v``; the kernel's name is cut from its
    mangled symbol."""
    import re

    out = []
    for m in re.finditer(
            r"Function properties for (\S+)\s+(\d+) bytes stack frame, "
            r"(\d+) bytes spill stores, (\d+) bytes spill loads\s+"
            r"ptxas info\s+: Used (\d+) registers", log):
        # ...<len>fused_x_kernelI<template arguments>EEv<parameters>
        name = re.search(r".*\d(fused_\w+?_kernel)(I\w+?E(?=Ev))?", m.group(1))
        out.append(((name.group(1) + (name.group(2) or "")) if name
                    else m.group(1),
                    int(m.group(5)), int(m.group(3)) + int(m.group(4))))
    return out


def kernel_times(fused, f32: dict, quads: dict) -> None:
    """``--kernels``: the four kernels' times on phase 2's random rows at
    the full-width shapes (the folded ones on float32 and bfloat16
    tables, 1,125 fine bins x 32), without the forwards."""
    import torch

    from bart_tpu_torch.demo import (fine_structure, random_rows,
                                     random_transit_rows)

    R, Rt, L, W, C, K = 27, 41, 100, 1125, 512, FOLD_K

    def fine_table(tab):
        factor = torch.tensor(fine_structure(tab.shape[0], W, K), **f32)
        return (tab[..., None] * factor).reshape(*tab.shape[:2], W * K)

    tab, wn, wrows, T, drp = (torch.tensor(a, **f32)
                              for a in random_rows(R, L, 2501, C, seed=7))
    for quad, ((mu, muw), powers) in quads.items():
        rest = [torch.tensor(mu, **f32), torch.tensor(muw, **f32), wrows, T,
                drp]
        print(f"# kernels: fused_eclipse {quad} "
              f"{cuda_ms(lambda: fused.fused_eclipse(tab, wn, *rest, powers), 20):.3f} ms")
    tab, wn, wrows, T, drp = (torch.tensor(a, **f32)
                              for a in random_rows(R, L, W, C, seed=7))
    fine = fine_table(tab)
    for tdt in (torch.bfloat16, torch.float32):
        ft = fused.folded_table(fine, K, tdt)
        for quad, ((mu, muw), powers) in quads.items():
            rest = [torch.tensor(mu, **f32), torch.tensor(muw, **f32), wrows,
                    T, drp]
            ms = cuda_ms(lambda: fused.fused_eclipse_folded(ft, wn, *rest,
                                                            powers), 5)
            print(f"# kernels: fused_eclipse_folded {str(tdt)[6:]} {quad} "
                  f"{W} bins x {K}: {ms:.3f} ms")
    del tab, wrows, fine, ft
    args = [torch.tensor(a, **f32)
            for a in random_transit_rows(Rt, L, 2501, C, seed=7)[:4]]
    print(f"# kernels: fused_transit "
          f"{cuda_ms(lambda: fused.fused_transit(*args), 20):.3f} ms; with a "
          f"prepared G "
          f"{cuda_ms(lambda: fused.fused_transit(*args[:2], fused.prepare_slant(args[2]), args[3]), 20):.3f} ms")
    tab, wrows, G, wgt = (torch.tensor(a, **f32)
                          for a in random_transit_rows(Rt, L, W, C, seed=7)[:4])
    fine = fine_table(tab)
    Gp = fused.prepare_slant(G)
    for tdt in (torch.bfloat16, torch.float32):
        ft = fused.folded_table(fine, K, tdt)
        ms = cuda_ms(lambda: fused.fused_transit_folded(ft, wrows, Gp, wgt), 5)
        print(f"# kernels: fused_transit_folded {str(tdt)[6:]} {W} bins x "
              f"{K}: {ms:.3f} ms")


def folded_path(fused, inp, solution: str, grid, fm_k1, nchain: int,
                f32: dict, budget_bytes: float) -> dict:
    """Phases 3 and 4 of one folded path (``grid`` None builds the fine
    opacity table): a 512-chain forward checked part by part against the
    plain versions and against the K = 1 model ``fm_k1``, then a short
    snooker retrieval.  Returns what phase 5 times and the path's
    launch counts."""
    import torch

    from bart_tpu_torch.demo import (DEMO_PARAMS, DEMO_PARAMS_TRANSIT,
                                     TRANSIT_BOUNDS, TRUTH, TRUTH_TRANSIT,
                                     build_demo_model)
    from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
    from bart_tpu_torch.inference.retrieval import run_mcmc
    from bart_tpu_torch.obs.bands import band_integrate
    from bart_tpu_torch.rt.transit_geom import slant_geometry

    transit = solution == "transit"
    kernels = ((fused.fused_transit_folded, fused.fused_transit) if transit
               else (fused.fused_eclipse_folded, fused.fused_eclipse))
    if grid is None:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fm = build_demo_model(
        inp, device=f32["device"], dtype=torch.float32, grid=grid,
        quadrature="raygrid" if transit else "expsum", solution=solution,
        cia=transit, fold=FOLD_K, fold_adapt=0.02, fold_bf16=True,
        budget_bytes=budget_bytes)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t = fm.tables
    check(fm._idx_fine is not None, "the adaptive split did not activate")
    n_f, n_s = len(fm._idx_fine), len(fm._idx_smooth)
    print(f"# phase 3: folded {solution} model (K={FOLD_K}, adaptive 0.02, "
          f"bf16 fine rows) "
          + (f"with the fine table {tuple(fm.opacity.sigma.shape)} built on "
             f"the card " if grid is None else "on the same fine table ")
          + f"in {setup_s:.1f} s (peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB): "
          f"{n_f} of {n_f + n_s} bins fine ({n_f / (n_f + n_s):.3f}); tabk "
          f"{tuple(t['tabk'].tab.shape)} {str(t['tabk'].tab.dtype)[6:]}, "
          f"tabs {tuple(t['tabs'].tab.shape)}")
    check(n_f + n_s == len(inp.wn), "the split lost bins")
    check(t["tabk"].tab.dtype == torch.bfloat16, "fine rows are not bf16")
    check(bool(torch.isfinite(fm.opacity.sigma).all()),
          "non-finite fine opacity table")

    for k in kernels:
        k.launches = 0                        # the folded path starts here
    rng = np.random.default_rng(2)
    if transit:
        base, truth = DEMO_PARAMS_TRANSIT, TRUTH_TRANSIT
        spread = np.where(np.arange(7) == 5, 10.0, 0.005)
    else:
        base, truth, spread = DEMO_PARAMS, TRUTH, 0.005
    params = torch.tensor(np.tile(base, (nchain, 1))
                          + rng.normal(0, 1, (nchain, len(base))) * spread,
                          **f32)
    forward = fm.batched()
    band, spec, valid = forward(params)
    torch.cuda.synchronize()
    check(tuple(band.shape) == (nchain, 10), f"band shape {band.shape}")
    check(tuple(spec.shape) == (nchain, len(inp.wn)),
          f"spectrum shape {spec.shape}")
    check(bool(valid.all()), f"invalid folded {solution} samples")
    check(bool(torch.isfinite(band).all() & torch.isfinite(spec).all()),
          f"non-finite folded {solution} output")
    check(all(k.launches == 1 for k in kernels),
          f"folded {solution} forward launched "
          f"{[k.launches for k in kernels]}, expected one of each")
    counts = [k.launches for k in kernels]

    # the forward's own rows through the plain versions, part by part
    T_safe, q, rad_cm, _ = fm._profiles(params, t)
    parts, wrows = fm._fused_rows(params, t, T_safe, q, rad_cm)
    if transit:
        geom = slant_geometry(rad_cm)
        rows = {True: (wrows, *geom), False: (wrows, *geom)}
        plains = {True: fused.transit_folded_plain,
                  False: lambda tab, *a: fused.transit_plain(tab.plain(), *a)}
        rtol = OUT_RTOL
    else:
        dr = rad_cm[:, :-1] - rad_cm[:, 1:]
        drp = torch.cat([torch.zeros_like(dr[:, :1]), dr], dim=1)
        tail = (t["mu"], t["mu_w"], wrows, T_safe, drp, fm._powers)
        rows = {True: (t["wn_f"], *tail), False: (t["wn_s"], *tail)}
        plains = {True: fused.eclipse_folded_plain,
                  False: lambda tab, *a: fused.eclipse_plain(tab.plain(), *a)}
        rtol = SPEC_RTOL[fm._powers]
    pieces, errs = [], []
    for (tab, folded, _, idx), kernel in zip(parts, kernels):
        got = kernel(tab, *rows[folded])
        plain = plains[folded](tab, *rows[folded])
        errs.append(rel_err(got, plain))
        pieces.append((plain, idx))
    plain_spec = fm._assemble(pieces, len(inp.wn))
    if transit:
        plain_spec = (rad_cm[:, -1:] ** 2 + plain_spec) / (
            fm.system.r_star * 100.0) ** 2
    e_band = rel_err(band, band_integrate(t["band_w"], plain_spec))
    # against the K = 1 model on the 2501-point table
    band1, spec1, _ = fm_k1.batched()(params)
    d_band, d_spec = rel_err(band, band1), rel_err(spec, spec1)
    for k, n in zip(kernels, counts):
        k.launches = n                        # comparisons do not count
    print(f"# phase 3: {nchain}-chain folded {solution} forward: depths "
          f"{float(band.min()):.4e}..{float(band.max()):.4e}; kernel vs "
          f"plain: folded part {errs[0]:.3e}, K = 1 part {errs[1]:.3e}, band "
          f"{e_band:.3e}; vs the K = 1 forward on the 2501-point table: band "
          f"{d_band:.3e}, spectrum {d_spec:.3e}")
    check(max(errs) < rtol, f"folded {solution} parts rel err {errs}")
    check(e_band < BAND_RTOL, f"folded {solution} band rel err {e_band}")
    check(d_band < FOLD_K1_BAND_RTOL,
          f"folded {solution} bands {d_band} from the K = 1 forward")

    # phase 4: a short folded retrieval
    data = forward(torch.tensor(truth[None], **f32))[0][0]
    data = data.double().cpu().numpy()
    uncert = (0.005 if transit else 0.03) * data
    data = data + np.random.default_rng(42).normal(0, 1, data.shape) * uncert
    if transit:
        pmin, pmax, step = TRANSIT_BOUNDS
    else:
        pmin, pmax, step = ([-5, -2, -2, 0, 0.55, -9], [-1, 1, 1, 1, 1.2, 1.5],
                            [0.01, 0.01, 0.0, 0.0, 0.001, 0.1])
    space = ParamSpace(pinit=base, pmin=pmin, pmax=pmax, stepsize=step)
    like = Likelihood(fm, space, data, uncert)
    before = [k.launches for k in kernels]
    t0 = time.perf_counter()
    res = run_mcmc(like, space, nchains=nchain, numit=nchain * 30,
                   burnin=10, block=10, seed=7, verbose=False)
    mcmc_s = time.perf_counter() - t0
    counts = [k.launches for k in kernels]     # the folded path ends here
    print(f"# phase 4: folded {solution} snooker {nchain} chains x "
          f"{res.niter_total // nchain} steps in {mcmc_s:.2f} s: best chi2 "
          f"{-2 * res.best_loglike:.3f}, accept {res.accept_rate:.3f}; "
          f"launches: folded kernel {counts[0]}, K = 1 kernel {counts[1]} "
          f"({counts[0] - before[0]} and {counts[1] - before[1]} in the "
          f"retrieval)")
    check(np.isfinite(res.best_loglike), "non-finite folded best loglike")
    check(res.accept_rate > 0.0, "no accepted folded proposal")
    check(all(n > b for n, b in zip(counts, before)),
          f"folded {solution} retrieval did not launch both kernels")
    return dict(fm=fm, forward=forward, params=params, launches=counts,
                parts=parts, rows=rows, kernels=kernels, plains=plains,
                solution=solution)


def folded_times(fused, path: dict) -> dict:
    """Phase 5 of one folded path: ms of the folded kernel, its plain
    version, the K = 1 kernel on the smooth bins, the whole forward and
    the forward less the kernels (with their rounds)."""
    import torch

    from bart_tpu_torch.obs.bands import band_integrate
    from bart_tpu_torch.rt.transit_geom import slant_geometry

    fm, parts, rows = path["fm"], path["parts"], path["rows"]
    t = fm.tables
    (tabk, _, _, idx_f), (tabs, _, _, idx_s) = parts
    kernels, plains = path["kernels"], path["plains"]
    counts = [k.launches for k in kernels]
    krows = rows
    if path["solution"] == "transit":
        # as the forward launches the kernels: one prepared slant matrix
        wr, G, wgt = rows[True]
        krows = dict.fromkeys(
            rows, (wr, fused.prepare_slant(G), wgt))
    out = dict(
        k_ms=cuda_ms(lambda: kernels[0](tabk, *krows[True]), 5),
        p_ms=cuda_ms(lambda: plains[True](tabk, *rows[True]), 2),
        k1_ms=cuda_ms(lambda: kernels[1](tabs, *krows[False]), 10))
    out["fwd"] = serialized_ms(lambda p: path["forward"](p)[0],
                               path["params"], 5)
    C, n_wn = path["params"].shape[0], t["wn"].shape[0]
    zeros = [(torch.zeros(C, len(i), dtype=torch.float32, device=i.device), i)
             for i in (idx_f, idx_s)]

    def no_kernel(p):
        # the forward's own work around the kernels: profiles, rows, the
        # geometry, putting the pieces together and the band integration
        Ts, qq, rr, _ = fm._profiles(p, t)
        _, wr = fm._fused_rows(p, t, Ts, qq, rr)
        if path["solution"] == "transit":
            extra = sum(x.sum() for x in slant_geometry(rr))
        else:
            d = rr[:, :-1] - rr[:, 1:]
            extra = torch.cat([torch.zeros_like(d[:, :1]), d], dim=1).sum()
        spec = fm._assemble(zeros, n_wn)
        return band_integrate(t["band_w"], spec + 0.0 * (wr.sum() + extra))

    out["rest"] = serialized_ms(no_kernel, path["params"], 10)
    for k, n in zip(kernels, counts):
        k.launches = n
    return out


#: the stages of a forward that ``--trace`` labels: functions that
#: bart_tpu_torch.rt.forward calls by these names
TRACE_STAGES = ("pt_generator", "radius_profile", "slant_geometry",
                "prepare_slant", "band_integrate", "fused_eclipse",
                "fused_transit", "fused_eclipse_folded",
                "fused_transit_folded")


def is_device_event(event) -> bool:
    """A profiler event that ran on the card (a kernel, a copy, a memset),
    not the device-side echo of a ``stage:`` label."""
    from torch.autograd import DeviceType

    return (event.device_type == DeviceType.CUDA
            and not event.name.startswith("stage:"))


def busy_and_gaps(intervals):
    """(busy time, [(gap start, gap end)]) of device intervals
    [(start, end)]: the length of their union and the idle stretches
    between its pieces, in the intervals' unit."""
    busy, gaps = 0.0, []
    cur_s, cur_e = None, None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def trace_forwards(paths: dict, smi: str, nfwd: int = 5) -> None:
    """Phase 6: one torch.profiler trace of ``nfwd`` forwards per path,
    each window ending in a host read.  Prints, per path, the wall time
    with and without the profiler, the device-busy share of the traced
    window, the five device operations that took most time, and the five
    stages of the forward during which the device idled longest (the
    stages are labelled with record_function for the trace only).
    Raises if the profiler records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import bart_tpu_torch.rt.forward as fwd_mod

    def labelled(name, fn):
        def wrapper(*args, **kwargs):
            with record_function("stage:" + name):
                return fn(*args, **kwargs)
        return wrapper

    def run(forward, params):
        t0 = time.perf_counter()
        for _ in range(nfwd):
            out = forward(params)[0]
        float(out.sum())
        return 1e3 * (time.perf_counter() - t0)

    saved = {name: getattr(fwd_mod, name) for name in TRACE_STAGES}
    saved_rows = fwd_mod.ForwardModel._fused_rows
    try:
        for name, fn in saved.items():
            setattr(fwd_mod, name, labelled(name, fn))
        fwd_mod.ForwardModel._fused_rows = labelled("rows", saved_rows)
        for path, (forward, params) in paths.items():
            run(forward, params)                         # warm
            plain_ms = run(forward, params)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall_ms = run(forward, params)
                torch.cuda.synchronize()
            events = list(prof.events())
            dev = [e for e in events if is_device_event(e)]
            if not dev:
                raise RuntimeError(f"chip_smoke: trace {path}: "
                                   "torch.profiler recorded no device activity")
            busy_us, gaps = busy_and_gaps(
                [(e.time_range.start, e.time_range.end) for e in dev])
            start = min(e.time_range.start for e in events)
            end = max(e.time_range.end for e in events)
            gaps = [(start, min(e.time_range.start for e in dev))] + gaps + [
                (max(e.time_range.end for e in dev), end)]
            by_op = {}
            for e in dev:
                n, us = by_op.get(e.name, (0, 0.0))
                by_op[e.name] = (n + 1,
                                 us + e.time_range.end - e.time_range.start)
            stages = [(e.time_range.start, e.time_range.end, e.name[6:])
                      for e in events if e.device_type == DeviceType.CPU
                      and e.name.startswith("stage:")]
            idle = {}
            for gs, ge in gaps:
                left = ge - gs
                for ss, se, label in stages:
                    over = min(ge, se) - max(gs, ss)
                    if over > 0:
                        idle[label] = idle.get(label, 0.0) + over
                        left -= over
                idle["other"] = idle.get("other", 0.0) + max(left, 0.0)
            window_us = end - start
            top_ops = sorted(by_op.items(), key=lambda kv: -kv[1][1])[:5]
            top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:5]
            print(f"# phase 6 ({smi}): trace of {nfwd} {path} forwards: "
                  f"wall {wall_ms:.2f} ms traced, {plain_ms:.2f} ms untraced; "
                  f"traced window {window_us / 1e3:.2f} ms, device busy "
                  f"{busy_us / 1e3:.2f} ms = {busy_us / window_us:.3f} of it "
                  f"in {len(dev)} device operations")
            print(f"# phase 6: {path}: device operations: " + "; ".join(
                f"{name[:60]} {us / 1e3:.3f} ms x{n}"
                for name, (n, us) in top_ops))
            print(f"# phase 6: {path}: device idle by forward stage: "
                  + "; ".join(f"{label} {us / 1e3:.2f} ms"
                              for label, us in top_idle))
            check(0.0 < busy_us <= window_us, f"trace {path}: busy time "
                  f"{busy_us} us outside the window {window_us} us")
    finally:
        for name, fn in saved.items():
            setattr(fwd_mod, name, fn)
        fwd_mod.ForwardModel._fused_rows = saved_rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bart_tpu_torch.demo import (DEMO_PARAMS, TRUTH, build_demo_model,
                                     demo_inputs, random_rows)
    from bart_tpu_torch.device import resolve_device
    from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
    from bart_tpu_torch.inference.retrieval import run_mcmc
    from bart_tpu_torch.obs.bands import band_integrate, build_band_matrix
    from bart_tpu_torch.rt import fused
    from bart_tpu_torch.rt.eclipse import expsum_weights, raygrid_weights

    # --- phase 0: the card ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    print(smi.strip().splitlines()[0])
    dev = resolve_device("cuda")
    print(f"# torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    f32 = dict(dtype=torch.float32, device=dev)
    quads = {"raygrid": (raygrid_weights([0.0, 20.0, 40.0, 60.0, 80.0]),
                         False),
             "expsum": (expsum_weights(8), True)}

    # --- phase 1: build ------------------------------------------------
    t0 = time.perf_counter()
    logs = fused.build_kernels(ptxas_verbose=True)
    names = ("fused_eclipse", "fused_transit", "fused_eclipse_folded",
             "fused_transit_folded")
    for name in names:
        fused.load_kernel(name)
    print(f"# phase 1: {len(names)} kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for kernel, regs, spill in ptxas_summary(log):
            print(f"# phase 1: {name}.cu {kernel}: {regs} registers, "
                  f"{spill} B of spill stores and loads")

    # --- phase 2: kernel vs plain on random rows ----------------------
    inp_full = demo_inputs()
    max_abs = 0.0
    for (R, L, W, C) in ((27, 100, 2501, 512), (18, 23, 300, 6),
                         (48, 23, 301, 33)):
        tab, wn, wrows, T, drp = (torch.tensor(a, **f32)
                                  for a in random_rows(R, L, W, C, seed=7))
        bands = build_band_matrix(wn.cpu().numpy(), inp_full.filters,
                                  device=dev, dtype=torch.float32)
        for quad, ((mu, muw), powers) in quads.items():
            mu_t, muw_t = torch.tensor(mu, **f32), torch.tensor(muw, **f32)
            got = fused.fused_eclipse(tab, wn, mu_t, muw_t, wrows, T, drp,
                                      powers)
            ref = fused.eclipse_plain(tab, wn, mu_t, muw_t, wrows, T, drp,
                                      powers)
            ref64 = fused.eclipse_plain(
                *(x.double() for x in (tab, wn, mu_t, muw_t, wrows, T, drp)),
                powers)
            torch.cuda.synchronize()
            e_spec = rel_err(got, ref)
            e_band = rel_err(band_integrate(bands, got),
                             band_integrate(bands, ref))
            if W == 2501:
                max_abs = max(max_abs, abs_err(got, ref))
            print(f"# phase 2: R={R} L={L} W={W} C={C} {quad}: spectrum "
                  f"max rel err {e_spec:.3e}, band {e_band:.3e}, max abs "
                  f"{abs_err(got, ref):.3e}; vs float64 plain: kernel "
                  f"{rel_err(got, ref64):.3e}, float32 plain "
                  f"{rel_err(ref, ref64):.3e}")
            del ref64
            check(bool(torch.isfinite(got).all()), "non-finite kernel output")
            check(e_spec < SPEC_RTOL[powers], f"spectrum rel err {e_spec}")
            check(e_band < BAND_RTOL, f"band rel err {e_band}")
        del tab, wrows
    t_max_abs = transit_kernel_vs_plain(fused, inp_full.filters, f32)
    f_max_abs = folded_kernels_vs_plain(fused, inp_full.filters, f32, quads)
    if "--kernels" in sys.argv[1:]:
        kernel_times(fused, f32, quads)
        return 0
    fused.fused_eclipse.launches = 0   # comparisons do not count

    # --- phase 3: full-width forward -----------------------------------
    t0 = time.perf_counter()
    fm = build_demo_model(inp_full, device=dev, dtype=torch.float32,
                          budget_bytes=8e9)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"# phase 3: opacity table {tuple(fm.sigma.shape)} built on the "
          f"card in {build_s:.1f} s (peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB)")
    check(bool(torch.isfinite(fm.sigma).all()), "non-finite opacity table")
    check(float(fm.sigma.max()) > 0.0, "empty opacity table")

    nchain = 512
    rng = np.random.default_rng(0)
    params = torch.tensor(np.tile(DEMO_PARAMS, (nchain, 1))
                          + rng.normal(0, 0.005, (nchain, 6)), **f32)
    forward = fm.batched()
    band, spec, valid = forward(params)
    torch.cuda.synchronize()
    check(tuple(band.shape) == (nchain, 10), f"band shape {band.shape}")
    check(tuple(spec.shape) == (nchain, 2501), f"spectrum shape {spec.shape}")
    check(bool(valid.all()), "invalid forward samples")
    check(bool(torch.isfinite(band).all() & torch.isfinite(spec).all()),
          "non-finite forward output")
    check(fused.fused_eclipse.launches >= 1, "forward did not launch kernel")
    # the same rows through the plain version
    t = fm.tables
    T_safe, q, rad_cm, _ = fm._profiles(params, t)
    ((rtab, _, _, _),), wrows = fm._fused_rows(params, t, T_safe, q, rad_cm)
    check(rtab is t["tab"], "the forward does not use the prepared table")
    tab = rtab.plain().contiguous()      # for the plain version
    dr = rad_cm[:, :-1] - rad_cm[:, 1:]
    drp = torch.cat([torch.zeros_like(dr[:, :1]), dr], dim=1)
    plain = fused.eclipse_plain(tab, t["wn"], t["mu"], t["mu_w"], wrows,
                                T_safe, drp, fm._powers)
    e_spec = rel_err(spec, plain)
    e_band = rel_err(band, band_integrate(t["band_w"], plain))
    print(f"# phase 3: {nchain}-chain forward: eclipse depths "
          f"{float(band.min()):.4e}..{float(band.max()):.4e}; kernel vs plain "
          f"spectrum {e_spec:.3e}, band {e_band:.3e}")
    check(e_spec < SPEC_RTOL[fm._powers],
          f"forward spectrum rel err {e_spec}")
    check(e_band < BAND_RTOL, f"forward band rel err {e_band}")
    check(bool(((band > 0) & (band < 0.02)).all()),
          "eclipse depths outside (0, 2%)")

    # --- phase 4: a short retrieval ------------------------------------
    data = forward(torch.tensor(TRUTH[None], **f32))[0][0].double().cpu()
    data = data.numpy()
    uncert = 0.03 * data
    data = data + np.random.default_rng(42).normal(0, 1, data.shape) * uncert
    space = ParamSpace(pinit=DEMO_PARAMS, pmin=[-5, -2, -2, 0, 0.55, -9],
                       pmax=[-1, 1, 1, 1, 1.2, 1.5],
                       stepsize=[0.01, 0.01, 0.0, 0.0, 0.001, 0.1])
    like = Likelihood(fm, space, data, uncert)
    before = fused.fused_eclipse.launches
    t0 = time.perf_counter()
    res = run_mcmc(like, space, nchains=nchain, numit=nchain * 30,
                   burnin=10, block=10, seed=7, verbose=False)
    mcmc_s = time.perf_counter() - t0
    launches = fused.fused_eclipse.launches           # main path ends here
    print(f"# phase 4: snooker {nchain} chains x {res.niter_total // nchain} "
          f"steps in {mcmc_s:.2f} s: best chi2 {-2 * res.best_loglike:.3f}, "
          f"accept {res.accept_rate:.3f}; kernel launches {launches} "
          f"({launches - before} in the retrieval)")
    check(np.isfinite(res.best_loglike), "non-finite best loglike")
    check(res.accept_rate > 0.0, "no accepted proposal")
    check(launches > before, "retrieval did not launch the kernel")

    # --- phases 3 and 4, transit ---------------------------------------
    tpath = transit_path(fused, fm, inp_full, nchain, f32)

    # --- phases 3 and 4, folded: eclipse builds the fine table ---------
    fm_k1 = build_demo_model(inp_full, device=dev, dtype=torch.float32,
                             grid=fm.opacity, quadrature="expsum")
    fpath = folded_path(fused, inp_full, "eclipse", None, fm_k1, nchain, f32,
                        budget_bytes=24e9)
    ftpath = folded_path(fused, inp_full, "transit", fpath["fm"].opacity,
                         tpath["fm"], nchain, f32, budget_bytes=24e9)

    # --- phase 5: times ------------------------------------------------
    mu, muw = t["mu"], t["mu_w"]
    k_ms = cuda_ms(lambda: fused.fused_eclipse(
        rtab, t["wn"], mu, muw, wrows, T_safe, drp, fm._powers), 20)
    p_ms = cuda_ms(lambda: fused.eclipse_plain(
        tab, t["wn"], mu, muw, wrows, T_safe, drp, fm._powers), 5)
    fwd_ms, fwd_rounds = serialized_ms(lambda p: forward(p)[0], params, 20)
    zero_spec = torch.zeros_like(spec)

    def no_kernel(p):
        # the forward's own work around the kernel: profiles, rows, the
        # layer steps and the band integration
        Ts, qq, rr, _ = fm._profiles(p, t)
        _, wr = fm._fused_rows(p, t, Ts, qq, rr)
        d = rr[:, :-1] - rr[:, 1:]
        d = torch.cat([torch.zeros_like(d[:, :1]), d], dim=1)
        return band_integrate(t["band_w"],
                              zero_spec + 0.0 * (wr.sum() + d.sum()))

    rest_ms, rest_rounds = serialized_ms(no_kernel, params, 20)
    print(f"# phase 5 ({smi.strip()}): per {nchain}-chain batch: kernel "
          f"{k_ms:.3f} ms, eclipse_plain {p_ms:.3f} ms, forward "
          f"{fwd_ms:.3f} ms (rounds {', '.join(f'{x:.2f}' for x in fwd_rounds)}),"
          f" forward less the kernel {rest_ms:.3f} ms (rounds "
          f"{', '.join(f'{x:.2f}' for x in rest_rounds)})")
    tk_ms, tp_ms, (tf_ms, tf_rounds), (tr_ms, tr_rounds) = transit_times(
        fused, tpath)
    print(f"# phase 5 ({smi.strip()}): per {nchain}-chain batch: transit "
          f"kernel {tk_ms:.3f} ms, transit_plain {tp_ms:.3f} ms, transit "
          f"forward {tf_ms:.3f} ms (rounds "
          f"{', '.join(f'{x:.2f}' for x in tf_rounds)}), forward less the "
          f"kernel {tr_ms:.3f} ms (rounds "
          f"{', '.join(f'{x:.2f}' for x in tr_rounds)})")

    ft_ = {name: folded_times(fused, path)
           for name, path in (("eclipse", fpath), ("transit", ftpath))}
    for name, path in (("eclipse", fpath), ("transit", ftpath)):
        x, tabk = ft_[name], path["parts"][0][0]
        print(f"# phase 5 ({smi.strip()}): per {nchain}-chain batch: folded "
              f"{name} kernel {x['k_ms']:.3f} ms on {tabk.W} bins x "
              f"{tabk.K}, its plain version {x['p_ms']:.3f} ms, the K = 1 "
              f"kernel on the smooth bins {x['k1_ms']:.3f} ms, forward "
              f"{x['fwd'][0]:.3f} ms (rounds "
              f"{', '.join(f'{v:.2f}' for v in x['fwd'][1])}), forward less "
              f"the kernels {x['rest'][0]:.3f} ms (rounds "
              f"{', '.join(f'{v:.2f}' for v in x['rest'][1])})")

    # --- phase 6 (--trace): where the forwards' wall time goes ---------
    if "--trace" in sys.argv[1:]:
        trace_forwards({
            "eclipse": (forward, params),
            "transit": (tpath["forward"], tpath["params"]),
            "folded eclipse": (fpath["forward"], fpath["params"]),
            "folded transit": (ftpath["forward"], ftpath["params"])},
            smi.strip())

    # --- the kernels' record: bounds from this run's shapes ------------
    nmu = int(mu.shape[0])
    R, L, W = tab.shape
    e_bound = eclipse_bound(R, L, W, nchain, nmu, fm._powers, 1,
                            nbytes(tab, wrows, T_safe, drp, t["wn"]))
    ttab, twr, tG, twgt = tpath["rows"]
    t_bound = transit_bound(ttab.shape[0], L, W, nchain, 1,
                            nbytes(ttab, twr, tG, twgt))
    ftab = fpath["parts"][0][0]
    f_rows = fpath["rows"][True]
    f_bound = eclipse_bound(ftab.tab.shape[0], L, ftab.W * ftab.K, nchain,
                            int(f_rows[1].shape[0]), fpath["fm"]._powers,
                            ftab.K, nbytes(ftab.tab, *f_rows[:-1]))
    fttab = ftpath["parts"][0][0]
    ft_bound = transit_bound(fttab.tab.shape[0], L, fttab.W * fttab.K, nchain,
                             fttab.K, nbytes(fttab.tab, *ftpath["rows"][True]))

    # the FMAs of the bounds above that run on tensor cores
    tri = L * (L + 1) // 2
    pts = nchain * L * W
    e_tensor = tensor_share(pts * R, 0, pts * (R + nmu + 4), "tf32")
    pts = nchain * W
    t_R = ttab.shape[0]
    t_tensor = tensor_share(pts * L * t_R, pts * tri,
                            pts * (L * t_R + tri + L), "tf32")
    pts = nchain * L * ftab.W * ftab.K
    f_R, f_nmu = ftab.tab.shape[0], int(f_rows[1].shape[0])
    f_tensor = tensor_share(pts * f_R, 0, pts * (f_R + f_nmu + 4), "bf16")
    pts = nchain * fttab.W * fttab.K
    ft_R = fttab.tab.shape[0]
    ft_tensor = tensor_share(pts * L * ft_R, pts * tri,
                             pts * (L * ft_R + tri + L), "bf16")

    def record(name, replaces, by_path, max_abs_err, ms, plain_ms, bnd,
               tensor):
        # launches: on all main paths; launches_by_path: on each that
        # runs this kernel (the K = 1 kernels also serve the smooth bins
        # of the folded paths)
        return {"name": name, "route": "cuda",
                "source": f"bart_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "bound_term": bnd[2],
                # share of the bound's FMAs on tensor cores, in which
                # types, and their time at those types' dense peaks
                "tensor_fmas": tensor[0], "tensor_type": tensor[1],
                "tensor_ms": tensor[2],
                # no single PyTorch call computes any of the four
                "library_ms": None}

    print(json.dumps({"kernels": [
        record("fused_eclipse", KERNEL_REPLACES,
               {"eclipse": launches, "folded_eclipse": fpath["launches"][1]},
               max_abs, k_ms, p_ms, e_bound, e_tensor),
        record("fused_transit", TRANSIT_REPLACES,
               {"transit": tpath["launches"],
                "folded_transit": ftpath["launches"][1]},
               t_max_abs, tk_ms, tp_ms, t_bound, t_tensor),
        record("fused_eclipse_folded", FOLDED_REPLACES,
               {"folded_eclipse": fpath["launches"][0]},
               f_max_abs["eclipse"], ft_["eclipse"]["k_ms"],
               ft_["eclipse"]["p_ms"], f_bound, f_tensor),
        record("fused_transit_folded", FOLDED_TRANSIT_REPLACES,
               {"folded_transit": ftpath["launches"][0]}, f_max_abs["transit"],
               ft_["transit"]["k_ms"], ft_["transit"]["p_ms"], ft_bound,
               ft_tensor),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
