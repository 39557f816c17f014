#!/usr/bin/env python3
"""Drive bart_tpu_torch's main paths once on one CUDA card and check them.

The main paths are the MCMC hot loops of the demo CH4 retrievals at the
benchmark's full width (100 layers x 2501 wn x 30,000 lines x 27
T-nodes, 512 chains): PT profile -> abundances -> hydrostatic radii ->
rows -> a fused CUDA kernel -> bands -> likelihood -> snooker step.
Eclipse runs the fused eclipse kernel on the 27 line rows; transit
(examples/demo_transit.cfg: a fitted radius and the in-repo H2-H2 CIA
table, 27 + 14 = 41 rows) runs slant_geometry and the fused transit
kernel, on the same opacity table.  Phases:

  0. the card's name and power limit (nvidia-smi); no card -> exit 2
  1. build both kernels from bart_tpu_torch/csrc with nvcc, in parallel
  2. each kernel vs its plain torch version on random rows at the bench
     shape and a ragged one (eclipse: both quadratures; transit: rows
     whose slant tau crosses unity inside the atmosphere)
  3. the port's own opacity build on the card, then one 512-chain
     forward batch through ForwardModel.batched() per geometry
  4. a short snooker retrieval (run_mcmc) per geometry on synthetic data
  5. serialized times per geometry: kernel, plain version, whole
     forward, forward less the kernel

Each path's launch count is zeroed just before its phase 3 and read
just after its phase 4.  Any failed check raises and exits non-zero.
The last two lines of stdout are the kernels' JSON record and the
result JSON.

    python3 chip_smoke.py
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
    for (R, L, W, C) in ((41, 100, 2501, 512), (17, 23, 300, 6)):
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
    check(fmt.sigma.data_ptr() == fm.sigma.data_ptr(),
          "the transit model holds a second opacity table")
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
    tab, wrows = fmt._fused_rows(params, t, T_safe, q, rad_cm)
    G, wgt = slant_geometry(rad_cm)
    n = fused.fused_transit.launches
    got = fused.fused_transit(tab, wrows, G, wgt)
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
                rows=(tab, wrows, G, wgt))


def transit_times(fused, path: dict):
    """Phase 5, transit: (kernel ms, transit_plain ms, forward ms and its
    rounds, forward less the kernel ms and its rounds)."""
    import torch

    from bart_tpu_torch.obs.bands import band_integrate
    from bart_tpu_torch.rt.transit_geom import slant_geometry

    fmt, rows = path["fm"], path["rows"]
    t = fmt.tables
    k_ms = cuda_ms(lambda: fused.fused_transit(*rows), 20)
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
    fused.build_kernels()
    for name in ("fused_eclipse", "fused_transit"):
        fused.load_kernel(name)
    print(f"# phase 1: kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")

    # --- phase 2: kernel vs plain on random rows ----------------------
    inp_full = demo_inputs()
    max_abs = 0.0
    for (R, L, W, C) in ((27, 100, 2501, 512), (18, 23, 300, 6)):
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
    tab, wrows = fm._fused_rows(params, t, T_safe, q, rad_cm)
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

    # --- phase 5: times ------------------------------------------------
    mu, muw = t["mu"], t["mu_w"]
    k_ms = cuda_ms(lambda: fused.fused_eclipse(
        tab, t["wn"], mu, muw, wrows, T_safe, drp, fm._powers), 20)
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

    print(json.dumps({"kernels": [{
        "name": "fused_eclipse",
        "route": "cuda",
        "source": "bart_tpu_torch/csrc/fused_eclipse.cu",
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "fused_transit",
        "route": "cuda",
        "source": "bart_tpu_torch/csrc/fused_transit.cu",
        "replaces": TRANSIT_REPLACES,
        "launches": tpath["launches"],
        "max_abs_err": t_max_abs,
        "ms": tk_ms,
        "plain_ms": tp_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
