#!/usr/bin/env python3
"""Drive bart_tpu_torch's main paths once on one CUDA card and check them.

The main paths are the MCMC hot loops of the demo CH4 retrievals at the
benchmark's full width (100 layers x 2501 wn x 30,000 lines x 27
T-nodes, 512 chains): PT profile -> abundances -> hydrostatic radii ->
rows -> a fused CUDA kernel -> bands -> likelihood -> snooker step, the
whole step captured as one CUDA graph and replayed once a step.
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
  4. a short snooker retrieval (run_mcmc: each block the replay of one
     captured step) per path on synthetic data; then per path (4b) the
     512-chain step eager and graphed: from one state and one block of
     variates the graphed block must equal the eager block bit for bit,
     a torch.profiler trace of a replayed block must hold each of the
     path's kernels once a step, and the step (eager and graphed), the
     forward (eager and ``graphed()``) and the device-busy share of the
     graphed block are timed; eclipse only (4c): a graphed 512-chain
     retrieval from uniform starts that must recover the demo truth
     (tests/test_end_to_end.py:71-87's four criteria)
  5. serialized times per path: kernel, plain version, whole forward;
     and from phase 4b's one trace of graphed() forwards, the kernels'
     device time and the rest of the forward's
  7. the rest of the model and inference surface on phase 3's table: a
     512-chain forward per PT family (iso, line, madhu_noinv, madhu_inv,
     adiabatic, piette), eager and ``graphed()`` bit for bit; the unfused
     extinction of ``diagnostics`` through the unfused radiative transfer
     against the fused forward, eclipse and transit; a graphed madhu_inv
     retrieval under the wavelet likelihood (wlike) from the
     least-squares pre-fit (leastsq), with phase 4b on its step; then
     ``diagnostics_batch`` and the band-averaged contribution functions
     of 300 posterior samples
  8. the port's CLI (``python3 -m bart_tpu_torch -c cfg``) on the cfgs of
     examples/torch_demo at full width: ``--validate`` on each and
     ``--justTEA`` (equilibrium chemistry) in subprocesses; then
     ``driver.cli.main`` in this process on eclipse.cfg, a graphed
     512-chain retrieval (25,000 steps) that must recover the cfg's
     truth (phase 4c's criteria) with fused_eclipse launched,
     ``--justSpectrum`` on its directory (no second build; against the
     forward at the cfg's parameters), and a short 512-chain transit.cfg
     retrieval with fused_transit launched; each run's stage seconds
  9. the last single-device surface: (a) the on-the-fly (table-free)
     forward at full width on 4 chains, eclipse and transit: the Voigt
     profiles of all 30,000 lines at every layer in each forward, the
     unfused radiative transfer (no fused kernel), graphed = eager bit
     for bit, held against the gridded forward (fused kernels) on
     isothermal profiles at table nodes, eager and graphed times with
     their peak memory; (b) ``--osamp 16`` through the CLI on
     eclipse.cfg (--justOpacity, then --justSpectrum), the T grid cut
     to the nodes that bracket the truth: the top layer's line mass
     against sum S(T), two conditions against a float64 CPU build; (c)
     the host entry points: the native HITRAN scanner called directly
     on the demo list written as a .par (against the numpy parser, bit
     for bit), the lineread CLI on it plus an ExoMol triplet, the widths
     tool
 10. multi-device execution on gloo ranks that share the card (the
     ranks are ``chip_smoke.py --mesh-rank`` subprocesses; their
     times measure overhead, not scaling): per mesh (1x2, 2x1, 2x2) the
     512-chain eclipse and transit K = 1 forwards and the folded pair
     with ``fold_adapt=None`` on phase 3's fine table, each rank holding
     only its shard of the table, its kernels counted and each held on
     its shard against its plain version, the gathered spectra against
     the unsharded card forward, the forward's and the all-reduce's time
     a rank; a 2-chain on-the-fly forward on 1x2; a 3-step snooker block
     on 2x2 against the unsharded eager block; a world of one NCCL rank
     whose graphed block (the all-reduce captured) must equal the eager
     block on the mesh and the unmeshed graphed block bit for bit; the
     dryrun under torchrun
 11. with ``--cli-fold`` only (after phase 2): the publication-accuracy
     retrievals through the CLI on examples/torch_demo/eclipse_fold.cfg
     and transit_fold.cfg (K = 32 on the 80,032-point fine grid, the
     adaptive split, bfloat16 fine rows): the fine build and a graphed
     512-chain eclipse retrieval that must recover the cfg's truth
     (phase 4c's criteria), phase 4b on each CLI model's own likelihood,
     ``--justSpectrum`` on its directory against the folded forward, each
     kernel on the CLI models' own rows against its plain version (these,
     not phase 2's, make the kernels line of this run), the folded bands
     at the truth against a K = 1 forward's (the source of the cfgs'
     data), and a 512-chain transit retrieval on the same fine table;
     then eclipse_fold_f32.cfg (the reference's default float32 fine
     rows, the 3xTF32 instance of the folded eclipse kernel) on that
     table: a short graphed retrieval, phase 4b, its kernels on its
     rows, its bands at the truth against the bfloat16 model's and the
     K = 1 forward's
 13. with ``--nccl4`` only (after phase 1; four cards, one NCCL rank
     each; fewer cards raise): the K = 1 and the 80,032-point fine table
     built once, on the four cards at once, the single-card references
     on card 0; then four ranks as phase 10's, one a card, in one world
     for every mesh: per mesh (1x4, 4x1, 2x2)
     the four paths' 512-chain forwards (folded with
     ``fold_adapt=None``), each kernel on its shard against its plain
     version and timed, the gathered spectra against the single card's,
     the graphed block (all-reduce captured) against the eager block bit
     for bit with the ranks' states checked equal after every block, the
     accept decisions against the single card's, the slowest rank's step,
     forward and all-reduce times; the truth recovery (phase 4c's) on
     2x2 with files from rank 0 alone; then the dryrun under torchrun on
     four NCCL ranks; its own kernels line (each kernel's ms per mesh)
 14. (after phase 10) the port's benchmark and cookbook: ``bench_torch.py``
     in a subprocess on a cold table cache with ``BENCH_FOLD=0`` (its
     JSON line with bench.py's keys and a finite rate above 0, its
     transit and roofline lines, the K = 1 table built once and then
     loaded, its kernels counted in its process), then the ``main`` of
     examples/torch_demo/quickstart.py in this process (it must end in
     ``quickstart OK`` and launch fused_eclipse); both wall times.  With
     ``--bench`` only (after phase 2): the whole bench, the folded pair
     included, twice in one call on one cache, cold and then warm (the
     warm run loads both tables and builds neither), then ``entry()``'s
     forward on a table built in this process and on the cached one,
     for the bench's problem and entry's default one: equal bit for bit
  6. with ``--trace`` only (after phase 14): a torch.profiler trace of a
     few forwards per path, eager and ``graphed()``: the device-busy
     share of the wall time, the five device operations that took most
     time and the five stages of the forward during which the device
     idled longest (a graph replay runs no stage)

Each path's launch counts are zeroed just before its phase 3 (phases 7
and 9, and each CLI run of 8 and 11: just before it; phases 10 and 13:
in each rank, before its forwards; phase 14: the bench's process starts
from 0, the quickstart's counts are zeroed before it) and read just
after its phase 4 (phases 7, 8, 9, 11 and 14: at its end; phases 10 and
13: after the forwards): the wrappers count
in Python, so
they see the
eager launches and each graph capture, never a replay.  The kernels'
``launches`` are counted on the device instead: each path's kernels in
the trace of its replayed block (phase 4b).  Any failed check raises and
exits non-zero.  The last two lines of stdout are the kernels' JSON
record and the result JSON.  A kernel's ``bound_ms`` is the largest of
its FMAs on the float32 pipes at the float32 peak, its FMAs on tensor
cores at their types' dense peaks times the passes used, its
exponentials at the special-function rate and its bytes at the HBM rate
(``bound``); the record names the term that binds.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels   # phases 0-2, then the kernels' times
    python3 chip_smoke.py --trace     # all phases, then phase 6
    python3 chip_smoke.py --cli       # phases 0-2, then phase 8
    python3 chip_smoke.py --cli-fold  # phases 0-2, then phase 11
    python3 chip_smoke.py --phase9    # phases 0-1, phase 3's table, phase 9
    python3 chip_smoke.py --phase10   # phases 0-1, phase 3's table, a
                                      # 320-bin fine table, phase 10
    python3 chip_smoke.py --nccl4     # phases 0-1, then phase 13 (four
                                      # cards)
    python3 chip_smoke.py --bench     # phases 0-2, then the bench cold
                                      # and warm, and entry()
"""

from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from bart_tpu_torch.utils.roofline import (  # noqa: E402
    eclipse_bound, transit_bound)

# Kernel vs plain version, both float32, summing in other orders over
# 100 layers.  Spectra: raygrid 1e-4 (measured ~2e-6); expsum 2e-4,
# because its 8-term Horner polynomial (|a_q| up to 28 against
# S(0) = 1/2) sits at the float32 floor: the plain version alone is
# ~7e-5 from its float64 result.  Bands average the per-wn rounding down.
SPEC_RTOL = {False: 1e-4, True: 2e-4}    # keyed by powers (expsum) mode
BAND_RTOL = 2e-5
# Transit kernel vs plain version on ``out`` (the absorbed area, not the
# depth, whose r_bot^2 would hide a wrong out), both float32: the kernel
# sums the rows, then the layers of each slant path, in other orders
# than the plain version's two matrix products; measured 3.3e-7..7.8e-7
# at the shapes here on the H100, so 1e-5 leaves ~13x.  Bands as above.
OUT_RTOL = 1e-5
# share of (chain, b, w) points whose slant tau must lie in [0.1, 10] in
# a transit comparison: with saturated tau, out = sum(wgt) whatever ext
MIXED_SHARE = 0.2
# The folded kernels against their plain versions: the same tolerances
# (both sides read the same float32 or bfloat16 table and differ in the
# order of sums only, now also over the K sub-samples of a bin).
FOLD_K = 32
# a folded result must differ from the K = 1 result on the bin-mean table
# by more than this somewhere: averaging ext before the exponential fails
FOLD_MIN_DIFF = 1e-3
# folded forward vs K = 1 forward on the 2501-point table: a sanity bound
# on the bands (the two differ by the sampling error folding removes)
FOLD_K1_BAND_RTOL = 0.05

#: the TPU kernel each wrapper's kernel replaces
REPLACES = {"fused_eclipse": "bart_tpu/rt/fused.py:159",          # _kernel
            "fused_transit": "bart_tpu/rt/fused.py:341",          # _tkernel
            "fused_eclipse_folded": "bart_tpu/rt/fused.py:535",   # _fkernel
            "fused_transit_folded": "bart_tpu/rt/fused.py:780"}   # _ftkernel


#: steps of a block in phase 4b (timed with one host read a block)
BLOCK = 10
#: the name of each wrapper's kernel among a trace's device events (the
#: folded paths' fine tables are bfloat16, so the float32 instance of the
#: transit template is the K = 1 launch)
TRACE_KERNEL = {"fused_eclipse": r"fused_eclipse_kernel",
                "fused_transit": r"fused_transit_mma_kernel<float>",
                "fused_eclipse_folded": r"fused_eclipse_folded_\w+_kernel",
                "fused_transit_folded":
                    r"fused_transit_mma_kernel<__nv_bfloat16>"}
#: phase 4c: steps, burn-in and block of the truth-recovery retrieval
#: (512 chains from uniform starts; tests/test_end_to_end.py runs 8 x
#: 6,000).  3,000 steps with 1,500 of burn-in held three criteria but not
#: split-R-hat (1.25-1.45 against 1.35, on an H100): the plateau
#: directions' autocorrelation time is ~800 steps, so the split halves
#: need ~2,500 steps each
TRUTH_STEPS, TRUTH_BURNIN, TRUTH_BLOCK = 10000, 5000, 250
#: phase 7: the madhu_inv + wlike + leastsq retrieval.  Bounds, steps and
#: the starting point of the PT and CH4 parameters (a1, a2, p1, p2, p3
#: [bar], T3 [K], log CH4); the truth is demo_params("madhu_inv").  The
#: three wavelet noise parameters follow (gamma fixed at 1, sigma_r and
#: sigma_w free), scaled to the white noise that phase 7 adds.
MADHU_PMIN = [0.2, 0.05, 1e-4, 0.02, 1.0, 1000.0, -3.0]
MADHU_PMAX = [1.0, 0.5, 0.02, 0.5, 10.0, 2500.0, 1.0]
MADHU_STEP = [0.01, 0.01, 1e-4, 0.01, 0.1, 10.0, 0.1]
MADHU_START = [0.45, 0.22, 0.006, 0.12, 2.5, 1550.0, -0.3]
#: steps of phase 7's retrieval and posterior samples of its diagnostics
WLIKE_STEPS, CF_SAMPLES = 30, 300
#: phase 8: the CLI demo's cfgs, the chains of its retrievals and the
#: steps a chain of the transit one (one block of run_mcmc's 100)
CLI_CFGS = ("eclipse", "transit", "eclipse_tea", "eclipse_fold",
            "transit_fold")
CLI_CHAINS, CLI_TRANSIT_STEPS = 512, 100
#: phase 8's eclipse retrieval: steps a chain and burn-in.  Phase 4c's
#: 10,000 and 5,000 held three criteria on this cfg's data (another line
#: list than demo.py's) but left split-R-hat at 1.63 (float32 or float64
#: sampler state, block 100 or 250, seed 0 or 7 alike: acceptance 3.5%,
#: two plateau directions; examples/torch_demo/mixing_check.py); 25,000
#: and 10,000 gave 1.10-1.25 (H100).
#: The cfg's grtest ranks the whole kept posterior on the host every 10
#: blocks (~60 s of such a run): off here, split-R-hat is computed once.
CLI_STEPS, CLI_BURNIN = 25000, 10000
#: --justSpectrum against the forward at the cfg's parameters with the
#: molfit factor at 0 (tests/test_pipeline.py:226-227): the atm file's
#: radii and T carry 3 and 2 decimals
CLI_SPEC_RTOL = 5e-3
#: phase 11 (``--cli-fold``): the folded eclipse retrieval through the
#: CLI takes phase 8's steps and burn-in (its data are eclipse.cfg's,
#: whose posterior needed them for split-R-hat); the folded transit one a
#: block of run_mcmc's 100.  A band of the folded forward at the truth
#: may sit up to FOLD_DATA_SIGMA of its uncertainty from the K = 1
#: forward's, whose bands (with noise) are the fold cfgs' data
FOLD_DATA_SIGMA = 0.3
#: phase 11: the chains (around the truth) on which each kernel of the
#: CLI's folded models is held against its plain version and timed
FOLD_CHECK_SPREAD = 0.005
#: phase 11 (d): steps a chain of the retrieval on eclipse_fold_f32.cfg
#: (the reference's default float32 fine rows; burn-in half of them), and
#: its folded bands at the truth against the bfloat16 model's
#: (tests/test_fused.py:592's tolerance for bfloat16 against float32 fine
#: tables)
F32_STEPS, F32_BAND_RTOL = 1000, 2e-3
#: phase 9a: chains of the on-the-fly forwards (512 in the other paths:
#: a forward computes the Voigt profiles of all 30,000 lines, 2.6e7
#: (line, point) pairs a layer on uniform tiles, at each of the chains'
#: 100 layers: ~2.4 s a chain at phase 3's build rate), the byte budget
#: of their cross-section chunks, and the isothermal profiles [K], nodes
#: of phase 3's 27-node table, at which the on-the-fly spectrum is held
#: against the gridded one: there T-interpolation is exact, so the two
#: differ by summation order only (the tiles' padding, the unfused
#: against the fused radiative transfer), as phase 7's unfused-vs-fused
#: check; the kernels' tolerances apply
OTF_CHAINS, OTF_BUDGET = 4, 12e9
OTF_NODES = (1500.0, 2200.0)
#: phase 9b: the CLI's osamp, the line mass of the top layer (1e-5 bar:
#: Doppler cores, whose wings beyond nwidth = 20 HWHM hold < 1e-4 of the
#: line) against sum S(T) over the lines inside the grid, as
#: tests/test_opacity.py:357-361; the float64 CPU reference of two
#: conditions on one 256-point tile of the build (the third, 3012-3267
#: cm-1, the densest band: the same tile span buckets the same lines,
#: whose profiles reach past the 25 cm-1 cutoff at high pressure), held
#: relative to each row's maximum: the card's table is float32, whose
#: wavenumbers (ulp 4.9e-4 cm-1 at 5000 cm-1) move a Doppler core (~1e-2
#: cm-1) that straddles a bin edge by up to ~5% of its mass between two
#: bins
CLI_OSAMP, MASS_RTOL, OSAMP_ROW_RTOL = 16, 1e-3, 5e-2
OSAMP_TILE = 2
#: phase 9c: an ExoMol triplet beside the demo list's .par
EXOMOL_STATES = "1 0.0 4 0\n2 1500.0 8 1\n3 3100.0 12 2\n4 3500.5 16 3\n"
EXOMOL_TRANS = "3 1 2.5e-2\n4 1 1.0e-3\n4 2 3.0e-2\n"
EXOMOL_PF = "100 50.0\n296 107.1\n1000 300.0\n"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_record(name: str, max_abs_err: float, ms: float, plain_ms: float,
                  bnd: dict, launches: int, **more) -> dict:
    """One kernel's entry of a kernels line: the contract's keys,
    ``bound``'s keys and ``more``.  ``name`` is the wrapper's, or the
    wrapper's with an instance in brackets (``fused_eclipse_folded
    [float32]``)."""
    base = name.split("[")[0]
    return {"name": name, "route": "cuda",
            "source": f"bart_tpu_torch/csrc/{base}.cu",
            "replaces": REPLACES[base], "launches": launches, **more,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            **bnd,
            # no single PyTorch call computes any of the four
            "library_ms": None}


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


def serialized_ms(fb, params, nrep: int, rounds: int = 3):
    """bart_tpu_torch.bench.time_batched in ms: ``fb(params)`` returns
    (bandflux, spectrum, valid).  Returns (best ms per call, per-round
    ms)."""
    from bart_tpu_torch.bench import time_batched

    best, _, times = time_batched(fb, params, nrep, rounds)
    return 1e3 * best, [1e3 * t for t in times]


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
    t0 = time.perf_counter()
    res = run_mcmc(like, space, nchains=nchain, numit=nchain * 30,
                   burnin=10, block=10, seed=7, verbose=False)
    mcmc_s = time.perf_counter() - t0
    print(f"# phase 4: transit snooker {nchain} chains x "
          f"{res.niter_total // nchain} graphed steps in {mcmc_s:.2f} s "
          f"(capture included): best chi2 {-2 * res.best_loglike:.3f}, "
          f"accept {res.accept_rate:.3f}")
    check(np.isfinite(res.best_loglike), "non-finite transit best loglike")
    check(res.accept_rate > 0.0, "no accepted transit proposal")
    step = step_phase("transit", like, space, fmt, params,
                      [fused.fused_transit])
    launches = fused.fused_transit.launches   # the transit path ends here
    print(f"# phase 4: transit path: {launches} kernel launches counted in "
          "Python (eager calls, warm-ups, captures)")
    check(launches > 0, "the transit path did not launch the kernel")
    return dict(fm=fmt, forward=forward, params=params, launches=launches,
                rows=(tab, wrows, G, wgt), rtab=rtab, step=step)


def transit_times(fused, path: dict):
    """Phase 5, transit: (kernel ms, transit_plain ms, forward ms and its
    rounds)."""
    rows = path["rows"]
    # as the forward launches it: the prepared table and slant matrix
    Gp = fused.prepare_slant(rows[2])
    k_ms = cuda_ms(lambda: fused.fused_transit(path["rtab"], rows[1], Gp,
                                               rows[3]), 20)
    p_ms = cuda_ms(lambda: fused.transit_plain(*rows), 5)
    fwd = serialized_ms(path["forward"], path["params"], 20)
    return k_ms, p_ms, fwd


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
            p_ms = cuda_ms(lambda: fused.eclipse_folded_plain(ft, wn, *rest,
                                                              powers), 2)
            bnd = eclipse_bound(R, L, W * K, C, len(mu), powers, K,
                                tdt == torch.bfloat16,
                                nbytes(ft.tab, wn, *rest))
            print(f"# kernels: fused_eclipse_folded {str(tdt)[6:]} {quad} "
                  f"{W} bins x {K}: {ms:.3f} ms; plain {p_ms:.3f} ms; bound "
                  f"{bnd['bound_ms']:.3f} ms ({bnd['bound_term']}; tensor "
                  f"cores {bnd['tensor_ms']:.3f} ms)")
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
    t0 = time.perf_counter()
    res = run_mcmc(like, space, nchains=nchain, numit=nchain * 30,
                   burnin=10, block=10, seed=7, verbose=False)
    mcmc_s = time.perf_counter() - t0
    print(f"# phase 4: folded {solution} snooker {nchain} chains x "
          f"{res.niter_total // nchain} graphed steps in {mcmc_s:.2f} s "
          f"(capture included): best chi2 {-2 * res.best_loglike:.3f}, "
          f"accept {res.accept_rate:.3f}")
    check(np.isfinite(res.best_loglike), "non-finite folded best loglike")
    check(res.accept_rate > 0.0, "no accepted folded proposal")
    step = step_phase(f"folded {solution}", like, space, fm, params, kernels)
    counts = [k.launches for k in kernels]     # the folded path ends here
    print(f"# phase 4: folded {solution} path: launches counted in Python "
          f"(eager calls, warm-ups, captures): folded kernel {counts[0]}, "
          f"K = 1 kernel {counts[1]}")
    check(all(n > 0 for n in counts),
          f"the folded {solution} path did not launch both kernels")
    return dict(fm=fm, forward=forward, params=params, launches=counts,
                parts=parts, rows=rows, kernels=kernels, plains=plains,
                solution=solution, step=step)


def folded_times(fused, path: dict) -> dict:
    """Phase 5 of one folded path: ms of the folded kernel, its plain
    version, the K = 1 kernel on the smooth bins and the whole forward
    (with its rounds)."""
    parts, rows = path["parts"], path["rows"]
    (tabk, _, _, _), (tabs, _, _, _) = parts
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
    out["fwd"] = serialized_ms(path["forward"], path["params"], 5)
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


def step_phase(label: str, like, space, fm, params, kernels) -> dict:
    """Phase 4b of one path: the MCMC step at the forward's chain count,
    eager and graphed.  From one state and one block of variates the
    graphed block (the captured step replayed BLOCK times) must equal the
    eager block bit for bit; a torch.profiler trace of one replayed block
    must hold each of the path's ``kernels`` once a step.  Then
    serialized times, best of three blocks each ending in a host read:
    the step eager and graphed, the forward eager and ``graphed()`` (which
    must equal the eager forward bit for bit); and the device-busy ms of
    a traced graphed step and of a traced ``graphed()`` forward.  Returns
    the times, the traced launch counts and the busy figures."""
    import torch

    from bart_tpu_torch.inference.samplers import EnsembleSampler

    s = EnsembleSampler(loglike_fn=like, nfree=space.nfree,
                        nmodel=int(like.data.shape[0]),
                        nchains=int(params.shape[0]), pmin=space.free_min,
                        pmax=space.free_max,
                        stepsize=space.stepsize[space.ifree])
    gen = torch.Generator(device=like.device)
    gen.manual_seed(11)
    state = s.init_state(gen)
    saved = gen.get_state()
    eager = s.run_block(state, gen, BLOCK, graphed=False)
    gen.set_state(saved)
    t0 = time.perf_counter()
    graphed = s.run_block(state, gen, BLOCK, graphed=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    names = list(state._fields) + ["positions block", "loglike block",
                                   "models block"]
    differ = {name: rel_err(g, e) for name, g, e in zip(
        names, [*graphed[0], *graphed[1:]], [*eager[0], *eager[1:]])
        if not torch.equal(g, e)}
    print(f"# phase 4b: {label}: graphed block ({BLOCK} steps, warm-up, "
          f"capture and replays {first_s:.2f} s) vs eager block from one "
          f"state and one block of variates: "
          + (f"differ (max rel err) {differ}" if differ else
             "equal bit for bit (state, positions, loglike, models, "
             "archive, best)"))
    check(not differ, f"{label}: graphed block differs from the eager "
          f"block: {differ}")

    # the kernels on the device: a trace of one replayed block
    def block():
        nonlocal st
        st = s.run_block(st, gen, BLOCK, graphed=True)[0]

    st = graphed[0]
    dev, busy_us, window_us = trace_device(block)
    check(bool(dev), f"{label}: the trace of a replayed block holds no "
          "device activity")
    counts = {k.__name__: sum(1 for e in dev
                              if re.search(TRACE_KERNEL[k.__name__], e.name))
              for k in kernels}
    print(f"# phase 4b: {label}: trace of one replayed block: {len(dev)} "
          f"device operations ({len(dev) / BLOCK:.0f} a step, the block's "
          f"draws included), kernels {counts}; device busy "
          f"{busy_us / 1e3:.2f} of {window_us / 1e3:.2f} ms = "
          f"{busy_us / window_us:.3f}; kernel names: "
          + "; ".join(sorted({e.name[:90] for e in dev
                              if "fused_" in e.name})))
    check(all(n == BLOCK for n in counts.values()),
          f"{label}: the replayed block launched {counts}, expected each "
          f"kernel {BLOCK} times")

    def block_ms(graph: bool):
        nonlocal st
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            st = s.run_block(st, gen, BLOCK, graphed=graph)[0]
            float(st.loglike.sum())
            times.append(1e3 * (time.perf_counter() - t0) / BLOCK)
        return min(times), times

    out = {"eager": block_ms(False), "graph": block_ms(True),
           "fwd": serialized_ms(fm, params, 10)}
    gfwd = fm.graphed()
    check(torch.equal(gfwd(params)[0], fm(params)[0]),
          f"{label}: graphed forward differs from the eager forward")
    out["gfwd"] = serialized_ms(gfwd, params, 10)
    # the same number of graphed forwards, traced: the step's device work
    # less the forward's is the sampler's, the likelihood's and the draws';
    # the kernels' device time and the rest of the forward's come from
    # this one trace (one stream: the two add up to the busy time)
    fdev, fwd_busy_us, _ = trace_device(
        lambda: [gfwd(params) for _ in range(BLOCK)])
    kernel_us = sum(e.time_range.end - e.time_range.start for e in fdev
                    if any(re.search(TRACE_KERNEL[k.__name__], e.name)
                           for k in kernels))
    out.update(counts=counts, busy_window=busy_us / window_us,
               busy_step=busy_us / 1e3 / BLOCK,
               busy_fwd=fwd_busy_us / 1e3 / BLOCK,
               kernel_fwd=kernel_us / 1e3 / BLOCK,
               rest_fwd=(fwd_busy_us - kernel_us) / 1e3 / BLOCK)
    return out


def trace_device(fn):
    """(device events, their busy us, the window us) of a torch.profiler
    trace of ``fn()`` and a synchronise."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    dev = [e for e in events if is_device_event(e)]
    busy_us, _ = busy_and_gaps([(e.time_range.start, e.time_range.end)
                                for e in dev])
    window_us = (max(e.time_range.end for e in events)
                 - min(e.time_range.start for e in events))
    return dev, busy_us, window_us


def print_steps(label: str, st: dict, smi: str) -> None:
    """Phase 5's line of one path's phase 4b times."""
    def ms(x):
        return f"{x[0]:.3f} ms (rounds {', '.join(f'{v:.2f}' for v in x[1])})"

    print(f"# phase 5 ({smi}): {label}: 512-chain step eager {ms(st['eager'])},"
          f" graphed {ms(st['graph'])}; forward eager {ms(st['fwd'])}, "
          f"graphed() {ms(st['gfwd'])}; device busy {st['busy_step']:.3f} ms "
          f"a graphed step = {st['busy_step'] / st['graph'][0]:.3f} of its "
          f"untraced time ({st['busy_window']:.3f} of the traced window), "
          f"{st['busy_fwd']:.3f} ms a graphed() forward: the sampler, the "
          f"likelihood and the draws {st['busy_step'] - st['busy_fwd']:.3f} "
          f"ms of device work a step; one trace of {BLOCK} graphed() "
          f"forwards: the kernels {st['kernel_fwd']:.3f} ms and the rest "
          f"{st['rest_fwd']:.3f} ms of device work a forward")


def model_surface_phase(fused, fm, fmt, inp, nchain: int, f32: dict,
                        smi: str) -> dict:
    """Phase 7: the rest of the model and inference surface on phase 3's
    table.  (a) One ``nchain`` forward per PT family, eager and
    ``graphed()``, bit for bit.  (b) The unfused extinction of
    ``diagnostics`` through the unfused radiative transfer against the
    fused forward, eclipse (``fm``) and transit (``fmt``).  (c) A graphed
    madhu_inv retrieval under the wavelet likelihood from a least-squares
    pre-fit, on synthetic data from the madhu_inv truth: the pre-fit's
    chi^2 at or below that of the starting point, a finite best loglike,
    acceptance > 0, then phase 4b on its step (fused_eclipse once a step
    in the trace of a replayed block).  (d) ``diagnostics_batch`` and the
    band-averaged contribution functions of CF_SAMPLES posterior samples.
    Returns the step's figures and the launches counted in Python."""
    import torch

    from bart_tpu_torch.demo import (DEMO_PARAMS, DEMO_PARAMS_TRANSIT,
                                     PT_PARAMS, build_demo_model,
                                     demo_params)
    from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
    from bart_tpu_torch.inference.retrieval import (least_squares_prefit,
                                                    run_mcmc)
    from bart_tpu_torch.obs.bands import band_integrate
    from bart_tpu_torch.post import cf
    from bart_tpu_torch.rt.eclipse import eclipse_flux
    from bart_tpu_torch.rt.tau import tau_vertical
    from bart_tpu_torch.rt.transit_geom import transit_depth

    dev = f32["device"]
    kernels = (fused.fused_eclipse, fused.fused_transit)
    for k in kernels:
        k.launches = 0                            # phase 7 starts here

    # (a) every PT family, eager and graphed()
    rng = np.random.default_rng(3)
    fams = {}
    for family in PT_PARAMS:
        fmf = build_demo_model(inp, device=dev, dtype=torch.float32,
                               grid=fm.opacity, pt_type=family)
        base = demo_params(family)
        params = torch.tensor(base * (1.0 + rng.normal(
            0, 0.002, (nchain, len(base)))), **f32)
        t0 = time.perf_counter()
        eager = fmf(params)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        graphed = fmf.graphed()(params)
        torch.cuda.synchronize()
        differ = [name for name, a, b in zip(("bands", "spectrum", "valid"),
                                             graphed, eager)
                  if not torch.equal(a, b)]
        T = fmf._profiles(params, fmf.tables)[0]
        print(f"# phase 7: {family}: {nchain}-chain forward ({len(base)} "
              f"parameters; T {float(T.min()):.1f}..{float(T.max()):.1f} K, "
              f"{int(eager[2].sum())} valid; eager {eager_s:.3f} s with its "
              f"first-call set-up): graphed() vs eager "
              + (f"differ in {differ}" if differ else "equal bit for bit"))
        check(not differ, f"{family}: graphed() differs in {differ}")
        check(bool(eager[2].all()), f"{family}: invalid samples")
        check(bool(torch.isfinite(eager[0]).all()
                   & torch.isfinite(eager[1]).all()),
              f"{family}: non-finite forward output")
        fams[family] = (fmf, params)

    # (b) the unfused extinction and radiative transfer vs the fused forward
    for model, base, spread in ((fm, DEMO_PARAMS, 0.005),
                                (fmt, DEMO_PARAMS_TRANSIT,
                                 np.where(np.arange(7) == 5, 10.0, 0.005))):
        params = torch.tensor(np.tile(base, (nchain, 1)) + rng.normal(
            0, 1, (nchain, len(base))) * spread, **f32)
        t0 = time.perf_counter()
        T, q, rad, ext, valid = model.diagnostics(params)
        torch.cuda.synchronize()
        diag_s = time.perf_counter() - t0
        band, spec, _ = model(params)
        if model.config.solution == "transit":
            rs2 = (model.system.r_star * 100.0) ** 2
            unfused = transit_depth(ext, rad, model.system.r_star * 100.0)
            e_out = rel_err(unfused * rs2 - rad[:, -1:] ** 2,
                            spec * rs2 - rad[:, -1:] ** 2)
            extra = f", absorbed area {e_out:.3e}"
            rtol = OUT_RTOL
        else:
            unfused = eclipse_flux(tau_vertical(ext, rad), T, model.wn,
                                   model.mu, model.mu_w)
            extra, rtol = "", SPEC_RTOL[model._powers]
        e_spec = rel_err(unfused, spec)
        e_band = rel_err(band_integrate(model.tables["band_w"], unfused),
                         band)
        print(f"# phase 7: {model.config.solution}: unfused diagnostics "
              f"({nchain} chains, extinction {tuple(ext.shape)} in "
              f"{diag_s:.3f} s) through the unfused radiative transfer vs "
              f"the fused forward: spectrum max rel err {e_spec:.3e} "
              f"(tolerance {rtol:g}), band {e_band:.3e} (tolerance "
              f"{BAND_RTOL:g}){extra}")
        check(bool(valid.all()), "invalid diagnostics samples")
        check(e_spec < rtol, f"unfused vs fused spectrum rel err {e_spec}")
        check(e_band < BAND_RTOL, f"unfused vs fused band rel err {e_band}")
        del T, q, rad, ext, unfused

    # (c) madhu_inv + wlike + leastsq, graphed
    fmr, params = fams["madhu_inv"]
    truth = demo_params("madhu_inv")
    clean = fmr(torch.tensor(truth[None], **f32))[0][0].double().cpu().numpy()
    sw = 0.03 * float(np.mean(clean))
    data = clean + np.random.default_rng(42).normal(0, sw, clean.shape)
    space = ParamSpace(pinit=MADHU_START + [1.0, 0.1 * sw, 2.0 * sw],
                       pmin=MADHU_PMIN + [0.0, 0.0, 0.1 * sw],
                       pmax=MADHU_PMAX + [3.0, 10.0 * sw, 10.0 * sw],
                       stepsize=MADHU_STEP + [0.0, 0.1 * sw, 0.1 * sw])
    like = Likelihood(fmr, space, data, np.full(len(data), sw), wlike=True)

    def chi2(free):
        """The pre-fit's objective, sum ((model - data) / uncert)^2."""
        _, m = like(torch.as_tensor(free[None], dtype=torch.float64,
                                    device=dev))
        return float((((m - like.data) / like.uncert) ** 2).sum())

    t0 = time.perf_counter()
    fit = least_squares_prefit(like, space)
    prefit_s = time.perf_counter() - t0
    c_fit, c_init = chi2(fit), chi2(space.free_init)
    print(f"# phase 7: madhu_inv + wlike: least-squares pre-fit in "
          f"{prefit_s:.2f} s: chi2 {c_init:.3f} at the start, {c_fit:.3f} at "
          f"the fit {np.array2string(fit[:7], precision=4)} (truth "
          f"{np.array2string(truth, precision=4)})")
    check(c_fit <= c_init, f"pre-fit chi2 {c_fit} above the start's {c_init}")
    t0 = time.perf_counter()
    res = run_mcmc(like, space, nchains=nchain, numit=nchain * WLIKE_STEPS,
                   burnin=10, block=10, seed=7, verbose=False, leastsq=True)
    torch.cuda.synchronize()
    mcmc_s = time.perf_counter() - t0
    print(f"# phase 7: madhu_inv + wlike + leastsq: snooker {nchain} chains "
          f"x {res.niter_total // nchain} graphed steps in {mcmc_s:.2f} s "
          f"(pre-fit and capture included): best -2 log L "
          f"{-2 * res.best_loglike:.3f}, accept {res.accept_rate:.3f}")
    check(np.isfinite(res.best_loglike), "non-finite wlike best loglike")
    check(res.accept_rate > 0.0, "no accepted wlike proposal")
    step = step_phase("madhu_inv + wlike", like, space, fmr, params,
                      [fused.fused_eclipse])
    print_steps("madhu_inv + wlike", step, smi)

    # (d) diagnostics_batch and contribution functions of the posterior
    free = torch.as_tensor(res.posterior[:CF_SAMPLES, :, -1],
                           dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T, q, rad, ext, valid = fmr.diagnostics_batch()(
        space.expand(free)[:, :-3])
    torch.cuda.synchronize()
    diag_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    cfs = cf.contribution_functions(ext, rad, T, fmr.pressure, fmr.wn,
                                    device=dev)
    cfb = cf.band_average(cfs, inp.wn, inp.filters, device=dev)
    cf_ms = 1e3 * (time.perf_counter() - t0)
    peak = inp.pressure[np.argmax(cfb.mean(0), axis=0)]
    print(f"# phase 7 ({smi}): diagnostics_batch of {free.shape[0]} "
          f"posterior samples {diag_ms:.1f} ms (extinction "
          f"{tuple(ext.shape)}, {int(valid.sum())} valid), contribution "
          f"functions and band average {cf_ms:.1f} ms (host copies "
          f"included): cf {cfs.shape}, band-averaged {cfb.shape}, the mean "
          f"contribution peaks at {np.array2string(peak, precision=3)} bar "
          f"per filter")
    check(bool(np.isfinite(cfs).all() & np.isfinite(cfb).all()),
          "non-finite contribution functions")
    check(bool((cfs >= 0).all()), "negative contribution functions")
    check(cfb.shape == (free.shape[0], len(inp.pressure), 10),
          f"band-averaged cf shape {cfb.shape}")
    del T, q, rad, ext, cfs

    launches = {k.__name__: k.launches for k in kernels}  # phase 7 ends here
    print(f"# phase 7: launches counted in Python (eager calls, warm-ups, "
          f"captures): {launches}")
    check(all(n > 0 for n in launches.values()),
          f"phase 7 did not launch both kernels: {launches}")
    return dict(step=step, launches=launches)


def truth_phase(like, space, nchain: int, label: str = "phase 4c",
                **run_kw) -> dict:
    """Phase 4c: a graphed retrieval of the K = 1 eclipse path at
    ``nchain`` chains from uniform starts, on data made from TRUTH with
    3% noise, held to tests/test_end_to_end.py:71-87's four criteria:
    pulls < 3.5 on the data-constrained directions, the central 99%
    interval covering the truth, chi2/dof < 3, split-R-hat < 1.35.
    ``run_kw`` goes to run_mcmc (output files); returns the figures."""
    import torch

    from bart_tpu_torch.demo import TRUTH
    from bart_tpu_torch.inference.retrieval import run_mcmc

    t0 = time.perf_counter()
    res = run_mcmc(like, space, nchains=nchain,
                   numit=nchain * TRUTH_STEPS, burnin=TRUTH_BURNIN,
                   block=TRUTH_BLOCK, seed=7, verbose=False, **run_kw)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    flat = res.posterior.transpose(1, 0, 2).reshape(space.nfree, -1)
    mean, std = flat.mean(1), flat.std(1)
    truth = TRUTH[space.ifree]
    constrained = std < 0.5 * (space.free_max - space.free_min) / np.sqrt(12)
    pulls = np.abs(mean - truth) / np.maximum(std, 1e-12)
    q = np.percentile(flat, [0.5, 99.5], axis=1)
    covered = (truth > q[0]) & (truth < q[1])
    chi2_dof = -2.0 * res.best_loglike / int(like.data.shape[0])
    print(f"# {label}: truth recovery, {nchain} chains x {TRUTH_STEPS} "
          f"graphed steps (burn-in {TRUTH_BURNIN}) in {took:.2f} s "
          f"({1e3 * took / TRUTH_STEPS:.3f} ms a step, host statistics "
          f"included): mean {np.array2string(mean, precision=4)}, std "
          f"{np.array2string(std, precision=4)}, truth "
          f"{np.array2string(truth, precision=4)}; constrained "
          f"{constrained.tolist()}, pulls "
          f"{np.array2string(pulls, precision=3)}; 99% interval covers "
          f"{covered.tolist()}; chi2/dof {chi2_dof:.3f}; split-Rhat "
          f"{np.array2string(res.psrf_rank, precision=4)}; accept "
          f"{res.accept_rate:.3f}, fgamma {res.fgamma_final:.3f}")
    check(bool(np.all(pulls[constrained] < 3.5)),
          f"truth recovery: pulls {pulls} on {constrained}")
    check(bool(np.all(covered)), "truth recovery: the 99% interval misses "
          f"the truth ({q}, {truth})")
    check(chi2_dof < 3.0, f"truth recovery: chi2/dof {chi2_dof}")
    check(bool(np.all(res.psrf_rank < 1.35)),
          f"truth recovery: split-Rhat {res.psrf_rank}")
    return {"seconds": took, "ms_step": 1e3 * took / TRUTH_STEPS,
            "mean": mean.tolist(), "std": std.tolist(),
            "pulls": pulls.tolist(), "constrained": constrained.tolist(),
            "covered": covered.tolist(), "chi2_dof": chi2_dof,
            "split_rhat": res.psrf_rank.tolist(),
            "accept": res.accept_rate, "fgamma": res.fgamma_final}


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


def cli_run(argv: list[str], kernels) -> dict:
    """driver.cli.main(argv) in this process with the kernels' Python
    counts zeroed just before and read just after; exit code 0 or
    raise.  Returns the counts and the stages' seconds from the run's
    stage_timing.jsonl."""
    import torch

    from bart_tpu_torch.driver import cli

    loc = argv[argv.index("--loc_dir") + 1]
    tlog = os.path.join(loc, "stage_timing.jsonl")
    if os.path.isfile(tlog):
        os.remove(tlog)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in kernels}
    check(rc == 0, f"cli.main({argv}) returned {rc}")
    with open(tlog) as f:
        stages = [json.loads(line) for line in f]
    return dict(counts=counts, seconds=took,
                stages={r["stage"]: r["wall_s"] for r in stages})


def cli_truth(label: str, cfg_path: str, loc: str, run: dict):
    """The eclipse retrieval in ``loc`` (the CLI's output.npy and
    MCMC.log) against the demo truth by tests/test_end_to_end.py:71-87's
    four criteria: pulls below 3.5 on the constrained parameters, the
    99% interval covers the truth, chi2/dof below 3, split-R-hat below
    1.35.  Prints the run's stages and the criteria; returns the cfg."""
    from bart_tpu_torch.demo import TRUTH
    from bart_tpu_torch.driver.config import load_config, load_data_array
    from bart_tpu_torch.inference.gr import split_rhat_rank
    from bart_tpu_torch.inference.likelihood import ParamSpace

    post = np.load(os.path.join(loc, "output.npy"))
    with open(os.path.join(loc, "MCMC.log")) as f:
        log = f.read()
    chi2 = float(re.findall(r"best chi2 = ([-+0-9.eE]+)", log)[-1])
    cfg = load_config(cfg_path, {"loc_dir": loc, "quiet": "True"})
    space = ParamSpace(cfg.params, cfg.pmin, cfg.pmax, cfg.stepsize)
    nfree = space.nfree
    flat = post.transpose(1, 0, 2).reshape(nfree, -1)
    mean, std = flat.mean(1), flat.std(1)
    truth = TRUTH[space.ifree]
    constrained = std < 0.5 * (space.free_max - space.free_min) / np.sqrt(12)
    pulls = np.abs(mean - truth) / np.maximum(std, 1e-12)
    qq = np.percentile(flat, [0.5, 99.5], axis=1)
    covered = (truth > qq[0]) & (truth < qq[1])
    rhat = split_rhat_rank(post.transpose(0, 2, 1))
    chi2_dof = chi2 / len(load_data_array(cfg.data))
    print(f"# {label}: {post.shape[0]} chains x {post.shape[2]} kept steps "
          f"in {run['seconds']:.2f} s; stages "
          + ", ".join(f"{k} {v} s" for k, v in run["stages"].items())
          + f"; launches counted in Python {run['counts']}")
    print(f"# {label}: mean "
          f"{np.array2string(mean, precision=4)}, std "
          f"{np.array2string(std, precision=4)}, truth "
          f"{np.array2string(truth, precision=4)}; constrained "
          f"{constrained.tolist()}, pulls "
          f"{np.array2string(pulls, precision=3)}; 99% interval covers "
          f"{covered.tolist()}; chi2/dof {chi2_dof:.3f}; split-Rhat "
          f"{np.array2string(rhat, precision=4)}")
    check(bool(np.all(np.isfinite(post))), f"{label}: non-finite posterior")
    check(bool(np.all(pulls[constrained] < 3.5)),
          f"{label}: truth recovery: pulls {pulls} on {constrained}")
    check(bool(np.all(covered)), f"{label}: truth recovery: the 99% "
          f"interval misses the truth ({qq}, {truth})")
    check(chi2_dof < 3.0, f"{label}: truth recovery: chi2/dof {chi2_dof}")
    check(bool(np.all(rhat < 1.35)),
          f"{label}: truth recovery: split-Rhat {rhat}")
    return cfg


def cli_model(cfg_path: str, loc: str, device, **over):
    """(cfg, forward model) of the CLI on the cfg at ``cfg_path`` with the
    files in ``loc`` (reused where they exist: --resume), built in this
    process by ``Pipeline.run`` with --justPlots and no plots, which
    stops after the forward's set-up; ``over``: cfg keys to override."""
    from bart_tpu_torch.driver.config import load_config
    from bart_tpu_torch.driver.pipeline import Pipeline

    class Model(Pipeline):
        def stage_forward(self, atm, wn, grid):
            self.model = super().stage_forward(atm, wn, grid)
            return self.model

    cfg = load_config(cfg_path, {"loc_dir": loc, "quiet": "True",
                                 "plots": "False", **over})
    pipe = Model(cfg, just_plots=True, resume=True, device=device)
    pipe.run()
    return cfg, pipe.model[0]


def cli_phase(fused, smi: str) -> dict:
    """Phase 8: the port's CLI, ``python3 -m bart_tpu_torch -c cfg``, on
    the cfgs of examples/torch_demo at full width (100 layers x 2501 wn x
    30,000 lines x 27 T-nodes, + 14 CIA T-nodes in transit).

    (a) subprocesses: ``--validate`` on each cfg exits 0; ``--justTEA`` on
    eclipse_tea.cfg exits 0 and writes an atm whose q sums to 1 per layer
    to the file's 5 digits with H2 above 0.5; the same stage in this
    process sums to 1 at 1e-8 and matches the file.
    (b) ``driver.cli.main`` on eclipse.cfg: 512 chains x CLI_STEPS graphed
    steps (burn-in CLI_BURNIN), no plots, no running convergence test;
    fused_eclipse launched; the posterior recovers the cfg's truth by
    tests/test_end_to_end.py:71-87's four criteria.  Then
    ``--justSpectrum`` on the same directory reuses the atm and opacity
    files (no second build) and its spectrum matches the forward at the
    cfg's parameters with the molfit factor at 0.
    (c) ``driver.cli.main`` on transit.cfg: 512 chains x 100 steps;
    fused_transit launched, output.npy finite, MCMC.log written."""
    import shutil

    import torch

    from bart_tpu_torch.driver.config import load_config
    from bart_tpu_torch.driver.pipeline import Pipeline
    from bart_tpu_torch.io.atm import read_atm
    from bart_tpu_torch.io.spectrum import read_spectrum

    root = os.path.dirname(os.path.abspath(__file__))
    demo = os.path.join(root, "examples", "torch_demo")
    work = os.path.join(root, "build", "phase8")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    kernels = (fused.fused_eclipse, fused.fused_transit)
    out = {}

    # (a) subprocesses
    env = {**os.environ, "PYTHONPATH": root}
    for name in CLI_CFGS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "bart_tpu_torch", "-c",
             os.path.join(demo, f"{name}.cfg"), "--validate"],
            cwd=work, env=env, capture_output=True, text=True, timeout=300)
        print(f"# phase 8: --validate {name}.cfg: exit {proc.returncode} in "
              f"{time.perf_counter() - t0:.2f} s (a process); "
              + proc.stdout.strip().splitlines()[-1])
        check(proc.returncode == 0, f"--validate {name}.cfg: {proc.stdout}"
              f"{proc.stderr}")
    tea_cfg = os.path.join(demo, "eclipse_tea.cfg")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "bart_tpu_torch", "-c", tea_cfg, "--justTEA",
         "--loc_dir", os.path.join(work, "tea")],
        cwd=work, env=env, capture_output=True, text=True, timeout=600)
    tea_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"--justTEA: {proc.stdout}{proc.stderr}")
    atm_file = read_atm(os.path.join(work, "tea", "atmosphere.atm"))
    cfg = load_config(tea_cfg, {"loc_dir": os.path.join(work, "tea_in"),
                                "quiet": "True"})
    atm = Pipeline(cfg, just_tea=True, device=dev).run()
    q, qf = atm.abundances, atm_file.abundances
    ih2 = atm.species.index("H2")
    e_sum = float(np.abs(q.sum(axis=1) - 1.0).max())
    e_file = float(np.abs(qf.sum(axis=1) - 1.0).max())
    e_q = float(np.max(np.abs(qf - q) / np.maximum(q, 1e-300)))
    print(f"# phase 8: --justTEA eclipse_tea.cfg: exit 0 in {tea_s:.2f} s "
          f"(a process); {q.shape[0]} layers x {len(atm.species)} species, "
          f"|sum q - 1| {e_sum:.3e} in process, {e_file:.3e} in the file; "
          f"file vs process q {e_q:.3e}; H2 {q[:, ih2].min():.4f}.."
          f"{q[:, ih2].max():.4f}, T {atm.temperature.min():.1f}.."
          f"{atm.temperature.max():.1f} K")
    check(e_sum < 1e-8, f"equilibrium q sums to 1 within {e_sum}")
    check(e_file < 1e-4, f"the atm file's q sums to 1 within {e_file}")
    check(e_q < 1e-4, f"the atm file's q differs by {e_q}")
    check(bool(np.all(q[:, ih2] > 0.5) and np.all(qf[:, ih2] > 0.5)),
          "H2 not above 0.5 in every layer")

    # (b) eclipse.cfg: the retrieval, then --justSpectrum
    ecfg = os.path.join(demo, "eclipse.cfg")
    eloc = os.path.join(work, "eclipse")
    run = cli_run(["-c", ecfg, "--loc_dir", eloc, "--nchains",
                   str(CLI_CHAINS), "--numit", str(CLI_CHAINS * CLI_STEPS),
                   "--burnin", str(CLI_BURNIN), "--plots", "False",
                   "--grtest", "False"],
                  kernels)
    cfg = cli_truth("phase 8: cli eclipse.cfg", ecfg, eloc, run)
    check(run["counts"]["fused_eclipse"] > 0,
          "the CLI eclipse run did not launch fused_eclipse")
    out["eclipse"] = run

    files = [os.path.join(eloc, n) for n in ("atmosphere.atm",
                                             "opacity_CH4.npz")]
    mtimes = [os.stat(f).st_mtime_ns for f in files]
    spec_run = cli_run(["-c", ecfg, "--loc_dir", eloc, "--justSpectrum"],
                       kernels)
    check([os.stat(f).st_mtime_ns for f in files] == mtimes,
          "--justSpectrum rewrote the atm or the opacity file")
    wn_s, spec_s = read_spectrum(os.path.join(eloc, cfg.outspec), wn=True)
    _, fm = cli_model(ecfg, eloc, dev)
    wn = cfg.wavenumber_grid()
    p = np.array(cfg.params, np.float64)
    p[-1] = 0.0   # the atm file carries unscaled abundances
    _, spec_p, valid = fm(torch.tensor(p[None], dtype=torch.float32,
                                       device=dev))
    spec_p = spec_p[0].double().cpu().numpy()
    e_spec = float(np.max(np.abs(spec_s - spec_p) / np.abs(spec_p)))
    print(f"# phase 8: cli eclipse.cfg --justSpectrum: {len(spec_s)} wn "
          f"in {spec_run['seconds']:.2f} s, stages "
          + ", ".join(f"{k} {v} s" for k, v in spec_run["stages"].items())
          + f"; launches {spec_run['counts']}; vs the forward at the cfg's "
          f"parameters: max rel err {e_spec:.3e}")
    check(bool(valid[0]), "the cfg's parameters are invalid")
    check(np.allclose(np.sort(wn_s), wn, rtol=1e-6), "outspec wn grid")
    check(e_spec < CLI_SPEC_RTOL, f"--justSpectrum rel err {e_spec}")
    check(spec_run["counts"]["fused_eclipse"] > 0,
          "--justSpectrum did not launch fused_eclipse")
    out["spectrum"] = spec_run

    # (c) transit.cfg: a short retrieval
    tloc = os.path.join(work, "transit")
    run = cli_run(["-c", os.path.join(demo, "transit.cfg"), "--loc_dir",
                   tloc, "--nchains", str(CLI_CHAINS), "--numit",
                   str(CLI_CHAINS * CLI_TRANSIT_STEPS), "--burnin", "50",
                   "--plots", "False"], kernels)
    post = np.load(os.path.join(tloc, "output.npy"))
    print(f"# phase 8: cli transit.cfg: {CLI_CHAINS} chains x "
          f"{CLI_TRANSIT_STEPS} steps in {run['seconds']:.2f} s; stages "
          + ", ".join(f"{k} {v} s" for k, v in run["stages"].items())
          + f"; launches counted in Python {run['counts']}; posterior "
          f"{post.shape}")
    check(run["counts"]["fused_transit"] > 0,
          "the CLI transit run did not launch fused_transit")
    check(post.shape[0] == CLI_CHAINS and post.shape[2] > 0
          and bool(np.all(np.isfinite(post))), "transit posterior")
    check(os.path.isfile(os.path.join(tloc, "MCMC.log")), "no MCMC.log")
    out["transit"] = run
    print(f"# phase 8 ({smi}): {time.perf_counter() - t_phase:.1f} s "
          "for the phase")
    return out



def fold_path_kernels(fused, fm, params) -> dict:
    """Phase 11: the two kernels of one of the CLI's folded models at the
    shapes its forward gives them (the folded kernel on the fine bins,
    the K = 1 kernel on the smooth ones), each held against its plain
    version on the same inputs and timed beside it with CUDA events;
    with each launch's bound.  These launches do not count."""
    import torch

    from bart_tpu_torch.rt.transit_geom import slant_geometry

    t = fm.tables
    transit = fm.config.solution == "transit"
    T_safe, q, rad_cm, _ = fm._profiles(params, t)
    parts, wrows = fm._fused_rows(params, t, T_safe, q, rad_cm)
    C, L = T_safe.shape
    if transit:
        G, wgt = slant_geometry(rad_cm)
        Gp = fused.prepare_slant(G)
        pair = (fused.fused_transit_folded, fused.fused_transit)
    else:
        dr = rad_cm[:, :-1] - rad_cm[:, 1:]
        drp = torch.cat([torch.zeros_like(dr[:, :1]), dr], dim=1)
        mu, muw = t["mu"], t["mu_w"]
        pair = (fused.fused_eclipse_folded, fused.fused_eclipse)
    counts = [k.launches for k in pair]
    out = {}
    for tab, folded, wn_p, _ in parts:
        kernel = pair[0] if folded else pair[1]
        K = tab.K if folded else 1
        R, F = tab.tab.shape[0], tab.W * K
        bf16 = folded and tab.tab.dtype == torch.bfloat16
        if transit:
            args, pargs = (wrows, Gp, wgt), (wrows, G, wgt)
            plain = (fused.transit_folded_plain if folded else
                     lambda tb, *a: fused.transit_plain(tb.plain(), *a))
            rtol = OUT_RTOL
            bnd = transit_bound(R, L, F, C, K, bf16,
                                nbytes(tab.tab, wrows, G, wgt))
        else:
            args = pargs = (wn_p, mu, muw, wrows, T_safe, drp, fm._powers)
            plain = (fused.eclipse_folded_plain if folded else
                     lambda tb, *a: fused.eclipse_plain(tb.plain(), *a))
            rtol = SPEC_RTOL[fm._powers]
            bnd = eclipse_bound(R, L, F, C, int(mu.shape[0]), fm._powers, K,
                                bf16, nbytes(tab.tab, *args[:-1]))
        got, ref = kernel(tab, *args), plain(tab, *pargs)
        torch.cuda.synchronize()
        name = kernel.__name__
        out[name] = dict(
            rel=rel_err(got, ref), abs=abs_err(got, ref), R=R, W=tab.W, K=K,
            ms=cuda_ms(lambda: kernel(tab, *args), 5 if folded else 10),
            plain_ms=cuda_ms(lambda: plain(tab, *pargs), 2), bound=bnd)
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(out[name]["rel"] < rtol,
              f"{name} on the CLI's rows: rel err {out[name]['rel']}")
        del got, ref
    for k, n in zip(pair, counts):
        k.launches = n                        # comparisons do not count
    return out


def cli_fold_phase(fused, f32: dict, smi: str) -> dict:
    """Phase 11 (``--cli-fold``): the publication-accuracy retrieval
    through the port's CLI at full width: examples/torch_demo/
    eclipse_fold.cfg and transit_fold.cfg (100 layers x 2501 output bins,
    K = 32 on the 80,032-point fine grid, the adaptive split 0.02,
    bfloat16 fine rows, 27 T-nodes, CH4 and H2-H2 CIA).

    (a) ``driver.cli.main`` on eclipse_fold.cfg: the fine build, then
    512 chains x CLI_STEPS graphed steps (burn-in CLI_BURNIN), no plots,
    no running convergence test; fused_eclipse_folded and fused_eclipse
    launched; phase 8's four truth criteria; then phase 4b on the CLI's
    own likelihood (graphed block = eager block bit for bit, each kernel
    once a step in the trace of a replayed block, the step's times).
    (b) ``--justSpectrum`` on its directory reuses the atm and opacity
    files (no second build) and matches the CLI's folded forward at the
    cfg's parameters within phase 2's tolerances; the bins that forward
    sends to the folded kernel are fine_bin_mask's on the file, each
    kernel against its plain version on its rows, and the folded bands at
    the truth within FOLD_DATA_SIGMA of a K = 1 forward's (the cfgs' data
    are the K = 1 pipeline's).  (c) ``driver.cli.main`` on
    transit_fold.cfg on (a)'s opacity file (make_inputs.py writes both
    cfgs from one fold block; the file's wn, pressure and T grids are
    checked against the transit cfg and model): 512 chains x 100 steps,
    fused_transit_folded and fused_transit launched, output.npy finite,
    MCMC.log written; phase 4b, its kernels and its truth bands as in
    (a)-(b).  (d) ``driver.cli.main`` on eclipse_fold_f32.cfg (foldtable16
    left at the reference's default: float32 fine rows) on (a)'s opacity
    file: 512 chains x F32_STEPS graphed steps, output.npy finite,
    acceptance > 0, MCMC.log written, the step's ms and the memory; phase
    4b on its likelihood; its kernels on its rows; its folded bands at the
    truth within F32_BAND_RTOL of (b)'s bfloat16 model's and within
    FOLD_DATA_SIGMA of the K = 1 forward's."""
    import shutil

    import torch

    from bart_tpu_torch.demo import TRUTH, TRUTH_TRANSIT
    from bart_tpu_torch.driver.config import load_data_array
    from bart_tpu_torch.driver.pipeline import Pipeline
    from bart_tpu_torch.io.spectrum import read_spectrum
    from bart_tpu_torch.opacity.grid import fine_bin_mask, load_grid
    from bart_tpu_torch.utils.grids import folded_fine_grid

    root = os.path.dirname(os.path.abspath(__file__))
    demo = os.path.join(root, "examples", "torch_demo")
    work = os.path.join(root, "build", "phase11")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_phase = time.perf_counter()
    dev = f32["device"]
    kernels = (fused.fused_eclipse_folded, fused.fused_eclipse,
               fused.fused_transit_folded, fused.fused_transit)
    ecfg, tcfg, fcfg = (os.path.join(demo, f"{n}.cfg")
                        for n in ("eclipse_fold", "transit_fold",
                                  "eclipse_fold_f32"))
    eloc, tloc, floc = (os.path.join(work, n)
                        for n in ("eclipse", "transit", "eclipse_f32"))
    opac = os.path.join(eloc, "opacity_CH4.npz")
    gib = 2.0 ** 30

    # the CLI's likelihood, parameter space and cfg, and the device memory
    # the pipeline holds when its retrieval starts
    held, likes = {}, {}
    stage_mcmc = Pipeline.stage_mcmc

    def measured(self, like, space):
        torch.cuda.synchronize()
        held[self.cfg.solution] = torch.cuda.memory_allocated() / gib
        likes[self.cfg.solution] = (like, space, self.cfg)
        return stage_mcmc(self, like, space)

    def near(truth, spread):
        return torch.tensor(np.tile(truth, (CLI_CHAINS, 1)) + rng.normal(
            0, 1, (CLI_CHAINS, len(truth))) * spread, **f32)

    def bands_at(fm, truth, label):
        b, _, valid = fm(torch.tensor(truth[None], **f32))
        check(bool(valid[0]), f"{label}: invalid truth")
        return b[0].double().cpu().numpy()

    def truth_bands(b, b1, uncert, label):
        """The folded bands ``b`` at the truth against the K = 1
        forward's ``b1``."""
        sig = np.abs(b - b1) / uncert
        print(f"# phase 11: {label}: folded bands at the truth against the "
              f"K = 1 forward's (the data's source): rel "
              f"{np.array2string(np.abs(b - b1) / b1, precision=3)}, in "
              f"sigma {np.array2string(sig, precision=3)} (max "
              f"{sig.max():.3f}, bound {FOLD_DATA_SIGMA})")
        check(float(sig.max()) < FOLD_DATA_SIGMA,
              f"{label}: the K = 1 data sit {sig.max():.3f} sigma from the "
              "folded model at the truth: make the fold cfgs' data from the "
              "folded forward")

    rng = np.random.default_rng(2)
    Pipeline.stage_mcmc = measured
    out = {"steps": {}}
    try:
        # (a) eclipse_fold.cfg: the fine build and the retrieval
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run = cli_run(["-c", ecfg, "--loc_dir", eloc, "--nchains",
                       str(CLI_CHAINS), "--numit", str(CLI_CHAINS * CLI_STEPS),
                       "--burnin", str(CLI_BURNIN), "--plots", "False",
                       "--grtest", "False"], kernels)
        peak = torch.cuda.max_memory_allocated() / gib
        cfg = cli_truth("phase 11: cli eclipse_fold.cfg", ecfg, eloc, run)
        step_ms = 1e3 * run["stages"]["mcmc"] / CLI_STEPS
        n_fine = len(folded_fine_grid(cfg.wavenumber_grid(), cfg.fold_K))
        print(f"# phase 11 ({smi}): cli eclipse_fold.cfg: opacity (the "
              f"{n_fine}-point fine build) {run['stages']['opacity']} s, "
              f"mcmc {run['stages']['mcmc']} s = {step_ms:.3f} ms a "
              f"{CLI_CHAINS}-chain "
              f"step with the host's stores; peak {peak:.2f} GiB, "
              f"{held['eclipse']:.2f} GiB held when the retrieval starts")
        check(run["counts"]["fused_eclipse_folded"] > 0
              and run["counts"]["fused_eclipse"] > 0,
              f"the CLI folded eclipse run launched {run['counts']}")
        check(run["counts"]["fused_transit_folded"] == 0
              and run["counts"]["fused_transit"] == 0,
              f"the CLI folded eclipse run launched {run['counts']}")
        out["eclipse"] = run
        like, space, _ = likes.pop("eclipse")
        fm = like.forward
        params = near(TRUTH, FOLD_CHECK_SPREAD)
        label = "phase 11: cli eclipse_fold.cfg"
        out["steps"]["cli_eclipse_fold"] = step = step_phase(
            label, like, space, fm, params,
            [fused.fused_eclipse_folded, fused.fused_eclipse])
        print_steps(label, step, smi)
        del like, space

        # (b) --justSpectrum on the same directory
        files = [os.path.join(eloc, "atmosphere.atm"), opac]
        mtimes = [os.stat(f).st_mtime_ns for f in files]
        spec_run = cli_run(["-c", ecfg, "--loc_dir", eloc, "--justSpectrum"],
                           kernels)
        check([os.stat(f).st_mtime_ns for f in files] == mtimes,
              "--justSpectrum rewrote the atm or the opacity file")
        wn_s, spec_s = read_spectrum(os.path.join(eloc, cfg.outspec),
                                     wn=True)
        K, wn = cfg.fold_K, cfg.wavenumber_grid()
        grid = load_grid(opac, device=dev)
        mask = fine_bin_mask(grid.sigma, K, delta=0.02).cpu().numpy()
        n_f = int(mask.sum())
        del grid
        p = np.array(cfg.params, np.float64)
        p[-1] = 0.0   # the atm file carries unscaled abundances
        # the folded forward on the files --justSpectrum read
        _, fms = cli_model(ecfg, eloc, dev)
        _, spec_p, valid = fms(torch.tensor(p[None], **f32))
        spec_p = spec_p[0].double().cpu().numpy()
        del fms
        e_spec = float(np.max(np.abs(spec_s - spec_p) / np.abs(spec_p)))
        print(f"# phase 11: cli eclipse_fold.cfg --justSpectrum: "
              f"{len(spec_s)} wn in {spec_run['seconds']:.2f} s, stages "
              + ", ".join(f"{k} {v} s" for k, v in spec_run["stages"].items())
              + f"; launches {spec_run['counts']}; vs the folded forward at "
              f"the cfg's parameters: max rel err {e_spec:.3e}; "
              f"fine bins {n_f} of {len(wn)} ({n_f / len(wn):.3f}), K = {K}")
        check(bool(valid[0]), "the cfg's parameters are invalid")
        check(np.allclose(np.sort(wn_s), wn, rtol=1e-6), "outspec wn grid")
        check(e_spec < SPEC_RTOL[fm._powers],
              f"folded --justSpectrum rel err {e_spec}")
        check(spec_run["counts"]["fused_eclipse_folded"] > 0
              and spec_run["counts"]["fused_eclipse"] > 0,
              f"--justSpectrum launched {spec_run['counts']}")
        check(fm._idx_fine is not None
              and np.array_equal(fm._idx_fine, np.where(mask)[0])
              and fm.tables["tabk"].W == n_f,
              "the folded bins are not fine_bin_mask's")
        out["spectrum"] = spec_run
        checks = fold_path_kernels(fused, fm, params)
        # the K = 1 pipeline's forward (the source of the cfg's data)
        k1loc = os.path.join(work, "k1")
        _, fm1 = cli_model(ecfg, k1loc, dev, rtosamp="1")
        b16 = bands_at(fm, TRUTH, "eclipse_fold.cfg")
        b1 = bands_at(fm1, TRUTH, "eclipse_fold.cfg, K = 1")
        truth_bands(b16, b1, load_data_array(cfg.uncert), "eclipse_fold.cfg")
        # the graphs of phase 4b hold their models in reference cycles
        del fm, fm1
        gc.collect()
        torch.cuda.empty_cache()

        # (c) transit_fold.cfg on (a)'s table
        torch.cuda.reset_peak_memory_stats()
        run = cli_run(["-c", tcfg, "--loc_dir", tloc, "--nchains",
                       str(CLI_CHAINS), "--numit",
                       str(CLI_CHAINS * CLI_TRANSIT_STEPS), "--burnin", "50",
                       "--plots", "False", "--opacityfile", opac], kernels)
        tpeak = torch.cuda.max_memory_allocated() / gib
        post = np.load(os.path.join(tloc, "output.npy"))
        print(f"# phase 11 ({smi}): cli transit_fold.cfg on the eclipse "
              f"run's table: {CLI_CHAINS} chains x {CLI_TRANSIT_STEPS} steps "
              f"in {run['seconds']:.2f} s; stages "
              + ", ".join(f"{k} {v} s" for k, v in run["stages"].items())
              + f"; launches counted in Python {run['counts']}; posterior "
              f"{post.shape}; peak {tpeak:.2f} GiB, {held['transit']:.2f} "
              "GiB held when the retrieval starts")
        check(run["counts"]["fused_transit_folded"] > 0
              and run["counts"]["fused_transit"] > 0,
              f"the CLI folded transit run launched {run['counts']}")
        check(post.shape[0] == CLI_CHAINS and post.shape[2] > 0
              and bool(np.all(np.isfinite(post))), "transit posterior")
        check(os.path.isfile(os.path.join(tloc, "MCMC.log")), "no MCMC.log")
        out["transit"] = run
        like, space, tc = likes.pop("transit")
        fmt = like.forward
        grid = load_grid(opac, device="cpu")
        t_grid = np.arange(tc.tlow, tc.thigh + tc.tempdelt / 2, tc.tempdelt)
        check(np.array_equal(grid.wn_grid, folded_fine_grid(
            tc.wavenumber_grid(), tc.fold_K))
              and np.array_equal(grid.t_grid, t_grid)
              and np.allclose(grid.pressure,
                              fmt.pressure.double().cpu().numpy(),
                              rtol=1e-6, atol=0),
              "eclipse_fold.cfg's opacity file is not transit_fold.cfg's "
              "table (wn, T or pressure grid): build it for transit")
        del grid
        # the radius (parameter 5) spread in km, the rest as eclipse's
        params = near(TRUTH_TRANSIT, np.where(
            np.arange(len(TRUTH_TRANSIT)) == 5, 10.0, FOLD_CHECK_SPREAD))
        label = "phase 11: cli transit_fold.cfg"
        out["steps"]["cli_transit_fold"] = step = step_phase(
            label, like, space, fmt, params,
            [fused.fused_transit_folded, fused.fused_transit])
        print_steps(label, step, smi)
        del like, space
        checks.update(fold_path_kernels(fused, fmt, params))
        _, fmt1 = cli_model(tcfg, os.path.join(work, "k1_transit"), dev,
                            rtosamp="1", opacityfile=os.path.join(
                                k1loc, "opacity_CH4.npz"))
        truth_bands(bands_at(fmt, TRUTH_TRANSIT, "transit_fold.cfg"),
                    bands_at(fmt1, TRUTH_TRANSIT, "transit_fold.cfg, K = 1"),
                    load_data_array(tc.uncert), "transit_fold.cfg")
        del fmt, fmt1
        gc.collect()
        torch.cuda.empty_cache()

        # (d) eclipse_fold_f32.cfg on (a)'s opacity file: float32 fine rows
        torch.cuda.reset_peak_memory_stats()
        run = cli_run(["-c", fcfg, "--loc_dir", floc, "--nchains",
                       str(CLI_CHAINS), "--numit", str(CLI_CHAINS * F32_STEPS),
                       "--burnin", str(F32_STEPS // 2), "--plots", "False",
                       "--grtest", "False", "--opacityfile", opac], kernels)
        fpeak = torch.cuda.max_memory_allocated() / gib
        post = np.load(os.path.join(floc, "output.npy"))
        with open(os.path.join(floc, "MCMC.log")) as f:
            accept = float(re.findall(r"accept=([0-9.]+)", f.read())[-1])
        print(f"# phase 11 ({smi}): cli eclipse_fold_f32.cfg on the eclipse "
              f"run's table: {CLI_CHAINS} chains x {F32_STEPS} steps in "
              f"{run['seconds']:.2f} s; stages "
              + ", ".join(f"{k} {v} s" for k, v in run["stages"].items())
              + f" = {1e3 * run['stages']['mcmc'] / F32_STEPS:.3f} ms a "
              f"{CLI_CHAINS}-chain step with the host's stores; accept "
              f"{accept:.3f}; launches counted in Python {run['counts']}; "
              f"posterior {post.shape}; peak {fpeak:.2f} GiB, "
              f"{held['eclipse']:.2f} GiB held when the retrieval starts")
        check(run["counts"]["fused_eclipse_folded"] > 0
              and run["counts"]["fused_eclipse"] > 0
              and run["counts"]["fused_transit_folded"] == 0
              and run["counts"]["fused_transit"] == 0,
              f"the CLI float32-table run launched {run['counts']}")
        check(post.shape[0] == CLI_CHAINS and post.shape[2] > 0
              and bool(np.all(np.isfinite(post))), "float32-table posterior")
        check(accept > 0.0, "float32-table retrieval: no accepted proposal")
        out["f32"] = run
        like, space, _ = likes.pop("eclipse")
        fmf = like.forward
        check(fmf.tables["tabk"].tab.dtype == torch.float32
              and fmf.tables["tabk"].W == n_f,
              "eclipse_fold_f32.cfg's model does not hold float32 fine rows "
              "on fine_bin_mask's bins")
        params = near(TRUTH, FOLD_CHECK_SPREAD)
        label = "phase 11: cli eclipse_fold_f32.cfg"
        out["steps"]["cli_eclipse_fold_f32"] = step = step_phase(
            label, like, space, fmf, params,
            [fused.fused_eclipse_folded, fused.fused_eclipse])
        print_steps(label, step, smi)
        del like, space
        f32_checks = fold_path_kernels(fused, fmf, params)
        checks["fused_eclipse_folded[float32]"] = f32_checks.pop(
            "fused_eclipse_folded")
        c = f32_checks["fused_eclipse"]
        print(f"# phase 11: eclipse_fold_f32.cfg: fused_eclipse on its "
              f"smooth bins (W={c['W']}): max rel err {c['rel']:.3e}, kernel "
              f"{c['ms']:.3f} ms")
        bf = bands_at(fmf, TRUTH, "eclipse_fold_f32.cfg")
        e16 = float(np.max(np.abs(bf - b16) / np.abs(b16)))
        print(f"# phase 11: eclipse_fold_f32.cfg: folded bands at the truth "
              f"against the bfloat16 model's: max rel {e16:.3e} (bound "
              f"{F32_BAND_RTOL})")
        check(e16 < F32_BAND_RTOL, f"float32 against bfloat16 fine rows: "
              f"bands at the truth rel {e16}")
        truth_bands(bf, b1, load_data_array(cfg.uncert),
                    "eclipse_fold_f32.cfg")
        del fmf
    finally:
        Pipeline.stage_mcmc = stage_mcmc
    for name, c in checks.items():
        print(f"# phase 11 ({smi}): {name} on the CLI's rows (R={c['R']} "
              f"W={c['W']} K={c['K']} C={CLI_CHAINS}): max rel err "
              f"{c['rel']:.3e}, abs {c['abs']:.3e}; kernel {c['ms']:.3f} ms, "
              f"plain {c['plain_ms']:.3f} ms, bound {c['bound']['bound_ms']:.3f}"
              f" ms ({c['bound']['bound_term']}; tensor cores "
              f"{c['bound']['tensor_ms']:.3f} ms, {c['bound']['tensor_type']})")
    out["checks"] = checks
    print(f"# phase 11 ({smi}): {time.perf_counter() - t_phase:.1f} s for "
          "the phase")
    return out


def cli_fold_kernels(p11: dict) -> list:
    """Phase 11's kernels line: launches on the device, in the trace of a
    replayed block of each CLI model's step; python_launches the
    wrapper's count over the phase's four CLI runs (eager calls,
    warm-ups, captures: a replay is never counted there); the rest from
    each kernel on the CLI models' own rows.  The folded eclipse kernel
    has an entry per table type, each counted on the runs of its type:
    ``fused_eclipse_folded`` the bfloat16 instance (eclipse_fold.cfg),
    ``fused_eclipse_folded[float32]`` the float32 one
    (eclipse_fold_f32.cfg)."""
    runs = {r: p11[r]["counts"]
            for r in ("eclipse", "spectrum", "transit", "f32")}
    recs = []
    for key, c in p11["checks"].items():
        name = key.split("[")[0]
        f32 = key.endswith("[float32]")
        folded = name == "fused_eclipse_folded"

        def mine(run):
            # the K = 1 kernels serve every run, a folded instance those
            # of its table type
            return not folded or run.endswith("f32") == f32

        by_path = {p: st["counts"][name] for p, st in p11["steps"].items()
                   if name in st["counts"] and mine(p)}
        more = {"table": "float32" if f32 else "bfloat16"} if folded else {}
        recs.append(kernel_record(
            key, c["abs"], c["ms"], c["plain_ms"], c["bound"],
            sum(by_path.values()), launches_by_path=by_path,
            python_launches=sum(n[name] for r, n in runs.items() if mine(r)),
            cli_fold_launches={r: n[name] for r, n in runs.items()
                               if mine(r)},
            max_rel_err=c["rel"], **more))
    return recs


def onthefly_phase(fused, fm, fmt, inp, f32: dict, smi: str) -> dict:
    """Phase 9a: the on-the-fly (table-free) forward at full width: the
    30,000 demo lines on uniform 256-point tiles (tile_lines, with the
    wing cutoff and ethresh of phase 3's build), Voigt profiles of every
    layer's (T, p) in each forward, the unfused radiative transfer; no
    fused kernel runs.  Per geometry (eclipse raygrid as ``fm``; transit
    with CIA as ``fmt``) on OTF_CHAINS chains: a forward, finite and
    valid, and ``spectrum_from_profiles`` on isothermal profiles at table
    nodes against the gridded model's (fused kernels) at the kernel
    tolerances.  Eclipse also: graphed = eager bit for bit, eager and
    graphed serialized times, and each one's peak memory."""
    import torch

    from bart_tpu_torch import constants as const
    from bart_tpu_torch.demo import DEMO_PARAMS, DEMO_PARAMS_TRANSIT
    from bart_tpu_torch.linelist.molecules import get_molecule
    from bart_tpu_torch.obs.bands import band_integrate
    from bart_tpu_torch.opacity.extinction import (BroadeningSpec,
                                                   tile_lines, wing_cutoff)
    from bart_tpu_torch.rt.forward import ForwardModel

    t_phase = time.perf_counter()
    dev = f32["device"]
    spec = BroadeningSpec()          # build_demo_model's bath
    mol = get_molecule("CH4")
    cutoff = wing_cutoff(20.0, float(inp.wn[-1]), float(inp.t_grid[0]),
                         float(inp.pressure[-1]) * const.BAR_TO_BARYE,
                         mol.mass * const.AMU, mol.diameter * 1e-8, spec)
    tiles = tile_lines(inp.lines, inp.wn, cutoff, tile_size=256,
                       device=dev, dtype=torch.float32)
    out = {"tiles": tiles.shape}
    L, S = inp.base_q.shape
    T_nodes = torch.tensor(OTF_NODES, **f32)[:, None].expand(-1, L)
    q_nodes = torch.tensor(inp.base_q, **f32).expand(len(OTF_NODES), L, S)
    rng = np.random.default_rng(9)
    for name, grid_fm, base in (("eclipse", fm, DEMO_PARAMS),
                                ("transit", fmt, DEMO_PARAMS_TRANSIT)):
        fmo = ForwardModel(
            grid_fm.config, wn_grid=inp.wn, pressure=inp.pressure,
            species=inp.species, base_abundances=inp.base_q,
            opacity={"CH4": tiles}, system=inp.system, bands=grid_fm.bands,
            cia_tables=[inp.cia] if name == "transit" else [],
            broadening=spec, nwidth=20.0, budget_bytes=OTF_BUDGET,
            device=dev, dtype=torch.float32)
        spread = np.where(np.arange(len(base)) == 5, 10.0, 0.005) \
            if name == "transit" else 0.005
        params = torch.tensor(np.tile(base, (OTF_CHAINS, 1)) + rng.normal(
            0, 1, (OTF_CHAINS, len(base))) * spread, **f32)
        n0 = (fused.fused_eclipse.launches, fused.fused_transit.launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        band, spectrum, valid = fmo(params)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        eager_gib = torch.cuda.max_memory_allocated() / 2**30
        check((fused.fused_eclipse.launches, fused.fused_transit.launches)
              == n0, "the on-the-fly forward launched a fused kernel")
        check(tuple(spectrum.shape) == (OTF_CHAINS, len(inp.wn)),
              f"on-the-fly spectrum shape {spectrum.shape}")
        check(bool(valid.all()), "invalid on-the-fly samples")
        check(bool(torch.isfinite(band).all()
                   & torch.isfinite(spectrum).all()),
              "non-finite on-the-fly forward")
        res = dict(first_s=first_s, eager_gib=eager_gib)
        timed = ""
        if name == "eclipse":
            # graphed = eager, and both timed (one round each: a forward
            # is seconds)
            torch.cuda.reset_peak_memory_stats()
            g = fmo.graphed()
            gout = g(params)
            torch.cuda.synchronize()
            res["graph_gib"] = torch.cuda.max_memory_allocated() / 2**30
            check(all(torch.equal(a, b) for a, b in
                      zip(gout, (band, spectrum, valid))),
                  f"{name}: graphed() on the fly differs from eager")
            res["eager"] = serialized_ms(fmo, params, 1, 1)
            res["graphed"] = serialized_ms(g, params, 1, 1)
            timed = (f"; {res['graph_gib']:.2f} GiB with the capture; "
                     f"graphed = eager bit for bit; serialized eager "
                     f"{res['eager'][0]:.1f} ms, graphed "
                     f"{res['graphed'][0]:.1f} ms")
            del g, gout
        # held against the gridded model at table nodes
        s_otf = fmo.spectrum_from_profiles(T_nodes, q_nodes)
        s_grid = grid_fm.spectrum_from_profiles(T_nodes, q_nodes)
        bw = grid_fm.tables["band_w"]
        res["e_spec"] = e_spec = rel_err(s_otf, s_grid)
        res["e_band"] = e_band = rel_err(band_integrate(bw, s_otf),
                                         band_integrate(bw, s_grid))
        print(f"# phase 9a ({smi}): on-the-fly {name}, {OTF_CHAINS} chains, "
              f"tiles {tuple(tiles.shape)} (cutoff {cutoff:.2f} cm-1), "
              f"chunks of {fmo._cond_chunk} conditions: first forward "
              f"{first_s:.2f} s, peak {eager_gib:.2f} GiB eager{timed}; "
              f"vs the gridded forward at {OTF_NODES} K: spectrum max rel "
              f"err {e_spec:.3e}, band {e_band:.3e}")
        check(e_spec < (OUT_RTOL if name == "transit" else SPEC_RTOL[False]),
              f"{name}: on the fly vs gridded spectrum rel err {e_spec}")
        check(e_band < BAND_RTOL,
              f"{name}: on the fly vs gridded band rel err {e_band}")
        out[name] = res
        del fmo
        torch.cuda.empty_cache()
    print(f"# phase 9a ({smi}): {time.perf_counter() - t_phase:.1f} s")
    return out


def osamp_cli_phase(fused, smi: str) -> dict:
    """Phase 9b: ``python -m bart_tpu_torch -c eclipse.cfg --osamp 16``
    (driver.cli.main in this process) at full wn width and 100 layers,
    the T grid cut to the cfg's nodes that bracket its truth's profile:
    --justOpacity builds the bin-averaged table on the card, then
    --justSpectrum reads it (fused_eclipse).  The top layer's line mass
    against sum S(T) at every T node (MASS_RTOL), two conditions on the
    build's tile OSAMP_TILE against the port's float64 cross-sections on
    the CPU (OSAMP_ROW_RTOL of each row's maximum), the stage seconds and
    the build's peak memory."""
    import shutil

    import torch

    from bart_tpu_torch import constants as const
    from bart_tpu_torch.demo import SYSTEM, TRUTH
    from bart_tpu_torch.driver.config import load_config
    from bart_tpu_torch.driver.pipeline import Pipeline
    from bart_tpu_torch.io.spectrum import read_spectrum
    from bart_tpu_torch.linelist.hitran import TREF
    from bart_tpu_torch.linelist.molecules import get_molecule
    from bart_tpu_torch.linelist.tips import partition_function
    from bart_tpu_torch.opacity.extinction import (cross_section_grid,
                                                   tile_lines, wing_cutoff)
    from bart_tpu_torch.opacity.grid import load_grid
    from bart_tpu_torch.physics.pt import pt_generator
    from bart_tpu_torch.utils.grids import pressure_grid

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    ecfg = os.path.join(root, "examples", "torch_demo", "eclipse.cfg")
    work = os.path.join(root, "build", "phase9")
    shutil.rmtree(work, ignore_errors=True)
    loc = os.path.join(work, "osamp")
    cfg = load_config(ecfg, {"loc_dir": loc, "quiet": "True"})
    # the nodes that bracket the truth's profile
    # (examples/torch_demo/make_inputs.py:truth_tgrid)
    p = torch.tensor(pressure_grid(cfg.n_layers, cfg.p_top, cfg.p_bottom,
                                   cfg.log), dtype=torch.float64)
    s = SYSTEM
    T_truth, _ = pt_generator(
        p, torch.tensor(TRUTH[:5])[None], cfg.PTtype,
        [s.r_star, s.t_star, cfg.tint, s.sma, s.g_planet_cgs,
         cfg.tint_type])
    lo = cfg.tlow + cfg.tempdelt * np.floor(
        (float(T_truth.min()) - cfg.tlow) / cfg.tempdelt)
    hi = max(cfg.tlow + cfg.tempdelt * np.ceil(
        (float(T_truth.max()) - cfg.tlow) / cfg.tempdelt), lo + cfg.tempdelt)
    argv = ["-c", ecfg, "--loc_dir", loc, "--osamp", str(CLI_OSAMP),
            "--tlow", str(lo), "--thigh", str(hi)]
    kernels = (fused.fused_eclipse,)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = cli_run(argv + ["--justOpacity"], kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    spec_run = cli_run(argv + ["--justSpectrum"], kernels)
    check(spec_run["counts"]["fused_eclipse"] > 0,
          "--justSpectrum on the osamp table did not launch fused_eclipse")
    wn_s, spec_s = read_spectrum(os.path.join(loc, cfg.outspec), wn=True)
    check(bool(np.all(np.isfinite(spec_s)) and np.all(spec_s > 0)),
          "--justSpectrum on the osamp table: spectrum")

    cfg = load_config(ecfg, {"loc_dir": loc, "quiet": "True",
                             "osamp": str(CLI_OSAMP), "tlow": str(lo),
                             "thigh": str(hi)})
    grid = load_grid(os.path.join(loc, cfg.opacityfile), device="cpu")
    wn = cfg.wavenumber_grid()
    nT = len(grid.t_grid)
    check(tuple(grid.sigma.shape) == (1, nT, cfg.n_layers, len(wn)),
          f"osamp table shape {tuple(grid.sigma.shape)}")
    check(bool(torch.isfinite(grid.sigma).all()), "non-finite osamp table")

    # the line mass of the top layer at every T node
    pipe = Pipeline(cfg, device="cpu")
    tli = pipe.stage_linelist(wn)
    lines = tli.lines["CH4"].cull(cfg.ethresh)
    q_fn = partition_function("CH4", (tli.partition or {}).get("CH4"))
    wndelt = float(wn[1] - wn[0])
    inside = (lines.wn0 > wn[0] - 0.5 * wndelt) & \
        (lines.wn0 < wn[-1] + 0.5 * wndelt)
    c2 = const.C2
    e_mass = []
    for it, T in enumerate(grid.t_grid):
        qr = float(q_fn(torch.tensor(TREF, dtype=torch.float64))
                   / q_fn(torch.tensor(T, dtype=torch.float64)))
        s_T = (lines.s296 * qr
               * np.exp(-c2 * lines.elower * (1.0 / T - 1.0 / TREF))
               * (1.0 - np.exp(-c2 * lines.wn0 / T))
               / (1.0 - np.exp(-c2 * lines.wn0 / TREF)))
        mass = float(grid.sigma[0, it, 0].double().sum()) * wndelt
        e_mass.append(abs(mass / float(s_T[inside].sum()) - 1.0))

    # two conditions on one tile against the float64 CPU build
    atm = pipe.stage_atmosphere(pipe.stage_pressure(),
                                pipe.stage_abundances())
    bspec = pipe._broadening(atm)
    mol = get_molecule("CH4")
    cutoff = wing_cutoff(cfg.nwidth, float(wn[-1]), float(grid.t_grid[0]),
                         float(atm.pressure[-1]) * const.BAR_TO_BARYE,
                         mol.mass * const.AMU, mol.diameter * 1e-8, bspec)
    cols = np.arange(256 * OSAMP_TILE, 256 * (OSAMP_TILE + 1))
    tiles = tile_lines(lines, wn[cols], cutoff, tile_size=256,
                       device="cpu", dtype=torch.float64)
    conds = ((0, 0), (nT - 1, cfg.n_layers - 1))
    t0 = time.perf_counter()
    ref = cross_section_grid(
        tiles, torch.tensor([grid.t_grid[i] for i, _ in conds],
                            dtype=torch.float64),
        torch.tensor([atm.pressure[j] for _, j in conds],
                     dtype=torch.float64) * const.BAR_TO_BARYE,
        bspec, nwidth=cfg.nwidth, q_table=(tli.partition or {}).get("CH4"),
        osamp=CLI_OSAMP, wndelt=wndelt).numpy()
    cpu_s = time.perf_counter() - t0
    got = np.stack([grid.sigma[0, i, j, cols].double().numpy()
                    for i, j in conds])
    e_rows = np.abs(got - ref).max(axis=1) / ref.max(axis=1)
    print(f"# phase 9b ({smi}): cli eclipse.cfg --osamp {CLI_OSAMP} "
          f"--tlow {lo} --thigh {hi}: table {tuple(grid.sigma.shape)}; "
          f"--justOpacity {run['seconds']:.2f} s (stages "
          + ", ".join(f"{k} {v} s" for k, v in run["stages"].items())
          + f"), build peak {peak:.2f} GiB; --justSpectrum "
          f"{spec_run['seconds']:.2f} s (stages "
          + ", ".join(f"{k} {v} s" for k, v in spec_run["stages"].items())
          + f"), launches {spec_run['counts']}")
    print(f"# phase 9b: top-layer line mass vs sum S(T) of "
          f"{int(inside.sum())} lines at {grid.t_grid.tolist()} K: rel err "
          + ", ".join(f"{e:.3e}" for e in e_mass)
          + f"; float32 card vs float64 CPU ({cpu_s:.1f} s) on "
          f"{len(cols)} wn, {wn[cols[0]]:.0f}-{wn[cols[-1]]:.0f} cm-1, at "
          f"(T, layer) {conds}: "
          "max abs err / row max " + ", ".join(f"{e:.3e}" for e in e_rows))
    check(max(e_mass) < MASS_RTOL, f"osamp line mass rel err {e_mass}")
    check(float(e_rows.max()) < OSAMP_ROW_RTOL,
          f"osamp table vs float64: {e_rows}")
    print(f"# phase 9b: {time.perf_counter() - t_phase:.1f} s")
    return dict(run=run, spectrum=spec_run, peak_gib=peak, e_mass=e_mass,
                e_rows=e_rows)


def write_par(lines, path: str, mol_id: int) -> None:
    """A HITRAN-2004 .par file (160-character records) of a LineList:
    the fields the parsers read, in their widths, the rest blank."""
    def frac(x, width):       # ".0633": HITRAN drops the leading zero
        return f"{x:{width + 1}.{width - 1}f}"[1:]

    with open(path, "w") as f:
        for k in range(lines.nlines):
            f.write(f"{mol_id:2d}{int(lines.iso[k]):1d}"
                    f"{lines.wn0[k]:12.6f}{lines.s296[k]:10.3E}"
                    f"{0.0:10.3E}{frac(lines.gamma_air[k], 5)}"
                    f"{lines.gamma_self[k]:5.3f}{lines.elower[k]:10.4f}"
                    f"{lines.n_air[k]:4.2f}{0.0:8.6f}" + " " * 93 + "\n")


def host_entry_points_phase(inp, work: str) -> dict:
    """Phase 9c: the host entry points, no card.  The demo list written
    as a .par and scanned by the native scanner called directly (a failed
    g++ build fails here), bit for bit against the numpy parser; the
    lineread CLI on that .par plus a synthetic ExoMol triplet, whose TLI
    loads and equals the parsed lines (and the source lines to the .par's
    digits); the widths tool on eclipse.cfg."""
    from bart_tpu_torch.linelist import lineread
    from bart_tpu_torch.linelist.exomol import read_exomol
    from bart_tpu_torch.linelist.hitran import parse_par_bytes
    from bart_tpu_torch.linelist.molecules import get_molecule
    from bart_tpu_torch.linelist.tli import load_tli
    from bart_tpu_torch.native import hitran_native
    from bart_tpu_torch.tools import widths

    t_phase = time.perf_counter()
    os.makedirs(work, exist_ok=True)
    par = os.path.join(work, "ch4_demo.par")
    write_par(inp.lines, par, get_molecule("CH4").hitran_id)
    t0 = time.perf_counter()
    native = hitran_native.read_par(par)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(par, "rb") as f:
        numpy_ = parse_par_bytes(f.read())
    numpy_s = time.perf_counter() - t0
    fields = ("wn0", "s296", "elower", "gamma_air", "gamma_self", "n_air",
              "iso")
    check(list(native) == list(numpy_) == ["CH4"], f"species {list(native)}")
    check(all(np.array_equal(getattr(native["CH4"], f),
                             getattr(numpy_["CH4"], f)) for f in fields),
          "the native scanner differs from the numpy parser")
    src, got = inp.lines, native["CH4"]
    check(got.nlines == src.nlines, "the .par lost lines")
    # the .par's digits: wn0 to 1e-6 and E'' to 1e-4 cm-1, S296 to three
    # significant digits (half a digit, and the doubles' rounding)
    e_src = {f: float(np.max(np.abs(getattr(got, f) - getattr(src, f))))
             for f in ("wn0", "elower")}
    e_src["s296 rel"] = float(np.max(np.abs(got.s296 / src.s296 - 1.0)))
    check(e_src["wn0"] < 6e-7 and e_src["elower"] < 6e-5
          and e_src["s296 rel"] < 6e-4, f"the .par vs its lines: {e_src}")

    for name, text in (("m.states", EXOMOL_STATES), ("m.trans", EXOMOL_TRANS),
                       ("m.pf", EXOMOL_PF)):
        with open(os.path.join(work, name), "w") as f:
            f.write(text)
    triplet = ":".join(os.path.join(work, n) for n in
                       ("m.states", "m.trans", "m.pf"))
    out = os.path.join(work, "demo.tli")
    pyline = os.path.join(work, "pyline.cfg")
    with open(pyline, "w") as f:
        f.write(f"[Parameters]\ndb_list = {par} {triplet}\n"
                "dbtype = hit exomol\npart_list = implicit implicit\n"
                f"species = CH4 H2O\noutput = {out}\niwav = 1.0\n"
                "fwav = 10.0\n")
    t0 = time.perf_counter()
    check(lineread.main(["-c", pyline]) == 0, "lineread failed")
    lineread_s = time.perf_counter() - t0
    check(lineread.main(["-c", pyline, "--validate"]) == 0,
          "lineread --validate found issues")
    tli = load_tli(out + ".npz")
    exo = read_exomol(*triplet.split(":")[:2], "H2O", triplet.split(":")[2],
                      1e4 / 10.0, 1e4 / 1.0)
    check(tli.species == ["CH4", "H2O"], f"TLI species {tli.species}")
    check(all(np.array_equal(getattr(tli.lines["CH4"], f),
                             getattr(got, f)) for f in fields)
          and all(np.array_equal(getattr(tli.lines["H2O"], f),
                                 getattr(exo, f)) for f in fields),
          "the TLI differs from the lines it was built from")
    ecfg = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "torch_demo", "eclipse.cfg")
    check(widths.main(["-c", ecfg]) == 0, "widths failed")
    from bart_tpu_torch.driver.config import load_config
    w = widths.get_widths(load_config(ecfg, {"quiet": "True"}))
    check(all(np.isfinite(v) and v > 0 for v in w.values()), f"widths {w}")
    print(f"# phase 9c: {src.nlines} demo lines as a .par "
          f"({os.path.getsize(par) / 2**20:.1f} MiB): native scanner "
          f"{native_s:.3f} s, numpy parser {numpy_s:.3f} s, equal bit for "
          f"bit; vs the source lines: "
          + ", ".join(f"{k} {v:.1e}" for k, v in e_src.items())
          + f"; lineread (.par + ExoMol triplet) {lineread_s:.2f} s -> "
          f"{tli.total_lines()} lines {tli.species}, equal to the parsed "
          f"lines; widths {w}; {time.perf_counter() - t_phase:.1f} s")
    return dict(native_s=native_s, numpy_s=numpy_s, lineread_s=lineread_s)


def phase9(fused, fm, fmt, inp, f32: dict, smi: str) -> dict:
    """Phase 9: the on-the-fly forward (9a), the osamp table through the
    CLI (9b) and the host entry points (9c).  The fused kernels' counts
    are zeroed at its start and summed over its runs: the on-the-fly
    forwards launch none, the gridded comparisons of 9a launch
    fused_eclipse and fused_transit, 9b's --justSpectrum fused_eclipse."""
    t0 = time.perf_counter()
    kernels = (fused.fused_eclipse, fused.fused_transit)
    for k in kernels:
        k.launches = 0                            # phase 9 starts here
    otf = onthefly_phase(fused, fm, fmt, inp, f32, smi)
    counts = {k.__name__: k.launches for k in kernels}
    osamp = osamp_cli_phase(fused, smi)
    for run in (osamp["run"], osamp["spectrum"]):
        counts["fused_eclipse"] += run["counts"]["fused_eclipse"]
    root = os.path.dirname(os.path.abspath(__file__))
    host = host_entry_points_phase(
        inp, os.path.join(root, "build", "phase9", "host"))
    took = time.perf_counter() - t0
    print(f"# phase 9 ({smi}): {took:.1f} s for the phase; launches counted "
          f"in Python {counts}")
    check(counts["fused_eclipse"] > 0 and counts["fused_transit"] > 0,
          f"phase 9 did not launch both K = 1 kernels: {counts}")
    return dict(otf=otf, osamp=osamp, host=host, counts=counts,
                seconds=took)


#: phase 10: the meshes of gloo ranks that share the card (name ->
#: (n_chain, n_wn)); the chains of a forward; the chains a folded plain
#: version takes a call when it is held against its kernel on a rank's
#: whole block (it holds [C, L, W K] temporaries: 16 chains are ~0.3 GB a
#: tensor on half the fine grid);
#: the on-the-fly forward's chains and byte budget (two ranks hold their
#: temporaries at once); the steps of the meshed snooker block and the
#: share of its chains whose accept decisions may differ from the
#: unsharded block's (float32 band sums added in another order can flip
#: a decision that sits on the edge); the output bins of the fine build
#: under --phase10; the sharded spectra against the unsharded card
#: forward; seconds a group of ranks, a collective of theirs and the
#: dryrun may take
MESH_LAYOUTS = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
MESH_CHAINS, MESH_FOLD_CHAINS = 512, 16
MESH_OTF_CHAINS, MESH_OTF_BUDGET = 2, 4e9
MESH_BLOCK_STEPS, MESH_FLIP_SHARE = 3, 0.01
MESH_FOLD_BINS, MESH_SPEC_RTOL = 320, 1e-6
MESH_TIMEOUT = 300
#: phases 10 and 13: the back-to-back all-reduces timed with CUDA events;
#: the graphed blocks timed a path (BLOCK steps each, one host read a
#: block; the median counts); seconds the ranks may take to exit once
#: they wrote their records; the kernel each path launches
MESH_ALLREDUCES, MESH_TIMED_BLOCKS, MESH_TEARDOWN_S = 50, 3, 60
CASE_KERNEL = {"eclipse": "fused_eclipse", "transit": "fused_transit",
               "folded-eclipse": "fused_eclipse_folded",
               "folded-transit": "fused_transit_folded"}
#: phase 13 (``--nccl4``): four ranks, one a card over NCCL (fewer cards
#: raise; nothing falls back to gloo, to shared cards or to fewer ranks),
#: every path on every one of these meshes (name -> (n_chain, n_wn)), the
#: truth recovery on 2x2; seconds the ranks may take together
NCCL4_WORLD = 4
NCCL4_LAYOUTS = {"1x4": (1, 4), "4x1": (4, 1), "2x2": (2, 2)}
NCCL4_TIMEOUT = 400


def mesh_inputs(inp, n_out: int):
    """The demo inputs cut to the first ``n_out`` output bins (the
    filters that lie inside them): the output grid of a fine table built
    on those bins."""
    import dataclasses

    if n_out == len(inp.wn):
        return inp
    top = inp.wn[n_out - 1]
    return dataclasses.replace(
        inp, wn=inp.wn[:n_out], star_flux=inp.star_flux[:n_out],
        filters=[f for f in inp.filters if f[0][-1] < top])


def mesh_models(inp, grid, fine, device, cases) -> dict:
    """Phase 10's models on ``device``: eclipse (raygrid) and transit
    (CIA) on the K = 1 table ``grid``; folded eclipse (expsum) and transit
    (CIA) with ``fold_adapt=None`` and bfloat16 fine rows on ``fine``; the
    on-the-fly eclipse model on the demo lines' uniform tiles."""
    import torch

    from bart_tpu_torch import constants as const
    from bart_tpu_torch.demo import build_demo_model
    from bart_tpu_torch.linelist.molecules import get_molecule
    from bart_tpu_torch.obs.bands import build_band_matrix
    from bart_tpu_torch.opacity.extinction import (BroadeningSpec,
                                                   tile_lines, wing_cutoff)
    from bart_tpu_torch.rt.forward import ForwardConfig, ForwardModel

    f32 = dict(device=device, dtype=torch.float32)
    out = {}
    for case in cases:
        if case in ("eclipse", "transit"):
            out[case] = build_demo_model(inp, grid=grid, solution=case,
                                         cia=case == "transit", **f32)
        elif case.startswith("folded"):
            solution = case.split("-")[1]
            sub = mesh_inputs(inp, fine.sigma.shape[-1] // FOLD_K)
            out[case] = build_demo_model(
                sub, grid=fine, solution=solution, cia=solution == "transit",
                quadrature="expsum" if solution == "eclipse" else "raygrid",
                fold=FOLD_K, fold_adapt=None, fold_bf16=True, **f32)
        else:                                    # on the fly
            spec, mol = BroadeningSpec(), get_molecule("CH4")
            cutoff = wing_cutoff(20.0, float(inp.wn[-1]),
                                 float(inp.t_grid[0]),
                                 float(inp.pressure[-1])
                                 * const.BAR_TO_BARYE, mol.mass * const.AMU,
                                 mol.diameter * 1e-8, spec)
            tiles = tile_lines(inp.lines, inp.wn, cutoff, tile_size=256,
                               **f32)
            out[case] = ForwardModel(
                ForwardConfig(**inp.config_kwargs), wn_grid=inp.wn,
                pressure=inp.pressure, species=inp.species,
                base_abundances=inp.base_q, opacity={"CH4": tiles},
                system=inp.system, bands=build_band_matrix(
                    inp.wn, inp.filters, star_flux=inp.star_flux,
                    rprs=inp.system.rprs, **f32),
                broadening=spec, nwidth=20.0, budget_bytes=MESH_OTF_BUDGET,
                **f32)
    return out


def held_table(fm):
    """(the columns in use of the model's wn-indexed table, its wn axis):
    the K = 1 table [R, L, W], the folded one [R, L, W, K], or the first
    species' line tiles [n_tiles, lines]."""
    t = fm.tables
    if "tabk" in t:
        return t["tabk"].bins(), 2
    if "tab" in t:
        return t["tab"].plain(), 2
    return t["lt0_wn0"], 0


def mesh_params(case: str, nchain: int) -> np.ndarray:
    """The chains of a phase-10 forward: around the demo parameters (the
    transit radius spread by 10 km), as phase 3's."""
    from bart_tpu_torch.demo import DEMO_PARAMS, DEMO_PARAMS_TRANSIT

    transit = case.endswith("transit")
    base = DEMO_PARAMS_TRANSIT if transit else DEMO_PARAMS
    spread = np.where(np.arange(len(base)) == 5, 10.0, 0.005) \
        if transit else 0.005
    rng = np.random.default_rng(10 + len(case))
    return np.tile(base, (nchain, 1)) + rng.normal(
        0, 1, (nchain, len(base))) * spread


def mesh_kernel_rows(fused, fm, params, case: str) -> dict:
    """The case's kernel on this rank's whole block of chains and its wn
    shard: {"name", "kernel": its wrapper on the forward's own rows,
    "plain": its plain version on them (the folded ones on
    MESH_FOLD_CHAINS chains a call, they hold [C, L, W K] temporaries;
    the slices put back together, so that every row the path launches
    is compared), "spec": the spectrum of an output, "band_w", "bound":
    the launch's bound on these rows}."""
    import torch

    from bart_tpu_torch.rt.transit_geom import slant_geometry

    t = fm.tables
    lo, hi = fm.mesh.chain_block(params.shape[0])
    p = fm._params(params[lo:hi])
    T, q, rad, _ = fm._profiles(p, t)
    ((tab, folded, wn_p, _),), wrows = fm._fused_rows(p, t, T, q, rad)
    C, L = wrows.shape[:2]
    bf16 = folded and tab.tab.dtype == torch.bfloat16

    def sliced(plain, head, tail, *per_chain):
        """``plain(*head, *per_chain, *tail)`` on MESH_FOLD_CHAINS chains
        of ``per_chain`` a call, the slices concatenated."""
        n = MESH_FOLD_CHAINS
        return torch.cat([plain(*head, *(x[i:i + n] for x in per_chain),
                                *tail) for i in range(0, C, n)])

    if case.endswith("transit"):
        G, wgt = slant_geometry(rad)
        if folded:
            name = "fused_transit_folded"
            kernel = lambda: fused.fused_transit_folded(tab, wrows, G, wgt)
            plain = lambda: sliced(fused.transit_folded_plain, (tab,), (),
                                   wrows, G, wgt)
            R, F, K = tab.tab.shape[0], tab.W * tab.K, tab.K
            nb = nbytes(tab.tab, wrows, G, wgt)
        else:
            name = "fused_transit"
            kernel = lambda: fused.fused_transit(tab, wrows, G, wgt)
            plain = lambda: fused.transit_plain(tab.plain(), wrows, G, wgt)
            (R, _, F), K = tab.plain().shape, 1
            nb = nbytes(tab.plain(), wrows, G, wgt)
        r2 = (fm.system.r_star * 100.0) ** 2
        spec = lambda x: (rad[:, -1:] ** 2 + x) / r2
        bnd = transit_bound(R, L, F, C, K, bf16, nb)
    else:
        dr = rad[:, :-1] - rad[:, 1:]
        drp = torch.cat([torch.zeros_like(dr[:, :1]), dr], dim=1)
        tail = (wn_p, t["mu"], t["mu_w"], wrows, T, drp, fm._powers)
        if folded:
            name = "fused_eclipse_folded"
            kernel = lambda: fused.fused_eclipse_folded(tab, *tail)
            plain = lambda: sliced(fused.eclipse_folded_plain,
                                   (tab, wn_p, t["mu"], t["mu_w"]),
                                   (fm._powers,), wrows, T, drp)
            R, F, K = tab.tab.shape[0], tab.W * tab.K, tab.K
            nb = nbytes(tab.tab, *tail[:-1])
        else:
            name = "fused_eclipse"
            kernel = lambda: fused.fused_eclipse(tab, *tail)
            plain = lambda: fused.eclipse_plain(tab.plain(), *tail)
            (R, _, F), K = tab.plain().shape, 1
            nb = nbytes(tab.plain(), wrows, T, drp, wn_p)
        spec = lambda x: x
        bnd = eclipse_bound(R, L, F, C, int(t["mu"].shape[0]), fm._powers,
                            K, bf16, nb)
    return {"name": name, "kernel": kernel, "plain": plain, "spec": spec,
            "band_w": t["band_w"], "chains": C, "bound": bnd}


def mesh_block(fm, seed: int = 11):
    """A MESH_BLOCK_STEPS-step snooker block of MESH_CHAINS chains on the
    eclipse model (eager: on a gloo mesh the step cannot be captured),
    from uniform starts: (positions [steps, chains, nfree], the initial
    positions)."""
    import torch

    from bart_tpu_torch.demo import DEMO_PARAMS, TRUTH
    from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
    from bart_tpu_torch.inference.samplers import EnsembleSampler

    data = fm(torch.tensor(TRUTH[None]))[0][0].double().cpu().numpy()
    space = ParamSpace(pinit=DEMO_PARAMS, pmin=[-5, -2, -2, 0, 0.55, -9],
                       pmax=[-1, 1, 1, 1, 1.2, 1.5],
                       stepsize=[0.01, 0.01, 0.0, 0.0, 0.001, 0.1])
    like = Likelihood(fm, space, data, 0.03 * data)
    sampler = EnsembleSampler(
        loglike_fn=like, nfree=space.nfree, nmodel=len(data),
        nchains=MESH_CHAINS, walk="snooker", pmin=space.free_min,
        pmax=space.free_max, stepsize=space.stepsize[space.ifree])
    gen = torch.Generator(device=fm.device).manual_seed(seed)
    state = sampler.init_state(gen)
    pos0 = state.positions.cpu().numpy()
    _, pb, _, _ = sampler.run_block(state, gen, MESH_BLOCK_STEPS,
                                    graphed=False)
    return pb.cpu().numpy(), pos0


def accept_decisions(pb: np.ndarray, pos0: np.ndarray) -> np.ndarray:
    """[steps, chains] bool: whether each step moved each chain."""
    prev = np.concatenate([pos0[None], pb[:-1]])
    return np.any(pb != prev, axis=-1)


def mesh_timed(fn, nrep: int = 5) -> float:
    """Median ms of ``nrep`` calls, each synchronised (a rank's calls wait
    for the other ranks' at the collective)."""
    import torch

    times = []
    for _ in range(nrep + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times[1:]))


def block_likelihood(fm, case: str, data):
    """(likelihood, space) of a graphed block on the case's model: the
    eclipse paths on the demo's parameters, the transit ones on the
    transit demo's, with ``data`` (the unsharded forward's bands at the
    truth) and 3% / 0.5% uncertainties, as phase 4."""
    from bart_tpu_torch.demo import (DEMO_PARAMS, DEMO_PARAMS_TRANSIT,
                                     TRANSIT_BOUNDS)
    from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace

    data = np.asarray(data, np.float64)
    if case.endswith("transit"):
        pmin, pmax, step = TRANSIT_BOUNDS
        space = ParamSpace(pinit=DEMO_PARAMS_TRANSIT, pmin=pmin, pmax=pmax,
                           stepsize=step)
        return Likelihood(fm, space, data, 0.005 * data), space
    space = ParamSpace(pinit=DEMO_PARAMS, pmin=[-5, -2, -2, 0, 0.55, -9],
                       pmax=[-1, 1, 1, 1, 1.2, 1.5],
                       stepsize=[0.01, 0.01, 0.0, 0.0, 0.001, 0.1])
    return Likelihood(fm, space, data, 0.03 * data), space


def graphed_blocks(fm, case: str, data, nchains: int, mesh=None) -> dict:
    """On one model, meshed or not: from uniform starts (seed 11) the
    eager block and the graphed block (BLOCK steps: the captured step
    replayed; on a mesh the band-flux all-reduce is in the capture) on
    the same variates, which must be equal bit for bit; then
    MESH_TIMED_BLOCKS graphed blocks, each ending in a host read.  On a
    mesh every block is followed by the ranks' agreement check
    (``Mesh.agree``).  Returns the graphed block's positions and the
    initial ones (its accept decisions), the equality, the median ms a
    graphed step and the acceptance."""
    import torch

    from bart_tpu_torch.inference.samplers import EnsembleSampler, StepGraph

    like, space = block_likelihood(fm, case, data)
    s = EnsembleSampler(loglike_fn=like, nfree=space.nfree,
                        nmodel=int(like.data.shape[0]), nchains=nchains,
                        walk="snooker", pmin=space.free_min,
                        pmax=space.free_max,
                        stepsize=space.stepsize[space.ifree])

    def agree(st):
        if mesh is not None:
            mesh.agree(st.positions, st.loglike, st.naccept,
                       what=f"{case} sampler states")

    gen = torch.Generator(device=fm.device).manual_seed(11)
    state = s.init_state(gen)
    pos0 = state.positions.cpu().numpy()
    saved = gen.get_state()
    eager = s.run_block(state, gen, BLOCK, graphed=False)
    agree(eager[0])
    gen.set_state(saved)
    graphed = s.run_block(state, gen, BLOCK, graphed=True)
    agree(graphed[0])
    check(isinstance(s.step_graph(state, BLOCK), StepGraph),
          f"{case}: the block did not replay a captured step")
    equal = all(torch.equal(g, e) for g, e in zip(
        [*graphed[0], *graphed[1:]], [*eager[0], *eager[1:]]))
    st, times = graphed[0], []
    for _ in range(MESH_TIMED_BLOCKS):
        t0 = time.perf_counter()
        st = s.run_block(st, gen, BLOCK)[0]
        float(st.loglike.sum())
        times.append(1e3 * (time.perf_counter() - t0) / BLOCK)
        agree(st)
    return {"positions": graphed[1].cpu().numpy(), "pos0": pos0,
            "bit_equal": equal, "step_ms": float(np.median(times)),
            "step_rounds": times,
            "accept": float(graphed[0].naccept.sum()) / (BLOCK * nchains)}


def mesh_layout(fused, meta: dict, mesh, inp, grid, fine, saved: dict,
                name: str) -> dict:
    """One mesh of phases 10 and 13 in one rank: the job's paths built on
    the host and sharded onto the rank's device; every path's forward
    with the kernels' counts zeroed just before and read just after;
    then per path its kernel on this rank's chains and wn shard against
    its plain version (errors, ms, the launch's bound), the gathered
    spectra (rank 0 keeps them), the forward's and the all-reduce's ms
    and, on a mesh that can capture, the graphed blocks of the paths the
    job gives data for (``graphed_blocks``); on the job's ``block`` mesh
    the eager block (``mesh_block``); the device's peak bytes."""
    import torch

    from bart_tpu_torch.obs.bands import band_integrate
    from bart_tpu_torch.parallel import shard_model

    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    models = mesh_models(inp, grid, fine, "cpu", meta["cases"][name])
    out = {"coords": [mesh.chain, mesh.wn], "cases": {}}
    for case, fm in models.items():
        full, axis = held_table(fm)
        n = full.shape[axis]
        shard_model(fm, mesh)
        held = held_table(fm)[0]
        out["cases"][case] = {
            "held_bytes": held.nbytes, "full_bytes": full.nbytes,
            "padded_bytes": full.nbytes // n * (n + (-n) % mesh.n_wn),
            "device": str(held.device), "on_mesh_device": held.device == dev}
    kernels = (fused.fused_eclipse, fused.fused_transit,
               fused.fused_eclipse_folded, fused.fused_transit_folded)
    params = {case: torch.tensor(mesh_params(
        case, MESH_OTF_CHAINS if case == "onthefly" else meta["nchains"]),
        dtype=torch.float32) for case in models}
    results = {}
    for k in kernels:
        k.launches = 0                          # the mesh's forwards start
    for case, fm in models.items():
        n0 = mesh.collectives
        results[case] = fm(params[case])
        out["cases"][case]["collectives"] = mesh.collectives - n0
    torch.cuda.synchronize()
    out["launches"] = {k.__name__: k.launches for k in kernels}  # they end
    for case, fm in models.items():
        band, spec, valid = results[case]
        C = params[case].shape[0]
        rec = out["cases"][case]
        rec["local_shape"] = list(spec.shape)
        if case != "onthefly":
            k = mesh_kernel_rows(fused, fm, params[case], case)
            got, ref = k["kernel"](), k["plain"]()
            check(got.shape == ref.shape and got.shape[0] == k["chains"],
                  f"{name} {case}: kernel {tuple(got.shape)}, plain "
                  f"{tuple(ref.shape)}")
            rec.update(kernel=k["name"], kernel_rel=rel_err(got, ref),
                       kernel_abs=abs_err(k["spec"](got), k["spec"](ref)),
                       kernel_band=rel_err(
                           band_integrate(k["band_w"], k["spec"](got)),
                           band_integrate(k["band_w"], k["spec"](ref))),
                       bound=k["bound"], chains=k["chains"])
            del got, ref
            rec["kernel_ms"] = cuda_ms(k["kernel"], 10)
            rec["plain_ms"] = cuda_ms(k["plain"], 2)
        whole = mesh.gather(spec, C)
        if mesh.rank == 0:
            saved[f"{name}/{case}/band"] = band.cpu().numpy()
            saved[f"{name}/{case}/valid"] = valid.cpu().numpy()
            saved[f"{name}/{case}/spectrum"] = whole.cpu().numpy()
        rec["forward_ms"] = mesh_timed(lambda: fm(params[case]),
                                       1 if case == "onthefly" else 5)
        buf = torch.zeros(C, band.shape[1] + 1, device=dev)
        rec["all_reduce_ms"] = cuda_ms(lambda: mesh.all_reduce(buf),
                                       MESH_ALLREDUCES)
        if mesh.capturable and case in meta.get("data", {}):
            blk = graphed_blocks(fm, case, meta["data"][case], C, mesh)
            if mesh.rank == 0:
                saved[f"{name}/{case}/block"] = blk["positions"]
                saved[f"{name}/{case}/pos0"] = blk["pos0"]
            rec.update({x: blk[x] for x in ("bit_equal", "step_ms",
                                            "step_rounds", "accept")})
        print(f"# rank {mesh.rank}: {name} {case} done", flush=True)
    if name == meta.get("block"):
        pb, pos0 = mesh_block(models["eclipse"])
        if mesh.rank == 0:
            saved[f"{name}/block/positions"] = pb
            saved[f"{name}/block/pos0"] = pos0
    del models, results
    gc.collect()
    torch.cuda.empty_cache()
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def mesh_truth(meta: dict, mesh, inp, grid, job: str) -> dict:
    """Phase 13 (d) in one rank: the eclipse model sharded over the mesh
    and phase 4c's retrieval on it (graphed, its all-reduce captured),
    every output file of run_mcmc asked for in a directory of the rank's
    own: only rank 0's may fill."""
    from bart_tpu_torch.demo import DEMO_PARAMS
    from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
    from bart_tpu_torch.parallel import shard_model

    fm = shard_model(mesh_models(inp, grid, None, "cpu",
                                 ["eclipse"])["eclipse"], mesh)
    data, uncert = (np.asarray(a) for a in meta["truth_data"])
    space = ParamSpace(pinit=DEMO_PARAMS, pmin=[-5, -2, -2, 0, 0.55, -9],
                       pmax=[-1, 1, 1, 1, 1.2, 1.5],
                       stepsize=[0.01, 0.01, 0.0, 0.0, 0.001, 0.1])
    like = Likelihood(fm, space, data, uncert)
    out = os.path.join(job, "truth", f"rank{mesh.rank}")
    os.makedirs(out)
    return truth_phase(
        like, space, meta["nchains"],
        label=f"phase 13 (d), rank {mesh.rank} of a {mesh.n_chain}x"
              f"{mesh.n_wn} mesh", savefile=os.path.join(out, "output.npy"),
        logfile=os.path.join(out, "MCMC.log"),
        checkpoint=os.path.join(out, "checkpoint.npz"))


def mesh_rank(job: str) -> int:
    """One rank of phases 10 and 13 (``chip_smoke.py --mesh-rank job``;
    RANK, LOCAL_RANK, WORLD_SIZE and MASTER_* set by ``run_ranks`` as
    torchrun sets them): ``mesh_rank_run``.  A rank that raises prints
    the traceback and leaves at once (exit 1): tearing its group down
    would wait for the other ranks' collectives."""
    import traceback

    try:
        return mesh_rank_run(job)
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def mesh_rank_run(job: str) -> int:
    """One rank: it joins the job's group (``init_distributed``: the
    job's backend, on the job's device, or on cuda:LOCAL_RANK when it
    names none), loads the tables on the host, runs every mesh of the job
    (``mesh_layout``) and, when the job asks, the truth recovery
    (``mesh_truth``); its record goes to rank<r>.json, rank 0's arrays to
    rank0.npz, and each mesh's record to the rank's log as it ends."""
    import torch
    import torch.distributed as dist

    from bart_tpu_torch.demo import demo_inputs
    from bart_tpu_torch.opacity.grid import load_grid
    from bart_tpu_torch.parallel import (init_distributed, local_device,
                                         make_mesh)
    from bart_tpu_torch.rt import fused

    t0 = time.perf_counter()
    meta = json.load(open(os.path.join(job, "job.json")))
    torch.set_num_threads(meta["threads"])
    init_distributed(backend=meta["backend"], device=meta["device"],
                     timeout_s=MESH_TIMEOUT)
    rank = dist.get_rank()
    inp = demo_inputs()
    grid = load_grid(meta["grid"], device="cpu")
    fine = load_grid(meta["fine"], device="cpu")
    out = {"rank": rank, "device": str(local_device(meta["device"])),
           "backend": dist.get_backend(), "layouts": {}}
    saved = {}
    for name, (n_chain, n_wn) in meta["layouts"].items():
        t1 = time.perf_counter()
        mesh = make_mesh(n_chain, n_wn, device=meta["device"])
        out["layouts"][name] = mesh_layout(fused, meta, mesh, inp, grid,
                                           fine, saved, name)
        out["layouts"][name]["seconds"] = time.perf_counter() - t1
        print(f"# rank {rank}: {name}: " + json.dumps(out["layouts"][name]),
              flush=True)
    if meta.get("truth"):
        del fine
        t1 = time.perf_counter()
        mesh = make_mesh(*meta["truth"], device=meta["device"])
        out["truth"] = mesh_truth(meta, mesh, inp, grid, job)
        out["truth"]["wall_s"] = time.perf_counter() - t1
        print(f"# rank {rank}: truth: " + json.dumps(out["truth"]),
              flush=True)
    out["seconds"] = time.perf_counter() - t0
    if rank == 0:
        np.savez(os.path.join(job, "rank0.npz"), **saved)
    with open(os.path.join(job, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    # the samplers' graphs go first: NCCL does not destroy a communicator
    # while a graph that captured one of its collectives lives
    gc.collect()
    t1 = time.perf_counter()
    dist.destroy_process_group()
    print(f"# rank {rank}: the group torn down in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    return 0


def run_session(cmd: list, timeout: float, log_path: str, **kw):
    """``cmd`` in a session of its own with its output in ``log_path``:
    its return code, or None if it outlived ``timeout`` s, when the whole
    session (the process and whatever it started) is killed."""
    import signal

    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True, **kw)
        try:
            return proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            return None


def run_ranks(work: str, name: str, job: dict, world: int,
              timeout: float = MESH_TIMEOUT) -> tuple:
    """One world of ``world`` ranks running ``job`` (written to
    ``work``/``name``/job.json with the ranks' threads): ``chip_smoke.py
    --mesh-rank`` processes (a process with a CUDA context must not
    fork), each in a session of its own with its log in
    ``work``/``name``/rank<r>.log, RANK, LOCAL_RANK = r, WORLD_SIZE and a
    free MASTER_PORT on localhost set as torchrun sets them.  When one
    exits non-zero the others are killed at once (they would wait in a
    collective); all of them after ``timeout`` s, or MESH_TEARDOWN_S s
    after every rank wrote its record (the group's teardown); either
    fails the phase with the logs' ends.  Returns (each rank's record,
    rank 0's arrays, seconds)."""
    import signal
    import socket

    path = os.path.join(work, name)
    os.makedirs(path)
    with open(os.path.join(path, "job.json"), "w") as f:
        json.dump({**job, "threads": max(1, (os.cpu_count() or world)
                                         // world)}, f)
    with socket.socket() as so:
        so.bind(("localhost", 0))
        port = so.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port), "WORLD_SIZE": str(world),
           "PYTHONPATH": os.pathsep.join([root,
                                          os.environ.get("PYTHONPATH", "")])}
    records = [os.path.join(path, f"rank{r}.json") for r in range(world)]
    t0 = time.perf_counter()
    procs, logs, failed, written = [], [], None, None
    try:
        for r in range(world):
            logs.append(open(os.path.join(path, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-rank",
                 path], env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                stdout=logs[-1], stderr=subprocess.STDOUT,
                start_new_session=True))
        while failed is None:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            now = time.perf_counter()
            if written is None and all(map(os.path.exists, records)):
                written = now
            if bad:
                failed = f"rank {bad[0]} exited {codes[bad[0]]}"
            elif all(c == 0 for c in codes):
                break
            elif now - t0 > timeout:
                failed = f"the ranks outlived {timeout} s"
            elif written is not None and now - written > MESH_TEARDOWN_S:
                failed = (f"the ranks wrote their records but did not exit "
                          f"within {MESH_TEARDOWN_S} s (the group's teardown)")
            else:
                time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        for f in logs:
            f.close()
    if failed:
        tails = "\n".join(
            f"--- rank {r} ---\n"
            + open(os.path.join(path, f"rank{r}.log")).read()[-3000:]
            for r in range(world))
        check(False, f"{name}: {failed}:\n{tails}")
    recs = [json.load(open(x)) for x in records]
    return recs, dict(np.load(os.path.join(path, "rank0.npz"))), \
        time.perf_counter() - t0


def mesh_layout_checks(label: str, name: str, n_wn: int, recs: list,
                       saved: dict, refs: dict, smi: str, blocks=None,
                       block_ref=None) -> dict:
    """The checks and lines of one mesh: each rank's collectives, table
    bytes, kernels launched and kernels against their plain versions;
    the gathered spectra and bands against the unsharded forward; with
    ``blocks`` (the unsharded graphed blocks) each path's graphed block
    equal to the eager block on every rank and its accept decisions
    against the unsharded block's (on a world of one: its positions
    equal to them bit for bit); with the mesh's eager block, its accept
    decisions against ``block_ref``'s; the slowest rank's times."""
    tol = {"fused_eclipse": SPEC_RTOL[False], "fused_transit": OUT_RTOL,
           "fused_eclipse_folded": SPEC_RTOL[True],
           "fused_transit_folded": OUT_RTOL}
    per_rank = [r["layouts"][name] for r in recs]
    launches = [r["launches"] for r in per_rank]
    cases = list(per_rank[0]["cases"])
    for r, n in enumerate(launches):
        check(all(n[CASE_KERNEL[c]] >= 1 for c in cases if c in CASE_KERNEL),
              f"{label} {name} rank {r} did not launch every kernel of its "
              f"paths: {n}")
    res = {"launches": launches, "cases": {},
           "peak_gib": [r["peak_bytes"] / 2**30 for r in per_rank],
           "seconds": max(r["seconds"] for r in per_rank)}
    for case in cases:
        per = [r["cases"][case] for r in per_rank]
        for r, c in enumerate(per):
            check(c["collectives"] == 1,
                  f"{name} {case} rank {r}: {c['collectives']} collectives")
            check(c["on_mesh_device"] and c["device"] == recs[r]["device"],
                  f"{name} {case} rank {r}: table on {c['device']}")
            check(c["held_bytes"] * n_wn == c["padded_bytes"],
                  f"{name} {case} rank {r}: {c['held_bytes']} B x {n_wn} "
                  f"!= {c['padded_bytes']} B")
            if "kernel" in c:
                check(c["kernel_rel"] < tol[c["kernel"]]
                      and c["kernel_band"] < BAND_RTOL,
                      f"{name} {case} rank {r}: {c['kernel']} vs plain "
                      f"{c['kernel_rel']}, bands {c['kernel_band']}")
            if "bit_equal" in c:
                check(c["bit_equal"], f"{name} {case} rank {r}: the graphed "
                      "block differs from the eager block on the mesh")
        band, spec, valid = refs[case]
        n = spec.shape[1]
        g_spec = saved[f"{name}/{case}/spectrum"][:, :n]
        e_spec = float(np.max(np.abs(g_spec.astype(np.float64) - spec)
                              / np.maximum(np.abs(spec), 1e-300)))
        e_band = float(np.max(np.abs(saved[f"{name}/{case}/band"].astype(
            np.float64) - band) / np.maximum(np.abs(band), 1e-300)))
        check(np.array_equal(saved[f"{name}/{case}/valid"], valid),
              f"{name} {case}: valid differs")
        check(e_spec < MESH_SPEC_RTOL, f"{name} {case}: spectrum {e_spec}")
        check(e_band < BAND_RTOL, f"{name} {case}: band {e_band}")
        rc = {"spectrum_rel": e_spec, "band_rel": e_band,
              "forward_ms": max(c["forward_ms"] for c in per),
              "all_reduce_ms": max(c["all_reduce_ms"] for c in per),
              "held_bytes": per[0]["held_bytes"],
              "full_bytes": per[0]["full_bytes"],
              "padded_bytes": per[0]["padded_bytes"],
              "local_shape": [c["local_shape"] for c in per]}
        k = per[0].get("kernel")
        text = "no fused kernel"
        if k:
            rc.update({x: max(c[x] for c in per) for x in (
                "kernel_rel", "kernel_band", "kernel_abs", "kernel_ms",
                "plain_ms")}, kernel=k, bound=per[0]["bound"])
            text = (f"{k} on each shard vs plain {rc['kernel_rel']:.2e} "
                    f"(bands {rc['kernel_band']:.2e}), {rc['kernel_ms']:.3f}"
                    f" ms (plain {rc['plain_ms']:.3f}, bound "
                    f"{rc['bound']['bound_ms']:.3f}) on {per[0]['chains']} "
                    "chains")
        if blocks is not None and "bit_equal" in per[0]:
            ref = blocks[case]
            pb, pos0 = (saved[f"{name}/{case}/{x}"] for x in ("block", "pos0"))
            check(np.array_equal(pos0, ref["pos0"]),
                  f"{name} {case}: the block's initial positions differ from "
                  "the unsharded block's")
            flips = float(np.mean(np.any(
                accept_decisions(pb, pos0)
                != accept_decisions(ref["positions"], ref["pos0"]), axis=0)))
            check(flips <= MESH_FLIP_SHARE,
                  f"{name} {case}: {flips} of chains flipped")
            if len(recs) == 1:
                check(np.array_equal(pb, ref["positions"]),
                      f"{name} {case}: the graphed block of a world of one "
                      "differs from the unmeshed graphed block")
            rc.update(step_ms=max(c["step_ms"] for c in per),
                      step_rounds=[c["step_rounds"] for c in per],
                      single_step_ms=ref["step_ms"], flip_share=flips,
                      accept=per[0]["accept"])
            text += (f"; graphed step {rc['step_ms']:.3f} ms (unsharded "
                     f"{ref['step_ms']:.3f}), graphed block = eager block "
                     f"bit for bit on every rank"
                     f"{', = the unmeshed block' if len(recs) == 1 else ''}"
                     f", accept decisions differ from the unsharded block's "
                     f"on {flips:.4f} of chains (accept {rc['accept']:.3f})")
        res["cases"][case] = rc
        print(f"# {label} ({smi}): {name} {case}: gathered spectrum vs the "
              f"unsharded forward max rel {e_spec:.3e}, bands {e_band:.3e}; "
              f"{text}; one collective a forward; table "
              f"{rc['held_bytes'] / 2**20:.2f} MiB a rank = "
              f"{rc['padded_bytes'] / 2**20:.2f} / {n_wn}; the slowest rank: "
              f"forward {rc['forward_ms']:.3f} ms, all-reduce "
              f"{rc['all_reduce_ms']:.4f} ms; local spectra "
              f"{rc['local_shape']}")
    if f"{name}/block/positions" in saved:
        ref_pb, ref_pos0 = block_ref
        pb, pos0 = saved[f"{name}/block/positions"], saved[f"{name}/block/pos0"]
        check(np.array_equal(pos0, ref_pos0),
              f"{name}: the block's initial positions differ")
        d_ref, d = accept_decisions(ref_pb, ref_pos0), accept_decisions(pb,
                                                                         pos0)
        flips = float(np.mean(np.any(d != d_ref, axis=0)))
        res["block_flip_share"] = flips
        print(f"# {label}: {name}: {MESH_BLOCK_STEPS}-step snooker block of "
              f"{MESH_CHAINS} chains (eager) against the unsharded eager "
              f"block: accept decisions differ on {flips:.4f} of chains; "
              f"accept {d.mean():.3f} (unsharded {d_ref.mean():.3f})")
        check(flips <= MESH_FLIP_SHARE, f"{name}: {flips} of chains flipped")
    print(f"# {label}: {name}: launches counted in each rank's forwards "
          f"{launches}; peak GiB a rank "
          f"{[round(x, 2) for x in res['peak_gib']]}; {res['seconds']:.1f} s "
          f"(the slowest rank)")
    return res


def torchrun_dryrun(label: str, work: str, args: list, backend: str) -> float:
    """``python -m bart_tpu_torch.parallel.dryrun`` (with ``args``) under
    torchrun on four ranks, its log in ``work``/dryrun.log, within
    MESH_TIMEOUT s: its three checks must print OK, the first on a 2x2
    mesh of ``backend``.  Returns its seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    log = os.path.join(work, "dryrun.log")
    rc = run_session(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "4", "-m", "bart_tpu_torch.parallel.dryrun",
         "--timeout", str(MESH_TIMEOUT), *args], MESH_TIMEOUT, log,
        cwd=root, env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [root, os.environ.get("PYTHONPATH", "")])})
    text = open(log).read()
    lines = [x for x in text.splitlines() if ": OK" in x]
    for x in lines:
        print(f"# {label}: dryrun: {x}")
    check(rc == 0 and len(lines) == 3
          and f"dryrun_multichip(2x2, {backend}): OK" in lines[0],
          f"{label}: the dryrun failed ({rc}):\n{text[-4000:]}")
    return time.perf_counter() - t0


def phase10(fused, fm, fine, inp, smi: str) -> dict:
    """Phase 10: multi-device execution on gloo ranks that share the card
    (their timings measure overhead and correctness, not scaling).  The
    K = 1 table of phase 3 and the fine table go to files that each rank
    loads on the host; per mesh (1x2, 2x1, 2x2) the ranks shard eclipse
    and transit K = 1 and the folded pair (``fold_adapt=None``), run each
    512-chain forward with the kernels counted, hold each kernel on its
    shard against its plain version, and gather the spectra, which are
    held against the unsharded card forward at the same wavenumbers; 1x2
    also runs a 2-chain on-the-fly forward, 2x2 a 3-step snooker block
    against the unsharded eager block.  Then a world of one NCCL rank
    (the graphed eclipse block with its all-reduce captured, against the
    eager block on the mesh and the unmeshed graphed block, bit for bit)
    and the dryrun under torchrun on four gloo ranks."""
    import shutil

    import torch

    from bart_tpu_torch.demo import TRUTH
    from bart_tpu_torch.opacity.grid import save_grid

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "phase10")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    files = {"grid": os.path.join(work, "grid.npz"),
             "fine": os.path.join(work, "fine.npz")}
    save_grid(fm.opacity, files["grid"])
    save_grid(fine, files["fine"])
    n_out = fine.sigma.shape[-1] // FOLD_K
    dev = fm.device
    cases = list(CASE_KERNEL)

    # the unsharded references on the card
    refs = {}
    models = mesh_models(inp, fm.opacity, fine, dev, cases + ["onthefly"])
    for case, m in models.items():
        nch = MESH_OTF_CHAINS if case == "onthefly" else MESH_CHAINS
        refs[case] = [x.cpu().numpy() for x in m(torch.tensor(
            mesh_params(case, nch), dtype=torch.float32, device=dev))]
    block_ref = mesh_block(models["eclipse"])
    data = models["eclipse"](torch.tensor(
        TRUTH[None], dtype=torch.float32, device=dev))[0][0].double()
    data = data.cpu().numpy()
    blocks = {"eclipse": graphed_blocks(models["eclipse"], "eclipse", data,
                                        MESH_CHAINS)}
    del models
    torch.cuda.empty_cache()
    print(f"# phase 10: unsharded references on the card in "
          f"{time.perf_counter() - t_phase:.1f} s (folded on {n_out} output "
          f"bins x {FOLD_K})")

    base = {**files, "nchains": MESH_CHAINS, "device": "cuda:0"}
    out = {"layouts": {}}
    for name, (n_chain, n_wn) in MESH_LAYOUTS.items():
        job = {**base, "backend": "gloo", "layouts": {name: [n_chain, n_wn]},
               "cases": {name: cases + (["onthefly"] if name == "1x2"
                                        else [])}, "block": "2x2"}
        recs, saved, secs = run_ranks(work, name, job, n_chain * n_wn)
        out["layouts"][name] = mesh_layout_checks(
            "phase 10", name, n_wn, recs, saved, refs, smi,
            block_ref=block_ref)
        out["layouts"][name]["group_s"] = secs

    job = {**base, "backend": "nccl", "layouts": {"1x1": [1, 1]},
           "cases": {"1x1": ["eclipse"]}, "data": {"eclipse": data.tolist()}}
    recs, saved, secs = run_ranks(work, "nccl", job, 1)
    out["nccl"] = mesh_layout_checks("phase 10, a world of one NCCL rank",
                                     "1x1", 1, recs, saved, refs, smi,
                                     blocks=blocks)
    out["dryrun_s"] = torchrun_dryrun(
        "phase 10", work, ["--backend", "gloo", "--device", "cuda:0"], "gloo")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"# phase 10 ({smi}): dryrun under torchrun (4 gloo ranks on the "
          f"card) {out['dryrun_s']:.1f} s; phase 10 {out['seconds']:.1f} s")
    return out


def nccl4_devices() -> int:
    """Phase 13's guard: NCCL4_WORLD ranks, one a card.  Raises, naming
    the count it found, unless that many CUDA devices exist; there is no
    other layout to fall back to."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < NCCL4_WORLD:
        raise RuntimeError(
            f"chip_smoke --nccl4 needs {NCCL4_WORLD} CUDA devices, one rank "
            f"a card over NCCL; found {n}")
    return NCCL4_WORLD


def nccl4_job(files: dict, data: dict, truth_data) -> dict:
    """The job of phase 13's ranks: the tables' files, NCCL on
    cuda:LOCAL_RANK (no device named), every path on every mesh of
    NCCL4_LAYOUTS with each path's data (the single-card forward's bands
    at the truth) for its graphed blocks, the truth recovery on 2x2 with
    its noisy data."""
    return {**files, "backend": "nccl", "device": None,
            "layouts": NCCL4_LAYOUTS,
            "cases": {name: list(CASE_KERNEL) for name in NCCL4_LAYOUTS},
            "nchains": MESH_CHAINS,
            "data": {k: np.asarray(v).tolist() for k, v in data.items()},
            "truth": NCCL4_LAYOUTS["2x2"],
            "truth_data": [np.asarray(a).tolist() for a in truth_data]}


def tables_on_cards(lines, wn_grid, t_grid, pressure, budget_bytes: float,
                    devices: list):
    """``build_opacity_grid`` of the CH4 ``lines`` with its temperature
    rows shared out among ``devices``, one thread a device, all at once:
    each builds a run of rows after the grid's first (which it drops
    again: ``wing_cutoff`` reads the lowest temperature, so every part
    cuts the line wings as one build does); the parts are put together
    on devices[0]."""
    import concurrent.futures
    import contextlib

    import torch

    from bart_tpu_torch.device import resolve_device
    from bart_tpu_torch.opacity.grid import OpacityGrid, build_opacity_grid

    t_grid = np.asarray(t_grid, np.float64)
    first = resolve_device(devices[0])

    def part(dev, rows):
        skip = int(rows[0] != 0)
        cuda = torch.device(dev).type == "cuda"
        with torch.cuda.device(dev) if cuda else contextlib.nullcontext():
            g = build_opacity_grid(
                {"CH4": lines}, wn_grid, t_grid[np.r_[0, rows][1 - skip:]],
                pressure, budget_bytes=budget_bytes, device=dev,
                dtype=torch.float32)
            return g, g.sigma[:, skip:].to(first)

    with concurrent.futures.ThreadPoolExecutor(len(devices)) as ex:
        parts = list(ex.map(part, devices, np.array_split(
            np.arange(len(t_grid)), len(devices))))
    g = parts[0][0]
    return OpacityGrid(species=g.species, t_grid=t_grid, pressure=g.pressure,
                       wn_grid=g.wn_grid,
                       sigma=torch.cat([s for _, s in parts], dim=1))


def nccl4_phase(fused, smi: str) -> dict:
    """Phase 13 (``--nccl4``): the port's multi-device path across
    NCCL4_WORLD cards over NCCL, one rank a card.  The parent builds the
    K = 1 table and the fine table once, on the cards at once
    (``tables_on_cards``), saves them (the ranks load them on the host
    and keep their shards), and runs the single-card references on card
    0: each path's 512-chain forward, its bands at the truth and its
    graphed block (times included).  Then one world of ranks runs (a)
    the forwards and (b, c) the graphed blocks on every mesh
    (``mesh_layout``) and (d) the truth recovery on 2x2; last, (e) the
    dryrun under torchrun."""
    import shutil

    import torch

    from bart_tpu_torch.demo import TRUTH, TRUTH_TRANSIT, demo_inputs
    from bart_tpu_torch.device import resolve_device
    from bart_tpu_torch.opacity.grid import save_grid
    from bart_tpu_torch.utils.grids import folded_fine_grid

    world = nccl4_devices()
    t_phase = time.perf_counter()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    topo = [x for cmd in (["topo", "-m"], ["nvlink", "--status", "-i", "0"])
            for x in subprocess.run(
                ["nvidia-smi", *cmd], capture_output=True, text=True,
                timeout=60).stdout.rstrip().splitlines()[:24]]
    for x in cards:
        print(f"# phase 13: card {x}")
    for x in topo:
        print(f"# phase 13: topo: {x}")
    peer = [[int(i == j or torch.cuda.can_device_access_peer(i, j))
             for j in range(world)] for i in range(world)]
    print(f"# phase 13: peer access between the cards (CUDA): {peer}")
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "nccl4")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    files = {"grid": os.path.join(work, "grid.npz"),
             "fine": os.path.join(work, "fine.npz")}
    devices = [f"cuda:{i}" for i in range(world)]
    dev = resolve_device(devices[0])
    f32 = dict(device=dev, dtype=torch.float32)
    inp = demo_inputs()
    t0 = time.perf_counter()
    grid = tables_on_cards(inp.lines, inp.wn, inp.t_grid, inp.pressure, 8e9,
                           devices)
    t1 = time.perf_counter()
    fine = tables_on_cards(inp.lines, folded_fine_grid(inp.wn, FOLD_K),
                           inp.t_grid, inp.pressure, 24e9, devices)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    save_grid(grid, files["grid"])
    save_grid(fine, files["fine"])
    print(f"# phase 13: on the {world} cards at once: the K = 1 table "
          f"{tuple(grid.sigma.shape)} {t1 - t0:.1f} s, the fine table "
          f"{tuple(fine.sigma.shape)} {t2 - t1:.1f} s (peak GiB a card "
          f"{[round(torch.cuda.max_memory_allocated(d) / 2**30, 1) for d in devices]}"
          f"), saved for the ranks in {time.perf_counter() - t2:.1f} s")

    # the single-card references on card 0
    refs, data, blocks = {}, {}, {}
    models = mesh_models(inp, grid, fine, dev, list(CASE_KERNEL))
    for case, m in models.items():
        refs[case] = [x.cpu().numpy() for x in m(torch.tensor(
            mesh_params(case, MESH_CHAINS), **f32))]
        truth = TRUTH_TRANSIT if case.endswith("transit") else TRUTH
        data[case] = m(torch.tensor(truth[None], **f32))[0][0].double()
        data[case] = data[case].cpu().numpy()
        blocks[case] = graphed_blocks(m, case, data[case], MESH_CHAINS)
        check(blocks[case]["bit_equal"], f"{case}: the single-card graphed "
              "block differs from the eager block")
        print(f"# phase 13 ({smi}): {case}: single-card graphed "
              f"{MESH_CHAINS}-chain step on card 0 "
              f"{blocks[case]['step_ms']:.3f} ms (median of "
              f"{MESH_TIMED_BLOCKS} blocks of {BLOCK}: "
              f"{', '.join(f'{x:.3f}' for x in blocks[case]['step_rounds'])}"
              f"), accept {blocks[case]['accept']:.3f}")
    uncert = 0.03 * data["eclipse"]
    noisy = data["eclipse"] + np.random.default_rng(42).normal(
        0, 1, uncert.shape) * uncert
    del models, m, grid, fine
    gc.collect()
    torch.cuda.empty_cache()
    print(f"# phase 13: single-card references in "
          f"{time.perf_counter() - t2:.1f} s; {world} ranks start")

    recs, saved, secs = run_ranks(work, "ranks",
                                  nccl4_job(files, data, (noisy, uncert)),
                                  world, NCCL4_TIMEOUT)
    check(all(r["backend"] == "nccl" for r in recs)
          and [r["device"] for r in recs] == devices,
          f"phase 13: ranks {[(r['backend'], r['device']) for r in recs]}")
    out = {"ranks_s": secs, "layouts": {}}
    for name, (_, n_wn) in NCCL4_LAYOUTS.items():
        out["layouts"][name] = mesh_layout_checks(
            "phase 13", name, n_wn, recs, saved, refs, smi, blocks=blocks)
    tr = recs[0]["truth"]
    check(all(r["truth"]["mean"] == tr["mean"] for r in recs),
          "phase 13 (d): the ranks' posteriors differ")
    written = {r: sorted(os.listdir(os.path.join(work, "ranks", "truth",
                                                 f"rank{r}")))
               for r in range(world)}
    check(written[0] == ["MCMC.log", "checkpoint.npz", "checkpoint.npz.pos.dat",
                         "output.npy"]
          and not any(written[r] for r in range(1, world)),
          f"phase 13 (d): files written per rank {written}")
    out["truth"] = tr
    print(f"# phase 13 ({smi}): (d) truth recovery on 2x2: {MESH_CHAINS} "
          f"chains x {TRUTH_STEPS} graphed steps in {tr['seconds']:.2f} s "
          f"({tr['ms_step']:.3f} ms a step, host statistics and the "
          f"agreement checks included); pulls "
          f"{np.array2string(np.asarray(tr['pulls']), precision=3)}, "
          f"chi2/dof {tr['chi2_dof']:.3f}, split-Rhat "
          f"{np.array2string(np.asarray(tr['split_rhat']), precision=4)}, "
          f"accept {tr['accept']:.3f}; held on every rank; files only from "
          f"rank 0 ({written[0]}); the ranks {secs:.1f} s")
    out["dryrun_s"] = torchrun_dryrun("phase 13 (e)", work, [], "nccl")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"# phase 13 ({smi}): (e) dryrun under torchrun, {world} NCCL "
          f"ranks, one a card: {out['dryrun_s']:.1f} s; phase 13 "
          f"{out['seconds']:.1f} s")
    return out


def nccl4_kernels(layouts: dict) -> list:
    """The kernels line of phase 13: per kernel the contract's keys, the
    times of the 2x2 mesh's slowest rank on its shard (bound of a 2x2
    shard), ``launches`` the Python counts of every rank's forwards on
    every mesh, and each mesh's times beside them."""
    out = []
    for name in REPLACES:
        per = {lay: next(c for c in res["cases"].values()
                         if c["kernel"] == name)
               for lay, res in layouts.items()}
        main = per["2x2"]
        out.append(kernel_record(
            name, max(c["kernel_abs"] for c in per.values()),
            main["kernel_ms"], main["plain_ms"], main["bound"],
            sum(sum(n[name] for n in res["launches"])
                for res in layouts.values()),
            launches_by_mesh={lay: [n[name] for n in res["launches"]]
                              for lay, res in layouts.items()},
            ms_by_mesh={lay: c["kernel_ms"] for lay, c in per.items()},
            plain_ms_by_mesh={lay: c["plain_ms"] for lay, c in per.items()},
            bound_ms_by_mesh={lay: c["bound"]["bound_ms"]
                              for lay, c in per.items()}))
    return out


#: phase 14: the keys of bench.py's JSON line (bench.py:219-226), the
#: limit of one bench run (cold, with the folded pair: the K = 1 table
#: ~25 s and the fine table ~185 s of its 420 s budget) and the shapes
#: of the bench's two tables
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "spread_pct"}
BENCH_TIMEOUT = 900
BENCH_TABLES = {"K = 1": "(1, 27, 100, 2501)", "fine": "(1, 27, 100, 80032)"}


def bench_run(label: str, cache: str, fold: bool) -> dict:
    """One run of ``bench_torch.py`` on the card in a subprocess, its
    tables cached in ``cache``: the JSON line (checked: bench.py's keys,
    a finite rate above 0), its stderr, its wall seconds, the tables it
    built and loaded (shape -> list of "built"/"loaded") and the kernel
    launches it counted in Python."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "BENCH_CACHE_DIR": cache,
           "BENCH_FOLD": "1" if fold else "0"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(root,
                                                        "bench_torch.py")],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    wall = time.perf_counter() - t0
    for ln in proc.stdout.splitlines() + proc.stderr.splitlines():
        print(f"# {label}: {ln.removeprefix('# ')}")
    check(proc.returncode == 0, f"{label}: bench_torch.py exited "
          f"{proc.returncode}")
    line = json.loads(proc.stdout.splitlines()[0])
    check(set(line) == BENCH_KEYS, f"{label}: keys {sorted(line)}")
    check(np.isfinite(line["value"]) and line["value"] > 0,
          f"{label}: value {line['value']}")
    tables = {}
    for shape, how in re.findall(r"table (\([\d, ]+\)) (built|loaded)",
                                 proc.stderr):
        tables.setdefault(shape, []).append(how)
    counts = json.loads(re.search(r"kernel launches \(.*?\): (\{.*\})",
                                  proc.stderr).group(1))
    return dict(line=line, wall=wall, stderr=proc.stderr, tables=tables,
                counts=counts)


def phase14(fused, smi: str) -> dict:
    """Phase 14: the port's bench (without the folded pair) and the
    quickstart on the card.  The bench runs in a subprocess on a cold
    cache; the quickstart in this process, its kernel launches counted
    from 0."""
    import contextlib
    import importlib.util
    import io
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "phase14")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    run = bench_run("phase 14 bench", work, fold=False)
    for what in ("# transit: batch 512 in", "# roofline (eclipse",
                 "# roofline (transit"):
        check(what in run["stderr"], f"phase 14: no {what!r} line")
    check(run["tables"] == {BENCH_TABLES["K = 1"]: ["built", "loaded"]},
          f"phase 14: tables {run['tables']}")
    check(run["counts"]["fused_eclipse"] > 0
          and run["counts"]["fused_transit"] > 0,
          f"phase 14: the bench launched {run['counts']}")

    spec = importlib.util.spec_from_file_location(
        "quickstart", os.path.join(root, "examples", "torch_demo",
                                   "quickstart.py"))
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    for name in CASE_KERNEL.values():
        getattr(fused, name).launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = quickstart.main([])
    qs_wall = time.perf_counter() - t0
    qs_counts = {name: getattr(fused, name).launches
                 for name in CASE_KERNEL.values()}
    for ln in out.getvalue().splitlines():
        print(f"# phase 14 quickstart: {ln}")
    check(rc == 0 and out.getvalue().splitlines()[-1] == "quickstart OK",
          "phase 14: the quickstart did not end in 'quickstart OK'")
    check(qs_counts["fused_eclipse"] > 0,
          f"phase 14: the quickstart launched {qs_counts}")
    print(f"# phase 14 ({smi}): bench {run['line']['value']} evals/s "
          f"(spread {run['line']['spread_pct']}%), {run['wall']:.1f} s of "
          f"wall time with its start; quickstart {qs_wall:.1f} s; Python "
          f"launch counts: bench {run['counts']}, quickstart {qs_counts}")
    return dict(bench=run, quickstart=dict(wall=qs_wall, counts=qs_counts))


def bench_phase(smi: str) -> dict:
    """``--bench``: the whole bench (the folded pair included) twice in
    one call, on a cold cache and then on the warm one; the warm run must
    load both tables and build neither.  Then ``entry()``'s forward on a
    table built now and on the same problem's cache file, the bench's
    problem and entry's default one: equal bit for bit."""
    import logging
    import shutil

    import torch

    from bart_tpu_torch.entry import entry

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "bench_cache")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    runs = {how: bench_run(f"--bench {how}", work, fold=True)
            for how in ("cold", "warm")}
    k1, fine = BENCH_TABLES["K = 1"], BENCH_TABLES["fine"]
    check(runs["cold"]["tables"] == {k1: ["built", "loaded"],
                                     fine: ["built", "loaded"]},
          f"--bench cold: tables {runs['cold']['tables']}")
    check(runs["warm"]["tables"] == {k1: ["loaded", "loaded"],
                                     fine: ["loaded", "loaded"]},
          f"--bench warm: tables {runs['warm']['tables']}")
    for how, run in runs.items():
        for geom in ("eclipse", "transit"):
            check(f"# folded rtosamp=32 {geom}" in run["stderr"],
                  f"--bench {how}: no folded {geom} line")
        check(all(n > 0 for n in run["counts"].values()),
              f"--bench {how}: the bench launched {run['counts']}")

    class Records(logging.Handler):
        def __init__(self):
            super().__init__()
            self.msgs = []

        def emit(self, record):
            self.msgs.append(record.getMessage())

    rec = Records()
    logger = logging.getLogger("bart_tpu_torch.entry")
    logger.addHandler(rec)
    logger.setLevel(logging.INFO)
    os.environ["BENCH_CACHE_DIR"] = work
    out = {}
    try:
        for label, problem in (("bench's problem", dict(
                nlayer=100, nwave=2501, nlines=30000)), ("default", {})):
            rec.msgs.clear()
            fn_new, (p,) = entry(**problem)                 # built now
            bands_new = fn_new(p)
            fn_a, _ = entry(cache=True, **problem)
            bands_a = fn_a(p)
            fn_b, _ = entry(cache=True, **problem)
            bands_b = fn_b(p)
            print(f"# --bench: entry() on the {label}: "
                  + "; ".join(rec.msgs))
            check(torch.equal(bands_new, bands_a)
                  and torch.equal(bands_a, bands_b),
                  f"--bench: entry()'s bands on the {label} differ between "
                  "the built and the loaded table")
            check(len(rec.msgs) == 3 and " built" in rec.msgs[0]
                  and " loaded from " in rec.msgs[2],
                  f"--bench: entry()'s tables on the {label}: {rec.msgs}")
            out[label] = bands_new.cpu().numpy()
            del fn_new, fn_a, fn_b
            torch.cuda.empty_cache()
    finally:
        logger.removeHandler(rec)
        del os.environ["BENCH_CACHE_DIR"]
    print(f"# --bench ({smi}): cold {runs['cold']['line']['value']} / warm "
          f"{runs['warm']['line']['value']} evals/s; wall time with the "
          f"start: cold {runs['cold']['wall']:.1f} s, warm "
          f"{runs['warm']['wall']:.1f} s; entry()'s bands equal bit for bit "
          "on built and loaded tables")
    return dict(runs=runs, entry=out)


def main() -> int:
    import torch

    if "--nccl4" in sys.argv[1:]:
        nccl4_devices()              # raises without NCCL4_WORLD cards
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(sys.argv[2])
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

    if "--nccl4" in sys.argv[1:]:
        p13 = nccl4_phase(fused, smi.strip().splitlines()[0])
        print(f"# chip_smoke: {time.perf_counter() - t_start:.1f} s from the "
              "start to the records")
        print(json.dumps({"kernels": nccl4_kernels(p13["layouts"])}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

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
    if "--cli" in sys.argv[1:]:
        cli_phase(fused, smi.strip())
        return 0
    if "--bench" in sys.argv[1:]:
        bench_phase(smi.strip())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--cli-fold" in sys.argv[1:]:
        p11 = cli_fold_phase(fused, f32, smi.strip())
        print(json.dumps({"kernels": cli_fold_kernels(p11)}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--phase9" in sys.argv[1:]:
        fm = build_demo_model(inp_full, device=dev, dtype=torch.float32,
                              budget_bytes=8e9)
        fmt = build_demo_model(inp_full, device=dev, dtype=torch.float32,
                               grid=fm.opacity, solution="transit",
                               cia=True)
        phase9(fused, fm, fmt, inp_full, f32, smi.strip())
        return 0
    if "--phase10" in sys.argv[1:]:
        from bart_tpu_torch.opacity.grid import build_opacity_grid
        from bart_tpu_torch.utils.grids import folded_fine_grid

        fm = build_demo_model(inp_full, device=dev, dtype=torch.float32,
                              budget_bytes=8e9)
        t0 = time.perf_counter()
        fine = build_opacity_grid(
            {"CH4": inp_full.lines},
            folded_fine_grid(inp_full.wn[:MESH_FOLD_BINS], FOLD_K),
            inp_full.t_grid, inp_full.pressure, budget_bytes=24e9,
            device=dev, dtype=torch.float32)
        torch.cuda.synchronize()
        print(f"# phase 10: the fine table of the first {MESH_FOLD_BINS} "
              f"output bins {tuple(fine.sigma.shape)} built in "
              f"{time.perf_counter() - t0:.1f} s")
        phase10(fused, fm, fine, inp_full, smi.strip())
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
    t0 = time.perf_counter()
    res = run_mcmc(like, space, nchains=nchain, numit=nchain * 30,
                   burnin=10, block=10, seed=7, verbose=False)
    mcmc_s = time.perf_counter() - t0
    print(f"# phase 4: snooker {nchain} chains x {res.niter_total // nchain} "
          f"graphed steps in {mcmc_s:.2f} s (capture included): best chi2 "
          f"{-2 * res.best_loglike:.3f}, accept {res.accept_rate:.3f}")
    check(np.isfinite(res.best_loglike), "non-finite best loglike")
    check(res.accept_rate > 0.0, "no accepted proposal")
    estep = step_phase("eclipse", like, space, fm, params,
                       [fused.fused_eclipse])
    truth_phase(like, space, nchain)
    launches = fused.fused_eclipse.launches           # main path ends here
    print(f"# phase 4: eclipse path: {launches} kernel launches counted in "
          "Python (eager calls, warm-ups, captures)")
    check(launches > 0, "the eclipse path did not launch the kernel")

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
    fwd_ms, fwd_rounds = serialized_ms(forward, params, 20)
    print(f"# phase 5 ({smi.strip()}): per {nchain}-chain batch: kernel "
          f"{k_ms:.3f} ms, eclipse_plain {p_ms:.3f} ms, forward "
          f"{fwd_ms:.3f} ms (rounds {', '.join(f'{x:.2f}' for x in fwd_rounds)})")
    print_steps("eclipse", estep, smi.strip())
    tk_ms, tp_ms, (tf_ms, tf_rounds) = transit_times(fused, tpath)
    print(f"# phase 5 ({smi.strip()}): per {nchain}-chain batch: transit "
          f"kernel {tk_ms:.3f} ms, transit_plain {tp_ms:.3f} ms, transit "
          f"forward {tf_ms:.3f} ms (rounds "
          f"{', '.join(f'{x:.2f}' for x in tf_rounds)})")
    print_steps("transit", tpath["step"], smi.strip())

    ft_ = {name: folded_times(fused, path)
           for name, path in (("eclipse", fpath), ("transit", ftpath))}
    for name, path in (("eclipse", fpath), ("transit", ftpath)):
        x, tabk = ft_[name], path["parts"][0][0]
        print(f"# phase 5 ({smi.strip()}): per {nchain}-chain batch: folded "
              f"{name} kernel {x['k_ms']:.3f} ms on {tabk.W} bins x "
              f"{tabk.K}, its plain version {x['p_ms']:.3f} ms, the K = 1 "
              f"kernel on the smooth bins {x['k1_ms']:.3f} ms, forward "
              f"{x['fwd'][0]:.3f} ms (rounds "
              f"{', '.join(f'{v:.2f}' for v in x['fwd'][1])})")
        print_steps(f"folded {name}", path["step"], smi.strip())

    # --- phase 7: every PT family, diagnostics, wlike, leastsq, cf ----
    surface = model_surface_phase(fused, fm, tpath["fm"], inp_full, nchain,
                                  f32, smi.strip())

    # --- phase 8: the CLI on examples/torch_demo, at full width -------
    torch.cuda.empty_cache()
    cli = cli_phase(fused, smi.strip())

    # --- phase 9: on the fly, osamp through the CLI, host entry points -
    torch.cuda.empty_cache()
    p9 = phase9(fused, fm, tpath["fm"], inp_full, f32, smi.strip())

    # --- phase 10: the (chain, wn) mesh of ranks sharing the card ------
    torch.cuda.empty_cache()
    p10 = phase10(fused, fm, fpath["fm"].opacity, inp_full, smi.strip())

    # --- phase 14: the bench and the quickstart -------------------------
    torch.cuda.empty_cache()
    p14 = phase14(fused, smi.strip())

    # --- phase 6 (--trace): where the forwards' wall time goes ---------
    if "--trace" in sys.argv[1:]:
        trace_forwards({
            "eclipse": (forward, params),
            "transit": (tpath["forward"], tpath["params"]),
            "folded eclipse": (fpath["forward"], fpath["params"]),
            "folded transit": (ftpath["forward"], ftpath["params"]),
            "eclipse graphed()": (fm.graphed(), params),
            "transit graphed()": (tpath["fm"].graphed(), tpath["params"]),
            "folded eclipse graphed()": (fpath["fm"].graphed(),
                                         fpath["params"]),
            "folded transit graphed()": (ftpath["fm"].graphed(),
                                         ftpath["params"])},
            smi.strip())

    # --- the kernels' record: bounds from this run's shapes ------------
    bf16 = torch.bfloat16
    nmu = int(mu.shape[0])
    R, L, W = tab.shape
    e_bound = eclipse_bound(R, L, W, nchain, nmu, fm._powers, 1, False,
                            nbytes(tab, wrows, T_safe, drp, t["wn"]))
    ttab, twr, tG, twgt = tpath["rows"]
    t_bound = transit_bound(ttab.shape[0], L, W, nchain, 1, False,
                            nbytes(ttab, twr, tG, twgt))
    ftab = fpath["parts"][0][0]
    f_rows = fpath["rows"][True]
    f_bound = eclipse_bound(ftab.tab.shape[0], L, ftab.W * ftab.K, nchain,
                            int(f_rows[1].shape[0]), fpath["fm"]._powers,
                            ftab.K, ftab.tab.dtype == bf16,
                            nbytes(ftab.tab, *f_rows[:-1]))
    fttab = ftpath["parts"][0][0]
    ft_bound = transit_bound(fttab.tab.shape[0], L, fttab.W * fttab.K, nchain,
                             fttab.K, fttab.tab.dtype == bf16,
                             nbytes(fttab.tab, *ftpath["rows"][True]))

    def record(name, max_abs_err, ms, plain_ms, bnd):
        # launches: on the device, in the traces of the replayed blocks of
        # every main path that runs this kernel (the K = 1 kernels also
        # serve the smooth bins of the folded paths); python_launches: the
        # wrapper's own count over the same paths (eager calls, warm-ups,
        # captures: a replay is never counted there)
        by_path = {p: st["counts"][name] for p, st in steps.items()
                   if name in st["counts"]}
        return kernel_record(
            name, max_abs_err, ms, plain_ms, bnd, sum(by_path.values()),
            launches_by_path=by_path, python_launches=python[name],
            # phase 8: the wrapper's count in each CLI run
            cli_launches={r: run["counts"][name] for r, run in cli.items()
                          if name in run["counts"]},
            # phase 9: the wrapper's count over its runs
            phase9_launches=p9["counts"].get(name, 0),
            # phase 10: the wrapper's count in each rank of each mesh
            phase10_launches={lay: [n[name] for n in r["launches"]]
                              for lay, r in p10["layouts"].items()},
            # phase 14: the wrapper's count in the bench's process and in
            # the quickstart
            phase14_launches={
                "bench": p14["bench"]["counts"][name],
                "quickstart": p14["quickstart"]["counts"][name]})

    steps = {"eclipse": estep, "transit": tpath["step"],
             "folded_eclipse": fpath["step"],
             "folded_transit": ftpath["step"],
             "madhu_inv_wlike": surface["step"]}
    python = {"fused_eclipse": launches + fpath["launches"][1]
              + surface["launches"]["fused_eclipse"],
              "fused_transit": tpath["launches"] + ftpath["launches"][1]
              + surface["launches"]["fused_transit"],
              "fused_eclipse_folded": fpath["launches"][0],
              "fused_transit_folded": ftpath["launches"][0]}
    print(f"# chip_smoke ({smi.strip()}): {time.perf_counter() - t_start:.1f}"
          " s from the start to the records")
    print(json.dumps({"kernels": [
        record("fused_eclipse", max_abs, k_ms, p_ms, e_bound),
        record("fused_transit", t_max_abs, tk_ms, tp_ms, t_bound),
        record("fused_eclipse_folded", f_max_abs["eclipse"],
               ft_["eclipse"]["k_ms"], ft_["eclipse"]["p_ms"], f_bound),
        record("fused_transit_folded", f_max_abs["transit"],
               ft_["transit"]["k_ms"], ft_["transit"]["p_ms"], ft_bound),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
