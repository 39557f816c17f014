"""The port's benchmark: likelihood evaluations per second per card
(counterpart of the JAX package's ``bench.py``).

Times the demo-CH4-class forward model (100 layers, 2501 output
wavenumbers, 30,000 lines, the opacity table and the fused eclipse
kernel) over a 512-chain ensemble, graphed: the MCMC hot loop's
likelihood.  The primary metric (eclipse) is measured and its JSON line
printed FIRST, with ``bench.py``'s keys:

  {"metric": "likelihood_evals_per_s", "value": N, "unit": "evals/s/chip",
   "vs_baseline": N/10, "spread_pct": S}

``vs_baseline`` is against the reference's optimistic 10 evals/s on one
CPU core (BASELINE.md).  The card's name and power limit go to stderr
before it; every other measurement is an extra on stderr after it: the
transit geometry on the same cached table and, on the card only, the
roofline of both batches against the fused kernels' data-sheet bounds
(utils/roofline.py) and the folded rtosamp = 32 pair (bfloat16 fine
rows, adaptive split 0.02; eclipse with expsum, transit with raygrid) on
one cached fine table.  ``BENCH_FOLD=0`` leaves the pair out.  Each
extra is guarded by the deadline ``BENCH_BUDGET_S`` (default 420 s from
the start): a skip is printed and is not a failure.  An extra that
raises is printed with its traceback, the others still run, and the
exit code is 1.

    python -m bart_tpu_torch.bench              # on the card
    python -m bart_tpu_torch.bench --device cpu # 3,000 lines, 32 chains
    python -m bart_tpu_torch.bench --device cpu --tiny

The tables are cached by entry.build_problem (``BENCH_CACHE_DIR``,
default the checkout's root), so a second run loads what the first
built.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

__all__ = ["time_batched", "main"]

#: the problem's size and the timing's chains and calls a round, on the
#: card, on the CPU (bench.py's CPU fallback) and with ``--tiny``
SIZES = {"cuda": dict(nlayer=100, nwave=2501, nlines=30000, nchain=512,
                      nrep=20),
         "cpu": dict(nlayer=100, nwave=2501, nlines=3000, nchain=32, nrep=3),
         "tiny": dict(nlayer=8, nwave=64, nlines=64, nchain=4, nrep=2)}
#: BASELINE.md: the reference's optimistic CPU rate, evals/s
BASELINE_EVALS_PER_S = 10.0
#: the parameters' centre and the scatter of the chains around it
BASE = np.array([-2.0, 0.0, 1.0, 0.0, 0.98, -0.5])
SPREAD = 0.005
#: seconds left below which the primary takes one timing round, the
#: extras are skipped and a folded extra is skipped
ONE_ROUND_S, EXTRAS_MIN_S, FOLD_MIN_S = 60.0, 45.0, 100.0
#: the folded pair: rtosamp, adaptive split and (geometry, quadrature)
FOLD_K, FOLD_ADAPT = 32, 0.02
FOLD_PATHS = (("eclipse", "expsum"), ("transit", "raygrid"))
#: the fused kernels' wrappers (rt/fused.py), whose launches are counted
KERNELS = ("fused_eclipse", "fused_transit", "fused_eclipse_folded",
           "fused_transit_folded")


def time_batched(fb, params: torch.Tensor, nrep: int, rounds: int = 3):
    """Serialized batch timing (bench.py's): each call's input depends on
    the last call's output and each round ends in a host read, so a call
    costs what an MCMC step pays for it (step t + 1 waits for step t).
    ``fb(params)`` returns (bandflux, spectrum, valid).  The first call is
    a warm-up whose flux must be finite and whose evaluations must all be
    valid, else RuntimeError.  Returns (best seconds a call, the median
    round's excess over the best in % of the best, each round's seconds
    a call)."""
    out = fb(params)
    if not bool(torch.isfinite(out[0]).all()):
        raise RuntimeError("time_batched: non-finite flux")
    if not bool(out[2].all()):
        raise RuntimeError("time_batched: invalid forward evaluations")
    times = []
    for _ in range(rounds):
        p = params
        t0 = time.perf_counter()
        for _ in range(nrep):
            out = fb(p)
            p = params + 0.0 * out[0].sum()          # serialize the chain
        if not math.isfinite(float(out[0].sum())):   # host read = barrier
            raise RuntimeError("time_batched: non-finite flux")
        times.append((time.perf_counter() - t0) / nrep)
    best = min(times)
    # median, not max: one stalled round should not set the spread
    spread_pct = (100.0 * (float(np.median(times)) - best) / best
                  if len(times) > 1 else 0.0)
    return best, spread_pct, times


def _say(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def _rounds(times) -> str:
    return ", ".join(f"{1e3 * t:.3f}" for t in times)


def _with_radius(params: torch.Tensor, r0_km: float) -> torch.Tensor:
    """Transit parameters: the radius [km] inserted at index 5."""
    r0 = torch.full_like(params[:, :1], r0_km)
    return torch.cat([params[:, :5], r0, params[:, 5:]], dim=1)


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _fb(fm, on_card: bool):
    return fm.graphed() if on_card else fm.batched()


def _transit(ctx: dict) -> None:
    from bart_tpu_torch.entry import build_problem

    s = ctx["size"]
    fmt = build_problem(s["nlayer"], s["nwave"], s["nlines"], cache=True,
                        solution="transit", device=ctx["device"])
    tparams = _with_radius(ctx["params"], fmt.r0_km)
    dt, spread, times = time_batched(_fb(fmt, ctx["on_card"]), tparams,
                                     s["nrep"], ctx["rounds"](90.0))
    ctx["transit"] = (fmt, dt)
    _say(f"transit: batch {s['nchain']} in {1e3 * dt:.3f} ms; "
         f"{s['nchain'] / dt:.1f} evals/s (spread {spread:.1f}%; rounds "
         f"[ms]: {_rounds(times)})")


def _roofline(ctx: dict) -> None:
    """The fused kernels' bounds (utils/roofline.py) for this batch's
    shapes, and the share of each bound that the measured batch
    reaches."""
    from bart_tpu_torch.utils.roofline import (PEAKS, eclipse_bound,
                                               transit_bound)

    fm, dt, C = ctx["fm"], ctx["dt"], ctx["size"]["nchain"]
    R, L, W = fm.tables["tab"].plain().shape
    # inputs as the kernel reads them, float32: the table, the row
    # weights [C, L, R], T and the layer thicknesses [C, L], the wn grid
    e = eclipse_bound(R, L, W, C, int(fm.mu.shape[0]), fm._powers, 1, False,
                      4 * (R * L * W + C * L * R + 2 * C * L + W))
    lines = [("eclipse", "fused_eclipse", e, dt)]
    if "transit" in ctx:
        fmt, dt_t = ctx["transit"]
        Rt = fmt.tables["tab"].plain().shape[0]
        # the table, the row weights, the slant matrix [C, L, L], the
        # annulus weights [C, L]
        t = transit_bound(Rt, L, W, C, 1, False,
                          4 * (Rt * L * W + C * L * Rt + C * L * L + C * L))
        lines.append(("transit", "fused_transit", t, dt_t))
    for geom, kernel, b, dt_ in lines:
        _say(f"roofline ({geom}, per {C}-chain batch; {PEAKS} peaks, on "
             f"{ctx['card']}): {kernel}'s bound {b['bound_ms']:.4f} ms "
             f"({b['bound_term']}); the batch's {1e3 * dt_:.3f} ms reaches "
             f"{100.0 * b['bound_ms'] / (1e3 * dt_):.2f}% of it; "
             f"{C / dt_ * W * L:.4e} wn-gridpoints/s")


def _folded(ctx: dict) -> None:
    from bart_tpu_torch.entry import build_problem

    s = ctx["size"]
    for geom, quad in FOLD_PATHS:
        if ctx["left"]() < FOLD_MIN_S:
            _say(f"folded {geom} skipped: {ctx['left']():.0f} s left in "
                 "the budget")
            return
        fmf = build_problem(s["nlayer"], s["nwave"], s["nlines"], cache=True,
                            fold=FOLD_K, fold_adapt=FOLD_ADAPT,
                            quadrature=quad, solution=geom, fold_bf16=True,
                            device=ctx["device"])
        frac = (len(fmf._idx_fine) / s["nwave"]
                if fmf._idx_fine is not None else 1.0)
        pf = (ctx["params"] if geom == "eclipse"
              else _with_radius(ctx["params"], fmf.r0_km))
        dt, spread, times = time_batched(_fb(fmf, ctx["on_card"]), pf,
                                         s["nrep"], ctx["rounds"](120.0))
        _say(f"folded rtosamp={FOLD_K} {geom} adapt={FOLD_ADAPT} {quad} "
             f"(fine frac {frac:.4f}): batch {s['nchain']} in "
             f"{1e3 * dt:.3f} ms; {s['nchain'] / dt:.1f} evals/s (spread "
             f"{spread:.1f}%; rounds [ms]: {_rounds(times)})")
        del fmf
        if ctx["on_card"]:
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    from bart_tpu_torch.device import resolve_device
    from bart_tpu_torch.entry import build_problem
    from bart_tpu_torch.rt import fused

    ap = argparse.ArgumentParser(prog="python -m bart_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--tiny", action="store_true",
                    help="a few layers, points, lines and chains")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    deadline = t_start + float(os.environ.get("BENCH_BUDGET_S", "420"))

    def left() -> float:
        return deadline - time.perf_counter()

    def rounds(need: float) -> int:
        """Timing rounds: 3, or 1 with less than ``need`` s left."""
        return 3 if left() > need else 1

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    logging.basicConfig(stream=sys.stderr, level=logging.INFO,
                        format="# %(name)s: %(message)s")
    card = _card() if on_card else f"{device} (no card)"
    if on_card:
        print(card, file=sys.stderr, flush=True)
    size = SIZES["tiny" if args.tiny else device.type]

    t0 = time.perf_counter()
    fm = build_problem(size["nlayer"], size["nwave"], size["nlines"],
                       cache=True, device=device)
    _say(f"eclipse model on {card} ready in {time.perf_counter() - t0:.1f} "
         "s")

    rng = np.random.default_rng(0)
    C = size["nchain"]
    params = torch.tensor(np.tile(BASE, (C, 1))
                          + rng.normal(0, SPREAD, (C, 6)),
                          dtype=fm.dtype, device=device)
    t0 = time.perf_counter()
    dt, spread, times = time_batched(_fb(fm, on_card), params, size["nrep"],
                                     rounds(ONE_ROUND_S))
    _say(f"eclipse: {'capture' if on_card else 'first call'} and warm-up "
         f"{time.perf_counter() - t0 - sum(times) * size['nrep']:.1f} s; "
         f"batch {C} in {1e3 * dt:.3f} ms ({len(times)} timing rounds "
         f"[ms]: {_rounds(times)})")
    evals_per_s = C / dt
    # PRIMARY METRIC: printed before any extra, so that no extra can
    # blank it
    print(json.dumps({
        "metric": "likelihood_evals_per_s",
        "value": round(evals_per_s, 1),
        "unit": "evals/s/chip",
        "vs_baseline": round(evals_per_s / BASELINE_EVALS_PER_S, 1),
        "spread_pct": round(spread, 1),
    }), flush=True)

    ctx = dict(size=size, device=device, on_card=on_card, card=card, fm=fm,
               dt=dt, params=params, left=left, rounds=rounds)
    extras = [("transit", _transit)]
    if on_card:
        extras.append(("roofline", _roofline))
        if os.environ.get("BENCH_FOLD", "1") != "0":
            extras.append(("folded", _folded))
    else:
        _say("roofline and folded pair: not measured (no card)")
    failed = []
    for name, fn in extras:
        if left() < EXTRAS_MIN_S:
            _say(f"extra {name} skipped: {left():.0f} s left in the budget")
            continue
        try:
            fn(ctx)
        except Exception:          # reported, and the exit code says so
            failed.append(name)
            _say(f"extra {name} failed:\n{traceback.format_exc()}")
    # the wrappers count eager calls and graph captures, never a replay
    _say("kernel launches (eager calls and captures): " + json.dumps(
        {k: getattr(fused, k).launches for k in KERNELS}))
    _say(f"bench: {time.perf_counter() - t_start:.1f} s"
         + (f"; failed extras: {', '.join(failed)}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
