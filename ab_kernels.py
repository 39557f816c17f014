#!/usr/bin/env python3
"""Hold the four kernels of this tree against those of another checkout
(the parent commit) on one CUDA card: the same outputs bit for bit, and
their times side by side.

Each version runs in a process of its own (its own sources, its own
build under its own ``bart_tpu_torch/build/``), in the order parent,
change, change, parent, on the same random rows (demo.random_rows and
random_transit_rows, seed 7; fine_structure inside the bins) at the
full-width shapes of chip_smoke.py's phase 2: 512 chains, 100 layers;
``fused_eclipse`` at R = 27 x 2,501 (raygrid 5 and expsum 8 nodes),
``fused_transit`` at R = 41 x 2,501, ``fused_eclipse_folded`` (R = 27)
and ``fused_transit_folded`` (R = 41) at 1,125 bins x K for K in 2, 4,
8, 16, 32 on bfloat16 tables (eclipse: expsum; at K = 32 also raygrid
and float32 tables), and at the K that straddle the tiles (3, 48, 128:
the cut bins' partial sums in their scratch) on both table types
(eclipse: bfloat16 expsum, float32 raygrid).  ``fused_eclipse_folded``
also at 1,064 bins x 32 (R = 27, both table types and quadratures) and
on its chunked rows: the flagship's R = 122 at 2,088 bins x 32 (expsum,
both table types), R = 512 at 1,125 bins x 32 (bfloat16 expsum), and
phase 17's eclipse shapes at 64 chains; and at eclipse_fold_f32.cfg's
R = 41 on a float32 table at 1,376 bins x 32 (both quadratures).  The
resident transit kernel also at its largest L = 112 with R = 226
(``fused_transit`` at 2,501 wavenumbers, ``fused_transit_folded`` at
1,125 bins x 32 on both table types), and on the transit shapes of
chip_smoke.py's phase 17 (a table past 2^31 elements, fine axes past
65,535 tiles; utils.slices' problems) at 64 chains.  Then the transit
kernels' streamed variant (L > 112) at 113 and 200 layers, at R = 41 and 226:
``fused_transit`` at 2,501 wavenumbers and ``fused_transit_folded`` at
1,125 bins x 32 on both table types and x 48 (a K the 32-point tiles
cut) on a bfloat16 table.  Every output is compared bit for bit across the
four runs; each case's ms (CUDA events, mean over the launches after a
warm-up) is printed per run, with the change's best against the
parent's best.

    python3 ab_kernels.py <parent root>     # e.g. build/parent
    python3 ab_kernels.py --only folded,rows <parent root>   # some of
                                            # SECTIONS
    git archive HEAD bart_tpu_torch | tar -x -C build/parent   # to make it

Exit code 1 when any output differs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
FOLD_KS = (2, 4, 8, 16, 32)
#: K that the folded kernels' 64- and 32-point tiles cut
STRADDLE_KS = (3, 48, 128)
#: the resident transit kernel at many rows and its largest L
RESIDENT_R, RESIDENT_L = 226, 112
#: the folded eclipse kernel at other rows: (R, W bins, table types,
#: quadratures), K = 32: its chunked rows, and eclipse_fold_f32.cfg's
#: R = 41
ROWS_ECLIPSE = ((122, 2088, ("bfloat16", "float32"), ("expsum",)),
                (512, 1125, ("bfloat16",), ("expsum",)),
                (41, 1376, ("float32",), ("expsum", "raygrid")))
#: chip_smoke.py's phase-17 eclipse and transit cases (wrapper, R, L, W,
#: K, table type), run at CEIL_CHAINS chains
CEIL_ECLIPSE = (("fused_eclipse_folded", 122, 100, 2088, 128, "bfloat16"),
                ("fused_eclipse_folded", 122, 100, 1376, 128, "float32"),
                ("fused_eclipse_folded", 8, 16, 33000, 128, "bfloat16"))
CEIL_TRANSIT = (("fused_transit", 122, 100, 176100, 1, "float32"),
                ("fused_transit_folded", 41, 100, 4200, 128, "bfloat16"),
                ("fused_transit", 8, 16, 2200000, 1, "float32"),
                ("fused_transit_folded", 8, 16, 17000, 128, "bfloat16"),
                ("fused_transit_folded", 8, 16, 45000, 48, "bfloat16"))
CEIL_CHAINS = 64
#: the case groups, in the order they run (``--only`` picks some)
SECTIONS = ("k1", "folded", "rows", "transit", "resident", "ceilings",
            "streamed")
#: the streamed transit cases: layers, rows, and the folded (K, table
#: type) pairs
STREAM_LS, STREAM_RS = (113, 200), (41, 226)
STREAM_FOLDS = ((32, "bfloat16"), (32, "float32"), (48, "bfloat16"))


def cases(root: str, out_npz: str, only: tuple = ()) -> None:
    """One version's run: its outputs into ``out_npz``, its ms as one JSON
    line on stdout; ``only``: the SECTIONS to run (all when empty)."""
    import numpy as np
    import torch

    sys.path.insert(0, root)
    from bart_tpu_torch.demo import (fine_structure, random_rows,
                                     random_transit_rows)
    from bart_tpu_torch.rt import fused
    from bart_tpu_torch.rt.eclipse import expsum_weights, raygrid_weights

    assert fused.__file__.startswith(os.path.abspath(root)), fused.__file__
    fused.build_kernels()
    f32 = dict(dtype=torch.float32, device="cuda")
    C, L, W1, WF = 512, 100, 2501, 1125
    quads = {"raygrid": (raygrid_weights([0.0, 20.0, 40.0, 60.0, 80.0]),
                         False),
             "expsum": (expsum_weights(8), True)}
    outs, ms = {}, {}

    def on(section):
        return not only or section in only

    def timed(name, fn, nrep):
        outs[name] = fn().cpu().numpy()
        fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(nrep):
            fn()
        stop.record()
        torch.cuda.synchronize()
        ms[name] = start.elapsed_time(stop) / nrep

    def q(quad):
        (mu, muw), powers = quads[quad]
        return torch.tensor(mu, **f32), torch.tensor(muw, **f32), powers

    def fine(tab, K, layers=L):
        R, _, W = tab.shape
        factor = torch.tensor(fine_structure(R, W, K), **f32)
        return (tab[..., None] * factor).reshape(R, layers, W * K)

    # K = 1
    if on("k1"):
        tab, wn, wrows, T, drp = (torch.tensor(a, **f32)
                                  for a in random_rows(27, L, W1, C, seed=7))
        rt = fused.rows_table(tab)
        for quad in quads:
            mu, muw, powers = q(quad)
            timed(f"fused_eclipse {quad}", lambda: fused.fused_eclipse(
                rt, wn, mu, muw, wrows, T, drp, powers), 20)
        tab, wrows, G, wgt = (torch.tensor(a, **f32) for a in
                              random_transit_rows(41, L, W1, C, seed=7)[:4])
        rt, Gp = fused.rows_table(tab), fused.prepare_slant(G)
        timed("fused_transit", lambda: fused.fused_transit(rt, wrows, Gp, wgt),
              20)
        del tab, rt
    # folded
    if on("folded"):
        tab, wn, wrows, T, drp = (torch.tensor(a, **f32)
                                  for a in random_rows(27, L, WF, C, seed=7))
        for K in FOLD_KS + STRADDLE_KS:
            fn = fine(tab, K)
            for tdt, quad in ([(torch.bfloat16, "expsum")]
                              + ([(torch.bfloat16, "raygrid"),
                                  (torch.float32, "expsum"),
                                  (torch.float32, "raygrid")]
                                 if K == 32 else [])
                              + ([(torch.float32, "raygrid")]
                                 if K in STRADDLE_KS else [])):
                ft = fused.folded_table(fn, K, tdt)
                mu, muw, powers = q(quad)
                timed(f"fused_eclipse_folded K={K} {str(tdt)[6:]} {quad}",
                      lambda: fused.fused_eclipse_folded(
                          ft, wn, mu, muw, wrows, T, drp, powers), 5)
            del fn, ft
        del tab, wn, wrows, T, drp
        tab, wn, wrows, T, drp = (torch.tensor(a, **f32)
                                  for a in random_rows(27, L, 1064, C, seed=7))
        fn = fine(tab, 32)
        for tdt in (torch.bfloat16, torch.float32):
            ft = fused.folded_table(fn, 32, tdt)
            for quad in quads:
                mu, muw, powers = q(quad)
                timed(f"fused_eclipse_folded W=1064 K=32 {str(tdt)[6:]} "
                      f"{quad}", lambda: fused.fused_eclipse_folded(
                          ft, wn, mu, muw, wrows, T, drp, powers), 5)
            del ft
        del fn, tab, wn, wrows, T, drp
    # the folded eclipse kernel at other rows
    if on("rows"):
        for R, W, tdts, rquads in ROWS_ECLIPSE:
            tab, wn, wrows, T, drp = (torch.tensor(a, **f32)
                                      for a in random_rows(R, L, W, C, seed=7))
            fn = fine(tab, 32)
            for tdt in tdts:
                ft = fused.folded_table(fn, 32, getattr(torch, tdt))
                for quad in rquads:
                    mu, muw, powers = q(quad)
                    timed(f"fused_eclipse_folded R={R} W={W} K=32 {tdt} "
                          f"{quad}",
                          lambda: fused.fused_eclipse_folded(
                              ft, wn, mu, muw, wrows, T, drp, powers), 3)
                del ft
            del fn, tab, wn, wrows, T, drp
            torch.cuda.empty_cache()
    if on("transit"):
        tab, wrows, G, wgt = (torch.tensor(a, **f32) for a in
                              random_transit_rows(41, L, WF, C, seed=7)[:4])
        Gp = fused.prepare_slant(G)
        for K in FOLD_KS + STRADDLE_KS:
            fn = fine(tab, K)
            for tdt in [torch.bfloat16] + ([torch.float32]
                                           if K == 32 or K in STRADDLE_KS
                                           else []):
                ft = fused.folded_table(fn, K, tdt)
                timed(f"fused_transit_folded K={K} {str(tdt)[6:]}",
                      lambda: fused.fused_transit_folded(ft, wrows, Gp, wgt),
                      5)
            del fn, ft
        del tab, wrows, G, Gp, wgt
    # the resident transit kernel at many rows and its largest L
    if on("resident"):
        tab, wrows, G, wgt = (torch.tensor(a, **f32) for a in
                              random_transit_rows(RESIDENT_R, RESIDENT_L, W1,
                                                  C, seed=7)[:4])
        rt, Gp = fused.rows_table(tab), fused.prepare_slant(G)
        timed(f"fused_transit L={RESIDENT_L} R={RESIDENT_R}",
              lambda: fused.fused_transit(rt, wrows, Gp, wgt), 5)
        del tab, wrows, G, Gp, wgt, rt
        tab, wrows, G, wgt = (torch.tensor(a, **f32) for a in
                              random_transit_rows(RESIDENT_R, RESIDENT_L, WF,
                                                  C, seed=7)[:4])
        Gp = fused.prepare_slant(G)
        for tdt in ("bfloat16", "float32"):
            fn = fine(tab, 32, RESIDENT_L)
            ft = fused.folded_table(fn, 32, getattr(torch, tdt))
            del fn
            timed(f"fused_transit_folded L={RESIDENT_L} R={RESIDENT_R} K=32 "
                  f"{tdt}",
                  lambda: fused.fused_transit_folded(ft, wrows, Gp, wgt),
                  3)
            del ft
        del tab, wrows, G, Gp, wgt
        torch.cuda.empty_cache()
    # phase 17's eclipse and transit shapes at 64 chains
    if on("ceilings"):
        from bart_tpu_torch.utils.slices import problem
        for i, (name, R, Lc, W, K, tdt) in enumerate(CEIL_ECLIPSE):
            pr = problem(name, R, Lc, W, K, CEIL_CHAINS, getattr(torch, tdt),
                         200 + i, torch.device("cuda"))
            timed(f"{name} ceiling R={R} L={Lc} W={W} K={K} {tdt}",
                  lambda: pr.launch(pr.tab, 0, W), 2)
            del pr
            torch.cuda.empty_cache()
        for i, (name, R, Lc, W, K, tdt) in enumerate(CEIL_TRANSIT):
            pr = problem(name, R, Lc, W, K, CEIL_CHAINS, getattr(torch, tdt),
                         100 + i, torch.device("cuda"))
            timed(f"{name} ceiling R={R} L={Lc} W={W} K={K} {tdt}",
                  lambda: pr.launch(pr.tab, 0, W), 2)
            del pr
            torch.cuda.empty_cache()
    # the streamed transit variant
    if on("streamed"):
        for Ls in STREAM_LS:
            for R in STREAM_RS:
                tab, wrows, G, wgt = (torch.tensor(a, **f32) for a in
                                      random_transit_rows(R, Ls, W1, C,
                                                          seed=7)[:4])
                rt, Gp = fused.rows_table(tab), fused.prepare_slant(G)
                timed(f"fused_transit L={Ls} R={R}",
                      lambda: fused.fused_transit(rt, wrows, Gp, wgt), 5)
                del tab, wrows, G, Gp, wgt, rt
                tab, wrows, G, wgt = (torch.tensor(a, **f32) for a in
                                      random_transit_rows(R, Ls, WF, C,
                                                          seed=7)[:4])
                Gp = fused.prepare_slant(G)
                for K, tdt in STREAM_FOLDS:
                    fn = fine(tab, K, Ls)
                    ft = fused.folded_table(fn, K, getattr(torch, tdt))
                    del fn
                    timed(f"fused_transit_folded L={Ls} R={R} K={K} {tdt}",
                          lambda: fused.fused_transit_folded(ft, wrows, Gp,
                                                             wgt), 3)
                    del ft
                del tab, wrows, G, Gp, wgt
                torch.cuda.empty_cache()
    np.savez(out_npz, **outs)
    print(json.dumps({"ms": ms, "card": torch.cuda.get_device_name(0)}))


def main() -> int:
    import numpy as np

    if sys.argv[1:2] == ["--one"]:
        cases(sys.argv[2], sys.argv[3], tuple(sys.argv[4:]))
        return 0
    args = sys.argv[1:]
    only = ()
    if "--only" in args:
        i = args.index("--only")
        only = tuple(args[i + 1].split(","))
        del args[i:i + 2]
        if not set(only) <= set(SECTIONS):
            print(f"ab_kernels: --only takes some of {','.join(SECTIONS)}",
                  file=sys.stderr)
            return 2
    parent = os.path.abspath(args[0])
    work = os.path.join(HERE, "build", "ab_kernels")
    os.makedirs(work, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    runs = []
    for i, (label, root) in enumerate((("parent", parent), ("change", HERE),
                                       ("change", HERE),
                                       ("parent", parent))):
        npz = os.path.join(work, f"run{i}_{label}.npz")
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root, npz, *only],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 2
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append((label, rec["ms"], dict(np.load(npz))))
        print(f"# ab_kernels: run {i} ({label}) done", flush=True)
    names = list(runs[0][1])
    same = True
    for name in names:
        outs = [r[2][name] for r in runs]
        eq = all(np.array_equal(outs[0], o) for o in outs[1:])
        same &= eq
        ms = [r[1][name] for r in runs]
        best_p, best_c = min(ms[0], ms[3]), min(ms[1], ms[2])
        bits = "equal" if eq else "DIFFER"
        print(f"# ab_kernels ({smi}): {name}: bits {bits}; ms parent "
              f"{ms[0]:.3f}, change {ms[1]:.3f}, change {ms[2]:.3f}, parent "
              f"{ms[3]:.3f}; change/parent (best) {best_c / best_p:.4f}")
    print(json.dumps({"same_bits": same, "cases": len(names),
                      "ms": {n: [r[1][n] for r in runs] for n in names}}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
