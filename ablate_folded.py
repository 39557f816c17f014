#!/usr/bin/env python3
"""Time ablated builds of the tensor-core kernels on one CUDA card, to
separate what binds them: the global -> shared copies, the tensor-core
products, the exponentials, the grid order.

Each variant is built with ``-DBART_ABLATE=<bits>`` (the bits are listed
in the kernels' sources) in a process of its own, and timed on
chip_smoke.py's phase-2 random rows at the full-width shapes (512 chains,
100 layers, or ``--layers N``: past 112 the transit kernels run their
streamed variant, whose ablation bits mean what the resident's do).
Without ``--k1`` the two folded kernels (1,125 fine bins x 32, bfloat16
tables, or float32 ones with ``--f32``; eclipse R = 27 with
the expsum quadrature, transit R = 41); with ``--k1`` the two K = 1
kernels (2,501 wavenumbers, float32 tables; eclipse R = 27 in both
quadratures, transit R = 41).  ``--rows N --bins M`` set the folded
eclipse kernel's rows and fine bins (R = 27 and 1,125 bins by default;
the flagship's shape is ``--rows 122 --bins 2088``).  An ablated
kernel's result is wrong (all bits but the K = 1 eclipse's 16 and the
transit's 8); its time is read, and its error against the plain version
printed.  The resident transit kernel (L <= 112) takes bits 1 (no
copies: 16-byte copies keep its cluster's hand-offs), 2, 4, 16 and their
sums (22: copies and barriers only, 23: barriers only); the folded
eclipse kernel takes 1 (no copies: the TMA's thread arrives without
bytes), 2, 4, 8, 16 (no recurrence, quadrature and flux: the Planck
means, the layer steps and the barriers stay) and the same sums (22:
copies, Planck means and barriers only, 23: Planck means and barriers
only).  ``--eclipse`` builds and times the folded eclipse kernel alone.
``--define NAME=VALUE`` (repeatable) adds ``-DNAME=VALUE`` to every
variant's build: a source variant that reads a macro, timed against the
source as it stands.

    python3 ablate_folded.py                 # the folded default variants
    python3 ablate_folded.py 0 1 6 8         # these bit sets
    python3 ablate_folded.py --f32 0 8       # on float32 fine tables
    python3 ablate_folded.py --eclipse --rows 122 --bins 2088 0 1 2 22 23
                             # the folded eclipse alone, at the flagship's
                             # shape
    python3 ablate_folded.py --eclipse --define NAME=1 0   # a variant
                                             # built with -DNAME=1
    python3 ablate_folded.py --k1            # the K = 1 default variants
    python3 ablate_folded.py --k1 0 16       # these bit sets
    python3 ablate_folded.py --k1 --layers 113 0 1 22   # the streamed
                                                          # variant
    python3 ablate_folded.py --root build/parent --k1 --layers 113 0 1
                             # the same bits on another checkout's kernels
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

VARIANTS = {0: "as built", 1: "no global -> shared copies",
            2: "no fill products", 4: "no exponentials",
            16: "transit: no slant products; eclipse: no recurrence, "
            "quadrature and flux", 22: "copies and barriers only (eclipse: "
            "and the Planck means)", 23: "barriers only (eclipse: and the "
            "Planck means)", 8: "eclipse, float32 table: "
            "the weights unsplit; transit (the streamed variant only): its "
            "items tile-major"}
# fused_eclipse.cu and fused_transit_mma.cuh give bits 8 and 16 other
# meanings: one label names both
VARIANTS_K1 = {0: "as built", 1: "no global -> shared copies",
               2: "no fill products",
               4: "no exponentials (eclipse: of the quadrature)",
               8: "eclipse: no Planck exponential and division; transit "
               "(the streamed variant only): its items tile-major",
               12: "eclipse: no exponentials and no Planck",
               16: "eclipse: __expf in the quadrature; transit: no slant "
               "products",
               14: "eclipse: copies, barriers and the recurrence only",
               15: "eclipse: barriers and the recurrence only",
               22: "transit: copies and barriers only",
               23: "transit: barriers only"}


def rel_err(a, b) -> float:
    return float(((a.double() - b.double()).abs()
                  / b.double().abs().clamp_min(1e-300)).max())


def one(bits: int, k1: bool, f32_table: bool = False, L: int = 100,
        root: str = HERE, rows: int = 27, bins: int = 1125,
        eclipse_only: bool = False, defines: tuple = ()) -> None:
    import torch

    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(root))
    from bart_tpu_torch.demo import (fine_structure, random_rows,
                                     random_transit_rows)
    from bart_tpu_torch.rt import fused
    from bart_tpu_torch.rt.eclipse import expsum_weights, raygrid_weights
    from chip_smoke import cuda_ms

    # one more flag keys another library in build/: set before any build
    fused._NVCC_FLAGS += (f"-DBART_ABLATE={bits}",
                          *(f"-D{d}" for d in defines))
    f32 = dict(dtype=torch.float32, device="cuda")
    R, Rt, C, K = rows, 41, 512, 32
    W = 2501 if k1 else bins
    names = (("fused_eclipse", "fused_transit") if k1
             else ("fused_eclipse_folded", "fused_transit_folded"))
    assert fused.__file__.startswith(os.path.abspath(root)), fused.__file__
    fused.build_kernels(names[:1] if eclipse_only else names)
    label = (VARIANTS_K1 if k1 else VARIANTS).get(bits, "custom")
    if defines:
        label += ", " + " ".join(f"-D{d}" for d in defines)

    def fine_table(tab):
        factor = torch.tensor(fine_structure(tab.shape[0], W, K), **f32)
        fine = (tab[..., None] * factor).reshape(*tab.shape[:2], W * K)
        return fused.folded_table(
            fine, K, torch.float32 if f32_table else torch.bfloat16)

    tab, wn, wrows, T, drp = (torch.tensor(a, **f32)
                              for a in random_rows(R, L, W, C, seed=7))
    quads = {"expsum": (expsum_weights(8), True)}
    if k1:
        quads["raygrid"] = (raygrid_weights([0.0, 20.0, 40.0, 60.0, 80.0]),
                            False)
        etab, ptab = fused.rows_table(tab), tab
        kernel, plain = fused.fused_eclipse, fused.eclipse_plain
    else:
        etab = ptab = fine_table(tab)
        kernel, plain = fused.fused_eclipse_folded, fused.eclipse_folded_plain
    e_out = []
    for quad, ((mu, muw), powers) in quads.items():
        rest = [wn, torch.tensor(mu, **f32), torch.tensor(muw, **f32), wrows,
                T, drp, powers]
        ms = cuda_ms(lambda: kernel(etab, *rest), 5)
        err = rel_err(kernel(etab, *rest), plain(ptab, *rest))
        e_out.append(f"{quad} {ms:.3f} ms (rel err {err:.2e})")
    del tab, etab, ptab
    table = "" if k1 else ("float32 " if f32_table else "bfloat16 ")
    if eclipse_only:
        print(f"# ablate {bits:2d} ({label}), L = {L}, eclipse R = {R} x "
              f"{W} bins: {table}{names[0]} {', '.join(e_out)}", flush=True)
        return
    tab, wrows, G, wgt = (torch.tensor(a, **f32) for a in
                          random_transit_rows(Rt, L, W, C, seed=7)[:4])
    Gp = fused.prepare_slant(G)
    if k1:
        ttab, ptab = fused.rows_table(tab), tab
        kernel, plain = fused.fused_transit, fused.transit_plain
    else:
        ttab = ptab = fine_table(tab)
        kernel, plain = fused.fused_transit_folded, fused.transit_folded_plain
    t_ms = cuda_ms(lambda: kernel(ttab, wrows, Gp, wgt), 5)
    t_err = rel_err(kernel(ttab, wrows, Gp, wgt), plain(ptab, wrows, G, wgt))
    print(f"# ablate {bits:2d} ({label}), L = {L}, eclipse R = {R} x {W} "
          f"bins: {table}{names[0]} "
          f"{', '.join(e_out)}; "
          f"{names[1]} {t_ms:.3f} ms (rel err {t_err:.2e})", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_folded: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if len(args) == 9 and args[0] == "--one":
        one(int(args[2]), args[1] == "k1", args[1] == "f32", int(args[3]),
            args[4], int(args[5]), int(args[6]), args[7] == "eclipse",
            tuple(d for d in args[8].split(",") if d))
        return 0
    k1, f32_table = "--k1" in args, "--f32" in args
    eclipse_only = "--eclipse" in args
    defines = []
    while "--define" in args:
        i = args.index("--define")
        defines.append(args[i + 1])
        del args[i:i + 2]
    opts = {"--layers": "100", "--root": HERE, "--rows": "27",
            "--bins": "1125"}
    for key in opts:
        if key in args:
            i = args.index(key)
            opts[key] = args[i + 1]
            del args[i:i + 2]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    print(smi.strip().splitlines()[0], flush=True)
    rc = 0
    for bits in ([a for a in args if a not in ("--k1", "--f32", "--eclipse")]
                 or [str(b) for b in (VARIANTS_K1 if k1 else VARIANTS)]):
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", "k1" if k1 else
                              "f32" if f32_table else "folded",
                              str(int(bits)), str(int(opts["--layers"])),
                              opts["--root"], str(int(opts["--rows"])),
                              str(int(opts["--bins"])),
                              "eclipse" if eclipse_only else "both",
                              ",".join(defines)]
                             ).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
