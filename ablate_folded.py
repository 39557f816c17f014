#!/usr/bin/env python3
"""Time ablated builds of the tensor-core kernels on one CUDA card, to
separate what binds them: the global -> shared copies, the tensor-core
products, the exponentials, the grid order.

Each variant is built with ``-DBART_ABLATE=<bits>`` (the bits are listed
in the kernels' sources) in a process of its own, and timed on
chip_smoke.py's phase-2 random rows at the full-width shapes (512 chains,
100 layers).  Without ``--k1`` the two folded kernels (1,125 fine bins x
32, bfloat16 tables, or float32 ones with ``--f32``; eclipse R = 27 with
the expsum quadrature, transit R = 41); with ``--k1`` the two K = 1
kernels (2,501 wavenumbers, float32 tables; eclipse R = 27 in both
quadratures, transit R = 41).  An ablated
kernel's result is wrong (all bits but the eclipse's 16 and the transit's
8); its time is read, and its error against the plain version printed.

    python3 ablate_folded.py                 # the folded default variants
    python3 ablate_folded.py 0 1 6 8         # these bit sets
    python3 ablate_folded.py --f32 0 8       # on float32 fine tables
    python3 ablate_folded.py --k1            # the K = 1 default variants
    python3 ablate_folded.py --k1 0 16       # these bit sets
"""

from __future__ import annotations

import os
import subprocess
import sys

VARIANTS = {0: "as built", 1: "no global -> shared copies",
            2: "no fill products", 4: "no exponentials",
            16: "no slant products (transit)", 22: "copies and barriers only",
            23: "barriers only", 8: "eclipse, float32 table: the weights "
            "unsplit; transit: fine tiles on the grid's fast axis"}
# fused_eclipse.cu and fused_transit_mma.cuh give bits 8 and 16 other
# meanings: one label names both
VARIANTS_K1 = {0: "as built", 1: "no global -> shared copies",
               2: "no fill products",
               4: "no exponentials (eclipse: of the quadrature)",
               8: "eclipse: no Planck exponential and division; transit: "
               "wavenumber tiles on the grid's fast axis",
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


def one(bits: int, k1: bool, f32_table: bool = False) -> None:
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bart_tpu_torch.demo import (fine_structure, random_rows,
                                     random_transit_rows)
    from bart_tpu_torch.rt import fused
    from bart_tpu_torch.rt.eclipse import expsum_weights, raygrid_weights
    from chip_smoke import cuda_ms

    # one more flag keys another library in build/: set before any build
    fused._NVCC_FLAGS += (f"-DBART_ABLATE={bits}",)
    f32 = dict(dtype=torch.float32, device="cuda")
    R, Rt, L, C, K = 27, 41, 100, 512, 32
    W = 2501 if k1 else 1125
    names = (("fused_eclipse", "fused_transit") if k1
             else ("fused_eclipse_folded", "fused_transit_folded"))
    fused.build_kernels(names)
    label = (VARIANTS_K1 if k1 else VARIANTS).get(bits, "custom")

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
    table = "" if k1 else ("float32 " if f32_table else "bfloat16 ")
    print(f"# ablate {bits:2d} ({label}): {table}{names[0]} "
          f"{', '.join(e_out)}; "
          f"{names[1]} {t_ms:.3f} ms (rel err {t_err:.2e})", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_folded: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if len(args) == 3 and args[0] == "--one":
        one(int(args[2]), args[1] == "k1", args[1] == "f32")
        return 0
    k1, f32_table = "--k1" in args, "--f32" in args
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    print(smi.strip().splitlines()[0], flush=True)
    rc = 0
    for bits in ([a for a in args if a not in ("--k1", "--f32")]
                 or [str(b) for b in (VARIANTS_K1 if k1 else VARIANTS)]):
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", "k1" if k1 else
                              "f32" if f32_table else "folded",
                              str(int(bits))]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
