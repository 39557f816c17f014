#!/usr/bin/env python3
"""Time ablated builds of the two tensor-core folded kernels on one CUDA
card, to separate what binds them: the global -> shared copies, the
tensor-core products, the exponentials, the grid order.

Each variant is built with ``-DBART_ABLATE=<bits>`` (the bits are listed
in the kernels' sources) in a process of its own, and timed on
chip_smoke.py's phase-2 random rows at the full-width shape (512 chains,
100 layers, 1,125 fine bins x 32, bfloat16 tables; eclipse R = 27 with
the expsum quadrature, transit R = 41).  An ablated kernel's result is
wrong; only its time is read.

    python3 ablate_folded.py                 # the default variants
    python3 ablate_folded.py 0 1 6 8         # these bit sets
"""

from __future__ import annotations

import os
import subprocess
import sys

VARIANTS = {0: "as built", 1: "no global -> shared copies",
            2: "no fill products", 4: "no exponentials",
            16: "no slant products (transit)", 22: "copies and barriers only",
            23: "barriers only", 8: "fine tiles on the grid's fast axis "
            "(transit)"}


def one(bits: int) -> None:
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bart_tpu_torch.demo import (fine_structure, random_rows,
                                     random_transit_rows)
    from bart_tpu_torch.rt import fused
    from bart_tpu_torch.rt.eclipse import expsum_weights
    from chip_smoke import cuda_ms

    # one more flag keys another library in build/: set before any build
    fused._NVCC_FLAGS += (f"-DBART_ABLATE={bits}",)
    f32 = dict(dtype=torch.float32, device="cuda")
    R, Rt, L, W, C, K = 27, 41, 100, 1125, 512, 32
    fused.build_kernels(["fused_eclipse_folded", "fused_transit_folded"])

    def fine_table(tab):
        factor = torch.tensor(fine_structure(tab.shape[0], W, K), **f32)
        fine = (tab[..., None] * factor).reshape(*tab.shape[:2], W * K)
        return fused.folded_table(fine, K, torch.bfloat16)

    tab, wn, wrows, T, drp = (torch.tensor(a, **f32)
                              for a in random_rows(R, L, W, C, seed=7))
    ft = fine_table(tab)
    mu, muw = (torch.tensor(a, **f32) for a in expsum_weights(8))
    e_ms = cuda_ms(lambda: fused.fused_eclipse_folded(
        ft, wn, mu, muw, wrows, T, drp, True), 5)
    del tab, ft
    tab, wrows, G, wgt = (torch.tensor(a, **f32) for a in
                          random_transit_rows(Rt, L, W, C, seed=7)[:4])
    ft = fine_table(tab)
    Gp = fused.prepare_slant(G)
    t_ms = cuda_ms(lambda: fused.fused_transit_folded(ft, wrows, Gp, wgt), 5)
    print(f"# ablate {bits:2d} ({VARIANTS.get(bits, 'custom')}): "
          f"fused_eclipse_folded {e_ms:.3f} ms, fused_transit_folded "
          f"{t_ms:.3f} ms", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_folded: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(int(sys.argv[2]))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    print(smi.strip().splitlines()[0], flush=True)
    rc = 0
    for bits in sys.argv[1:] or [str(b) for b in VARIANTS]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", str(int(bits))]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
