"""The fused kernels as the device trace names them, and the frozen bound
of one launch of each at the shapes the configuration gives it."""

from __future__ import annotations

import re

from . import roofline

#: kernel -> its name's pattern in the trace
KERNELS = {
    "fused_eclipse": r"fused_eclipse_kernel",
    "fused_eclipse_folded": r"fused_eclipse_folded_\w+_kernel",
}


def matcher(name: str):
    pat = re.compile(KERNELS[name])
    return lambda op: bool(pat.search(op))


def launch_bounds(ref, chains: int) -> dict:
    """{kernel: seconds}: the least time of one launch of each fused
    eclipse kernel a forward of ``chains`` chains makes, at the shapes
    the reference ``ref`` (its table loaded) works out from the cfg: R
    rows (a line row per molecule and T node, a continuum row per CIA
    temperature), L layers, the raygrid's angles (an exponential each),
    the fine bins of its own split at K points each (the folded kernel,
    its rows stored in bfloat16 under foldtable16) and the other bins at
    one (the K = 1 kernel, float32 rows)."""
    R = len(ref.line_species) * len(ref.t_grid) \
        + sum(len(temps) for _, temps, _, _ in ref.cia)
    L, C, nmu = len(ref.pressure), chains, len(ref.mu)
    W, K = len(ref.wn), ref.K
    fine = W if K == 1 else (int(ref.mask.sum()) if ref.mask is not None
                             else W)
    bf16 = ref.precisions()[0] == "bfloat16"
    parts = {"fused_eclipse": (W - fine if K > 1 else W, 1, False)}
    if K > 1:
        parts["fused_eclipse_folded"] = (fine * K, K, bf16)
    out = {}
    for name, (F, k, half) in parts.items():
        if F == 0:
            continue
        nb = (2 if half else 4) * R * L * F \
            + 4 * (C * L * R + 2 * C * L + (nmu if k > 1 else F))
        out[name] = roofline.eclipse_bound(R, L, F, C, nmu, False, k, half,
                                           nb)["bound_ms"] / 1e3
    return out


def roofline_share(ctx: dict, name: str):
    """% of the kernel's frozen bound in its own device time over the
    traced blocks, or None where the trace holds no launch of it."""
    us, n = ctx["blocks"].time_us(matcher(name))
    bound = ctx["bounds"].get(name)
    if not n or bound is None or us <= 0:
        return None
    return 100.0 * n * bound / (us * 1e-6)
