"""The least time the card could take for one launch of a fused kernel:
the bound that ``chip_smoke.py``'s kernels line and the bench's roofline
print, from one accounting.

The peaks are an NVIDIA H100 SXM's data sheet (dense rates, at the full
700 W power limit): a card set to a lower limit runs slower under load,
so every share quoted against them names the card and its limit.
"""

from __future__ import annotations

__all__ = ["PEAKS", "HBM_BPS", "F32_FLOPS", "SFU_PS", "TENSOR_FLOPS",
           "TENSOR_PASSES", "bound", "eclipse_bound", "transit_bound"]

#: whose peak rates these are
PEAKS = "NVIDIA H100 SXM data sheet"
# HBM3 bytes/s, float32 FLOP/s outside the tensor cores (an FMA is two),
# and special-function results/s at the same clock as that float32 peak:
# an SM has 16 special-function lanes beside 128 float32 lanes of 2 FLOP
# (Hopper architecture white paper), so 1/16 of the FLOP rate.
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
SFU_PS = F32_FLOPS / 16
# dense tensor-core peaks of the same data sheet, FLOP/s; every
# tensor-core contraction of the four kernels takes three passes (the
# weights' three bfloat16 parts, or 3xTF32)
TENSOR_FLOPS = {"bf16": 989e12, "tf32": 495e12}
TENSOR_PASSES = 3


def bound(fmas: float, tensor: list, exps: float, nbytes: float) -> dict:
    """The least time the card could take for one launch, as the
    kernels line's bound keys: the largest of the FMAs on the float32
    pipes at the float32 peak, the FMAs on tensor cores (``tensor``:
    [(what, type, FMAs)]) at their types' dense peaks times the passes
    used, the exponentials at the special-function rate and the bytes at
    the HBM rate; with the term that binds, the tensor cores' share of
    all FMAs, their types and their ms."""
    tensor_ms = sum(2e3 * TENSOR_PASSES * n / TENSOR_FLOPS[kind]
                    for _, kind, n in tensor)
    terms = {"fmas": 2e3 * fmas / F32_FLOPS, "tensor": tensor_ms,
             "exponentials": 1e3 * exps / SFU_PS,
             "bytes": 1e3 * nbytes / HBM_BPS}
    term = max(terms, key=terms.get)
    n_tensor = sum(n for _, _, n in tensor)
    return {"bound_ms": terms[term],
            "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "tensor_fmas": n_tensor / (n_tensor + fmas),
            "tensor_type": " + ".join(f"{kind} x {TENSOR_PASSES} passes "
                                      f"({what})" for what, kind, _ in tensor),
            "tensor_ms": tensor_ms}


def eclipse_bound(R, L, F, C, nmu, powers, K, bf16, nbytes_in) -> dict:
    """Bound of one eclipse launch, K = 1 or folded over F = W K fine
    points: per (chain, layer, fine point) R FMAs for ext (the fill, on
    tensor cores: bfloat16 on a bfloat16 fine table, else TF32), 4 for
    the recurrence and the flux, nmu for the quadrature, and 1 (powers)
    or nmu exponentials; one Planck exponential per (chain, layer, output
    bin).  Bytes: every input as stored and the output, once each."""
    pts = C * L * F
    return bound(pts * (nmu + 4), [("fill", "bf16" if bf16 else "tf32",
                                    pts * R)],
                 pts * (1 if powers else nmu) + pts // K,
                 nbytes_in + 4 * C * (F // K))


def transit_bound(R, L, F, C, K, bf16, nbytes_in) -> dict:
    """Bound of one transit launch, K = 1 or folded over F = W K fine
    points: per (chain, fine point) L R FMAs for ext (the fill, on
    tensor cores: bfloat16 on a bfloat16 fine table, else TF32), L (L +
    1) / 2 for the triangle of slant paths (TF32 on tensor cores) and L
    for the annulus sum, and L exponentials."""
    pts = C * F
    return bound(pts * L, [("fill", "bf16" if bf16 else "tf32", pts * L * R),
                           ("slant", "tf32", pts * L * (L + 1) // 2)],
                 pts * L, nbytes_in + 4 * C * (F // K))
