"""The frozen roofline copy gives the six bounds the program's accounting
is pinned to (512 chains, 100 layers, 2,501 bins; the folded kernels on
1,064 fine bins x 32 with bfloat16 tables, the float32 instance on
1,125), and agrees with the program's own functions."""

import pytest

from benchtools import HERE  # noqa: F401
from bm import roofline

C, L, W, NMU = 512, 100, 2501, {"raygrid": 5, "expsum": 8}


def eclipse(R, F, K, bf16, quad):
    el = 2 if bf16 else 4
    nb = el * R * L * F + 4 * (C * L * R + 2 * C * L
                               + (W if K == 1 else NMU[quad]))
    return roofline.eclipse_bound(R, L, F, C, NMU[quad], quad == "expsum",
                                  K, bf16, nb)


def transit(R, F, K, bf16):
    el = 2 if bf16 else 4
    nb = el * R * L * F + 4 * (C * L * R + C * L * L + C * L)
    return roofline.transit_bound(R, L, F, C, K, bf16, nb)


CASES = {
    "fused_eclipse": (lambda: eclipse(27, W, 1, False, "raygrid"), 0.183),
    "fused_transit": (lambda: transit(41, W, 1, False), 0.142),
    "fused_eclipse_folded": (
        lambda: eclipse(27, 1064 * 32, 32, True, "expsum"), 0.624),
    "fused_transit_folded": (lambda: transit(41, 1064 * 32, 32, True),
                             1.501),
    "fused_eclipse_folded[float32, expsum]": (
        lambda: eclipse(27, 1125 * 32, 32, False, "expsum"), 0.660),
    "fused_eclipse_folded[float32, raygrid]": (
        lambda: eclipse(27, 1125 * 32, 32, False, "raygrid"), 2.215),
}


@pytest.mark.parametrize("kernel", list(CASES))
def test_pinned_bounds(kernel):
    fn, ms = CASES[kernel]
    got = fn()
    assert round(got["bound_ms"], 3) == ms, got
    assert got["bound_by"] == "operations"


def test_same_as_the_programs_accounting():
    from bart_tpu_torch.utils import roofline as prog

    for name in ("HBM_BPS", "F32_FLOPS", "SFU_PS", "TENSOR_FLOPS",
                 "TENSOR_PASSES"):
        assert getattr(roofline, name) == getattr(prog, name)
    args = (41, 100, 1376 * 32, 512, 5, False, 32, True, 123456789)
    assert roofline.eclipse_bound(*args) == prog.eclipse_bound(*args)
    targs = (41, 100, 1376 * 32, 512, 32, True, 123456789)
    assert roofline.transit_bound(*targs) == prog.transit_bound(*targs)


#: each cell's launch bounds, ms: the demo's 1,376 fine bins x 32 (bf16
#: rows) and its 1,125 smooth ones at R = 41; WASP-12b's 2,424 bins at
#: R = 122
CELL_BOUNDS = {
    "demo_ch4_eclipse.fold32": (1376, {"fused_eclipse_folded": 2.708691,
                                       "fused_eclipse": 0.082531}),
    "wasp12b_eclipse.k1": (None, {"fused_eclipse": 0.183531}),
}


@pytest.mark.parametrize("name", list(CELL_BOUNDS))
def test_cell_bounds(name):
    """The bounds the cells' roofline shares and step.mfu divide by, from
    the cfg and the reference's split alone."""
    import torch

    from bm import kernels, manifest
    from bm.reference import Reference

    fine, want = CELL_BOUNDS[name]
    w = manifest.cell(name)
    ref = Reference(w["config_obj"], w["traffic_params"]["cfg"],
                    manifest.HERE, torch.device("cpu"))
    ref.mask = None
    if fine is not None:
        ref.mask = torch.arange(len(ref.wn)) < fine
    got = {k: round(v * 1e3, 6) for k, v in
           kernels.launch_bounds(ref, 512).items()}
    assert got == want
