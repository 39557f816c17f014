"""bart_tpu_torch's unfused extinction and post-processing against
bart_tpu's at float64 on the small demo problems: ``diagnostics``
against ``jax.vmap(diagnostics)`` (eclipse and transit with CIA,
Rayleigh and cloud rows, and folded models) at rtol 1e-9; the unfused
spectrum of the diagnostics (tau_vertical -> eclipse_flux,
transit_depth) against the port's fused forward at 1e-10, as
tests/test_fused.py:119 holds bart_tpu; ``spectrum_from_profiles``
against bart_tpu's at 1e-9; the contribution functions, the
transmittance and the band average at 1e-10."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bart_tpu.opacity.grid import build_opacity_grid as jbuild
from bart_tpu.post import cf as jcf

from bart_tpu_torch.demo import DEMO_PARAMS, DEMO_PARAMS_TRANSIT, demo_inputs
from bart_tpu_torch.post import cf
from bart_tpu_torch.rt.eclipse import eclipse_flux
from bart_tpu_torch.rt.tau import tau_vertical
from bart_tpu_torch.rt.transit_geom import transit_depth
from bart_tpu_torch.utils.grids import folded_fine_grid

from test_torch_folded_forward import K as FOLD_K
from test_torch_folded_forward import _models as folded_models
from test_torch_folded_forward import _params as folded_params
from test_torch_transit_forward import _models, _params

#: case -> (solution, ForwardConfig options, base parameters, the
#: cloud-top/Rayleigh parameters inserted before log CH4); CIA throughout
CASES = {
    "eclipse": ("eclipse", {}, DEMO_PARAMS, ()),
    "eclipse+ray+cloudtop": ("eclipse",
                             {"scattering": "ray", "cloudtop": True},
                             DEMO_PARAMS, (1.0, 0.5)),
    "transit": ("transit", {}, DEMO_PARAMS_TRANSIT, ()),
    "transit+ray+cloudtop": ("transit",
                             {"scattering": "ray", "cloudtop": True},
                             DEMO_PARAMS_TRANSIT, (1.0, 0.5)),
    "transit+polar+cloudrad": ("transit",
                               {"scattering": "polar",
                                "cloudrad": (94000.0, 93000.0),
                                "cloudext": 1e-4},
                               DEMO_PARAMS_TRANSIT, (0.0,)),
}
NAMES = ("T", "q", "radius", "extinction")


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def demo():
    """(inputs, bart_tpu OpacityGrid) of the small demo problem."""
    inp = demo_inputs(nlayer=12, nwave=256, nlines=300, t_step=520.0)
    grid = jbuild({"CH4": inp.lines}, inp.wn, inp.t_grid, inp.pressure,
                  cond_batch=80, dtype=jnp.float64)
    return inp, grid


@pytest.fixture(scope="module")
def folded_demo():
    """The same problem's table on the folded fine grid (K = 4, 64 wn)."""
    inp = demo_inputs(nlayer=12, nwave=64, nlines=300, t_step=520.0)
    grid = jbuild({"CH4": inp.lines}, folded_fine_grid(inp.wn, FOLD_K),
                  inp.t_grid, inp.pressure, cond_batch=80,
                  dtype=jnp.float64)
    return inp, grid


def _case(demo, case):
    solution, cfg, base, extra = CASES[case]
    inp, grid = demo
    fmj, fmt, _ = _models(inp, grid, solution, **cfg)
    return fmj, fmt, _params(base, extra)


def _compare_diagnostics(got, ref):
    assert len(got) == len(ref) == 5
    for name, a, b in zip(NAMES, got[:4], ref[:4]):
        assert a.dtype == torch.float64, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   err_msg=name)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))


@pytest.mark.parametrize("case", list(CASES))
def test_diagnostics_match_bart_tpu(demo, case):
    fmj, fmt, P = _case(demo, case)
    got = fmt.diagnostics(torch.tensor(P))
    assert got[3].shape == (4, 12, 256)
    assert not got[4][3] and got[4][:3].all()
    _compare_diagnostics(got, jax.vmap(fmj.diagnostics)(jnp.asarray(P)))
    batch = fmt.diagnostics_batch()(torch.tensor(P[:2]))
    for a, b in zip(batch[:4], got[:4]):
        np.testing.assert_allclose(a.numpy(), b[:2].numpy(), rtol=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_unfused_spectrum_matches_fused_forward(demo, case):
    """The diagnostics' extinction through the unfused radiative transfer
    equals the port's fused forward."""
    _, fmt, P = _case(demo, case)
    T, q, rad, ext, _ = fmt.diagnostics(torch.tensor(P))
    if fmt.config.solution == "transit":
        ref = transit_depth(ext, rad, fmt.system.r_star * 100.0)
    else:
        ref = eclipse_flux(tau_vertical(ext, rad), T, fmt.wn, fmt.mu,
                           fmt.mu_w)
    np.testing.assert_allclose(fmt(torch.tensor(P))[1].numpy(), ref.numpy(),
                               rtol=1e-10)


@pytest.mark.parametrize("solution", ["eclipse", "transit"])
@pytest.mark.parametrize("with_radius", [False, True])
def test_spectrum_from_profiles_matches_bart_tpu(demo, solution, with_radius):
    fmj, fmt, P = _case(demo, solution)
    T, q, rad, _, _ = fmt.diagnostics(torch.tensor(P))
    T = T * torch.linspace(0.8, 1.4, T.shape[1], dtype=T.dtype)  # clipped
    rad = rad if with_radius else None
    got = fmt.spectrum_from_profiles(T.numpy(), q,
                                     None if rad is None else rad.numpy())
    assert got.shape == (4, 256) and bool(torch.isfinite(got).all())

    def one(i):
        return fmj.spectrum_from_profiles(
            jnp.asarray(T[i].numpy()), jnp.asarray(q[i].numpy()),
            None if rad is None else jnp.asarray(rad[i].numpy()))

    ref = np.stack([np.asarray(one(i)) for i in range(4)])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9)


@pytest.mark.parametrize("solution", ["eclipse", "transit"])
def test_folded_diagnostics_match_bart_tpu(folded_demo, solution):
    """A folded model's diagnostics read its bin-mean table, as
    bart_tpu's do."""
    inp, grid = folded_demo
    fmj, fmt, _ = folded_models(inp, grid, solution)
    assert fmt.fold == FOLD_K and fmt.sigma.shape[-1] == 64
    P = folded_params(DEMO_PARAMS_TRANSIT if solution == "transit"
                      else DEMO_PARAMS)
    _compare_diagnostics(fmt.diagnostics(torch.tensor(P)),
                         jax.vmap(fmj.diagnostics)(jnp.asarray(P)))


# ---------------------------------------------------------------------
# contribution functions, transmittance, band average

@pytest.mark.parametrize("solution", ["eclipse", "transit"])
def test_contribution_functions_and_transmittance_match_bart_tpu(
        demo, solution):
    inp, _ = demo
    _, fmt, P = _case(demo, solution)
    T, q, rad, ext, _ = (x.numpy() for x in
                         fmt.diagnostics(torch.tensor(P[:3])))
    pressure, wn = inp.pressure, inp.wn
    got_cf = cf.contribution_functions(ext, rad, T, pressure, wn,
                                       device="cpu")
    got_tr = cf.transmittance(ext, rad, device="cpu")
    assert got_cf.shape == got_tr.shape == (3, 12, 256)
    assert isinstance(got_cf, np.ndarray) and np.all(got_cf >= 0)
    assert np.all(got_cf[:, -1] == 0) and got_cf.max() > 0
    for i in range(3):
        ref_cf = jcf.contribution_functions(ext[i], rad[i], T[i], pressure,
                                            wn)
        np.testing.assert_allclose(got_cf[i], ref_cf, rtol=1e-10)
        # one profile at a time, as bart_tpu's
        np.testing.assert_allclose(
            cf.contribution_functions(ext[i], rad[i], T[i], pressure, wn,
                                      device="cpu"), got_cf[i], rtol=1e-12)
        np.testing.assert_allclose(got_tr[i], jcf.transmittance(ext[i],
                                                                rad[i]),
                                   rtol=1e-10)
    got = cf.band_average(got_cf, wn, inp.filters, device="cpu")
    assert got.shape == (3, 12, 10)
    for i in range(3):
        np.testing.assert_allclose(
            got[i], jcf.band_average(got_cf[i], wn, inp.filters), rtol=1e-10)
