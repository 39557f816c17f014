"""bart_tpu_torch reference math against bart_tpu at float64: Planck,
vertical tau, eclipse flux and its quadratures, the Line PT profile, the
hydrostatic radii, the Faddeeva function, partition sums, interp.

Inputs are made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest
import scipy.special
import torch

import jax
import jax.numpy as jnp

import bart_tpu.linelist.tips as jtips
import bart_tpu.physics.hydro as jhydro
import bart_tpu.physics.pt as jpt
import bart_tpu.physics.voigt as jvoigt
import bart_tpu.rt.eclipse as jecl
from bart_tpu.rt.planck import planck_wn as jplanck
from bart_tpu.rt.tau import tau_vertical as jtau

from bart_tpu_torch.linelist.tips import partition_function
from bart_tpu_torch.physics.hydro import anchor_index, radius_profile
from bart_tpu_torch.physics.pt import pt_generator, pt_line
from bart_tpu_torch.physics.voigt import (
    doppler_hwhm, faddeeva_real, lorentz_hwhm_collision,
)
from bart_tpu_torch.rt.eclipse import (
    eclipse_flux, eclipse_intensity, expsum_weights, raygrid_weights,
)
from bart_tpu_torch.rt.planck import planck_wn
from bart_tpu_torch.rt.tau import tau_vertical
from bart_tpu_torch.utils.interp import interp

F64 = torch.float64


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=F64)


@pytest.fixture
def atmosphere():
    rng = np.random.default_rng(3)
    L, W = 23, 300
    wn = np.linspace(2500.0, 5000.0, W)
    T = rng.uniform(500, 2900, L)
    ext = rng.lognormal(-12, 2, (L, W))
    rad = 7e9 - np.cumsum(rng.uniform(1e6, 5e6, L))
    return wn, T, ext, rad


def test_planck_matches():
    rng = np.random.default_rng(0)
    wn = rng.uniform(100, 10000, (7, 50))
    T = rng.uniform(300, 4000, (7, 1))
    np.testing.assert_allclose(planck_wn(t64(wn), t64(T)).numpy(),
                               np.asarray(jplanck(wn, T)), rtol=1e-10)


def test_tau_vertical_matches_batched(atmosphere):
    _, _, ext, rad = atmosphere
    ext3 = np.stack([ext, 2 * ext, 0.5 * ext])
    rad3 = np.stack([rad, rad - 1e5, rad + 3e5])
    got = tau_vertical(t64(ext3), t64(rad3)).numpy()
    for c in range(3):
        np.testing.assert_allclose(
            got[c], np.asarray(jtau(ext3[c], rad3[c])), rtol=1e-10)


@pytest.mark.parametrize("quad", ["raygrid", "expsum4", "expsum8"])
def test_quadrature_weights_and_flux_match(atmosphere, quad):
    wn, T, ext, rad = atmosphere
    if quad == "raygrid":
        mine = raygrid_weights([0, 20, 40, 60, 80])
        ref = jecl.raygrid_weights([0, 20, 40, 60, 80])
    else:
        n = int(quad[-1])
        mine, ref = expsum_weights(n), jecl.expsum_weights(n)
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(a, b, rtol=1e-10)
    mu, w = ref
    tau = np.asarray(jtau(ext, rad))
    got = eclipse_flux(t64(tau), t64(T), t64(wn), t64(mu), t64(w)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jecl.eclipse_flux(tau, T, wn, mu, w)), rtol=1e-10)


def test_eclipse_intensity_single_layer():
    wn, T = np.linspace(2500, 5000, 40), np.array([1500.0])
    tau = np.full((1, 40), 0.3)
    mu = np.array([0.3, 0.8])
    np.testing.assert_allclose(
        eclipse_intensity(t64(tau), t64(T), t64(wn), t64(mu)).numpy(),
        np.asarray(jecl.eclipse_intensity(tau, T, wn, mu)), rtol=1e-10)


def test_isothermal_limit_is_pi_b(atmosphere):
    wn, _, ext, rad = atmosphere
    T = np.full(len(rad), 1234.0)
    tau = tau_vertical(t64(ext), t64(rad))
    for mu, w in (raygrid_weights([0, 20, 40, 60, 80]), expsum_weights(8)):
        F = eclipse_flux(tau, t64(T), t64(wn), t64(mu), t64(w)).numpy()
        piB = np.pi * planck_wn(t64(wn), t64(1234.0)).numpy()
        # the raygrid weights integrate mu over [0, 1] exactly; the
        # expsum coefficients sum to 1/2 exactly
        np.testing.assert_allclose(F, piB, rtol=1e-12)


# ---------------------------------------------------------------------
# atmosphere profiles

_PT_ARGS = [7.97e8, 6075.0, 100.0, 7.05e9, 2500.0, "const"]


@pytest.mark.parametrize("tint_type", ["const", "thorngren"])
def test_pt_line_matches_batched(tint_type):
    rng = np.random.default_rng(5)
    p = np.logspace(-5, 2, 40)
    C = 4
    P = np.column_stack([rng.uniform(-3, -1, C), rng.uniform(-1, 1, C),
                         rng.uniform(-1, 1, C), rng.uniform(0, 1, C),
                         rng.uniform(0.6, 1.1, C)])
    args = _PT_ARGS[:-1] + [tint_type]
    T, valid = pt_line(t64(p), *[t64(P[:, i]) for i in range(5)], *args)
    ref = jax.vmap(lambda q: jpt.pt_line(jnp.asarray(p), *q, *args)[0])(
        jnp.asarray(P))
    np.testing.assert_allclose(T.numpy(), np.asarray(ref), rtol=1e-12)
    assert valid.all() and valid.shape == (C,)
    T2, _ = pt_generator(t64(p), t64(P), "line", args)
    np.testing.assert_array_equal(T2.numpy(), T.numpy())


def test_pt_exp1_matches_scipy():
    from bart_tpu_torch.physics.pt import _exp1

    x = np.concatenate([np.logspace(-6, 0, 30), np.linspace(1.0, 40, 30)])
    np.testing.assert_allclose(_exp1(t64(x)).numpy(), scipy.special.exp1(x),
                               rtol=1e-12)


@pytest.mark.parametrize("p0", [0.1, 3e-5, 1e-6, 200.0])
def test_radius_profile_matches_vmap(p0):
    """Four chains against a jax.vmap of bart_tpu's radius_profile; p0
    inside the grid, near its top, and beyond both ends (interp's end
    clamping)."""
    rng = np.random.default_rng(11)
    p = np.logspace(-5, 2, 30)
    C = 4
    T = rng.uniform(800, 2500, (C, 30))
    mu = rng.uniform(2.2, 2.5, (C, 30))
    i0 = anchor_index(p, p0)
    got = radius_profile(t64(p), t64(T), t64(mu), p0, 1.0e5, 9.4, i0=i0)
    ref = jax.vmap(lambda Tc, mc: jhydro.radius_profile(
        jnp.asarray(p), Tc, mc, p0, 1.0e5, 9.4, i0=i0))(
            jnp.asarray(T), jnp.asarray(mu))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10)


def test_interp_matches_jnp():
    rng = np.random.default_rng(2)
    xp = np.sort(rng.uniform(0, 10, 17))
    fp = rng.normal(size=(3, 17))
    x = np.concatenate([[-1.0, xp[0], xp[-1], 11.0], rng.uniform(0, 10, 20)])
    got = interp(t64(x), t64(xp), t64(fp)).numpy()
    for c in range(3):
        np.testing.assert_allclose(
            got[c], np.asarray(jnp.interp(x, xp, fp[c])), rtol=1e-14)
    got0 = interp(t64(4.2), t64(xp), t64(fp)).numpy()
    np.testing.assert_allclose(got0, [float(jnp.interp(4.2, xp, f))
                                      for f in fp], rtol=1e-14)


# ---------------------------------------------------------------------
# line shape and partition sums

def test_faddeeva_matches_bart_tpu_and_scipy():
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.uniform(-30, 30, 400), [0.0, 1e-3, 5.0]])
    y = np.concatenate([10 ** rng.uniform(-4, 2, 400), [1e-6, 1.0, 0.2]])
    got = faddeeva_real(t64(x), t64(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(jvoigt.faddeeva_real(x, y)),
                               rtol=1e-12)
    np.testing.assert_allclose(got, scipy.special.wofz(x + 1j * y).real,
                               rtol=1e-6, atol=1e-12)


def test_hwhm_helpers_match():
    T = np.array([400.0, 1500.0, 3000.0])
    np.testing.assert_allclose(
        doppler_hwhm(4000.0, t64(T), 16 * 1.66e-24).numpy(),
        np.asarray(jvoigt.doppler_hwhm(4000.0, T, 16 * 1.66e-24)),
        rtol=1e-12)
    args = (1e8, 3.8e-8, np.array([0.85, 0.15]),
            np.array([3.3e-24, 6.6e-24]), np.array([2.9e-8, 2.6e-8]))
    got = lorentz_hwhm_collision(2e6, t64(T), 16 * 1.66e-24, args[1],
                                 t64(args[2])[:, None], t64(args[3])[:, None],
                                 t64(args[4])[:, None])
    ref = jvoigt.lorentz_hwhm_collision(
        2e6, T, 16 * 1.66e-24, args[1], args[2][:, None], args[3][:, None],
        args[4][:, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)


@pytest.mark.parametrize("species", ["CH4", "CO", "H2O", "He"])
def test_partition_function_matches(species):
    T = np.linspace(200.0, 3500.0, 37)
    got = partition_function(species)(t64(T)).numpy()
    ref = np.asarray(jtips.partition_function(species)(jnp.asarray(T)))
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_tabulated_partition_function_matches():
    table = (np.array([100.0, 500.0, 1000.0, 3000.0]),
             np.array([10.0, 80.0, 300.0, 2500.0]))
    T = np.array([50.0, 296.0, 999.0, 2800.0, 4000.0])
    got = partition_function("CH4", table)(t64(T)).numpy()
    ref = np.asarray(jtips.partition_function("CH4", table)(jnp.asarray(T)))
    np.testing.assert_allclose(got, ref, rtol=1e-14)
