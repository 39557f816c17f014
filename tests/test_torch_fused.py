"""bart_tpu_torch.rt.fused against bart_tpu.rt.fused.

(a) ``eclipse_plain`` at float64 against ``jax.vmap(_single)``;
(b) ``eclipse_plain`` at float32 against the Pallas ``_kernel`` run in
    interpret mode, as tests/test_fused.py runs it;
(c) the CUDA kernel against ``eclipse_plain`` on the card (marked gpu,
    skipped without one).

Fixture scale as tests/test_fused.py: M=2, nT=9, L=23, W=300, C=6.

The card has no JAX, so this module imports jax only inside the tests
that compare with bart_tpu; the card tests run there with
``python -m pytest --noconftest -m gpu tests/test_torch_fused.py``.
"""

import re

import numpy as np
import pytest
import torch

from bart_tpu import constants as const

import bart_tpu_torch.rt.fused as fused
from bart_tpu_torch.rt.eclipse import expsum_weights, raygrid_weights
from bart_tpu_torch.rt.planck import C1

QUADS = {"raygrid": (raygrid_weights([0.0, 20.0, 40.0, 60.0, 80.0]), False),
         "expsum": (expsum_weights(8), True),
         # past the old 16-node ceiling: every 5 degrees and every degree
         "raygrid18": (raygrid_weights(np.arange(0.0, 90.0, 5.0)), False),
         "raygrid90": (raygrid_weights(np.arange(0.0, 90.0, 1.0)), False)}


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _problem(quad, L=23, W=300, C=6, seed=7):
    """Random rows-contraction problem (numpy) in the fused contract:
    molecule x T-node rows weighted by T-interpolation x number density,
    the density growing seven decades downwards so that tau crosses
    unity inside the atmosphere."""
    rng = np.random.default_rng(seed)
    M, nT = 2, 9
    (mu, muw), powers = QUADS[quad]
    sigma = rng.lognormal(-46, 2, (M, nT, L, W))
    T = rng.uniform(500, 2900, (C, L))
    n_mol = rng.lognormal(0, 1, (C, L, M)) \
        * 10.0 ** np.linspace(8.0, 15.0, L)[None, :, None]
    drp = np.concatenate([np.zeros((C, 1)), rng.uniform(1e6, 5e6, (C, L - 1))],
                         axis=1)
    w_t = fused.interp_weights(nT, 400.0, 100.0, torch.tensor(T)).numpy()
    wrows = (n_mol[..., None] * w_t[:, :, None, :]).reshape(C, L, M * nT)
    tab = sigma.reshape(M * nT, L, W)
    wn = np.linspace(2500, 5000, W)
    return (tab, wn, mu, muw, wrows, T, drp), powers


def _torch(args, dtype):
    return [torch.tensor(np.asarray(a), dtype=dtype) for a in args]


@pytest.fixture
def jx():
    """(jax, jax.numpy, bart_tpu.rt.fused), imported on first use."""
    import jax
    import jax.numpy as jnp

    import bart_tpu.rt.fused as jfused

    return jax, jnp, jfused


@pytest.mark.parametrize("quad", ["raygrid", "expsum"])
def test_plain_matches_vmap_single_f64(jx, quad):
    jax, jnp, jfused = jx
    args, powers = _problem(quad)
    ref = jax.vmap(
        lambda w, t, d: jfused._single(*args[:4], w, t, d, powers=powers)
    )(*[jnp.asarray(a) for a in args[4:]])
    got = fused.eclipse_plain(*_torch(args, torch.float64), powers=powers)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10)


@pytest.mark.parametrize("quad", ["raygrid", "expsum"])
def test_plain_f32_matches_pallas_interpret(jx, quad):
    jax, jnp, jfused = jx
    args, powers = _problem(quad)
    old_force, old_interp = jfused.FORCE_PALLAS, jfused.INTERPRET
    jfused.FORCE_PALLAS, jfused.INTERPRET = True, True
    try:
        ref = jax.vmap(
            lambda w, t, d: jfused.fused_eclipse(
                *[jnp.asarray(a, jnp.float32) for a in args[:4]], w, t, d,
                powers=powers)
        )(*[jnp.asarray(a, jnp.float32) for a in args[4:]])
    finally:
        jfused.FORCE_PALLAS, jfused.INTERPRET = old_force, old_interp
    got = fused.eclipse_plain(*_torch(args, torch.float32), powers=powers)
    assert got.dtype == torch.float32
    # both compute in f32, summing in other orders over 23 layers
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-5)


def test_fused_eclipse_on_cpu_is_the_plain_path():
    args, powers = _problem("raygrid", L=5, W=40, C=3)
    ts = _torch(args, torch.float64)
    before = fused.fused_eclipse.launches
    np.testing.assert_array_equal(
        fused.fused_eclipse(*ts, powers=powers).numpy(),
        fused.eclipse_plain(*ts, powers=powers).numpy())
    assert fused.fused_eclipse.launches == before   # no kernel launch


def test_problem_is_optically_mixed():
    """The fixture's tau crosses unity inside the atmosphere at most
    wavenumbers (a saturated top layer would hide the recurrence)."""
    args, _ = _problem("raygrid")
    tab, _, _, _, wrows, _, drp = args
    ext = np.einsum("clr,rlw->clw", wrows, tab)
    tau_bot = np.sum(0.5 * (ext[:, :-1] + ext[:, 1:]) * drp[:, 1:, None],
                     axis=1)
    tau_top = 0.5 * (ext[:, 0] + ext[:, 1]) * drp[:, 1, None]
    assert np.mean(tau_top < 0.1) > 0.9 and np.mean(tau_bot > 10) > 0.9


def test_isothermal_limit_through_plain():
    """F = pi B for an isothermal atmosphere at any optical depth."""
    args, _ = _problem("expsum", L=8, W=50, C=2)
    tab, wn, mu, muw, wrows, T, drp = _torch(args, torch.float64)
    T = torch.full_like(T, 1700.0)
    for (mu_, muw_), powers in QUADS.values():
        F = fused.eclipse_plain(tab, wn, torch.tensor(mu_), torch.tensor(muw_),
                                wrows, T, drp, powers=powers)
        piB = np.pi * C1 * wn**3 / torch.expm1(const.C2 * wn / 1700.0)
        np.testing.assert_allclose(F.numpy(), np.broadcast_to(piB, F.shape),
                                   rtol=1e-12)


def test_interp_weights_match_bracketing(jx):
    _, jnp, jfused = jx
    T = np.array([[300.0, 400.0, 449.9, 1000.0, 2999.0, 3000.0, 3500.0]])
    got = fused.interp_weights(27, 400.0, 100.0, torch.tensor(T)).numpy()
    ref = np.asarray(jfused.interp_weights(27, 400.0, 100.0, jnp.asarray(T)))
    np.testing.assert_array_equal(got, ref)
    # above the last node: f = 1 on the top bracket
    assert got[0, -1, -1] == 1.0 and got[0, -1].sum() == 1.0


def test_kernel_source_constants_match_python():
    src = (fused._CSRC / "fused_eclipse.cu").read_text()

    def lit(name):
        return float(re.search(rf"{name} = ([0-9.e+-]+)f;", src).group(1))

    np.testing.assert_allclose(lit("kC1"), C1, rtol=1e-15)
    np.testing.assert_allclose(lit("kC2"), const.C2, rtol=1e-15)
    assert lit("kTauClamp") == fused.TAU_CLAMP
    for macro, value in (("TILE_W", fused._TILE_W), ("CB", fused._CB)):
        assert re.search(rf"#define {macro} (\d+)", src).group(1) == str(value)
    # any number of quadrature nodes: no ceiling in the source or the
    # wrapper, the runtime-count instance reads the nodes through the
    # read-only cache and the unrolled ones (5, 8) from shared memory
    assert "MAX_NMU" not in src and not hasattr(fused, "_MAX_NMU")
    assert "__ldg(wmu + q)" in src and "minv_s[NMU ? NMU : 1]" in src


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from bart_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("quad", ["raygrid", "expsum", "raygrid18",
                                  "raygrid90"])
@pytest.mark.parametrize("shape", [(23, 300, 6), (100, 2501, 64)])
def test_kernel_matches_plain_on_card(cuda_device, quad, shape):
    L, W, C = shape
    args, powers = _problem(quad, L=L, W=W, C=C)
    ts = [t.to(cuda_device) for t in _torch(args, torch.float32)]
    before = fused.fused_eclipse.launches
    got = fused.fused_eclipse(*ts, powers=powers)
    ref = fused.eclipse_plain(*ts, powers=powers)
    torch.cuda.synchronize()
    assert fused.fused_eclipse.launches == before + 1
    # f32 sums in another order over up to 100 layers; the expsum Horner
    # polynomial (|a_q| up to 28 against S(0) = 1/2) is at the f32 floor:
    # the plain version alone is ~7e-5 from its f64 result on the card
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-4 if powers else 1e-4)
