"""bart_tpu_torch transit geometry and the fused transit kernel against
bart_tpu.

(a) slant_chords, tau_slant, slant_geometry and transit_depth at float64
    against bart_tpu's, per chain;
(b) ``transit_plain`` at float64 against ``jax.vmap(_tsingle)``;
(c) ``transit_plain`` at float32 against the Pallas ``_tkernel`` run in
    interpret mode, as tests/test_fused.py runs it, on ``out`` itself
    (the depth adds r_bot^2, most of it, and would hide a wrong ``out``);
(d) the CUDA kernel against ``transit_plain`` on the card (marked gpu,
    skipped without one).

The problems come from ``demo.random_transit_rows``, whose slant tau
crosses unity inside the atmosphere (checked here): with saturated tau,
out = sum(wgt) whatever the extinction and a comparison tests nothing.

The card has no JAX, so this module imports jax only inside the tests
that compare with bart_tpu; the card tests run there with
``python -m pytest --noconftest -m gpu tests/test_torch_transit.py``.
"""

import re

import numpy as np
import pytest
import torch

import bart_tpu_torch.rt.fused as fused
from bart_tpu_torch.demo import random_transit_rows
from bart_tpu_torch.rt.tau import TAU_CLAMP, slant_chords, tau_slant
from bart_tpu_torch.rt.transit_geom import slant_geometry, transit_depth

F64 = torch.float64
R_STAR_CM = 7.97e10
SHAPES = [(17, 23, 300, 6), (41, 23, 300, 6)]       # (R, L, W, C)


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def jx():
    """(jax, jax.numpy, bart_tpu.rt.fused), imported on first use."""
    import jax
    import jax.numpy as jnp

    import bart_tpu.rt.fused as jfused

    return jax, jnp, jfused


def _torch(args, dtype):
    return [torch.tensor(np.asarray(a), dtype=dtype) for a in args]


@pytest.fixture
def atmosphere():
    """Three chains of descending radii with 30-80 km layers and
    lognormal extinction, L=23, W=300."""
    rng = np.random.default_rng(11)
    C, L, W = 3, 23, 300
    rad = 7.1e9 - np.cumsum(rng.uniform(3e6, 8e6, (C, L)), axis=1)
    ext = rng.lognormal(-14, 2, (C, L, W))
    return ext, rad


# ---------------------------------------------------------------------
# (a) geometry

def test_slant_chords_and_tau_slant_match(atmosphere):
    from bart_tpu.rt import tau as jtau

    ext, rad = atmosphere
    x = slant_chords(torch.tensor(rad)).numpy()
    tau = tau_slant(torch.tensor(ext), torch.tensor(rad)).numpy()
    for c in range(rad.shape[0]):
        np.testing.assert_allclose(x[c], np.asarray(jtau.slant_chords(rad[c])),
                                   rtol=1e-10)
        np.testing.assert_allclose(
            tau[c], np.asarray(jtau.tau_slant(ext[c], rad[c])), rtol=1e-10)
    # zero on and above the diagonal, exactly
    assert np.all(np.triu(x[0]) == 0.0)
    assert np.all(x[0][np.tril_indices(23, -1)] > 0)


def test_slant_geometry_matches_and_is_lower_triangular(atmosphere):
    from bart_tpu.rt.transit_geom import slant_geometry as jgeom

    _, rad = atmosphere
    G, wgt = slant_geometry(torch.tensor(rad))
    assert G.shape == (3, 23, 23) and wgt.shape == (3, 23)
    for c in range(3):
        Gj, wj = jgeom(rad[c])
        np.testing.assert_allclose(G[c].numpy(), np.asarray(Gj), rtol=1e-10)
        np.testing.assert_allclose(wgt[c].numpy(), np.asarray(wj), rtol=1e-10)
    assert float(torch.triu(G, diagonal=1).abs().max()) == 0.0
    # the float32 geometry keeps the exact zeros the kernel skips
    G32, _ = slant_geometry(torch.tensor(rad, dtype=torch.float32))
    assert float(torch.triu(G32, diagonal=1).abs().max()) == 0.0


def test_transit_depth_matches_and_equals_the_factored_form(atmosphere):
    from bart_tpu.rt.transit_geom import transit_depth as jdepth

    ext, rad = atmosphere
    got = transit_depth(torch.tensor(ext), torch.tensor(rad), R_STAR_CM)
    for c in range(3):
        np.testing.assert_allclose(
            got[c].numpy(), np.asarray(jdepth(ext[c], rad[c], R_STAR_CM)),
            rtol=1e-10)
    # (r_bot^2 + wgt @ (1 - e^-tau)) / r_star^2 is the same depth
    e, r = torch.tensor(ext), torch.tensor(rad)
    G, wgt = slant_geometry(r)
    tau = torch.clamp(G @ e, max=TAU_CLAMP)
    absorbed = torch.einsum("cb,cbw->cw", wgt, 1.0 - torch.exp(-tau))
    np.testing.assert_allclose(
        ((r[:, -1:] ** 2 + absorbed) / R_STAR_CM ** 2).numpy(), got.numpy(),
        rtol=1e-10)


# ---------------------------------------------------------------------
# (b), (c) the plain version against bart_tpu's _tsingle and _tkernel

def test_random_transit_rows_are_optically_mixed():
    """At least 20% of (chain, b, w) points have slant tau in [0.1, 10],
    and doubling the weights moves every out by more than 1%."""
    for R, L, W, C in SHAPES:
        tab, wrows, G, wgt, rad = random_transit_rows(R, L, W, C)
        assert np.abs(np.triu(G, 1)).max() == 0.0
        tau = np.einsum("cbl,clw->cbw", G,
                        np.einsum("clr,rlw->clw", wrows, tab))
        assert np.mean((tau >= 0.1) & (tau <= 10.0)) >= 0.2
        out = fused.transit_plain(*_torch((tab, wrows, G, wgt), F64))
        out2 = fused.transit_plain(*_torch((tab, 2 * wrows, G, wgt), F64))
        assert float(((out2 - out) / out).abs().min()) > 0.01


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_vmap_tsingle_f64(jx, shape):
    jax, jnp, jfused = jx
    tab, wrows, G, wgt, _ = random_transit_rows(*shape)
    ref = jax.vmap(jfused._tsingle, in_axes=(None, 0, 0, 0))(
        jnp.asarray(tab), jnp.asarray(wrows), jnp.asarray(G), jnp.asarray(wgt))
    got = fused.transit_plain(*_torch((tab, wrows, G, wgt), F64))
    assert got.dtype == F64 and got.shape == (shape[3], shape[2])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_f32_matches_pallas_interpret(jx, shape):
    jax, jnp, jfused = jx
    tab, wrows, G, wgt, _ = random_transit_rows(*shape)
    f32 = [jnp.asarray(a, jnp.float32) for a in (tab, wrows, G, wgt)]
    old_force, old_interp = jfused.FORCE_PALLAS, jfused.INTERPRET
    jfused.FORCE_PALLAS, jfused.INTERPRET = True, True
    try:
        ref = jax.vmap(lambda w, g, wt: jfused.fused_transit(f32[0], w, g, wt)
                       )(*f32[1:])
    finally:
        jfused.FORCE_PALLAS, jfused.INTERPRET = old_force, old_interp
    got = fused.transit_plain(*_torch((tab, wrows, G, wgt), torch.float32))
    assert got.dtype == torch.float32
    # both f32, summing in other orders over up to 23 layers and rows
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4)


def test_plain_ignores_the_upper_triangle():
    """The kernel skips G[b, l] for l > b (zero in slant_geometry's G);
    the plain version takes the same contract."""
    tab, wrows, G, wgt, _ = random_transit_rows(5, 9, 40, 3)
    noisy = G + np.triu(np.ones_like(G), 1)
    np.testing.assert_array_equal(
        fused.transit_plain(*_torch((tab, wrows, noisy, wgt), F64)).numpy(),
        fused.transit_plain(*_torch((tab, wrows, G, wgt), F64)).numpy())


def test_fused_transit_on_cpu_is_the_plain_path():
    ts = _torch(random_transit_rows(5, 9, 40, 3)[:4], F64)
    before = fused.fused_transit.launches
    np.testing.assert_array_equal(fused.fused_transit(*ts).numpy(),
                                  fused.transit_plain(*ts).numpy())
    assert fused.fused_transit.launches == before      # no kernel launch
    with pytest.raises(ValueError, match="fused_transit: unsupported device"):
        fused.fused_transit(*[t.to("meta") for t in ts])


def test_kernel_source_constants_match_python():
    entry = (fused._CSRC / "fused_transit.cu").read_text()
    assert '#include "fused_transit_mma.cuh"' in entry
    src = (fused._CSRC / "fused_transit_mma.cuh").read_text() + entry
    assert float(re.search(r"kTauClamp = ([0-9.e+-]+)f;", src).group(1)) \
        == TAU_CLAMP
    for macro, value in (("FT_W", fused._FT_W), ("FT_CB", fused._FT_CB),
                         ("FT_NS", fused._FT_NS), ("FT_MT", fused._FT_MT)):
        assert re.search(rf"#define {macro} (\d+)", src).group(1) == str(value)
    assert "extern \"C\" int bart_fused_transit(" in src
    # the K = 1 entry takes the float32 instance: the 3xTF32 fill in steps
    # of 8 rows
    assert "launch_transit_mma<float>(" in entry and fused._MMA_K32 == 8
    assert set(fused._KERNELS) == {p.stem for p in fused._CSRC.glob("*.cu")}


# ---------------------------------------------------------------------
# (d) on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from bart_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(17, 23, 300, 6), (41, 100, 2501, 64),
                                   (5, 112, 70, 9)])   # the largest L
def test_kernel_matches_plain_on_card(cuda_device, shape):
    ts = [t.to(cuda_device) for t in
          _torch(random_transit_rows(*shape)[:4], torch.float32)]
    before = fused.fused_transit.launches
    got = fused.fused_transit(*ts)
    ref = fused.transit_plain(*ts)
    torch.cuda.synchronize()
    assert fused.fused_transit.launches == before + 1
    # 3xTF32 products (2^-21 an operand) summed in float32 in other
    # orders over up to 112 layers and 48 rows (chip_smoke.py's OUT_RTOL)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5)


@pytest.mark.gpu
def test_kernel_raises_beyond_shared_memory(cuda_device):
    # 113 and 200 layers (past the resident kernel's 112) take the
    # streamed variant and match the plain version
    for L in (113, 200):
        ts = [t.to(cuda_device) for t in
              _torch(random_transit_rows(3, L, 40, 2)[:4], torch.float32)]
        np.testing.assert_allclose(fused.fused_transit(*ts).cpu().numpy(),
                                   fused.transit_plain(*ts).cpu().numpy(),
                                   rtol=1e-5)
    # the annulus weights' shared memory caps L near 10,688 on a float32
    # table
    L = 10800
    f32 = dict(dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        fused.fused_transit(torch.ones(1, L, 8, **f32),
                            torch.ones(2, L, 1, **f32),
                            torch.zeros(2, L, L, **f32),
                            torch.ones(2, L, **f32))
