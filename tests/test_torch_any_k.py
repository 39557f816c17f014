"""Any number of sub-samples a bin and any number of quadrature nodes:
bart_tpu_torch against bart_tpu where the folded kernels' tiles and the
eclipse kernels' quadrature used to stop the port on the card.

(a) ``eclipse_folded_plain`` and ``transit_folded_plain`` at K = 3, 6
    and 48 (none divides the kernels' 64- and 32-point fine tiles)
    against ``jax.vmap`` of ``_single_folded``/``_tsingle_folded`` at
    float64 and against the Pallas ``_fkernel``/``_ftkernel`` run in
    interpret mode at float32, both quadratures;
(b) an 18-node raygrid (every 5 degrees): ``eclipse_plain`` (the K = 1
    path of ``fused_eclipse`` on the CPU) and ``eclipse_folded_plain``
    against ``_single``/``_single_folded`` and the Pallas kernels;
(c) a folded ``ForwardModel`` at K = 6 against bart_tpu's ``batched()``
    at float64 on the small demo problem (the adaptive split, CIA,
    Rayleigh and cloud rows), both geometries.

The tolerances are those of the K = 4 tests in tests/test_torch_folded.py
and tests/test_torch_folded_forward.py.  The card's kernels at these K
and node counts are held against the plain versions by the gpu-marked
tests of tests/test_torch_folded.py and tests/test_torch_fused.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bart_tpu.rt.fused as jfused
from bart_tpu.obs.bands import build_band_matrix as jbands
from bart_tpu.opacity.grid import build_opacity_grid as jbuild
from bart_tpu.rt.forward import ForwardConfig as JConfig
from bart_tpu.rt.forward import ForwardModel as JModel

import bart_tpu_torch.rt.fused as fused
from bart_tpu_torch.demo import (DEMO_PARAMS, DEMO_PARAMS_TRANSIT,
                                 build_demo_model, demo_inputs)
from bart_tpu_torch.rt.eclipse import raygrid_weights
from bart_tpu_torch.rt.forward import ForwardConfig, ForwardModel
from bart_tpu_torch.utils.grids import folded_fine_grid

from test_torch_folded import QUADS, _eclipse, _ft, _pallas_interpret, _t
from test_torch_folded import _transit
from test_torch_folded_forward import CONTINUUM, _params, _torch_grid

F32, F64 = torch.float32, torch.float64
#: a raygrid every 5 degrees, 0 .. 85: 18 nodes
RAY18 = (raygrid_weights(np.arange(0.0, 90.0, 5.0)), False)


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _quad(name):
    return RAY18 if name == "raygrid18" else QUADS[name]


def _eclipse_args(quad, k, shape=(18, 23, 75, 6)):
    """(fine [R, L, W k], (tab, wn, mu, muw, wrows, T, drp), powers) in
    numpy float64, with the quadrature ``quad``."""
    fine, args, _ = _eclipse("raygrid", shape, k)
    (mu, muw), powers = _quad(quad)
    return fine, (args[0], args[1], mu, muw, *args[4:]), powers


# ---------------------------------------------------------------------
# (a) K that straddles the kernels' tiles, (b) an 18-node raygrid

@pytest.mark.parametrize("quad", ["raygrid", "expsum", "raygrid18"])
@pytest.mark.parametrize("k", [3, 6, 48])
def test_eclipse_folded_plain_matches_single_folded_f64(quad, k):
    fine, args, powers = _eclipse_args(quad, k)
    tabk = jfused.fold_table(jnp.asarray(fine), k)
    ref = jax.vmap(
        lambda w, t, d: jfused._single_folded(
            tabk, *[jnp.asarray(a) for a in args[1:4]], w, t, d,
            powers=powers)
    )(*[jnp.asarray(a) for a in args[4:]])
    got = fused.eclipse_folded_plain(_ft(fine, k), *[_t(a) for a in args[1:]],
                                     powers=powers)
    assert got.shape == (6, 75)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10)


@pytest.mark.parametrize("quad", ["raygrid", "expsum", "raygrid18"])
@pytest.mark.parametrize("k", [3, 6, 48])
def test_eclipse_folded_plain_f32_matches_pallas_interpret(quad, k):
    # W = 25 output bins keeps the interpreted grid of K = 48 short
    fine, args, powers = _eclipse_args(quad, k, (18, 23, 25, 6))
    f32 = [jnp.asarray(a, jnp.float32) for a in args]
    tabk = jfused.fold_table(jnp.asarray(fine, jnp.float32), k)
    with _pallas_interpret(jfused):
        ref = jax.vmap(
            lambda w, t, d: jfused.fused_eclipse_folded(
                tabk, *f32[1:4], w, t, d, powers=powers)
        )(*f32[4:])
    got = fused.eclipse_folded_plain(
        _ft(fine, k, F32), *[_t(a, F32) for a in args[1:]], powers=powers)
    assert got.dtype == F32
    # both compute in f32, summing in other orders
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-5)


@pytest.mark.parametrize("k", [3, 6, 48])
def test_transit_folded_plain_matches_tsingle_folded_f64(k):
    fine, args = _transit(k=k)
    tabk = jfused.fold_table(jnp.asarray(fine), k)
    ref = jax.vmap(jfused._tsingle_folded, in_axes=(None, 0, 0, 0))(
        tabk, *[jnp.asarray(a) for a in args[1:]])
    got = fused.transit_folded_plain(_ft(fine, k), *[_t(a) for a in args[1:]])
    assert got.shape == (6, 75)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9)


@pytest.mark.parametrize("k", [3, 6, 48])
def test_transit_folded_plain_f32_matches_pallas_interpret(k):
    fine, args = _transit((18, 23, 25, 6), k)
    tabk = jfused.fold_table(jnp.asarray(fine, jnp.float32), k)
    with _pallas_interpret(jfused):
        ref = jax.vmap(
            lambda w, g, wt: jfused.fused_transit_folded(tabk, w, g, wt)
        )(*[jnp.asarray(a, jnp.float32) for a in args[1:]])
    got = fused.transit_folded_plain(_ft(fine, k, F32),
                                     *[_t(a, F32) for a in args[1:]])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4)


def test_eighteen_node_raygrid_k1_matches_bart_tpu():
    """fused_eclipse on the CPU (its plain path) with an 18-node
    raygrid against _single at float64 and the Pallas _kernel, which
    unrolls any node count, at float32."""
    _, args, powers = _eclipse_args("raygrid18", 4)
    assert len(args[2]) == 18 and not powers
    ref64 = jax.vmap(
        lambda w, t, d: jfused._single(*args[:4], w, t, d, powers=powers)
    )(*[jnp.asarray(a) for a in args[4:]])
    got64 = fused.fused_eclipse(*[_t(a) for a in args], powers=powers)
    np.testing.assert_allclose(got64.numpy(), np.asarray(ref64), rtol=1e-10)
    f32 = [jnp.asarray(a, jnp.float32) for a in args]
    with _pallas_interpret(jfused):
        ref32 = jax.vmap(
            lambda w, t, d: jfused.fused_eclipse(*f32[:4], w, t, d,
                                                 powers=powers)
        )(*f32[4:])
    got32 = fused.fused_eclipse(*[_t(a, F32) for a in args], powers=powers)
    np.testing.assert_allclose(got32.numpy(), np.asarray(ref32), rtol=5e-5)
    # more nodes move the flux: 18 angles are not the 5-angle result
    five = fused.eclipse_plain(*[_t(a) for a in args[:2]],
                               *[_t(a) for a in QUADS["raygrid"][0]],
                               *[_t(a) for a in args[4:]])
    assert float(((got64 - five) / five).abs().max()) > 1e-6


# ---------------------------------------------------------------------
# (c) the folded forward model at K = 6

NL, NW, K6 = 12, 64, 6


@pytest.fixture(scope="module")
def demo6():
    """The small demo problem of tests/test_torch_folded_forward.py on
    the 6-times-finer grid, its table built once by bart_tpu."""
    inp = demo_inputs(nlayer=NL, nwave=NW, nlines=300, t_step=520.0)
    grid = jbuild({"CH4": inp.lines}, folded_fine_grid(inp.wn, K6),
                  inp.t_grid, inp.pressure, cond_batch=80,
                  dtype=jnp.float64)
    return inp, grid


@pytest.mark.parametrize("geometry", ["eclipse-raygrid", "eclipse-expsum",
                                      "transit"])
def test_folded_forward_at_k6_matches_bart_tpu(demo6, geometry):
    inp, grid = demo6
    solution, _, quad = geometry.partition("-")
    transit = solution == "transit"
    if transit:
        bands = jbands(inp.wn, inp.filters)
        kw = inp.transit_config_kwargs
    else:
        bands = jbands(inp.wn, inp.filters, star_flux=inp.star_flux,
                       rprs=inp.system.rprs)
        kw = inp.config_kwargs
    cfg = dict(quadrature=quad or "raygrid", **kw, **CONTINUUM)
    common = dict(wn_grid=inp.wn, pressure=inp.pressure, species=inp.species,
                  base_abundances=inp.base_q, system=inp.system,
                  cia_tables=[inp.cia], fold_osamp=K6, fold_adapt=0.02)
    fmj = JModel(JConfig(**cfg), opacity=grid, bands=bands,
                 dtype=jnp.float64, **common)
    plain = build_demo_model(inp, dtype=F64, grid=_torch_grid(grid), fold=K6,
                             solution=solution, device="cpu")
    fmt = ForwardModel(ForwardConfig(**cfg), opacity=plain.opacity,
                       bands=plain.bands, dtype=F64, device="cpu", **common)
    assert fmt.fold == K6 and fmt.tables["tabk"].K == K6
    assert 0 < len(fmt._idx_fine) < NW
    np.testing.assert_array_equal(fmt._idx_fine, fmj._idx_fine)
    P = _params(DEMO_PARAMS_TRANSIT if transit else DEMO_PARAMS)
    bj, sj, vj = fmj.batched()(jnp.asarray(P))
    bt, st, vt = fmt(torch.tensor(P))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-9)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-9)
