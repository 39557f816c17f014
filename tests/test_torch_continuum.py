"""bart_tpu_torch CIA, Rayleigh and gray-cloud opacity against bart_tpu
at float64: the CIA reader on the in-repo demo table, the CIA
interpolation (T exactly on a node, beyond both ends, wn outside the
table), both Rayleigh modes, and the three cloud profiles, batched over
chains where the forward model batches them.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bart_tpu.opacity.cia as jcia
import bart_tpu.opacity.cloud as jcloud
import bart_tpu.opacity.rayleigh as jray

from bart_tpu_torch.opacity import cia, cloud, rayleigh

F64 = torch.float64
CIA_FILE = (Path(__file__).resolve().parents[1] / "examples" / "demo_inputs"
            / "CIA_H2H2_demo.dat")


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=F64)


@pytest.fixture(scope="module")
def table():
    return cia.read_cia(str(CIA_FILE))


def test_read_cia_matches(table, tmp_path):
    ref = jcia.read_cia(str(CIA_FILE))
    assert table.species == ref.species == ("H2", "H2")
    assert table.absorption.shape == (14, 200)
    for f in ("temps", "wn", "absorption"):
        np.testing.assert_array_equal(getattr(table, f), getattr(ref, f))
    bad = tmp_path / "bad.dat"
    bad.write_text("# nothing here\n")
    with pytest.raises(ValueError, match="not a CIA grid table"):
        cia.read_cia(str(bad))


def test_cia_extinction_matches_batched(table):
    rng = np.random.default_rng(3)
    C, L = 3, 23
    # wn beyond the table on both sides; T on nodes, between, beyond
    wn = np.linspace(1500.0, 6500.0, 300)
    T = rng.uniform(300.0, 3200.0, (C, L))
    T[0, :6] = [400.0, 600.0, 1000.0, 3000.0, 350.0, 3500.0]
    n1 = rng.uniform(1e-3, 10.0, (C, L))
    n2 = rng.uniform(1e-3, 10.0, (C, L))
    got = cia.cia_extinction(t64(table.temps), t64(table.wn),
                             t64(table.absorption), t64(wn), t64(T),
                             t64(n1), t64(n2)).numpy()
    assert got.shape == (C, L, 300)
    for c in range(C):
        ref = jcia.cia_extinction(table.temps, table.wn, table.absorption,
                                  wn, T[c], n1[c], n2[c])
        np.testing.assert_allclose(got[c], np.asarray(ref), rtol=1e-10,
                                   atol=0.0)
    assert np.all(got[:, :, wn < 2000.0] == 0.0)
    assert np.all(got[:, :, wn > 6000.0] == 0.0)


def test_cia_weights_bracket_nodes_from_the_left(table):
    """T exactly on node k > 0 takes bracket k-1 with fraction 1
    (searchsorted side left), as bart_tpu's _fused_rows
    (bart_tpu/rt/forward.py:598-604, repeated here in jnp)."""
    T = np.array([[400.0, 600.0, 1400.0, 3000.0, 100.0, 5000.0, 700.0]])
    w = cia.cia_weights(t64(table.temps), t64(T))[0].numpy()
    temps = jnp.asarray(table.temps)
    it = jnp.clip(jnp.searchsorted(temps, T[0]) - 1, 0, 12)
    f = jnp.clip((T[0] - temps[it]) / (temps[it + 1] - temps[it]), 0.0, 1.0)
    iota = jnp.arange(14)
    ref = jnp.where(iota == it[:, None], 1.0 - f[:, None], 0.0)
    ref = jnp.where(iota == it[:, None] + 1, ref + f[:, None], ref)
    np.testing.assert_array_equal(w, np.asarray(ref))
    assert w[1, 0] == 0.0 and w[1, 1] == 1.0      # 600 K: upper end of [0, 1]
    assert w[4, 0] == 1.0 and w[5, 13] == 1.0     # clamped at both ends
    np.testing.assert_allclose(w[6, 1:3], [0.5, 0.5], rtol=1e-15)


def test_rayleigh_matches_both_modes():
    rng = np.random.default_rng(5)
    wn = np.linspace(2500.0, 5000.0, 200)
    np.testing.assert_allclose(
        rayleigh.h2_rayleigh_cross_section(t64(wn)).numpy(),
        np.asarray(jray.h2_rayleigh_cross_section(jnp.asarray(wn))),
        rtol=1e-12)
    # the host (numpy) form the forward model's set-up uses
    np.testing.assert_allclose(
        rayleigh.h2_rayleigh_cross_section(wn),
        rayleigh.h2_rayleigh_cross_section(t64(wn)).numpy(), rtol=1e-14)
    n_h2 = rng.uniform(1e10, 1e18, (3, 23))
    logf = np.array([-1.0, 0.3, 2.0])
    for mode in (1, 2):
        got = rayleigh.rayleigh_extinction(t64(wn), t64(n_h2), t64(logf),
                                           mode=mode).numpy()
        for c in range(3):
            ref = jray.rayleigh_extinction(wn, n_h2[c], logf[c], mode=mode)
            np.testing.assert_allclose(got[c], np.asarray(ref), rtol=1e-12)
    one = rayleigh.rayleigh_extinction(t64(wn), t64(n_h2[0]), 0.3).numpy()
    np.testing.assert_allclose(
        one, np.asarray(jray.rayleigh_extinction(wn, n_h2[0], 0.3)),
        rtol=1e-12)


def test_cloud_profiles_match():
    p = np.logspace(-5, 2, 23)
    ptop = np.array([1e-3, 0.05, 10.0])
    got = cloud.cloud_deck_extinction(t64(p), t64(np.log10(ptop)), 4).numpy()
    assert got.shape == (3, 23, 4)
    for c in range(3):
        ref = jcloud.cloud_deck_extinction(p, np.log10(ptop[c]), 4)
        np.testing.assert_allclose(got[c], np.asarray(ref), rtol=1e-12,
                                   atol=1e-300)
    np.testing.assert_allclose(
        cloud.cloud_deck_extinction(t64(p), -1.5, 2).numpy(),
        np.asarray(jcloud.cloud_deck_extinction(p, -1.5, 2)), rtol=1e-12)

    rad_km = 94400.0 - np.cumsum(np.random.default_rng(2).uniform(
        30.0, 80.0, (3, 23)), axis=1)
    got = cloud.extended_cloud_extinction(t64(rad_km), 94000.0, 93500.0,
                                          0.02).numpy()
    for c in range(3):
        ref = jcloud.extended_cloud_extinction(rad_km[c], 94000.0, 93500.0,
                                               0.02)
        np.testing.assert_allclose(got[c], np.asarray(ref), rtol=1e-12)
    assert got.min() == 0.0 and got.max() == 0.02

    got = cloud.gray_extinction(t64(p), 1e-3, 1.0, 0.5, 6).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jcloud.gray_extinction(p, 1e-3, 1.0, 0.5, 6)))
