"""bart_tpu_torch's equilibrium chemistry (chem/thermo.py, chem/tea.py)
against bart_tpu's, in float64 on the host.

The JAX package's own chemistry tests read an abundance table from a
reference checkout that this repository does not ship; here both packages
read the five-element excerpt of examples/torch_demo/abundances.txt.
Measured on the CPU: gibbs_rt agrees to the last bit for 25 of the 31
species the registry holds and to <= 2.0e-16 relative for the other six
(molecules whose q_approx the port evaluates in torch; tolerance 1e-12);
the equilibrium mole fractions agree to <= 2.9e-14 relative above a
mixing ratio of 1e-30 (tolerance 1e-9).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from bart_tpu.chem import tea as jtea
from bart_tpu.chem import thermo as jthermo
from bart_tpu.chem.thermo_tables import builtin_tables as jbuiltin_tables
from bart_tpu.io.abundances import read_elements as jread_elements

from bart_tpu_torch.chem import tea, thermo
from bart_tpu_torch.chem.thermo_tables import builtin_tables
from bart_tpu_torch.demo import DEMO_PARAMS, SYSTEM
from bart_tpu_torch.io.abundances import read_elements
from bart_tpu_torch.physics.pt import pt_generator
from bart_tpu_torch.utils.grids import pressure_grid

torch.set_num_threads(2)

ABUN = str(Path(__file__).resolve().parents[1] / "examples" / "torch_demo"
           / "abundances.txt")
#: the ten species of the equilibrium pipeline test (tests/test_pipeline.py)
SPECIES = ["H", "He", "C", "N", "O", "H2", "CO", "CO2", "CH4", "H2O"]
ELEMENTS = ["H", "He", "C", "N", "O"]
#: mole fractions compared above this mixing ratio
Q_FLOOR = 1e-30


@pytest.fixture(scope="module")
def elems():
    return read_elements(ABUN), jread_elements(ABUN)


def _line_profile(pt_params, n=100):
    """T [n] of the PT 'line' family on the demo pressure grid."""
    p = pressure_grid(n, 1e-5, 100.0)
    s = SYSTEM
    T, valid = pt_generator(
        torch.tensor(p), torch.tensor(pt_params)[None], "line",
        [s.r_star, s.t_star, 100.0, s.sma, s.g_planet_cgs, "const"])
    assert bool(valid[0])
    return p, T[0].numpy()


@pytest.mark.parametrize("species", sorted(set(thermo.D0_KJ_MOL)
                                           | set(thermo.ATOMS) | {"e-"}))
def test_gibbs_rt_matches(species):
    assert thermo.D0_KJ_MOL == jthermo.D0_KJ_MOL
    assert thermo.ATOMS == jthermo.ATOMS
    T = np.linspace(300.0, 3000.0, 28)
    try:
        ref = np.asarray(jthermo.gibbs_rt(species, T))
    except KeyError as e:       # not in the molecule registry: both raise
        with pytest.raises(KeyError, match=str(e.args[0])[:20]):
            thermo.gibbs_rt(species, T)
        return
    got = thermo.gibbs_rt(species, T)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    # a table overrides the analytic path in both
    tab = (np.array([200.0, 4000.0]), np.array([-10.0, -50.0]))
    np.testing.assert_array_equal(thermo.gibbs_rt(species, T, tab),
                                  np.asarray(jthermo.gibbs_rt(species, T,
                                                              tab)))


@pytest.mark.parametrize("thermofile", [None, "builtin"])
@pytest.mark.parametrize("pt", ["demo", "hot"])
def test_equilibrium_abundances_match(elems, thermofile, pt):
    """100 layers of the demo grid on a 'line' PT profile (the demo's,
    ~1400 K, and a hotter one reaching H2 dissociation at the top)."""
    pt_params = DEMO_PARAMS[:5] if pt == "demo" else \
        np.array([-1.0, 1.0, 1.0, 0.0, 1.15])
    p, T = _line_profile(pt_params)
    mine, theirs = elems
    g, jg = None, None
    if thermofile:
        g, jg = builtin_tables(SPECIES), jbuiltin_tables(SPECIES)
    got = tea.equilibrium_abundances(SPECIES, ELEMENTS, p, T, mine,
                                     g_tables=g)
    ref = np.asarray(jtea.equilibrium_abundances(SPECIES, ELEMENTS, p, T,
                                                 theirs, g_tables=jg))
    assert got.shape == ref.shape == (100, 10) and got.dtype == np.float64
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-12)
    big = ref > Q_FLOOR
    assert big.mean() > 0.5
    rel = np.abs(got - ref)[big] / ref[big]
    assert rel.max() < 1e-9, rel.max()
    np.testing.assert_array_equal(got <= Q_FLOOR, ref <= Q_FLOOR)
    # H2-dominated solar gas below the dissociation layers
    assert np.all(got[-50:, SPECIES.index("H2")] > 0.5)


def test_solve_equilibrium_and_stoich_matrix_match():
    A = tea._stoich_matrix(SPECIES + ["e-", "H-"], ELEMENTS + ["e"])
    np.testing.assert_array_equal(
        A, jtea._stoich_matrix(SPECIES + ["e-", "H-"], ELEMENTS + ["e"]))
    with pytest.raises(ValueError, match="not in the input element list"):
        tea._stoich_matrix(["TiO"], ELEMENTS)
    A = tea._stoich_matrix(SPECIES, ELEMENTS)
    T = np.array([800.0, 1600.0, 2600.0])
    g = np.stack([thermo.gibbs_rt(s, T) for s in SPECIES], axis=1)
    b = np.array([1.0, 0.08, 3e-4, 7e-5, 5e-4])
    lnp = np.log(np.array([1e-3, 1.0, 30.0]))
    got = tea.solve_equilibrium_batch(A, g, b, lnp)
    ref = np.asarray(jtea.solve_equilibrium_batch(A, g, b, lnp))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-300)
    one = tea.solve_equilibrium(A, g[1], b, lnp[1])
    assert isinstance(one, np.ndarray)
    np.testing.assert_allclose(
        one, np.asarray(jtea.solve_equilibrium(A, g[1], b, lnp[1])),
        rtol=1e-12, atol=1e-300)


def test_reaction_constant_exact():
    """H2 <-> 2H: the solution satisfies the analytic mass-action law
    (tests/test_chem.py:33-44, on the port's functions)."""
    A = tea._stoich_matrix(["H", "H2"], ["H"])
    for T in (2500.0, 3500.0, 5000.0):
        for lnp in (-2.0, 0.0, 2.0):
            g = np.array([float(thermo.gibbs_rt("H", T)),
                          float(thermo.gibbs_rt("H2", T))])
            x = tea.solve_equilibrium(A, g, np.array([1.0]), np.array(lnp))
            kp_model = x[0] ** 2 / x[1] * np.exp(lnp)
            kp_true = np.exp(-(2 * g[0] - g[1]))
            assert kp_model == pytest.approx(kp_true, rel=1e-8)


def test_partial_g_tables_warns(elems):
    tabs = builtin_tables(["CO", "H2O"])
    with pytest.warns(UserWarning, match="conventions"):
        tea.equilibrium_abundances(SPECIES, ELEMENTS, np.array([1.0]),
                                   np.array([1500.0]), elems[0],
                                   g_tables=tabs)
