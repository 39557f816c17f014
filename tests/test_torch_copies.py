"""bart_tpu_torch keeps its own copies of the host-side helpers it needs
from bart_tpu (constants, the molecule registry, line lists, grids, the
stellar blackbody, the planet system, the convergence diagnostics) and
imports nothing of bart_tpu.  Each copy is held against its original."""

import dataclasses
import re
import tempfile
from pathlib import Path

import numpy as np
import pytest

import bart_tpu.constants as jconst
import bart_tpu.inference.gr as jgr
import bart_tpu.io.kurucz as jkurucz
import bart_tpu.inference.retrieval as jretrieval
import bart_tpu.io.tep as jtep
import bart_tpu.linelist.hitran as jhitran
import bart_tpu.linelist.molecules as jmol
import bart_tpu.linelist.tli as jtli
import bart_tpu.post.bestfit as jbestfit
import bart_tpu.utils.grids as jgrids

import bart_tpu_torch.constants as const
import bart_tpu_torch.inference.gr as gr
import bart_tpu_torch.inference.retrieval as retrieval
import bart_tpu_torch.io.kurucz as kurucz
import bart_tpu_torch.io.tep as tep
import bart_tpu_torch.linelist.hitran as hitran
import bart_tpu_torch.linelist.molecules as mol
import bart_tpu_torch.linelist.tli as tli
import bart_tpu_torch.post.bestfit as bestfit
import bart_tpu_torch.utils.grids as grids

PORT = Path(const.__file__).resolve().parent
SYSTEM = (6075.0, 7.97e8, 4.37, 7.05e9, 9.44e7, 1.32e27)


def _lines_equal(a, b):
    assert a.species == b.species and a.nlines == b.nlines
    for f in dataclasses.fields(a):
        if f.name != "species":
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name), err_msg=f.name)


def _constants():
    names = [n for n in dir(jconst) if n.isupper()]
    assert len(names) >= 20 and names == [n for n in dir(const)
                                          if n.isupper()]
    for n in names:
        assert getattr(const, n) == getattr(jconst, n), n     # to the last bit


def _molecules():
    assert list(mol.MOLECULES) == list(jmol.MOLECULES)
    for name in jmol.MOLECULES:
        assert dataclasses.asdict(mol.get_molecule(name)) \
            == dataclasses.asdict(jmol.get_molecule(name)), name
    assert mol.HITRAN_IDS == jmol.HITRAN_IDS
    with pytest.raises(KeyError, match="registry"):
        mol.get_molecule("Xx")


def _synthetic_linelist():
    kw = dict(seed=12, band_centers=(2700.0, 3100.0, 4300.0))
    got = tli.synthetic_linelist("CH4", 2500.0, 5000.0, 200, **kw)
    ref = jtli.synthetic_linelist("CH4", 2500.0, 5000.0, 200, **kw)
    _lines_equal(got, ref)
    _lines_equal(tli.synthetic_linelist("CO", 100.0, 900.0, 50, seed=3),
                 jtli.synthetic_linelist("CO", 100.0, 900.0, 50, seed=3))
    assert isinstance(got, hitran.LineList) and hitran.TREF == jhitran.TREF
    # the container's methods, on the same lines
    for call in (lambda l: l.trim(2900.0, 3300.0), lambda l: l.strongest(40),
                 lambda l: l.cull(1e-3),
                 lambda l: type(l).concatenate([l.trim(2500.0, 3000.0),
                                                l.trim(3000.0, 5000.0)])):
        _lines_equal(call(got), call(ref))


def _pressure_grid():
    for args in ((100, 1e-5, 100.0), (7, 1e-3, 10.0, False)):
        np.testing.assert_array_equal(grids.pressure_grid(*args),
                                      jgrids.pressure_grid(*args))


def _folded_fine_grid():
    wn = np.linspace(2500.0, 5000.0, 41)
    for k in (1, 2, 4, 32):
        np.testing.assert_array_equal(grids.folded_fine_grid(wn, k),
                                      jgrids.folded_fine_grid(wn, k))
    fine = grids.folded_fine_grid(wn, 4)
    assert fine.shape == (164,) and np.all(np.diff(fine) > 0)
    np.testing.assert_allclose(fine.reshape(41, 4).mean(1), wn, rtol=1e-14)


def _blackbody_star():
    wn = np.linspace(2500.0, 5000.0, 97)
    for got, ref in zip(kurucz.blackbody_star(wn, 6075.0),
                        jkurucz.blackbody_star(wn, 6075.0)):
        np.testing.assert_array_equal(got, ref)


def _planet_system():
    got, ref = tep.PlanetSystem(*SYSTEM), jtep.PlanetSystem(*SYSTEM)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for prop in ("g_planet_si", "g_planet_cgs", "rprs", "teff_planet"):
        assert getattr(got, prop) == getattr(ref, prop), prop


def _convergence_diagnostics():
    rng = np.random.default_rng(3)
    # correlated chains with distinct means, and a constant parameter
    chains = np.cumsum(rng.normal(0, 1, (6, 200, 3)), axis=1) * 0.1 \
        + rng.normal(0, 1, (6, 1, 3))
    chains[:, :, 2] = 1.5
    for name in ("gelman_rubin", "split_rhat_rank", "effective_sample_size"):
        np.testing.assert_array_equal(getattr(gr, name)(chains),
                                      getattr(jgr, name)(chains), err_msg=name)


def _sample_store():
    with tempfile.TemporaryDirectory() as tmp:
        _sample_stores(Path(tmp))


def _sample_stores(tmp_path):
    rng = np.random.default_rng(4)
    blocks = [rng.normal(size=(5, 3, 2)) for _ in range(3)]
    for path in (None, "store"):
        stores = [mod._SampleStore(
            3, 2, 20, np.float64,
            None if path is None else str(tmp_path / f"{path}{i}.dat"), n0=2)
            for i, mod in enumerate((retrieval, jretrieval))]
        for s in stores:
            for b in blocks:
                s.append(b)
            s.flush()
        got, ref = stores
        assert got.n == ref.n == 17
        np.testing.assert_array_equal(got.iterations(4), ref.iterations(4))
        np.testing.assert_array_equal(got.samples(2, 3), ref.samples(2, 3))
        if path is not None:     # the memmap sidecar, as written to disk
            assert (tmp_path / "store0.dat").read_bytes() == \
                (tmp_path / "store1.dat").read_bytes()


def _read_mcmc_log():
    """Both readers on the port's own MCMC.log: its best fit, to the
    printed precision (8 significant digits)."""
    import torch

    from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace

    space = ParamSpace([0.0, 0.0, 2.0], [-5, -5, 0], [5, 5, 4],
                       [0.1, 0.1, 0.0], pnames=["a", "b", "c"])

    def fwd(p):
        return p, p, torch.ones(p.shape[0], dtype=torch.bool)

    like = Likelihood(fwd, space, np.array([1.0, -1.0, 2.0]),
                      np.full(3, 0.3), device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        log = str(Path(tmp) / "MCMC.log")
        res = retrieval.run_mcmc(like, space, nchains=4, numit=400,
                                 burnin=20, block=20, seed=2, verbose=False,
                                 logfile=log)
        got, ref = bestfit.read_mcmc_log(log), jbestfit.read_mcmc_log(log)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        assert got[0].shape == (2,)
        np.testing.assert_allclose(got[0], res.bestp, rtol=1e-7)
        assert np.all(got[1] > 0)
        Path(log).write_text("no block\n")
        with pytest.raises(ValueError, match="Best-fit"):
            bestfit.read_mcmc_log(log)


COPIES = {
    "constants": _constants,
    "molecules": _molecules,
    "synthetic_linelist": _synthetic_linelist,
    "pressure_grid": _pressure_grid,
    "folded_fine_grid": _folded_fine_grid,
    "blackbody_star": _blackbody_star,
    "planet_system": _planet_system,
    "convergence_diagnostics": _convergence_diagnostics,
    "sample_store": _sample_store,
    "read_mcmc_log": _read_mcmc_log,
}


@pytest.mark.parametrize("name", list(COPIES))
def test_copy_equals_the_original(name):
    COPIES[name]()


def test_no_module_of_the_port_imports_bart_tpu():
    pat = re.compile(r"^\s*(from|import)\s+bart_tpu(\s|\.)", re.M)
    files = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    assert len(files) > 30
    for f in files:
        assert not pat.search(f.read_text()), f
