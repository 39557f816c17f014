"""bart_tpu_torch keeps its own copies of the host-side helpers it needs
from bart_tpu (constants, the molecule registry, line lists and their
readers, grids and pressure files, the Kurucz reader and the stellar
blackbody, the planet system, the convergence diagnostics, the abundance,
atmosphere, filter and spectrum files, stoichiometry, the thermochemical
tables, the config and its preflight) and imports nothing of bart_tpu.
Each copy is held against its original, on small files the tests write
or the in-repo inputs of examples/torch_demo."""

import dataclasses
import re
import tempfile
from pathlib import Path

import numpy as np
import pytest

import bart_tpu.chem.thermo_species as jthermo_species
import bart_tpu.chem.thermo_tables as jthermo_tables
import bart_tpu.constants as jconst
import bart_tpu.driver.config as jconfig
import bart_tpu.driver.validate as jvalidate
import bart_tpu.inference.gr as jgr
import bart_tpu.io.abundances as jabundances
import bart_tpu.io.atm as jatm
import bart_tpu.io.filters as jfilters
import bart_tpu.io.kurucz as jkurucz
import bart_tpu.io.spectrum as jspectrum
import bart_tpu.inference.retrieval as jretrieval
import bart_tpu.io.tep as jtep
import bart_tpu.linelist.hitran as jhitran
import bart_tpu.linelist.molecules as jmol
import bart_tpu.linelist.tli as jtli
import bart_tpu.opacity.cia as jcia
import bart_tpu.physics.voigt as jvoigt
import bart_tpu.physics.stoich as jstoich
import bart_tpu.post.bestfit as jbestfit
import bart_tpu.utils.grids as jgrids

import bart_tpu_torch.chem.thermo_species as thermo_species
import bart_tpu_torch.chem.thermo_tables as thermo_tables
import bart_tpu_torch.constants as const
import bart_tpu_torch.driver.config as config
import bart_tpu_torch.driver.validate as validate
import bart_tpu_torch.inference.gr as gr
import bart_tpu_torch.inference.retrieval as retrieval
import bart_tpu_torch.io.abundances as abundances
import bart_tpu_torch.io.atm as atm
import bart_tpu_torch.io.filters as filters
import bart_tpu_torch.io.kurucz as kurucz
import bart_tpu_torch.io.spectrum as spectrum
import bart_tpu_torch.io.tep as tep
import bart_tpu_torch.linelist.hitran as hitran
import bart_tpu_torch.linelist.molecules as mol
import bart_tpu_torch.linelist.tli as tli
import bart_tpu_torch.opacity.cia as cia
import bart_tpu_torch.physics.voigt as voigt
import bart_tpu_torch.physics.stoich as stoich
import bart_tpu_torch.post.bestfit as bestfit
import bart_tpu_torch.utils.grids as grids

PORT = Path(const.__file__).resolve().parent
DEMO = PORT.parent / "examples" / "torch_demo"
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


def _fields_equal(a, b):
    """Two dataclass instances of the two packages, field by field."""
    fa = {f.name for f in dataclasses.fields(a)}
    assert fa == {f.name for f in dataclasses.fields(b)}
    for name in sorted(fa):
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name


def _abundances():
    path = str(DEMO / "abundances.txt")
    got, ref = abundances.read_elements(path), jabundances.read_elements(path)
    _fields_equal(got, ref)
    assert list(got.symbol) == ["H", "He", "C", "N", "O"]
    for args in ((1.0, False), (10.0, False), (0.3, True)):
        _fields_equal(abundances.scale_abundances(got, *args),
                      jabundances.scale_abundances(ref, *args))
    assert got.dex_of("C") == 8.43 and got.mass_of("O") == 15.9994
    with tempfile.TemporaryDirectory() as tmp:
        a, b = Path(tmp) / "a.abn", Path(tmp) / "b.abn"
        abundances.write_elements(got, str(a))
        jabundances.write_elements(ref, str(b))
        assert a.read_bytes() == b.read_bytes()


def _stoich():
    elems = abundances.read_elements(str(DEMO / "abundances.txt"))
    jelems = jabundances.read_elements(str(DEMO / "abundances.txt"))
    for name in ("H2O_g", "CO2", "CH4_g", "He_ref", "H_ion_n", "HCN",
                 "C2H6", "Na_ion_p", "H-", "e-"):
        assert stoich.strip_janaf(name) == jstoich.strip_janaf(name)
    for f in ("H2O", "CO2", "CH4", "C2H6", "H-", "Na+", "NH3", "TiO"):
        assert stoich.parse_formula(f) == jstoich.parse_formula(f), f
    for f in ("H2O", "CO2", "CH4", "H-", "N2", "NH3"):
        assert stoich.species_mass(f, elems) == \
            jstoich.species_mass(f, jelems), f
    with pytest.raises(ValueError, match="cannot parse"):
        stoich.parse_formula("h2o")
    species = ["H2", "He", "CH4", "H2O", "CO"]
    q = np.random.default_rng(5).dirichlet(np.ones(5), size=7)
    np.testing.assert_array_equal(
        stoich.mean_molar_mass(species, q, elems),
        jstoich.mean_molar_mass(species, q, jelems))


def _atm():
    rng = np.random.default_rng(6)
    L = 9
    args = (["H2", "He", "CH4_g", "H_ion_n"], np.logspace(-5, 2, L),
            rng.uniform(800, 2000, L), rng.dirichlet(np.ones(4), size=L),
            np.linspace(1.0e5, 0.9e5, L))
    with tempfile.TemporaryDirectory() as tmp:
        for write in ("write_atm_transit", "write_atm_tea"):
            for radius in (True, False):
                a = atm.Atmosphere(*args[:4], args[4] if radius else None)
                ja = jatm.Atmosphere(*args[:4], args[4] if radius else None)
                pa, pb = Path(tmp) / "a.atm", Path(tmp) / "b.atm"
                getattr(atm, write)(a, str(pa))
                getattr(jatm, write)(ja, str(pb))
                # the header names the writing package; the data agree
                assert pa.read_text().splitlines()[1:] == \
                    pb.read_text().splitlines()[1:]
                got, ref = atm.read_atm(str(pa)), jatm.read_atm(str(pb))
                _fields_equal(got, ref)
                _fields_equal(atm.read_atm(str(pb)), ref)


def _filters_and_spectrum():
    for k in range(1, 11):
        path = str(DEMO / "filters" / f"fdemo{k:02d}.dat")
        for got, ref in zip(filters.read_filter(path),
                            jfilters.read_filter(path)):
            np.testing.assert_array_equal(got, ref)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "spec.dat"
        wl = np.linspace(4.0, 2.0, 31)
        path.write_text("#wvl [um]    flux\n" + "".join(
            f"{w:.7e}  {np.sin(w):.7e}\n" for w in wl))
        for wn in (True, False):
            for got, ref in zip(spectrum.read_spectrum(str(path), wn=wn),
                                jspectrum.read_spectrum(str(path), wn=wn)):
                np.testing.assert_array_equal(got, ref)


def _kurucz_grid():
    from test_real_formats import _pck_text

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "grid.pck"
        path.write_text(_pck_text())
        got, ref = kurucz.read_kurucz_pck(str(path)), \
            jkurucz.read_kurucz_pck(str(path))
        _fields_equal(got, ref)
        for mode in ("nearest", "interp", "spline"):
            for t, g in ((5800.0, 4.4), (5900.0, 4.1), (6100.0, 4.6)):
                a = kurucz.stellar_flux(got, t, g, mode=mode)
                b = jkurucz.stellar_flux(ref, t, g, mode=mode)
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)


def _hitran_par():
    from test_real_formats import PAR_FIXTURE, _par_record

    for species in (None, "CO", "CH4"):
        got = hitran.parse_par_bytes(PAR_FIXTURE.encode(), species)
        ref = jhitran.parse_par_bytes(PAR_FIXTURE.encode(), species)
        assert list(got) == list(ref)
        for name in got:
            _lines_equal(got[name], ref[name])
    rec = _par_record(5, 1, " 2147.081134", " 2.706D-19", " 3.366E+01",
                      "     ", ".0664", "    0.0000", "0.69", "-.000026")
    bad = rec[:3] + "  GARBAGE   " + rec[15:]
    dirty = (rec[:59] + "\r\n" + "# comment\n" + bad + "\nshort\n").encode()
    reports = [hitran.ParseReport(path="x"), jhitran.ParseReport(path="x")]
    got = hitran.parse_par_bytes(dirty, on_error="skip", report=reports[0])
    ref = jhitran.parse_par_bytes(dirty, on_error="skip", report=reports[1])
    _lines_equal(got["CO"], ref["CO"])
    assert dataclasses.asdict(reports[0]) == dataclasses.asdict(reports[1])
    assert reports[0].summary() == reports[1].summary()
    for mod in (hitran, jhitran):
        with pytest.raises(ValueError, match="shorter than"):
            mod.parse_par_bytes(dirty)
        with pytest.raises(ValueError, match="GARBAGE"):
            mod.parse_par_bytes((bad + "\n").encode())
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "lines.par"
        path.write_text(PAR_FIXTURE)
        got, ref = hitran.read_par(str(path)), jhitran.read_par(str(path))
        assert list(got) == list(ref)
        for name in got:
            _lines_equal(got[name], ref[name])


def _cia_hitran():
    from test_real_formats import BORYSOW_CIA, HITRAN_CIA

    with tempfile.TemporaryDirectory() as tmp:
        for text, reader in ((HITRAN_CIA, "read_cia_hitran"),
                             (BORYSOW_CIA, "read_cia")):
            path = Path(tmp) / "cia.dat"
            path.write_text(text)
            _fields_equal(getattr(cia, reader)(str(path)),
                          getattr(jcia, reader)(str(path)))
        # the pipeline reads read_cia, then read_cia_hitran on its
        # ValueError: a HITRAN file is no grid table
        path.write_text(HITRAN_CIA)
        with pytest.raises(ValueError):
            cia.read_cia(str(path))


def _write_cia():
    """write_cia: the port's file equals bart_tpu's byte for byte, on a
    table drawn from a seed and on the in-repo H2-H2 table, and both
    packages' read_cia read it back alike."""
    rng = np.random.default_rng(5)
    drawn = dict(species=("H2", "He"),
                 temps=np.array([200.0, 350.5, 1000.0, 3000.25]),
                 wn=np.sort(rng.uniform(20.0, 9000.0, 37)),
                 absorption=10.0 ** rng.uniform(-12, -3, (4, 37)))
    demo = cia.read_cia(str(PORT.parent / "examples" / "demo_inputs"
                            / "CIA_H2H2_demo.dat"))
    with tempfile.TemporaryDirectory() as tmp:
        for k, fields in enumerate((drawn, dataclasses.asdict(demo))):
            a, b = Path(tmp) / f"port{k}.dat", Path(tmp) / f"jax{k}.dat"
            cia.write_cia(cia.CiaTable(**fields), str(a))
            jcia.write_cia(jcia.CiaTable(**fields), str(b))
            assert a.read_bytes() == b.read_bytes()
            got, ref = cia.read_cia(str(a)), jcia.read_cia(str(a))
            _fields_equal(got, ref)
            assert got.species == tuple(fields["species"])
            np.testing.assert_allclose(got.absorption, fields["absorption"],
                                       rtol=5e-7)


def _voigt_constants():
    assert "SQRT_LN2" in voigt.__all__ and "SQRT_PI" in voigt.__all__
    assert set(voigt.__all__) == set(jvoigt.__all__)
    assert voigt.SQRT_LN2 == jvoigt.SQRT_LN2           # to the last bit
    assert voigt.SQRT_PI == jvoigt.SQRT_PI


def _pressure_file_and_wn_grid():
    with tempfile.TemporaryDirectory() as tmp:
        a, b = Path(tmp) / "a.pres", Path(tmp) / "b.pres"
        p = grids.pressure_grid(37, 1e-6, 300.0)
        grids.write_pressure_file(p, str(a))
        jgrids.write_pressure_file(p, str(b))
        assert a.read_bytes() == b.read_bytes()
        np.testing.assert_array_equal(grids.read_pressure_file(str(a)),
                                      jgrids.read_pressure_file(str(a)))
    for kw in (dict(wllow=2.0, wlhigh=4.0, wndelt=1.0),
               dict(wnlow=2500.0, wnhigh=5000.0, wndelt=25.0),
               dict(wnlow=2.5, wnhigh=5.0, wndelt=0.3, wnfct=1000.0),
               dict(wllow=1.0, wlhigh=3.0, wlfct=1e-4, wndelt=7.0)):
        np.testing.assert_array_equal(grids.wavenumber_grid(**kw),
                                      jgrids.wavenumber_grid(**kw))
    for mod in (grids, jgrids):
        with pytest.raises(ValueError, match="bounds"):
            mod.wavenumber_grid(wndelt=1.0)


def _tli():
    src = PORT.parent / "examples" / "demo_inputs" / "CH4_demo.tli.npz"
    got, ref = tli.load_tli(str(src)), jtli.load_tli(str(src))
    assert (got.species, got.wn_min, got.wn_max) == \
        (ref.species, ref.wn_min, ref.wn_max)
    _lines_equal(got.lines["CH4"], ref.lines["CH4"])
    assert got.total_lines() == ref.total_lines() == 30000
    lines = {"CH4": got.lines["CH4"].strongest(50),
             "CO": tli.synthetic_linelist("CO", 2000.0, 2300.0, 20, seed=2)}
    part = {"CO": (np.array([100.0, 1000.0, 3000.0]),
                   np.array([36.0, 360.0, 1100.0]))}
    with tempfile.TemporaryDirectory() as tmp:
        for mod, jmod in ((tli, jtli), (jtli, tli)):
            path = str(Path(tmp) / "x.tli.npz")
            mod.save_tli(mod.TliData(list(lines), lines, 2000.0, 5000.0,
                                     part), path)
            a, b = mod.load_tli(path), jmod.load_tli(path)
            assert a.species == b.species == ["CH4", "CO"]
            for name in lines:
                _lines_equal(a.lines[name], b.lines[name])
                _lines_equal(a.lines[name], lines[name])
            assert list(a.partition) == list(b.partition) == ["CO"]
            for x, y in zip(a.partition["CO"], b.partition["CO"]):
                np.testing.assert_array_equal(x, y)


def _thermo_tables():
    recs, jrecs = (m.read_nasa7(m.BUILTIN_NASA7)
                   for m in (thermo_tables, jthermo_tables))
    assert list(recs) == list(jrecs) and len(recs) >= 10
    t_grid = np.linspace(300.0, 3000.0, 19)
    for name in recs:
        for got, ref in zip(thermo_tables.g_table_nasa7(recs[name], t_grid),
                            jthermo_tables.g_table_nasa7(jrecs[name],
                                                         t_grid)):
            np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            thermo_tables.nasa7_gibbs_rt(recs[name], t_grid),
            jthermo_tables.nasa7_gibbs_rt(jrecs[name], t_grid))
    species = ["H", "He", "C", "N", "O", "H2", "CO", "CO2", "CH4", "H2O",
               "TiO", "Na+", "e-"]
    for got, ref in ((thermo_tables.builtin_tables(species),
                      jthermo_tables.builtin_tables(species)),
                     (thermo_species.computed_tables(),
                      jthermo_species.computed_tables())):
        assert list(got) == list(ref)
        for name in got:
            for x, y in zip(got[name], ref[name]):
                np.testing.assert_array_equal(x, y, err_msg=name)
    for mod in (thermo_tables, jthermo_tables):
        with pytest.raises(KeyError, match="XeF6"):
            mod.builtin_tables(["CO", "XeF6"])


def _config():
    import warnings

    for name in ("eclipse", "transit", "eclipse_tea", "eclipse_fold",
                 "transit_fold", "eclipse_fold_f32"):
        path = str(DEMO / f"{name}.cfg")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # both warn about wnosamp
            got, ref = config.load_config(path), jconfig.load_config(path)
            over = {"numit": "1234", "uniform": "None", "rtosamp": "4",
                    "molfit": "CH4 H2O", "quiet": "True"}
            got_o = config.load_config(path, over)
            ref_o = jconfig.load_config(path, over)
        for a, b in ((got, ref), (got_o, ref_o)):
            _fields_equal(a, b)
            assert a.fold_K == b.fold_K
            np.testing.assert_array_equal(a.wavenumber_grid(),
                                          b.wavenumber_grid())
        assert got.tep_name == str(DEMO / "system.tep")
        np.testing.assert_array_equal(
            config.load_data_array(got.data),
            jconfig.load_data_array(ref.data))
        assert len(config.load_data_array(got.data)) == 10
    for name in ("eclipse_fold", "transit_fold"):
        fold = config.load_config(str(DEMO / f"{name}.cfg"))
        assert (fold.fold_K, fold.rtadapt, fold.foldtable16) == (32, True,
                                                                True)
    # the reference's default: float32 fine tables
    fold = config.load_config(str(DEMO / "eclipse_fold_f32.cfg"))
    assert (fold.fold_K, fold.rtadapt, fold.foldtable16) == (32, True, False)
    assert config.load_config(str(DEMO / "transit_fold.cfg")).solution \
        == "transit"
    # every default but abun_basic, a file of a reference checkout that
    # the port does not name
    got, ref = config.RetrievalConfig(), jconfig.RetrievalConfig()
    assert got.abun_basic is None and ref.abun_basic.endswith(
        "abundances_Asplund2009.txt")
    got.abun_basic = ref.abun_basic
    _fields_equal(got, ref)
    for v in ("1.0 2e-3", None, "None", np.ones(3)):
        a, b = config.load_data_array(v), jconfig.load_data_array(v)
        assert (a is None and b is None) or np.array_equal(a, b)


def _validate():
    """The messages of tests/test_pipeline.py:229's fault cases, on the
    demo eclipse cfg: the port's preflight says what bart_tpu's says."""
    import warnings

    path = str(DEMO / "eclipse.cfg")

    def issues(mod, cmod, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cfg = cmod.load_config(path)
        for k, v in kw.items():
            setattr(cfg, k, v)
        return mod.validate_config(cfg, str(DEMO))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        base = config.load_config(path)
    p = np.asarray(base.params).copy()
    p[0] = 99.0
    ss = np.asarray(base.stepsize).copy()
    ss[-1] = -99.0
    cases = [
        {},
        dict(data=np.ones(7)),
        dict(params=p),
        dict(params=np.ones(3), pmin=-np.ones(3), pmax=2 * np.ones(3),
             stepsize=0.1 * np.ones(3), parnames=["a", "b", "c"]),
        dict(molfit=["XeF6"]),
        dict(linedb="/no/such/file.npz", opacityfile=None),
        dict(stepsize=ss),
        dict(uncert=-np.ones(10)),
        dict(tep_name=None, walk="banana", quadrature="gauss"),
    ]
    expect = ["", "7 entries", "outside [pmin, pmax]", "expects", "XeF6",
              "linedb", "shares parameter", "non-positive", "tep_name"]
    for kw, want in zip(cases, expect):
        got = issues(validate, config, **kw)
        assert got == issues(jvalidate, jconfig, **kw), kw
        assert bool(got[0]) == bool(want), (kw, got)
        assert any(want in s for s in got[0]) or not want, (kw, got)


def _demo_inputs():
    """examples/torch_demo/make_inputs.py's system and filters read back,
    by both packages' readers, to demo.py's SYSTEM and demo_filters()."""
    from bart_tpu_torch.demo import SYSTEM, demo_filters

    path = str(DEMO / "system.tep")
    got, ref = tep.PlanetSystem.from_tep(path), \
        jtep.PlanetSystem.from_tep(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for name, value in dataclasses.asdict(SYSTEM).items():
        assert getattr(got, name) == pytest.approx(value, rel=1e-15), name
    for k, (wn, resp) in enumerate(demo_filters(), start=1):
        fw, ft = filters.read_filter(str(DEMO / "filters"
                                         / f"fdemo{k:02d}.dat"))
        np.testing.assert_allclose(fw, wn, rtol=1e-14)
        np.testing.assert_array_equal(ft, resp)


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
    "abundances": _abundances,
    "stoich": _stoich,
    "atm": _atm,
    "filters_and_spectrum": _filters_and_spectrum,
    "kurucz_grid": _kurucz_grid,
    "hitran_par": _hitran_par,
    "cia_hitran": _cia_hitran,
    "write_cia": _write_cia,
    "voigt_constants": _voigt_constants,
    "pressure_file_and_wn_grid": _pressure_file_and_wn_grid,
    "tli": _tli,
    "thermo_tables": _thermo_tables,
    "config": _config,
    "validate": _validate,
    "demo_inputs": _demo_inputs,
}


@pytest.mark.parametrize("name", list(COPIES))
def test_copy_equals_the_original(name):
    COPIES[name]()


def test_no_module_of_the_port_imports_bart_tpu():
    pat = re.compile(r"^\s*(from|import)\s+bart_tpu(\s|\.)", re.M)
    files = sorted(PORT.rglob("*.py")) + [
        PORT.parent / name for name in ("chip_smoke.py", "bench_torch.py",
                                        "examples/torch_demo/quickstart.py")]
    assert len(files) > 30
    for f in files:
        assert not pat.search(f.read_text()), f
