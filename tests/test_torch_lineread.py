"""bart_tpu_torch's line-list entry points against bart_tpu's, bit for
bit, on synthetic files each test writes (as tests/test_lineread.py and
tests/test_real_formats.py do): the ExoMol readers (plain and gzip, with
.broad files), the Partridge-Schwenke and Schwenke TiO binaries, Plez
VO, the Kurucz partition tables, the native HITRAN scanner against both
packages' parsers (and its build from several processes at once), the
lineread CLI with --validate and a multi-database merge, and the widths
tool on the demo cfgs."""

import gzip
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest

import bart_tpu.linelist.exomol as jexo
import bart_tpu.linelist.kurucz_mol as jkur
import bart_tpu.linelist.lineread as jlr
from bart_tpu.driver.config import load_config as jload_config
from bart_tpu.linelist.hitran import parse_par_bytes as jparse
from bart_tpu.linelist.hitran import read_par as jread_par
from bart_tpu.linelist.tli import load_tli as jload_tli
from bart_tpu.native import hitran_native as jnative
from bart_tpu.tools import widths as jwidths

import bart_tpu_torch.linelist.exomol as exo
import bart_tpu_torch.linelist.kurucz_mol as kur
import bart_tpu_torch.linelist.lineread as lr
from bart_tpu_torch.driver.config import load_config
from bart_tpu_torch.linelist.hitran import parse_par_bytes, read_par
from bart_tpu_torch.linelist.tli import load_tli
from bart_tpu_torch.native import hitran_native
from bart_tpu_torch.tools import widths

from test_real_formats import PAR_FIXTURE, _par_record

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("wn0", "s296", "elower", "gamma_air", "gamma_self", "n_air", "iso")


def _same_lines(a, b):
    """Two LineLists equal field for field, bit for bit."""
    assert a.species == b.species
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _same_dicts(a, b):
    assert list(a) == list(b)
    for k in a:
        _same_lines(a[k], b[k])


def _exomol_files(d: Path, gz: bool):
    """A .states/.trans/.pf triplet (gzip-compressed when ``gz``) and two
    .broad files: 6 states, 7 transitions between 900 and 4400 cm-1."""
    rng = np.random.default_rng(11)
    e = np.array([0.0, 120.5, 1500.0, 2200.25, 3100.0, 4400.75])
    states = "".join(f"{i + 1}  {e[i]:.4f}  {4 * (i + 1)}  {i % 4}\n"
                     for i in range(6))
    pairs = [(3, 1), (4, 1), (5, 2), (5, 1), (6, 2), (6, 3), (4, 2)]
    trans = "".join(f"{u}  {lo}  {a:.5e}\n" for (u, lo), a in
                    zip(pairs, 10 ** rng.uniform(-4, 1, len(pairs))))
    paths = {}
    for name, text in (("mol.states", states), ("mol.trans", trans)):
        if gz:
            p = d / (name + ".gz")
            with gzip.open(p, "wt") as f:
                f.write(text)
        else:
            p = d / name
            p.write_text(text)
        paths[name] = str(p)
    (d / "mol.pf").write_text("100 50.0\n296 107.1\n1000 300.0\n")
    (d / "mol__H2.broad").write_text(
        "a0  0.0800  0.40  0\na0  0.0700  0.45  1\na0  0.0650  0.5  2\n")
    (d / "mol__He.broad").write_text("a1  0.0400  0.30\n")
    return (paths["mol.states"], paths["mol.trans"], str(d / "mol.pf"),
            [(str(d / "mol__H2.broad"), 0.85), (str(d / "mol__He.broad"),
                                                0.15)])


@pytest.mark.parametrize("gz", [False, True])
def test_exomol_readers_match(tmp_path, gz):
    states, trans, pf, broad = _exomol_files(tmp_path, gz)
    for fn, path in (("read_states", states), ("read_trans", trans),
                     ("read_pf", pf), ("read_broad", broad[0][0]),
                     ("read_broad", broad[1][0])):
        for x, y in zip(getattr(exo, fn)(path), getattr(jexo, fn)(path)):
            np.testing.assert_array_equal(x, y, err_msg=fn)
    for kw in (dict(pf_path=pf), dict(pf_path=None),
               dict(pf_path=pf, broadeners=broad, wn_min=1000.0,
                    wn_max=4000.0)):
        got = exo.read_exomol(states, trans, "CO", **kw)
        ref = jexo.read_exomol(states, trans, "CO", **kw)
        assert got.nlines >= 3
        _same_lines(got, ref)


def _kurucz_lines(n=60, seed=5):
    rng = np.random.default_rng(seed)
    wl = np.sort(rng.uniform(2000.0, 5000.0, n))            # nm
    return (wl, np.round(rng.uniform(0.0, 8000.0, n)),
            10 ** rng.uniform(-8, -2, n), rng.integers(0, 4, n))


def test_kurucz_binaries_match(tmp_path):
    """write_ps_binary byte for byte; read_ps_binary (8-byte records) and
    read_tio_binary (16-byte) with and without a window and a partition
    table; read_kurucz_partition; gf_to_s296."""
    wl, elo, gf, iso = _kurucz_lines()
    for rs in (8, 16):
        a, b = tmp_path / f"port{rs}.bin", tmp_path / f"jax{rs}.bin"
        kur.write_ps_binary(str(a), wl, elo, gf, iso, record_size=rs)
        jkur.write_ps_binary(str(b), wl, elo, gf, iso, record_size=rs)
        assert a.read_bytes() == b.read_bytes()
    part = tmp_path / "h2opartfn.dat"
    part.write_text("Partition functions\n   T  a b c d\n"
                    "  100.0  50.0  51.0  52.0  53.0\n"
                    "  296.0 174.0 176.0 178.0 180.0\n"
                    " 1000.0 900.0 910.0 920.0 930.0\n")
    pf = kur.read_kurucz_partition(str(part))
    for x, y in zip(pf, jkur.read_kurucz_partition(str(part))):
        np.testing.assert_array_equal(x, y)
    for window in ((0.0, np.inf), (2500.0, 4000.0)):
        for table in (None, pf):
            _same_lines(
                kur.read_ps_binary(str(tmp_path / "port8.bin"), "H2O",
                                   *window, table),
                jkur.read_ps_binary(str(tmp_path / "port8.bin"), "H2O",
                                    *window, table))
            _same_lines(
                kur.read_tio_binary(str(tmp_path / "port16.bin"), "TiO",
                                    *window, table),
                jkur.read_tio_binary(str(tmp_path / "port16.bin"), "TiO",
                                     *window, table))
    args = (gf, 1e7 / wl, elo, 42.0, 0.99)
    np.testing.assert_array_equal(kur.gf_to_s296(*args),
                                  jkur.gf_to_s296(*args))


def test_plez_vo_matches(tmp_path):
    path = tmp_path / "vo.dat"
    path.write_text("# Plez VO list\n' a quoted header\n"
                    "1000.0  0.1  -2.0\n1050.0  0.5  -1.5\nbad line here\n"
                    "1100.0  -1.0  -3.0\n900.0  0.2  -0.5  extra\n")
    for kw in (dict(), dict(wn_min=9200.0, wn_max=10500.0),
               dict(pf_table=(np.array([100.0, 1000.0]),
                              np.array([80.0, 700.0])))):
        _same_lines(kur.read_plez_vo(str(path), "VO", **kw),
                    jkur.read_plez_vo(str(path), "VO", **kw))


def test_native_scanner_matches_both_parsers(tmp_path):
    """The port's scanner, built here with g++, against both packages'
    numpy parsers and bart_tpu's scanner, bit for bit; it refuses a
    corrupt or blank required field, where read_par falls back to the
    numpy parser's diagnostics, as bart_tpu's does."""
    path = tmp_path / "fixture.par"
    path.write_text(PAR_FIXTURE)
    got = hitran_native.read_par(str(path))
    assert hitran_native.library_path().is_file()
    for ref in (parse_par_bytes(PAR_FIXTURE.encode()),
                jparse(PAR_FIXTURE.encode()),
                jnative.read_par(str(path)), read_par(str(path)),
                jread_par(str(path))):
        _same_dicts(got, ref)
    _same_dicts(hitran_native.read_par(str(path), "CH4"),
                jparse(PAR_FIXTURE.encode(), "CH4"))

    rec = _par_record(5, 1, " 2147.081134", " 2.706D-19", " 3.366E+01",
                      ".0601", ".0664", "    0.0000", "0.69", "-.000026")
    quirks = tmp_path / "quirks.par"
    quirks.write_bytes((rec[:59] + "\r\n").encode())
    _same_dicts(hitran_native.read_par(str(quirks)),
                jnative.read_par(str(quirks)))
    assert hitran_native.read_par(str(quirks))["CO"].s296[0] == 2.706e-19
    for name, text in (("bad", rec[:3] + "  GARBAGE   " + rec[15:]),
                       ("blank", rec[:3] + " " * 12 + rec[15:])):
        p = tmp_path / f"{name}.par"
        p.write_text(text + "\n")
        with pytest.raises(ValueError, match="unparseable"):
            hitran_native.read_par(str(p))
        with pytest.raises(ValueError) as e_port:
            read_par(str(p))
        with pytest.raises(ValueError) as e_jax:
            jread_par(str(p))
        assert str(e_port.value) == str(e_jax.value)
    with pytest.raises(FileNotFoundError):
        hitran_native.read_par(str(tmp_path / "missing.par"))


def test_native_scanner_builds_from_several_processes(tmp_path):
    """Six processes (more than this test's share of cores) build the
    scanner into one empty directory at once: each loads a whole library
    and parses the fixture, and no temporary file is left behind."""
    (tmp_path / "fixture.par").write_text(PAR_FIXTURE)
    code = textwrap.dedent(f"""
        from pathlib import Path
        from bart_tpu_torch.native import hitran_native as h
        from bart_tpu_torch.utils import build
        build.BUILD_DIR = Path({str(tmp_path / "build")!r})
        out = h.read_par({str(tmp_path / "fixture.par")!r})
        print(sorted((k, v.nlines) for k, v in out.items()))
    """)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "[('CH4', 1), ('CO', 4)]"
    built = sorted(os.listdir(tmp_path / "build"))
    assert len(built) == 1 and built[0].endswith(".so"), built


def _pyline_cfg(d: Path, dbs, types, parts, out, species=None):
    lines = ["[Parameters]", f"db_list = {' '.join(dbs)}",
             f"part_list = {' '.join(parts)}", f"dbtype = {' '.join(types)}",
             f"output = {out}", "iwav = 2.0", "fwav = 12.0"]
    if species:
        lines.append(f"species = {' '.join(species)}")
    p = d / f"{Path(out).name}.cfg"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def test_lineread_cli_matches(tmp_path, capsys):
    """main() on a four-database cfg (HITRAN, ExoMol, PS binary, Plez VO;
    two H2O databases merged) writes the same TLI as bart_tpu's; --validate
    prints the same report with the same exit code on a clean and on a
    corrupt database; build_tli merges sorted."""
    par = tmp_path / "co_ch4.par"
    par.write_text(PAR_FIXTURE)
    states, trans, pf, _ = _exomol_files(tmp_path, gz=False)
    wl, elo, gf, iso = _kurucz_lines()
    kur.write_ps_binary(str(tmp_path / "h2o.bin"), wl, elo, gf, iso)
    vo = tmp_path / "vo.dat"
    vo.write_text("2500.0  0.1  -2.0\n3050.0  0.5  -1.5\n")
    dbs = [str(par), f"{states}:{trans}:{pf}", str(tmp_path / "h2o.bin"),
           str(vo)]
    types = ["hit", "exomol", "ps", "vo"]
    parts = ["implicit", "implicit", pf, "implicit"]
    for pkg, main in (("port", lr.main), ("jax", jlr.main)):
        cfg = _pyline_cfg(tmp_path, dbs, types, parts,
                          str(tmp_path / f"{pkg}.tli"),
                          species=["CO", "H2O", "H2O", "VO"])
        assert main(["-c", cfg]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].replace("port", "jax") == printed[1]
    got = load_tli(str(tmp_path / "port.tli.npz"))
    ref = jload_tli(str(tmp_path / "jax.tli.npz"))
    assert got.species == ref.species == ["CO", "CH4", "H2O", "VO"]
    _same_dicts(got.lines, ref.lines)
    assert got.lines["H2O"].nlines == 7 + 60
    assert np.all(np.diff(got.lines["H2O"].wn0) >= 0)
    assert list(got.partition) == list(ref.partition) == ["H2O"]
    for x, y in zip(got.partition["H2O"], ref.partition["H2O"]):
        np.testing.assert_array_equal(x, y)
    assert (got.wn_min, got.wn_max) == (ref.wn_min, ref.wn_max)

    bad = tmp_path / "bad.par"
    rec = PAR_FIXTURE.splitlines()[0]
    bad.write_text(PAR_FIXTURE + rec[:3] + "  GARBAGE   " + rec[15:] + "\n")
    for dbl, rc in ((dbs, 0), ([str(bad)] + dbs[1:], 1)):
        reports = []
        for main in (lr.main, jlr.main):
            cfg = _pyline_cfg(tmp_path, dbl, types, parts,
                              str(tmp_path / "v.tli"),
                              species=["CO", "H2O", "H2O", "VO"])
            assert main(["-c", cfg, "--validate"]) == rc
            reports.append(capsys.readouterr().out)
        assert reports[0] == reports[1]
        assert not (tmp_path / "v.tli.npz").exists()

    b = [str(tmp_path / f"b{k}.bin") for k in range(2)]
    for path, w in zip(b, (2600.0, 2510.0)):
        kur.write_ps_binary(path, np.array([w]), np.array([100.0]),
                            np.array([1e-5]))
    got = lr.build_tli(b, ["ps"], None, "", 2.0, 4.0)
    _same_dicts(got.lines, jlr.build_tli(b, ["ps"], None, "", 2.0,
                                         4.0).lines)
    assert got.lines["H2O"].nlines == 2


@pytest.mark.parametrize("name", ["eclipse", "transit", "eclipse_tea",
                                  "eclipse_fold"])
def test_widths_match(name, capsys):
    """get_widths on the port's own config of each demo cfg, exactly as
    bart_tpu's on its; main prints the same lines."""
    path = str(REPO / "examples" / "torch_demo" / f"{name}.cfg")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # the cfgs set wnosamp
        got = widths.get_widths(load_config(path))
        ref = jwidths.get_widths(jload_config(path))
        assert got == ref
        assert widths.main(["-c", path]) == jwidths.main(["-c", path]) == 0
    a, b = np.array_split(capsys.readouterr().out.splitlines(), 2)
    assert list(a) == list(b) and len(a) == 2
