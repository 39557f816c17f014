"""bart_tpu_torch's retrieval pipeline and CLI against bart_tpu's, on the
cfgs of examples/torch_demo at a tiny size (16 layers, 25 cm-1 bins,
650 K T-nodes, the 600 strongest lines of the demo line list), each
package in its own directory: the port on the CPU in float64, bart_tpu
as tests/conftest.py sets it (CPU, x64).

Tolerances: the host files (pressure, abundances) byte for byte; the
atm file's T, q and radii at 1e-10; the opacity tables, each package's
own float32 build, at tests/test_torch_opacity.py's 2e-6; spectra and
the best-fit outputs on one shared table at 1e-9 (measured <= 1e-14).
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from bart_tpu.driver import config as jconfig
from bart_tpu.driver.pipeline import Pipeline as JPipeline
from bart_tpu.opacity.grid import load_grid as jload_grid

from bart_tpu_torch.driver import config
from bart_tpu_torch.driver.pipeline import Pipeline
from bart_tpu_torch.io.atm import read_atm
from bart_tpu_torch.io.spectrum import read_spectrum
from bart_tpu_torch.linelist.tli import TliData, load_tli, save_tli
from bart_tpu_torch.opacity.grid import load_grid

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
DEMO = REPO / "examples" / "torch_demo"
TINY = {"n_layers": "16", "tempdelt": "650", "wndelt": "25",
        "quiet": "True"}
NLINES = 600
RTOL = 1e-9
OPACITY = "opacity_CH4.npz"
#: (cfg, overrides) of the spectrum comparisons: folded at rtosamp = 4
#: (eclipse_fold_f32: float32 fine tables, foldtable16's default)
FOLD = {"rtosamp": "4"}
SPECTRA = {"eclipse": ("eclipse", {}), "transit": ("transit", {}),
           "eclipse_fold": ("eclipse_fold", FOLD),
           "transit_fold": ("transit_fold", FOLD),
           "eclipse_fold_f32": ("eclipse_fold_f32", FOLD)}
#: spectra that read another one's table (the same atm and grids)
TABLE_OF = {"transit": "eclipse", "transit_fold": "eclipse_fold",
            "eclipse_fold_f32": "eclipse_fold"}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A work directory holding the tiny line list."""
    root = tmp_path_factory.mktemp("pipeline")
    src = load_tli(str(REPO / "examples" / "demo_inputs"
                       / "CH4_demo.tli.npz"))
    lines = {"CH4": src.lines["CH4"].strongest(NLINES)}
    save_tli(TliData(["CH4"], lines, src.wn_min, src.wn_max),
             str(root / "lines.tli.npz"))
    return root


def cfgs(work, name, loc, **over):
    """(the port's cfg, bart_tpu's cfg) of examples/torch_demo/name.cfg
    at the tiny size, with loc_dir ``loc``."""
    ov = {**TINY, "loc_dir": str(loc),
          "linedb": str(work / "lines.tli.npz"), **over}
    path = str(DEMO / f"{name}.cfg")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # both warn about wnosamp
        return config.load_config(path, ov), jconfig.load_config(path, ov)


def port(cfg, **kw):
    return Pipeline(cfg, device="cpu", dtype=torch.float64, **kw)


@pytest.fixture(scope="module")
def jax_spectra(work):
    """bart_tpu's --justSpectrum on each of SPECTRA, each in its own
    directory (those of TABLE_OF on a copy of that one's table: the same
    atm); -> {name: (directory, wn, spectrum)}."""
    out = {}
    for key, (name, over) in SPECTRA.items():
        loc = work / f"jax_{key}"
        loc.mkdir()
        if key in TABLE_OF:
            shutil.copy(work / f"jax_{TABLE_OF[key]}" / OPACITY,
                        loc / OPACITY)
        _, jcfg = cfgs(work, name, loc, **over)
        wn, spec = JPipeline(jcfg, just_spectrum=True).run()
        out[key] = (loc, np.asarray(wn), np.asarray(spec))
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


@pytest.mark.parametrize("name", ["eclipse", "eclipse_tea"])
def test_host_stages_and_atmosphere(work, name):
    """--justTEA: the pressure and abundance files byte for byte, the atm
    file's T, q and radii at 1e-10 (uniform and equilibrium branch)."""
    a, b = work / f"jtea_{name}", work / f"ptea_{name}"
    cfg, jcfg = cfgs(work, name, b)
    _, jcfg = cfgs(work, name, a)
    jatm = JPipeline(jcfg, just_tea=True).run()
    atm = port(cfg, just_tea=True).run()
    for f in ("atm.pres", "abundances.abn"):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    got, ref = read_atm(str(b / "atmosphere.atm")), \
        read_atm(str(a / "atmosphere.atm"))
    assert got.species == ref.species == atm.species
    for field in ("pressure", "temperature", "abundances", "radius"):
        np.testing.assert_allclose(getattr(got, field), getattr(ref, field),
                                   rtol=1e-10, atol=0, err_msg=field)
        np.testing.assert_allclose(getattr(atm, field),
                                   np.asarray(getattr(jatm, field)),
                                   rtol=1e-10, atol=1e-300, err_msg=field)
    np.testing.assert_allclose(atm.abundances.sum(axis=1), 1.0, rtol=1e-8)
    if name == "eclipse_tea":
        assert atm.abundances.shape == (16, 10)
        assert np.all(atm.abundances[:, atm.species.index("H2")] > 0.5)


def test_just_opacity(work, jax_spectra):
    """--justOpacity: each package's own float32 table at 2e-6; a rerun
    reuses the file; osamp = 2 builds a bin-averaged table that differs
    from the point-sampled one."""
    cfg, _ = cfgs(work, "eclipse", work / "p_opacity")
    grid = port(cfg, just_opacity=True).run()
    ref = jload_grid(str(jax_spectra["eclipse"][0] / OPACITY))
    got, want = grid.sigma.numpy(), np.asarray(ref.sigma)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (1, 5, 16, 101)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6 * want.max())
    assert grid.species == ref.species
    np.testing.assert_array_equal(grid.t_grid, ref.t_grid)
    again = port(cfg, just_opacity=True).run()
    np.testing.assert_array_equal(again.sigma.numpy(), got)
    cfg, _ = cfgs(work, "eclipse", work / "p_osamp", osamp="2")
    binned = port(cfg, just_opacity=True).run().sigma.numpy()
    assert binned.shape == got.shape and np.all(np.isfinite(binned))
    assert np.abs(binned - got).max() > 1e-3 * got.max()


@pytest.mark.parametrize("key", list(SPECTRA))
def test_just_spectrum(work, jax_spectra, key):
    """--justSpectrum on bart_tpu's opacity table (copied into the port's
    own directory): the spectrum and its file at 1e-9; folded at
    rtosamp = 4 through the plain versions of the folded kernels."""
    name, over = SPECTRA[key]
    jloc, jwn, jspec = jax_spectra[key]
    loc = work / f"port_{key}"
    loc.mkdir()
    shutil.copy(jloc / OPACITY, loc / OPACITY)
    cfg, _ = cfgs(work, name, loc, **over)
    wn, spec = port(cfg, just_spectrum=True).run()
    np.testing.assert_array_equal(wn, jwn)
    assert spec.shape == jspec.shape and np.all(np.isfinite(spec))
    assert _rel(spec, jspec) < RTOL
    got = read_spectrum(str(loc / cfg.outspec))
    np.testing.assert_allclose(got[1], read_spectrum(
        str(jloc / cfg.outspec))[1], rtol=RTOL)
    if key.endswith("_fold"):
        assert len(load_grid(str(loc / OPACITY), device="cpu").wn_grid) \
            == 4 * len(wn)


def test_state_carried_across(work, jax_spectra):
    """With resume, the port's pipeline in the directory bart_tpu's
    stages filled reuses bart_tpu's pressure, atm and opacity files
    (none is rewritten) and its --justSpectrum equals bart_tpu's own
    resumed one (both read the atm file's rounded T and radii)."""
    jloc = jax_spectra["eclipse"][0]
    cfg, jcfg = cfgs(work, "eclipse", jloc)
    _, jspec = JPipeline(jcfg, just_spectrum=True, resume=True).run()
    files = [jloc / f for f in ("atm.pres", "atmosphere.atm", OPACITY)]
    mtimes = [f.stat().st_mtime_ns for f in files]
    _, spec = port(cfg, just_spectrum=True, resume=True).run()
    assert [f.stat().st_mtime_ns for f in files] == mtimes
    assert _rel(spec, jspec) < RTOL


def _posterior_files(loc, cfg, seed):
    """An output.npy and an MCMC.log, as run_mcmc writes them, of a
    posterior around the cfg's parameters."""
    free = np.where(np.asarray(cfg.stepsize) > 0)[0]
    rng = np.random.default_rng(seed)
    pinit = np.asarray(cfg.params)[free]
    step = np.asarray(cfg.stepsize)[free]
    post = pinit[None, :, None] + 2 * step[None, :, None] \
        * rng.normal(0.0, 1.0, (4, len(free), 40))
    np.save(loc / "output.npy", post)
    names = [cfg.parnames[i] for i in free]
    with open(loc / cfg.logfile, "w") as f:
        f.write("MCMC done\n\n Best-fit params    Uncertainties   S/N      "
                "Sample Span\n")
        for b, u, n in zip(post[0, :, -1], post.std(axis=(0, 2)), names):
            f.write(f" {b: .7e}  {u: .7e}  {abs(b) / u:9.2f}  {n}\n")
        f.write("\n")


@pytest.mark.parametrize("key", ["eclipse", "transit", "eclipse_fold",
                                 "transit_fold", "eclipse_fold_f32"])
def test_just_plots(work, jax_spectra, key):
    """--justPlots on one output.npy and MCMC.log: bestfit_spectrum.dat,
    cf.npy (eclipse) or transmittance.npy (transit) and tau.npz against
    bart_tpu's at 1e-9; every figure file written.  Folded at rtosamp =
    4 on the fine table, which the port's Pipeline lets go before this
    stage."""
    name, over = SPECTRA[key]
    locs = {}
    for who in ("jax", "port"):
        loc = work / f"plots_{who}_{key}"
        loc.mkdir()
        shutil.copy(jax_spectra[key][0] / OPACITY, loc / OPACITY)
        locs[who] = cfgs(work, name, loc, savefiles="True", **over)[
            0 if who == "port" else 1]
        _posterior_files(loc, locs[who], seed=3)
    JPipeline(locs["jax"], just_plots=True, resume=True).run()
    port(locs["port"], just_plots=True, resume=True).run()
    a, b = work / f"plots_port_{key}", work / f"plots_jax_{key}"
    got = np.loadtxt(a / "bestfit_spectrum.dat")
    ref = np.loadtxt(b / "bestfit_spectrum.dat")
    assert got.shape == ref.shape == (101, 2)
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    cf = "cf.npy" if name.startswith("eclipse") else "transmittance.npy"
    ref_cf = np.load(b / cf)
    assert ref_cf.shape == (16, 10)
    np.testing.assert_allclose(np.load(a / cf), ref_cf, rtol=RTOL,
                               atol=RTOL * np.abs(ref_cf).max())
    tg, tr = np.load(a / "tau.npz"), np.load(b / "tau.npz")
    assert sorted(tg.files) == sorted(tr.files)
    for k in tr.files:
        np.testing.assert_allclose(tg[k], tr[k], rtol=RTOL,
                                   atol=RTOL * np.abs(tr[k]).max(),
                                   err_msg=k)
    ga, gb = read_atm(str(a / "bestfit.atm")), read_atm(str(b / "bestfit.atm"))
    np.testing.assert_allclose(ga.temperature, gb.temperature, rtol=RTOL)
    for fig in ("trace", "pairwise", "posterior", "abundances",
                "bestfit_spectrum", "PT_envelope"):
        assert (a / f"{fig}.png").stat().st_size > 0, fig


def test_full_tiny_run_then_plots_and_resume(work, jax_spectra):
    """A whole port run (4 chains, one block of 100 steps) writes every
    file tests/test_pipeline.py:92-114 asserts; then --justPlots and
    --resume (one more block) run."""
    loc = work / "full"
    loc.mkdir()
    shutil.copy(jax_spectra["eclipse"][0] / OPACITY, loc / OPACITY)
    cfg, _ = cfgs(work, "eclipse", loc, numit="200", nchains="4",
                  burnin="20")
    result = port(cfg).run()
    assert result is not None
    for f in ("output.npy", "MCMC.log", "bestfit_spectrum.dat",
              "PT_envelope.png", "mcmc_checkpoint.npz",
              "stage_timing.jsonl"):
        assert (loc / f).is_file(), f
    post = np.load(loc / "output.npy")
    assert post.shape == (4, 4, 80) and np.all(np.isfinite(post))
    port(cfg, just_plots=True, resume=True).run()
    cfg.numit, cfg.plots = 800, False
    res = port(cfg, resume=True).run()
    assert res.posterior.shape == (4, 4, 180)
    np.testing.assert_array_equal(res.posterior[:, :, :80], post)


@pytest.mark.parametrize("name", ["eclipse_fold", "transit_fold",
                                  "eclipse_fold_f32"])
def test_folded_cli_retrieval(work, jax_spectra, name, monkeypatch):
    """The folded retrieval through ``driver.cli.main`` (rtosamp = 4,
    the adaptive split; bfloat16 fine rows, float32 ones on
    eclipse_fold_f32.cfg), 4 chains x one block of 100 steps on the CPU,
    where the wrappers run the four kernels' plain versions: the forward
    calls the folded and the K = 1 wrapper, the folded one on fine rows
    of the cfg's type, the posterior is finite, MCMC.log is written, and
    the fine table is reused from the directory, not rebuilt."""
    from bart_tpu_torch.driver import cli
    from bart_tpu_torch.rt import forward

    loc = work / f"cli_{name}"
    loc.mkdir()
    shutil.copy(jax_spectra[name][0] / OPACITY, loc / OPACITY)
    mtime = (loc / OPACITY).stat().st_mtime_ns
    transit = name.startswith("transit")
    calls, dtypes = {}, set()
    for wrapper in (("fused_transit_folded", "fused_transit") if transit
                    else ("fused_eclipse_folded", "fused_eclipse")):
        def counted(*a, _fn=getattr(forward, wrapper), _name=wrapper,
                    **kw):
            calls[_name] = calls.get(_name, 0) + 1
            if _name.endswith("_folded"):
                dtypes.add(a[0].tab.dtype)
            return _fn(*a, **kw)
        monkeypatch.setattr(forward, wrapper, counted)
    argv = ["-c", str(DEMO / f"{name}.cfg"), "--device", "cpu",
            "--loc_dir", str(loc), "--linedb", str(work / "lines.tli.npz"),
            "--nchains", "4", "--numit", "400", "--burnin", "20",
            "--plots", "False"]
    for k, v in {**TINY, **FOLD}.items():
        argv += [f"--{k}", v]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # the cfg sets wnosamp
        assert cli.main(argv) == 0
    assert len(calls) == 2 and min(calls.values()) > 0, calls
    assert dtypes == {torch.float32 if name.endswith("_f32")
                      else torch.bfloat16}
    assert (loc / OPACITY).stat().st_mtime_ns == mtime
    post = np.load(loc / "output.npy")
    nfree = 5 if transit else 4
    assert post.shape == (4, nfree, 80) and np.all(np.isfinite(post))
    log = (loc / "MCMC.log").read_text()
    assert "Best-fit params" in log
    stages = [json.loads(line)["stage"] for line in
              (loc / "stage_timing.jsonl").read_text().splitlines()]
    assert stages[-2:] == ["forward_setup", "mcmc"]


def test_cli_subprocess_without_jax(work):
    """``python -m bart_tpu_torch`` with jax and bart_tpu blocked:
    --justTEA --device cpu on eclipse_tea.cfg, and --validate (exit 0 on
    the clean cfg, 1 on an injected fault)."""
    loc = work / "cli_tea"
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["jax"] = None
        sys.modules["bart_tpu"] = None
        import torch
        torch.set_num_threads(2)
        from bart_tpu_torch.driver import cli
        cfg = {str(DEMO / 'eclipse_tea.cfg')!r}
        sys.argv = ["bart_tpu_torch", "-c", cfg, "--justTEA", "--device",
                    "cpu", "--loc_dir", {str(loc)!r}, "--n_layers", "16",
                    "--quiet", "True"]
        try:
            runpy.run_module("bart_tpu_torch", run_name="__main__")
            rc = None
        except SystemExit as e:
            rc = e.code
        ok = cli.main(["-c", cfg, "--validate", "--device", "cpu"])
        bad = cli.main(["-c", cfg, "--validate", "--device", "cpu",
                        "--tep_name", "/no/such/system.tep"])
        assert not any(k == "jax" or k.startswith(("jax.", "bart_tpu."))
                       or k == "bart_tpu" or k.startswith("matplotlib")
                       for k, v in sys.modules.items() if v is not None)
        print("rcs", rc, ok, bad)
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(work), capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "rcs 0 0 1", proc.stdout
    assert "config OK" in proc.stdout and "ISSUE: tep_name" in proc.stdout
    atm = read_atm(str(loc / "atmosphere.atm"))
    assert atm.abundances.shape == (16, 10)
    # the file's 5 significant digits
    np.testing.assert_allclose(atm.abundances.sum(axis=1), 1.0, rtol=1e-4)
    assert np.all(atm.abundances[:, atm.species.index("H2")] > 0.5)
