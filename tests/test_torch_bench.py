"""The port's benchmark problem, its table cache, its timing, ``entry()``,
the benchmark script and the quickstart against their counterparts in
the JAX system (``__graft_entry__.py``, ``bench.py``,
``examples/quickstart.py``), at a small size on the CPU; and the kernel
bounds that ``utils/roofline.py`` took over from ``chip_smoke.py``.
CPU and float64 unless stated."""

import ast
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as graft
from bart_tpu_torch import entry
from bart_tpu_torch.bench import time_batched
from bart_tpu_torch.utils import roofline

REPO = Path(__file__).resolve().parents[1]
F64 = torch.float64
#: the small problem: (nlayer, nwave, nlines)
SMALL = (16, 64, 64)
BENCH_BASE = np.array([-2.0, 0.0, 1.0, 0.0, 0.98, -0.5])


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _bench_params(nchain: int = 4) -> np.ndarray:
    """bench.py's parameters: default_rng(0), base plus N(0, 0.005)."""
    rng = np.random.default_rng(0)
    return np.tile(BENCH_BASE, (nchain, 1)) + rng.normal(0, 0.005,
                                                         (nchain, 6))


def _subprocess(code: str, tmp_path: Path) -> subprocess.CompletedProcess:
    """``code`` in a fresh interpreter with jax and bart_tpu blocked, two
    torch threads and the table cache under ``tmp_path``."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None          # any `import jax` now fails
        sys.modules["bart_tpu"] = None     # and any import of bart_tpu
    """) + textwrap.dedent(code)
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2",
             "BENCH_CACHE_DIR": str(tmp_path)})


# --- build_problem against __graft_entry__._build_problem ---------------

@pytest.mark.parametrize("solution,fold,fold_adapt,quadrature", [
    ("eclipse", 1, None, "raygrid"), ("transit", 1, None, "raygrid"),
    ("eclipse", 4, None, "raygrid"), ("transit", 4, None, "raygrid"),
    ("eclipse", 4, 0.02, "expsum")])
def test_build_problem_matches_bart_tpu(solution, fold, fold_adapt,
                                        quadrature):
    """The same table (rtol 1e-10) and the same bands at the bench's
    parameters (1e-9) as the JAX system's problem builder."""
    kw = dict(solution=solution, fold=fold, fold_adapt=fold_adapt,
              quadrature=quadrature)
    ref = graft._build_problem(*SMALL, dtype=jnp.float64, **kw)
    got = entry.build_problem(*SMALL, dtype=F64, device="cpu", **kw)
    np.testing.assert_allclose(got.opacity.sigma.numpy(),
                               np.asarray(ref.opacity.sigma), rtol=1e-10)
    params = _bench_params()
    if solution == "transit":
        params = np.insert(params, 5, ref.r0_km, axis=1)
    band, _, valid = got(torch.tensor(params))
    rband, _, rvalid = ref.batched()(jnp.asarray(params))
    assert bool(valid.all()) and np.all(np.asarray(rvalid))
    np.testing.assert_allclose(band.numpy(), np.asarray(rband), rtol=1e-9)


def test_build_problem_refuses_other_solutions():
    with pytest.raises(ValueError, match="direct"):
        entry.build_problem(*SMALL, solution="direct", device="cpu")


# --- the table cache ----------------------------------------------------

@pytest.mark.parametrize("fold", [1, 4])
def test_cache_loads_and_does_not_build(fold, tmp_path, monkeypatch,
                                        caplog):
    """A second ``cache=True`` build loads the file the first one saved
    and builds nothing: the same table and forward, bit for bit."""
    import bart_tpu_torch.opacity.grid as grid_mod

    monkeypatch.setenv("BENCH_CACHE_DIR", str(tmp_path))
    caplog.set_level("INFO", logger="bart_tpu_torch.entry")
    built = entry.build_problem(*SMALL, dtype=F64, cache=True, fold=fold,
                                device="cpu")
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and re.fullmatch(
        rf"\.bench_grid_torch_16x64x64{'_fold4' if fold > 1 else ''}"
        r"_float64_[0-9a-f]{12}\.npz", files[0].name), files
    assert "built and saved" in caplog.text

    def no_build(*a, **k):
        raise AssertionError("the table was built again")

    monkeypatch.setattr(grid_mod, "build_opacity_grid", no_build)
    caplog.clear()
    loaded = entry.build_problem(*SMALL, dtype=F64, cache=True, fold=fold,
                                 device="cpu")
    assert f"loaded from {files[0].name}" in caplog.text
    assert torch.equal(loaded.opacity.sigma, built.opacity.sigma)
    params = torch.tensor(_bench_params())
    for a, b in zip(loaded(params), built(params)):
        assert torch.equal(a, b)


def test_failed_save_raises(tmp_path, monkeypatch):
    """No silent rebuild loop: a cache file that cannot be written
    raises."""
    monkeypatch.setenv("BENCH_CACHE_DIR", str(tmp_path / "missing"))
    with pytest.raises(OSError):
        entry.build_problem(8, 64, 16, cache=True, device="cpu")


def _key_inputs():
    from bart_tpu_torch.demo import demo_inputs
    from bart_tpu_torch.utils.grids import folded_fine_grid

    inp = demo_inputs(*SMALL)
    return dict(lines=inp.lines, pressure=inp.pressure,
                wn_rt=folded_fine_grid(inp.wn, 4), t_grid=inp.t_grid)


@pytest.mark.parametrize("changed", ["wn0", "s296", "elower", "pressure",
                                     "wn_rt", "t_grid"])
def test_cache_key_follows_the_hashed_values(changed):
    import dataclasses

    kw = _key_inputs()
    key = entry.table_key(**kw)
    assert entry.table_key(**_key_inputs()) == key
    if changed in ("wn0", "s296", "elower"):
        arr = getattr(kw["lines"], changed).copy()
        arr[3] *= 1.0 + 1e-12
        kw["lines"] = dataclasses.replace(kw["lines"], **{changed: arr})
    else:
        kw[changed] = kw[changed].copy()
        kw[changed][-1] += 1e-9
    assert entry.table_key(**kw) != key


@pytest.mark.parametrize("source", ["opacity/grid.py", "opacity/cia.py",
                                    "physics/voigt.py", "linelist/tli.py",
                                    "utils/grids.py"])
def test_cache_key_follows_the_sources(source, tmp_path):
    """The key hashes the table's sources: a copy of them keys the same
    file, and a change to any of them keys another."""
    import shutil

    pkg = Path(entry.__file__).parent
    for pattern in entry.TABLE_SOURCES:
        for src in pkg.glob(pattern):
            dst = tmp_path / src.relative_to(pkg)
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(src, dst)
    kw = _key_inputs()
    key = entry.table_key(**kw)
    assert entry.table_key(**kw, package=tmp_path) == key
    with open(tmp_path / source, "a") as f:
        f.write("\n# edited\n")
    assert entry.table_key(**kw, package=tmp_path) != key


# --- time_batched ---------------------------------------------------------

def _fake_forward(bad: str | None = None):
    calls = []

    def fb(p):
        calls.append(p)
        flux = p.sum(1, keepdim=True)
        if bad == "flux":
            flux = flux + float("inf")
        valid = torch.ones(p.shape[0], dtype=torch.bool)
        if bad == "valid":
            valid[1] = False
        return flux, p, valid

    return fb, calls


def test_time_batched_times_a_serialized_chain():
    fb, calls = _fake_forward()
    params = torch.tensor(_bench_params())
    best, spread, times = time_batched(fb, params, 5, rounds=3)
    assert len(times) == 3 and best == min(times) > 0.0
    assert spread >= 0.0
    assert len(calls) == 1 + 3 * 5
    # every timed call's input is params plus 0 x the last output
    assert all(torch.equal(c, params) for c in calls)
    assert time_batched(fb, params, 2, rounds=1)[1] == 0.0


@pytest.mark.parametrize("bad,match", [("flux", "non-finite"),
                                       ("valid", "invalid")])
def test_time_batched_raises(bad, match):
    fb, _ = _fake_forward(bad)
    with pytest.raises(RuntimeError, match=match):
        time_batched(fb, torch.tensor(_bench_params()), 2)


# --- entry() ----------------------------------------------------------------

def test_entry_on_the_cpu():
    """entry()'s forward at its parameters: the band fluxes of the JAX
    system's problem at the same size (the default problem's table takes
    minutes on this CPU; float64)."""
    fn, (params,) = entry.entry(device="cpu", nlayer=SMALL[0],
                                nwave=SMALL[1], nlines=SMALL[2], dtype=F64)
    assert params.shape == (1, 6) and params.device.type == "cpu"
    band = fn(params)
    ref = graft._build_problem(*SMALL, dtype=jnp.float64)
    rband = ref.batched()(jnp.asarray(np.asarray(entry.ENTRY_PARAMS)[None]))
    assert band.shape == (1, 10)
    np.testing.assert_allclose(band.numpy(), np.asarray(rband[0]), rtol=1e-9)


# --- the benchmark script ---------------------------------------------------

def _bench_py_keys() -> set:
    """The keys of the JSON line that bench.py prints (its json.dumps of
    a dict literal)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    keys = [{k.value for k in node.args[0].keys}
            for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "")
            == "dumps" and node.args and isinstance(node.args[0], ast.Dict)]
    assert len(keys) == 1, keys
    return keys[0]


@pytest.mark.parametrize("how", ["module", "launcher"])
def test_bench_script_on_the_cpu_without_jax(how, tmp_path):
    """``python -m bart_tpu_torch.bench`` and ``bench_torch.py`` with
    ``--device cpu --tiny``: exit 0, a first stdout line with exactly
    bench.py's keys, the transit extra; run twice, the second run loads
    the table the first built."""
    run = ("runpy.run_module('bart_tpu_torch.bench', run_name='__main__')"
           if how == "module" else
           f"runpy.run_path({str(REPO / 'bench_torch.py')!r}, "
           "run_name='__main__')")
    code = f"""
        import runpy
        sys.argv = ["bench", "--device", "cpu", "--tiny"]
        try:
            {run}
        except SystemExit as e:
            assert e.code == 0, e.code
        assert not any(k.split(".")[0] in ("jax", "bart_tpu")
                       for k, v in sys.modules.items() if v is not None)
    """
    for attempt in ("built and saved", "loaded from"):
        proc = _subprocess(code, tmp_path)
        assert proc.returncode == 0, proc.stderr
        line = json.loads(proc.stdout.splitlines()[0])
        assert set(line) == _bench_py_keys()
        assert line["metric"] == "likelihood_evals_per_s"
        assert line["unit"] == "evals/s/chip"
        assert np.isfinite(line["value"]) and line["value"] > 0
        assert line["vs_baseline"] == pytest.approx(line["value"] / 10,
                                                    abs=0.06)
        assert "# transit: batch 4 in" in proc.stderr, proc.stderr
        assert "not measured (no card)" in proc.stderr
        assert re.search(rf"table \(1, 27, 8, 64\) {attempt}", proc.stderr)
        assert "built" not in proc.stderr or attempt == "built and saved"


# --- the quickstart ---------------------------------------------------------

def _jax_quickstart_bands() -> np.ndarray:
    """Steps 1, 4 and 5 of examples/quickstart.py (bart_tpu, float32;
    the synthetic system it falls back to without its reference inputs)."""
    from bart_tpu.io.kurucz import blackbody_star
    from bart_tpu.io.tep import PlanetSystem
    from bart_tpu.linelist.tli import synthetic_linelist
    from bart_tpu.obs.bands import build_band_matrix
    from bart_tpu.opacity.grid import build_opacity_grid
    from bart_tpu.rt.forward import ForwardConfig, ForwardModel
    from bart_tpu.utils.grids import pressure_grid, wavenumber_grid

    pressure = pressure_grid(40, 1e-5, 100.0)
    wn = wavenumber_grid(wllow=2.5, wlhigh=4.0, wndelt=2.0)
    system = PlanetSystem(6075.0, 7.97e8, 4.37, 7.05e9, 9.44e7, 1.32e27)
    lines = synthetic_linelist("CH4", float(wn[0]), float(wn[-1]), 800,
                               seed=1)
    grid = build_opacity_grid({"CH4": lines}, wn,
                              np.arange(400.0, 3001.0, 325.0), pressure)
    centers = np.linspace(wn[0] + 60, wn[-1] - 60, 6)
    filters = [(np.linspace(c - 50, c + 50, 41), np.ones(41))
               for c in centers]
    starfl, _ = blackbody_star(wn, system.t_star)
    bands = build_band_matrix(wn, filters, star_flux=starfl,
                              rprs=system.rprs)
    fm = ForwardModel(
        ForwardConfig(solution="eclipse", pt_type="line", molfit=("CH4",)),
        wn_grid=wn, pressure=pressure, species=["H2", "He", "CH4"],
        base_abundances=np.tile([0.85, 0.149, 1e-3], (len(pressure), 1)),
        opacity=grid, system=system, bands=bands,
    )
    assert fm.dtype == jnp.float32
    truth = jnp.asarray([-2.0, 0.0, 1.0, 0.0, 0.98, -0.5], fm.dtype)
    return np.asarray(fm.jitted()(truth)[0], np.float64)


def test_quickstart_on_the_cpu_without_jax(tmp_path):
    """examples/torch_demo/quickstart.py --device cpu with jax blocked
    ends in ``quickstart OK``; its step-5 band fluxes are bart_tpu's at
    rtol 1e-5 (float32, as both scripts run)."""
    path = REPO / "examples" / "torch_demo" / "quickstart.py"
    proc = _subprocess(f"""
        import runpy
        sys.argv = ["quickstart", "--device", "cpu"]
        try:
            runpy.run_path({str(path)!r}, run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        assert not any(k.split(".")[0] in ("jax", "bart_tpu")
                       for k, v in sys.modules.items() if v is not None)
    """, tmp_path)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.splitlines()
    assert out[-1] == "quickstart OK", proc.stdout
    assert out[0] == "grids: 40 layers, 751 wavenumbers [2500, 4000] cm-1"
    band_line, = [s for s in out if s.startswith("forward model:")]
    bands = np.array([float(x) for x in band_line.rsplit(":", 1)[1].split()])
    np.testing.assert_allclose(bands, _jax_quickstart_bands(), rtol=1e-5)


# --- the bounds that utils/roofline.py took over ---------------------------

@pytest.mark.parametrize("kernel,ms", [
    ("fused_eclipse", 0.183), ("fused_transit", 0.142),
    ("fused_eclipse_folded", 0.624), ("fused_transit_folded", 1.501),
    ("fused_eclipse_folded[float32, expsum]", 0.660),
    ("fused_eclipse_folded[float32, raygrid]", 2.215)])
def test_roofline_pins_the_smokes_bounds(kernel, ms):
    """The kernels' bounds at PERF.md's full-width shapes (512 chains,
    100 layers, 2501 bins; the folded ones on 1,064 fine bins x 32 with
    bfloat16 tables, the float32 instance on 1,125): the values that
    chip_smoke.py printed before the accounting moved, from the same
    functions."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    assert chip_smoke.eclipse_bound is roofline.eclipse_bound
    assert chip_smoke.transit_bound is roofline.transit_bound
    C, L, W, nmu = 512, 100, 2501, {"raygrid": 5, "expsum": 8}

    def eclipse(R, F, K, bf16, quad):
        el = 2 if bf16 else 4
        # the table, the row weights [C, L, R], T and drp [C, L], the wn
        # (folded: the fine table, its rows, T, drp and mu)
        nb = el * R * L * F + 4 * (C * L * R + 2 * C * L
                                   + (W if K == 1 else nmu[quad]))
        return roofline.eclipse_bound(R, L, F, C, nmu[quad],
                                      quad == "expsum", K, bf16, nb)

    def transit(R, F, K, bf16):
        el = 2 if bf16 else 4
        nb = el * R * L * F + 4 * (C * L * R + C * L * L + C * L)
        return roofline.transit_bound(R, L, F, C, K, bf16, nb)

    got = {"fused_eclipse": lambda: eclipse(27, W, 1, False, "raygrid"),
           "fused_transit": lambda: transit(41, W, 1, False),
           "fused_eclipse_folded": lambda: eclipse(27, 1064 * 32, 32, True,
                                                   "expsum"),
           "fused_transit_folded": lambda: transit(41, 1064 * 32, 32, True),
           "fused_eclipse_folded[float32, expsum]": lambda: eclipse(
               27, 1125 * 32, 32, False, "expsum"),
           "fused_eclipse_folded[float32, raygrid]": lambda: eclipse(
               27, 1125 * 32, 32, False, "raygrid")}[kernel]()
    assert round(got["bound_ms"], 3) == ms, got
    assert got["bound_by"] == "operations"
