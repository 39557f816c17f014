"""bart_tpu_torch imports and runs its plain paths with jax and bart_tpu
blocked, and its kernel module imports with no nvcc and no card; asking
for a CUDA device without a card raises, and the card is the device of
every entry point that is not told otherwise."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def _run(code: str, env: dict | None = None) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO), **(env or {})})


def test_every_module_imports_and_runs_without_jax():
    proc = _run("""
        import sys
        sys.modules["jax"] = None          # any `import jax` now fails
        sys.modules["bart_tpu"] = None     # and any import of bart_tpu
        import importlib, pkgutil
        import numpy as np, torch
        import bart_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            bart_tpu_torch.__path__, "bart_tpu_torch.")]
        for n in names:
            importlib.import_module(n)
        for n in bart_tpu_torch._LAZY:
            getattr(bart_tpu_torch, n)
        # the plain main path, end to end, at a tiny size
        from bart_tpu_torch.demo import (DEMO_PARAMS, DEMO_PARAMS_TRANSIT,
                                         build_demo_model, demo_inputs)
        torch.set_num_threads(2)
        inp = demo_inputs(nlayer=6, nwave=64, nlines=40, t_step=1300.0)
        fm = build_demo_model(inp, dtype=torch.float64, budget_bytes=1e7,
                              device="cpu")
        band, spec, valid = fm(torch.tensor(DEMO_PARAMS[None]))
        assert bool(valid.all()) and bool(torch.isfinite(band).all())
        # and the transit path with CIA, on the same opacity table
        fmt = build_demo_model(inp, dtype=torch.float64, grid=fm.opacity,
                               solution="transit", cia=True, device="cpu")
        band, spec, valid = fmt(torch.tensor(DEMO_PARAMS_TRANSIT[None]))
        assert bool(valid.all()) and bool(torch.isfinite(band).all())
        # the folded path too: fine table, adaptive split, bf16 rows
        fmf = build_demo_model(inp, dtype=torch.float64, fold=4,
                               fold_bf16=True, budget_bytes=1e7,
                               device="cpu")
        band, spec, valid = fmf(torch.tensor(DEMO_PARAMS[None]))
        assert bool(valid.all()) and bool(torch.isfinite(band).all())
        assert not any(k == "jax" or k.startswith("jax.")
                       for k, v in sys.modules.items() if v is not None)
        assert not any(k == "bart_tpu" or k.startswith("bart_tpu.")
                       for k, v in sys.modules.items() if v is not None)
        print(len(names), "modules")
    """)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 15


def test_fused_imports_without_nvcc_or_card():
    proc = _run("""
        import bart_tpu_torch.rt.fused as f
        assert f._libs == {}                # nothing built at import
        assert f.fused_eclipse.launches == f.fused_transit.launches == 0
        print("ok")
    """, env={"PATH": "/nonexistent", "CUDA_VISIBLE_DEVICES": "",
              "CUDA_HOME": "/nonexistent"})
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_cuda_device_without_card_raises(monkeypatch):
    from bart_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_forward_model_on_cuda_without_card_raises(monkeypatch):
    from bart_tpu_torch.demo import demo_inputs
    from bart_tpu_torch.obs.bands import BandMatrix
    from bart_tpu_torch.opacity.grid import OpacityGrid
    from bart_tpu_torch.rt.forward import ForwardConfig, ForwardModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inp = demo_inputs(nlayer=4, nwave=32, nlines=10, t_step=1300.0)
    grid = OpacityGrid(["CH4"], inp.t_grid, inp.pressure, inp.wn,
                       torch.zeros(1, len(inp.t_grid), 4, 32))
    with pytest.raises(RuntimeError, match="is_available"):
        ForwardModel(ForwardConfig(**inp.config_kwargs), wn_grid=inp.wn,
                     pressure=inp.pressure, species=inp.species,
                     base_abundances=inp.base_q, opacity=grid,
                     system=inp.system,
                     bands=BandMatrix(torch.zeros(10, 32), 10),
                     device="cuda")


def _quickstart():
    """examples/torch_demo/quickstart.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "quickstart", REPO / "examples" / "torch_demo" / "quickstart.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _console_script():
    """The function pyproject.toml's ``bart-tpu-torch`` script runs."""
    import importlib
    import tomllib

    target = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "project"]["scripts"]["bart-tpu-torch"]
    module, attr = target.split(":")
    return getattr(importlib.import_module(module), attr)


@pytest.mark.parametrize("entry", [
    "ForwardModel", "build_demo_model", "build_opacity_grid", "load_grid",
    "build_band_matrix", "tile_lines_bucketed", "tile_lines",
    "load_checkpoint",
    "Likelihood", "contribution_functions", "transmittance",
    "band_average", "Pipeline", "cli.main", "bart-tpu-torch",
    "init_distributed", "local_device", "dryrun.main", "build_problem",
    "entry", "bench.main", "quickstart"])
def test_entry_points_default_to_the_card(entry, monkeypatch, tmp_path):
    """Called without ``device=`` and without a card, every entry point
    that creates tensors raises: none falls back to the CPU."""
    import numpy as np

    import warnings

    from bart_tpu_torch.demo import build_demo_model, demo_inputs
    from bart_tpu_torch import bench, entry as entry_mod
    from bart_tpu_torch.driver import cli
    from bart_tpu_torch.driver.config import load_config
    from bart_tpu_torch.driver.pipeline import Pipeline
    from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
    from bart_tpu_torch.inference.retrieval import (load_checkpoint,
                                                    save_checkpoint)
    from bart_tpu_torch.post import cf
    from bart_tpu_torch.inference.samplers import SamplerState
    from bart_tpu_torch.obs.bands import BandMatrix, build_band_matrix
    from bart_tpu_torch.opacity.extinction import (tile_lines,
                                                   tile_lines_bucketed)
    from bart_tpu_torch.opacity.grid import (OpacityGrid, build_opacity_grid,
                                             load_grid, save_grid)
    from bart_tpu_torch.parallel import dryrun, init_distributed, local_device
    from bart_tpu_torch.rt.forward import ForwardConfig, ForwardModel

    inp = demo_inputs(nlayer=4, nwave=32, nlines=10, t_step=1300.0)
    grid = OpacityGrid(["CH4"], inp.t_grid, inp.pressure, inp.wn,
                       torch.zeros(1, len(inp.t_grid), 4, 32))
    path = str(tmp_path / "grid.npz")
    save_grid(grid, path)
    ckpt = str(tmp_path / "ck.npz")
    save_checkpoint(ckpt, SamplerState(*[torch.zeros(2)] * 9), 0,
                    torch.Generator())
    demo_cfg = str(REPO / "examples" / "torch_demo" / "eclipse.cfg")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # the cfg sets wnosamp
        cfg = load_config(demo_cfg, {"loc_dir": str(tmp_path / "out")})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "ForwardModel": lambda: ForwardModel(
            ForwardConfig(**inp.config_kwargs), wn_grid=inp.wn,
            pressure=inp.pressure, species=inp.species,
            base_abundances=inp.base_q, opacity=grid, system=inp.system,
            bands=BandMatrix(torch.zeros(10, 32), 10)),
        "build_demo_model": lambda: build_demo_model(inp, grid=grid),
        "build_opacity_grid": lambda: build_opacity_grid(
            {"CH4": inp.lines}, inp.wn, inp.t_grid, inp.pressure),
        "load_grid": lambda: load_grid(path),
        "build_band_matrix": lambda: build_band_matrix(
            np.linspace(2500.0, 5000.0, 256), inp.filters),
        "tile_lines_bucketed": lambda: tile_lines_bucketed(
            inp.lines, inp.wn, 25.0),
        "tile_lines": lambda: tile_lines(inp.lines, inp.wn, 25.0),
        "load_checkpoint": lambda: load_checkpoint(ckpt),
        # a plain callable forward has no device of its own
        "Likelihood": lambda: Likelihood(
            lambda p: (p, p, p[:, 0] > 0), ParamSpace([0.0], [-1], [1], [1]),
            np.zeros(1), np.ones(1)),
        "contribution_functions": lambda: cf.contribution_functions(
            np.ones((4, 32)), np.linspace(2e9, 1e9, 4), np.full(4, 1e3),
            inp.pressure, inp.wn),
        "transmittance": lambda: cf.transmittance(
            np.ones((4, 32)), np.linspace(2e9, 1e9, 4)),
        "band_average": lambda: cf.band_average(
            np.ones((4, 32)), np.linspace(2500.0, 5000.0, 32), inp.filters),
        # the driver: without --device, even --validate asks for the card
        "Pipeline": lambda: Pipeline(cfg),
        "cli.main": lambda: cli.main(["-c", demo_cfg, "--validate"]),
        # the console script: pyproject's target, resolved as an
        # installer does
        "bart-tpu-torch": lambda: _console_script()(
            ["-c", demo_cfg, "--validate"]),
        # a rank's device: cuda:{LOCAL_RANK} unless the caller names one
        "init_distributed": lambda: init_distributed(
            f"file://{tmp_path}/rdzv", 1, 0),
        "local_device": lambda: local_device(),
        "dryrun.main": lambda: dryrun.main([]),
        # the benchmark's problem, entry(), the benchmark, the cookbook
        "build_problem": lambda: entry_mod.build_problem(4, 32, 10),
        "entry": lambda: entry_mod.entry(nlayer=4, nwave=32, nlines=10),
        "bench.main": lambda: bench.main(["--tiny"]),
        "quickstart": lambda: _quickstart().main([]),
    }
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="is_available"):
        calls[entry]()


def test_graphs_and_run_mcmc_import_and_run_without_jax(tmp_path):
    """The new entry points (ForwardModel.graphed, StepGraph, the
    complete run_mcmc) import with jax and bart_tpu blocked, and run_mcmc
    runs every walk on a CPU likelihood, with checkpoint, resume,
    savemodel and logfile."""
    proc = _run(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["bart_tpu"] = None
        import numpy as np, torch
        from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
        from bart_tpu_torch.inference.retrieval import run_mcmc
        from bart_tpu_torch.inference.samplers import StepGraph
        from bart_tpu_torch.rt.forward import ForwardModel
        assert callable(ForwardModel.graphed) and StepGraph
        torch.set_num_threads(2)
        space = ParamSpace([0.0, 0.0], [-5, -5], [5, 5], [0.1, 0.1])
        fwd = lambda p: (p, p, torch.ones(p.shape[0], dtype=torch.bool))
        like = Likelihood(fwd, space, np.array([1.0, -1.0]), np.ones(2),
                          device="cpu")
        out = {str(tmp_path)!r}
        for walk in ("snooker", "demc", "mrw", "unif"):
            kw = dict(nchains=4, burnin=10, walk=walk, block=10,
                      verbose=False, checkpoint=f"{{out}}/{{walk}}.npz",
                      savemodel=f"{{out}}/{{walk}}_models.npy",
                      logfile=f"{{out}}/{{walk}}.log")
            run_mcmc(like, space, numit=200, **kw)
            res = run_mcmc(like, space, numit=400, resume=True, **kw)
            assert res.posterior.shape == (4, 2, 90)
            assert res.models.shape == (4, 2, 100)
        print("ok")
    """)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_model_and_inference_surface_runs_without_jax(tmp_path):
    """Every PT family, diagnostics, spectrum_from_profiles, the
    contribution functions, the wavelet likelihood, the least-squares
    pre-fit and read_mcmc_log, with jax and bart_tpu blocked, at a tiny
    size on the CPU."""
    proc = _run(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["bart_tpu"] = None
        import numpy as np, torch
        from bart_tpu_torch.demo import (PT_PARAMS, build_demo_model,
                                         demo_inputs, demo_params)
        from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
        from bart_tpu_torch.inference.retrieval import run_mcmc
        from bart_tpu_torch.post import cf
        from bart_tpu_torch.post.bestfit import read_mcmc_log
        torch.set_num_threads(2)
        inp = demo_inputs(nlayer=6, nwave=64, nlines=40, t_step=1300.0)
        grid = build_demo_model(inp, dtype=torch.float64, budget_bytes=1e7,
                                device="cpu").opacity
        for family in PT_PARAMS:
            fm = build_demo_model(inp, dtype=torch.float64, grid=grid,
                                  pt_type=family, device="cpu")
            band, spec, valid = fm(torch.tensor(demo_params(family)[None]))
            assert bool(valid.all()) and bool(torch.isfinite(band).all())
        T, q, rad, ext, valid = fm.diagnostics_batch()(
            torch.tensor(demo_params("piette")[None]))
        assert ext.shape == (1, 6, 64) and bool(valid.all())
        spec2 = fm.spectrum_from_profiles(T, q, rad)
        assert torch.allclose(spec2, spec, rtol=1e-10)
        c = cf.contribution_functions(ext, rad, T, inp.pressure, inp.wn,
                                      device="cpu")
        assert isinstance(c, np.ndarray) and np.all(c >= 0)
        assert cf.band_average(c, inp.wn, inp.filters,
                               device="cpu").shape == (1, 6, 10)
        assert cf.transmittance(ext, rad, device="cpu").shape == (1, 6, 64)
        pinit = np.concatenate([demo_params("iso"), [1.0, 1e-5, 2e-5]])
        space = ParamSpace(pinit, [400, -9, 0, 0, 1e-7],
                           [3000, 1.5, 3, 1e-3, 1e-3],
                           [10.0, 0.1, 0.0, 1e-6, 1e-6])
        fm = build_demo_model(inp, dtype=torch.float64, grid=grid,
                              pt_type="iso", device="cpu")
        data = fm(torch.tensor(demo_params("iso")[None]))[0][0].numpy()
        like = Likelihood(fm, space, data, np.full(10, 2e-5), wlike=True)
        log = {str(tmp_path)!r} + "/MCMC.log"
        res = run_mcmc(like, space, nchains=6, numit=120, burnin=0,
                       block=10, verbose=False, leastsq=True, logfile=log)
        assert np.isfinite(res.best_loglike)
        np.testing.assert_allclose(read_mcmc_log(log)[0], res.bestp,
                                   rtol=1e-7)
        assert not any(k == "jax" or k.startswith("jax.")
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.mark.parametrize("entry", ["graphed", "StepGraph", "run_block"])
def test_graph_constructors_raise_without_a_card(entry, monkeypatch):
    """The graphed forward and the step graph raise on a CPU model or
    state (no eager fallback), without a card."""
    import numpy as np

    from bart_tpu_torch.demo import build_demo_model, demo_inputs
    from bart_tpu_torch.inference.samplers import EnsembleSampler, StepGraph

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "graphed":
        inp = demo_inputs(nlayer=4, nwave=64, nlines=10, t_step=1300.0)
        fm = build_demo_model(inp, dtype=torch.float64, budget_bytes=1e7,
                              device="cpu")
        with pytest.raises(RuntimeError, match="CUDA graph"):
            fm.graphed()
        return
    s = EnsembleSampler(
        loglike_fn=lambda x: (-0.5 * (x * x).sum(1), x), nfree=2, nmodel=2,
        nchains=4, pmin=np.full(2, -3.0), pmax=np.full(2, 3.0))
    gen = torch.Generator().manual_seed(0)
    state = s.init_state(gen)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        if entry == "StepGraph":
            StepGraph(s, state, 5)
        else:
            s.run_block(state, gen, 5, graphed=True)
    assert s._graphs == {}


def test_driver_imports_neither_matplotlib_nor_jax():
    """The pipeline, the CLI, the best-fit module, the benchmark's problem
    (``entry``), the benchmark and its roofline accounting import without
    matplotlib (the card's machine has none: post/plots.py is imported by
    the post stage only) and without jax or bart_tpu."""
    proc = _run("""
        import sys
        import bart_tpu_torch.driver.pipeline
        import bart_tpu_torch.driver.cli
        import bart_tpu_torch.driver.validate
        import bart_tpu_torch.post.bestfit
        import bart_tpu_torch.chem.tea
        import bart_tpu_torch.entry
        import bart_tpu_torch.bench
        import bart_tpu_torch.utils.roofline
        bad = sorted(k for k in sys.modules if k.split(".")[0] in
                     ("matplotlib", "jax", "bart_tpu"))
        print("ok" if not bad else bad)
    """)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr


def test_onthefly_and_line_list_entry_points_run_without_jax(tmp_path):
    """The on-the-fly forward (osamp 2, eclipse and transit), the osamp
    table build, the native HITRAN scanner, the ExoMol, PS-binary and
    Plez readers, the lineread CLI and the widths tool, with jax and
    bart_tpu blocked, at a tiny size on the CPU."""
    proc = _run(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["bart_tpu"] = None
        import numpy as np, torch
        from bart_tpu_torch import constants as const
        from bart_tpu_torch.demo import (DEMO_PARAMS, DEMO_PARAMS_TRANSIT,
                                         demo_inputs)
        from bart_tpu_torch.linelist import exomol, kurucz_mol, lineread
        from bart_tpu_torch.linelist.hitran import read_par
        from bart_tpu_torch.linelist.tli import load_tli
        from bart_tpu_torch.native import hitran_native
        from bart_tpu_torch.obs.bands import build_band_matrix
        from bart_tpu_torch.opacity.extinction import (BroadeningSpec,
                                                       tile_lines)
        from bart_tpu_torch.opacity.grid import build_opacity_grid
        from bart_tpu_torch.rt.forward import ForwardConfig, ForwardModel
        from bart_tpu_torch.tools import widths
        torch.set_num_threads(2)
        inp = demo_inputs(nlayer=6, nwave=64, nlines=40, t_step=1300.0)
        tiles = tile_lines(inp.lines, inp.wn, 25.0, device="cpu")
        for sol, p in (("eclipse", DEMO_PARAMS),
                       ("transit", DEMO_PARAMS_TRANSIT)):
            kw = (dict(star_flux=inp.star_flux, rprs=inp.system.rprs)
                  if sol == "eclipse" else {{}})
            fm = ForwardModel(
                ForwardConfig(solution=sol, molfit=("CH4",)),
                wn_grid=inp.wn, pressure=inp.pressure, species=inp.species,
                base_abundances=inp.base_q, opacity={{"CH4": tiles}},
                system=inp.system, bands=build_band_matrix(
                    inp.wn, inp.filters, device="cpu", dtype=torch.float64,
                    **kw),
                broadening=BroadeningSpec(), osamp=2, dtype=torch.float64,
                device="cpu")
            band, spec, valid = fm(torch.tensor(p[None]))
            assert bool(valid.all()) and bool(torch.isfinite(band).all())
        g = build_opacity_grid({{"CH4": inp.lines}}, inp.wn, inp.t_grid,
                               inp.pressure, osamp=4, budget_bytes=1e6,
                               device="cpu")
        assert float(g.sigma.max()) > 0
        rec = (" 61" + " 3028.752190" + " 1.216E-19" + " 7.845E+00"
               + ".0633" + ".0791" + " 1293.1413" + "0.73" + "-.007280"
               + " " * 93)
        d = {str(tmp_path)!r}
        open(d + "/ch4.par", "w").write(rec + "\\n")
        assert hitran_native.read_par(d + "/ch4.par")["CH4"].nlines == 1
        assert read_par(d + "/ch4.par")["CH4"].wn0[0] == 3028.75219
        open(d + "/m.states", "w").write("1 0.0 4 0\\n2 3000.0 8 1\\n")
        open(d + "/m.trans", "w").write("2 1 1.0e-2\\n")
        assert exomol.read_exomol(d + "/m.states", d + "/m.trans",
                                  "H2O").nlines == 1
        kurucz_mol.write_ps_binary(d + "/h.bin", np.array([3000.0]),
                                   np.array([100.0]), np.array([1e-5]))
        open(d + "/vo.dat", "w").write("3000.0 0.1 -2.0\\n")
        assert kurucz_mol.read_plez_vo(d + "/vo.dat").nlines == 1
        open(d + "/pyline.cfg", "w").write(
            "[Parameters]\\ndb_list = " + d + "/ch4.par " + d + "/h.bin "
            + d + "/m.states:" + d + "/m.trans\\ndbtype = hit ps exomol\\n"
            "part_list = implicit\\noutput = " + d + "/out.tli\\n"
            "iwav = 2.0\\nfwav = 4.0\\n")
        assert lineread.main(["-c", d + "/pyline.cfg"]) == 0
        assert load_tli(d + "/out.tli.npz").species == ["CH4", "H2O"]
        assert widths.main(["-c", "examples/torch_demo/eclipse.cfg"]) == 0
        assert not any(k.split(".")[0] in ("jax", "bart_tpu")
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), \
        proc.stdout + proc.stderr


def test_parallel_imports_and_runs_without_jax(tmp_path):
    """bart_tpu_torch.parallel (distributed, mesh, dryrun) and the lazy
    make_mesh/shard_model exports with jax and bart_tpu blocked; no group
    without a world size; a one-rank gloo group on the CPU, a 1x1 mesh,
    a sharded forward equal to the unsharded one and one collective."""
    proc = _run(f"""
        import os, sys
        sys.modules["jax"] = None
        sys.modules["bart_tpu"] = None
        import numpy as np, torch
        import bart_tpu_torch
        import bart_tpu_torch.parallel.dryrun
        from bart_tpu_torch.parallel import (init_distributed, is_multihost,
                                             make_mesh)
        from bart_tpu_torch.demo import DEMO_PARAMS, build_demo_model, demo_inputs
        assert bart_tpu_torch.make_mesh is make_mesh
        shard_model = bart_tpu_torch.shard_model
        torch.set_num_threads(2)
        os.environ.pop("WORLD_SIZE", None)
        assert init_distributed(device="cpu") is False
        try:
            make_mesh(1, 1, device="cpu")
            raise AssertionError("make_mesh without a group")
        except RuntimeError:
            pass
        assert init_distributed("file://{tmp_path}/rdzv", 1, 0,
                                device="cpu") is False
        assert not is_multihost()
        mesh = make_mesh(1, 1, device="cpu")
        assert mesh.shape == {{"chain": 1, "wn": 1}} and not mesh.capturable
        inp = demo_inputs(nlayer=6, nwave=64, nlines=40, t_step=1300.0)
        fm = build_demo_model(inp, dtype=torch.float64, budget_bytes=1e7,
                              device="cpu")
        ref = fm(torch.tensor(DEMO_PARAMS[None]))
        shard_model(fm, mesh)
        got = fm(torch.tensor(DEMO_PARAMS[None]))
        assert mesh.collectives == 1 and fm.n_wn_orig == 64
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert not any(k.split(".")[0] in ("jax", "bart_tpu")
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr
