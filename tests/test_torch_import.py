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


@pytest.mark.parametrize("entry", [
    "ForwardModel", "build_demo_model", "build_opacity_grid", "load_grid",
    "build_band_matrix", "tile_lines_bucketed"])
def test_entry_points_default_to_the_card(entry, monkeypatch, tmp_path):
    """Called without ``device=`` and without a card, every entry point
    that creates tensors raises: none falls back to the CPU."""
    import numpy as np

    from bart_tpu_torch.demo import build_demo_model, demo_inputs
    from bart_tpu_torch.obs.bands import BandMatrix, build_band_matrix
    from bart_tpu_torch.opacity.extinction import tile_lines_bucketed
    from bart_tpu_torch.opacity.grid import (OpacityGrid, build_opacity_grid,
                                             load_grid, save_grid)
    from bart_tpu_torch.rt.forward import ForwardConfig, ForwardModel

    inp = demo_inputs(nlayer=4, nwave=32, nlines=10, t_step=1300.0)
    grid = OpacityGrid(["CH4"], inp.t_grid, inp.pressure, inp.wn,
                       torch.zeros(1, len(inp.t_grid), 4, 32))
    path = str(tmp_path / "grid.npz")
    save_grid(grid, path)
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
    }
    with pytest.raises(RuntimeError, match="is_available"):
        calls[entry]()
