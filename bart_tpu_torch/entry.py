"""The benchmark's problem and the single-card entry point (counterpart
of the JAX package's ``__graft_entry__._build_problem`` and ``entry``).

``build_problem`` builds the demo-shaped CH4 problem of the benchmark:
the synthetic planet system, ten top-hat filters and the synthetic CH4
line list of ``demo.demo_inputs`` (seed 12, bands at 2700/3100/4300
cm-1; the reference's HITRAN data is an external download), a uniform
T grid from 400 to 3000 K in steps of 100 K, and the eclipse or transit
forward model of ``demo.build_demo_model`` on that table.

With ``cache=True`` the opacity table is kept in an uncompressed npz
under a key of everything that determines its values: the sources whose
code makes it (``TABLE_SOURCES``) and the values of the line list, the
pressure grid, the wn grid it is tabulated on and the T grid.  A repeated
benchmark then loads the table instead of rebuilding it (the fine table
of the folded problem takes minutes to build on the card, seconds to
load).  The file lies in ``BENCH_CACHE_DIR`` (default: the checkout's
root, where ``.gitignore`` lists ``.bench_grid_*.npz``).  Each table's
origin, built or loaded, and its seconds are logged to this module's
logger.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["TABLE_SOURCES", "ENTRY_PARAMS", "build_problem", "table_key",
           "table_path", "entry"]

log = logging.getLogger(__name__)

PACKAGE = Path(__file__).resolve().parent
#: the sources, relative to the package, whose code makes the table
TABLE_SOURCES = ("opacity/*.py", "physics/voigt.py", "linelist/tli.py",
                 "utils/grids.py")
#: the parameters of ``entry``'s forward [log kappa, log g1, log g2,
#: alpha, beta, log CH4]
ENTRY_PARAMS = (-2.0, 0.0, 1.0, 0.0, 0.98, -0.5)


def table_key(lines, pressure, wn_rt, t_grid, package: Path = PACKAGE
              ) -> str:
    """sha256 of the table's sources (``TABLE_SOURCES`` under
    ``package``) and of the values of its inputs: the line list's wn0,
    s296 and elower, the pressure grid, the wn grid the table is
    tabulated on and the T grid."""
    h = hashlib.sha256()
    srcs = []
    for pattern in TABLE_SOURCES:
        found = sorted(package.glob(pattern))
        if not found:
            raise FileNotFoundError(f"no table source {package / pattern}")
        srcs += found
    for src in srcs:
        h.update(src.read_bytes())
    for arr in (lines.wn0, lines.s296, lines.elower, pressure, wn_rt,
                t_grid):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def table_path(nlayer: int, nwave: int, nlines: int, fold: int,
               dtype: torch.dtype, key: str) -> Path:
    """The cache file of a table: ``.bench_grid_torch_{nlayer}x{nwave}x
    {nlines}[_fold{K}]_{dtype}_{key[:12]}.npz`` in ``BENCH_CACHE_DIR``
    (default: the checkout's root)."""
    root = Path(os.environ.get("BENCH_CACHE_DIR", PACKAGE.parent))
    fold_tag = f"_fold{fold}" if fold > 1 else ""
    name = str(dtype).removeprefix("torch.")
    return root / (f".bench_grid_torch_{nlayer}x{nwave}x{nlines}{fold_tag}"
                   f"_{name}_{key[:12]}.npz")


def build_problem(nlayer: int = 40, nwave: int = 512, nlines: int = 4000,
                  dtype: torch.dtype = torch.float32, cache: bool = False,
                  solution: str = "eclipse", fold: int = 1,
                  fold_adapt: float | None = None,
                  quadrature: str = "raygrid", nquad: int = 8,
                  fold_bf16: bool = False, *,
                  device: str | torch.device = "cuda"):
    """The benchmark's demo-shaped CH4 problem on ``device`` (the card
    unless the caller asks for the CPU): a ForwardModel of ``solution``
    ("eclipse" or "transit"; transit bands have no stellar division) at
    ``nlayer`` layers x ``nwave`` wn from 2500 to 5000 cm-1 on ``nlines``
    lines.  ``fold`` = K > 1 builds the folded problem: the table on the
    K-times-finer folded_fine_grid, the outputs on the nwave grid;
    ``fold_adapt`` and ``fold_bf16`` as ForwardModel's.  ``cache=True``
    loads the table from its cache file when there is one, else builds
    it and saves it there (a failed save raises)."""
    from bart_tpu_torch.demo import build_demo_model, demo_inputs
    from bart_tpu_torch.device import resolve_device
    from bart_tpu_torch.opacity.grid import (build_budget,
                                             build_opacity_grid, load_grid,
                                             save_grid)
    from bart_tpu_torch.utils.grids import folded_fine_grid

    if solution not in ("eclipse", "transit"):
        raise ValueError(f"solution {solution!r}: the benchmark's problems "
                         "are 'eclipse' and 'transit'")
    device = resolve_device(device)
    inp = demo_inputs(nlayer, nwave, nlines)
    wn_rt = folded_fine_grid(inp.wn, fold)

    path = None
    if cache:
        path = table_path(nlayer, nwave, nlines, fold, dtype,
                          table_key(inp.lines, inp.pressure, wn_rt,
                                    inp.t_grid))
    t0 = time.perf_counter()
    if path is not None and path.is_file():
        grid = load_grid(str(path), device=device)
        how = f"loaded from {path.name}"
    else:
        grid = build_opacity_grid({"CH4": inp.lines}, wn_rt, inp.t_grid,
                                  inp.pressure,
                                  budget_bytes=build_budget(device),
                                  device=device, dtype=dtype)
        how = "built"
        if path is not None:
            # written under a temporary name and moved into place: a
            # reader never sees half a file
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
            save_grid(grid, str(tmp))
            os.replace(tmp, path)
            how = f"built and saved to {path.name}"
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log.info("table %s %s in %.1f s", tuple(grid.sigma.shape), how,
             time.perf_counter() - t0)
    return build_demo_model(inp, device=device, dtype=dtype, grid=grid,
                            quadrature=quadrature, nquad=nquad,
                            solution=solution, fold=fold,
                            fold_adapt=fold_adapt, fold_bf16=fold_bf16)


def entry(*, device: str | torch.device = "cuda", **problem):
    """(fn, (params,)): one forward of ``build_problem(**problem)`` (the
    default problem unless given) at ``ENTRY_PARAMS`` on ``device`` (the
    card unless the caller asks for the CPU).  ``params`` is [1, 6] and
    ``fn(params)`` returns the band fluxes [1, nfilters]."""
    fm = build_problem(device=device, **problem)
    params = torch.tensor([ENTRY_PARAMS], dtype=fm.dtype, device=fm.device)

    def fn(p: torch.Tensor) -> torch.Tensor:
        return fm(p)[0]

    return fn, (params,)
