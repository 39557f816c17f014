"""Shared helpers of the benchmark's tests: the harness at a tiny size on
the CPU (16 layers, 25 cm-1 bins, 650 K T steps, the 600 strongest lines a
species, 16 chains, K = 4 where the cell folds)."""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from bm import cell, check, manifest  # noqa: E402

CELLS = [w["name"] for w in manifest.manifest()["workloads"]]
CHECK = {"table_entries": 64, "states": 8, "steps": 2, "chains_per_step": 8}


def tiny_harness(monkeypatch, workdir: str) -> None:
    """The harness's sampling, warm-up and cache at a CPU test's size,
    the program in float64 (its float32 build's rounding at 25 cm-1 bins
    and 600 lines is not what the cells' limits were read at)."""
    monkeypatch.setattr(check, "SAMPLES", CHECK)
    monkeypatch.setattr(cell, "DTYPE", torch.float64)
    monkeypatch.setattr(cell, "WARM_SECONDS", 0.5)
    monkeypatch.setattr(cell, "CACHE", workdir)


def small_tli(src: str, dst: str, n: int = 600) -> str:
    """The n strongest lines of each species of a TLI .npz, in wn order."""
    z = np.load(src)
    out = {k: z[k] for k in ("__version__", "__species__", "__wn_range__")}
    for sp in z["__species__"]:
        keep = np.sort(np.argsort(z[f"{sp}/s296"])[-n:])
        for f in ("wn0", "s296", "elower", "gamma_air", "gamma_self",
                  "n_air", "iso"):
            out[f"{sp}/{f}"] = z[f"{sp}/{f}"][keep]
    np.savez(dst, **out)
    return dst


def tiny_overrides(name: str, workdir: str) -> dict:
    """cfg overrides that shrink the cell to a CPU test's size."""
    w = manifest.cell(name)
    linedb = os.path.join(HERE, w["config_obj"]["cfg"]["linedb"])
    dst = os.path.join(workdir, os.path.basename(linedb))
    if not os.path.exists(dst):
        small_tli(linedb, dst)
    ov = {"n_layers": "16", "wndelt": "25", "tempdelt": "650",
          "linedb": dst}
    if int(w["traffic_params"]["cfg"].get("rtosamp", "1")) > 1:
        ov["rtosamp"] = "4"
    return ov


def tiny_run(name: str, workdir: str, seed: int = 2**31 + 12345,
             seconds: float = 1.0, *, monkeypatch) -> dict:
    """One run of the cell at the tiny size on the CPU, its table cached
    in ``workdir``."""
    w = manifest.cell(name)
    w["traffic_params"].update(chains=16)
    monkeypatch.setattr(manifest, "cell", lambda n, man=None: w)
    tiny_harness(monkeypatch, workdir)
    return cell.run(name, seed, seconds, False, time.perf_counter(),
                    device="cpu", overrides=tiny_overrides(name, workdir))
