"""One run of a cell: the port's retrieval path set up from the cell's cfg,
the graphed ensemble sampler driven for a window of ``seconds``, its
outputs kept for the check, and with ``trace`` the per-layer readings.

Set-up is what a user's ``run_mcmc`` does before its first block: the
pipeline's stages (pressure, abundances, atmosphere, line list, opacity
table, forward model and likelihood), the sampler on that likelihood, its
state and its first block (which captures the step as a CUDA graph).  The
program's table and the reference's own are kept at fixed paths of the
checkout (``cache/<cell>/``): only a checkout's first run of a cell builds
them.
"""

from __future__ import annotations

import gc
import os
import shutil
import time

import numpy as np
import torch

from . import check, kernels, manifest
from .trace import Trace

CACHE = os.path.join(manifest.HERE, "cache")
#: graphed() forwards traced for the forward's layer metrics
TRACED_FORWARDS = 20
#: blocks traced for the sampler's and the device's metrics
TRACED_BLOCKS = 2
#: the program's type, as the configurations run it
DTYPE = torch.float32
#: seconds of blocks between set-up and the window (``warm_up``)
WARM_SECONDS = 30.0
#: the chains' start: the cfg's parameters plus this share of each
#: prior width, normal, drawn from the seed
START_JITTER = 0.01


def raw_cfg(w: dict, overrides: dict | None = None) -> dict:
    """The cfg keys of the cell (configuration, then traffic, then
    ``overrides``) with its data paths made absolute."""
    conf = w["config_obj"]
    raw = dict(conf["cfg"])
    raw.update(w["traffic_params"]["cfg"])
    raw.update(overrides or {})
    for k in conf["path_keys"]:
        if k in raw and not os.path.isabs(raw[k].split()[0]):
            raw[k] = " ".join(os.path.join(manifest.HERE, v)
                              for v in raw[k].split())
    return raw


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans(dict):
    """Host-clock spans of the harness around the program's layers, each
    ending in a synchronise: {name: seconds}."""

    def __init__(self, device):
        super().__init__()
        self.device = device

    def __call__(self, name):
        spans = self

        class _Span:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                sync(spans.device)
                spans[name] = time.perf_counter() - self.t0

        return _Span()


def set_up(w: dict, device: torch.device, spans: Spans,
           overrides: dict | None = None):
    """(cfg, forward model, likelihood, parameter space, table path): the
    pipeline's stages up to the likelihood, as Pipeline.run takes them."""
    from bart_tpu_torch.driver.config import load_config
    from bart_tpu_torch.driver.pipeline import Pipeline
    from bart_tpu_torch.utils.grids import folded_fine_grid

    cache = os.path.join(CACHE, w["name"])
    out = os.path.join(cache, "out")
    shutil.rmtree(out, ignore_errors=True)
    raw = raw_cfg(w, overrides)
    raw.update(loc_dir=out, opacityfile=os.path.join(cache, "opacity.npz"),
               quiet="True", plots="False")
    cfg = load_config(None, raw)
    pipe = Pipeline(cfg, device=device, dtype=DTYPE)
    with spans("setup.atmosphere"):
        pressure = pipe.stage_pressure()
        atm = pipe.stage_atmosphere(pressure, pipe.stage_abundances())
    wn = cfg.wavenumber_grid()
    wn_rt = folded_fine_grid(wn, cfg.fold_K) if cfg.fold_K > 1 else wn
    with spans("setup.table"):
        tli = pipe.stage_linelist(wn_rt)
        grid = pipe.stage_opacity(tli, wn_rt, pressure, atm)
        fm, like, space = pipe.stage_forward(atm, wn, grid)
        if cfg.fold_K > 1:
            fm.opacity = None
        del grid
    return cfg, fm, like, space, raw["opacityfile"]


def start_positions(space, chains: int, jitter: float, seed: int):
    """The cfg's free parameters plus a jitter of ``jitter`` of each
    prior width, normal, drawn from the seed, clipped to the prior."""
    rng = np.random.default_rng([seed, 1])
    width = space.free_max - space.free_min
    x = space.free_init + rng.normal(size=(chains, space.nfree)) \
        * jitter * width
    return np.clip(x, space.free_min, space.free_max)


def chains(w: dict, cfg, like, space, seed: int, device: torch.device):
    """(sampler, generator, record): the ensemble sampler on the
    likelihood at the traffic's chain count, its generator seeded, and
    the record the check reads (the starting positions, every block's
    outputs and the generator's state before each draw)."""
    from bart_tpu_torch.inference.samplers import EnsembleSampler

    tp = w["traffic_params"]
    C, B = int(tp["chains"]), int(tp["block"])
    sampler = EnsembleSampler(
        loglike_fn=like, nfree=space.nfree, nmodel=int(like.data.shape[0]),
        nchains=C, walk=cfg.walk, pmin=space.free_min, pmax=space.free_max,
        stepsize=space.stepsize[space.ifree],
        snooker_frac=cfg.snooker_frac, z_thin=cfg.z_thin)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init = start_positions(space, C, START_JITTER, seed)
    rec = dict(block=B, chains=C, lo=space.free_min, hi=space.free_max,
               device=device, z_thin=cfg.z_thin,
               snooker_frac=cfg.snooker_frac, fgamma=sampler.fgamma,
               init_pos=init, blocks=[], gen_blocks=[],
               first_window_block=1, graphed=device.type == "cuda")
    return sampler, gen, rec


def advance(sampler, gen, rec: dict, state):
    """One block of ``rec['block']`` steps (the captured step replayed on
    a card), its outputs copied to the host as run_mcmc stores them."""
    rec["gen_blocks"].append(gen.get_state())
    state, pb, lb, mb = sampler.run_block(state, gen, rec["block"],
                                          graphed=rec["graphed"])
    rec["blocks"].append((pb.cpu().numpy(), lb.cpu().numpy(),
                          mb.cpu().numpy()))
    return state


def begin(sampler, gen, rec: dict):
    """The initial state and the first block (on a card: the step's
    warm-up, its capture and the block's replays)."""
    rec["gen_init"] = gen.get_state()
    state = sampler.init_state(gen, rec["init_pos"], dtype=torch.float64)
    rec["nz"] = sampler.nz
    return advance(sampler, gen, rec, state)


def warm_up(sampler, gen, rec: dict, state, seconds: float):
    """Blocks for ``seconds`` after set-up, before the window: a
    process's first seconds of replays run slower on the card (a
    transient of 5-30 s on an H100, at unchanged clocks), so the window
    starts after it.  Every shape was built and run in set-up's first
    block, so this is neither set-up nor window.  Their outputs stay in
    the record (the check rebuilds the archive from every step); the
    window's first block follows them."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        state = advance(sampler, gen, rec, state)
    rec["first_window_block"] = len(rec["blocks"])
    return state


def reference_table(ref, name: str) -> np.ndarray:
    """The reference's own table [M, nT, L, F], float32: built line by
    line on the device by a checkout's first run of the cell and kept in
    ``cache/<cell>/reference.npz`` with the digest of its inputs (built
    anew where that differs)."""
    path = os.path.join(CACHE, name, "reference.npz")
    key = ref.fingerprint()
    if os.path.exists(path):
        with np.load(path) as z:
            if str(z["key"]) == key:
                return z["sigma"]
    sigma = ref.build_table().float().cpu().numpy()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".part", "wb") as f:
        np.savez(f, sigma=sigma, key=key)
    os.replace(path + ".part", path)
    return sigma


def run(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", overrides: dict | None = None) -> dict:
    """One run -> the result's fields (``metrics`` holds every metric the
    run read; the caller picks the cell's), plus ``checks`` {number:
    (value, limit)}."""
    from .reference import Reference

    w = manifest.cell(cell)
    dev = torch.device(device)
    graphed = dev.type == "cuda"
    spans = Spans(dev)
    cfg, fm, like, space, table_path = set_up(w, dev, spans, overrides)

    sampler, gen, rec = chains(w, cfg, like, space, seed, dev)
    with spans("setup.capture"):
        state = begin(sampler, gen, rec)
    setup_s = time.perf_counter() - t_start
    B, C = rec["block"], rec["chains"]
    state = warm_up(sampler, gen, rec, state, WARM_SECONDS)

    # --- the window ----------------------------------------------------
    t0 = time.perf_counter()
    ends = [t0]
    while True:
        state = advance(sampler, gen, rec, state)
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    window_s = ends[-1] - t0
    first = rec["first_window_block"]
    steps = (len(rec["blocks"]) - first) * B
    peak = torch.cuda.max_memory_allocated(dev) if graphed else 0
    out = {"attempted": C * steps,
           "failed": int(sum(np.isnan(b[1]).sum() + np.isnan(b[2]).any(
               axis=-1).sum() for b in rec["blocks"][first:])),
           "metrics": {"evals_per_s": C * steps / window_s,
                       "setup_s": setup_s},
           "memory_peak_bytes": peak, "window_s": window_s, "steps": steps,
           "block_s": np.diff(ends)}

    ctx = (traced(fm, space, sampler, state, gen, B, C, spans,
                  window_s / steps) if trace else None)
    del fm, like, sampler, state
    gc.collect()
    if graphed:
        torch.cuda.empty_cache()

    # --- the check -------------------------------------------------------
    ref = Reference(w["config_obj"], dict(w["traffic_params"]["cfg"],
                                          **(overrides or {})),
                    manifest.HERE, dev)
    own = reference_table(ref, w["name"])
    ref.load_table(own, *ref.precisions())
    with np.load(table_path) as z:
        sigma = z["sigma"]
    lim = w["limits"]
    stage = None
    if "stage_model_gap" in lim or "stage_loglike_gap" in lim:
        stage = Reference(w["config_obj"], ref.c, manifest.HERE, dev)
        stage.load_table(sigma, *stage.precisions())
    nums = check.compare(ref, rec, sigma, own, seed, lim, stage)
    out["checks"] = {k: (nums[k], lim[k]) for k in check.NUMBERS
                     if k in lim}
    out["correct"] = all(v <= lim for v, lim in out["checks"].values()) \
        and out["failed"] == 0
    if ctx is not None:
        out.update(per_layer(w, ctx, ref))
    return out


def traced(fm, space, sampler, state, gen, B, C, spans, step_s) -> dict:
    """What the per-layer readers read: a trace of TRACED_BLOCKS replayed
    blocks (host copies included, as in the window) and one of
    TRACED_FORWARDS ``graphed()`` forwards at the window's positions."""
    box = [state]

    def blocks():
        for _ in range(TRACED_BLOCKS):
            st, pb, lb, mb = sampler.run_block(box[0], gen, B, graphed=True)
            pb.cpu(), lb.cpu(), mb.cpu()
            box[0] = st

    tb = Trace.record(blocks)
    gfwd = fm.graphed()
    full = space.expand(box[0].positions)
    gfwd(full)
    torch.cuda.synchronize()
    tf = Trace.record(lambda: [gfwd(full) for _ in range(TRACED_FORWARDS)])
    return {"spans": dict(spans), "blocks": tb, "forward": tf,
            "steps": TRACED_BLOCKS * B, "forwards": TRACED_FORWARDS,
            "step_s": step_s, "chains": C}


def per_layer(w: dict, ctx: dict, ref) -> dict:
    """The cell's per-layer readings from ``traced``'s context, the
    kernels' bounds taken at the reference's shapes."""
    tb = ctx["blocks"]
    ctx["bounds"] = kernels.launch_bounds(ref, ctx["chains"])
    per = {}
    for m in w["per_layer"]:
        v = manifest.reader(m["name"])(ctx)
        if v is not None:
            per[m["name"]] = float(v)
    return {"per_layer": per,
            "busy_s": tb.busy_us() * 1e-6, "traced_window_s":
                tb.window_us * 1e-6,
            "breakdown": {"device_ops": tb.top_ops(),
                          "idle_gaps": tb.top_gaps()}}
