"""The port's tracing (bart_tpu_torch/utils/profiling.py) on the CPU: spans
that do nothing while off, the forward's spans in order and nested under a
CPU torch.profiler, the recorder's totals on the ``perf_counter`` clock,
the counters, the pipeline's stage timing, and chip_smoke.py's split of
device idle time by the innermost span.  The block timeline's CUDA
events and a real graph capture are gpu cases:
``python -m pytest --noconftest -m gpu tests/test_torch_profiling.py``.
"""

import json
import os
import stat
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bart_tpu_torch.demo import DEMO_PARAMS, build_demo_model, demo_inputs
from bart_tpu_torch.driver import config
from bart_tpu_torch.driver.pipeline import Pipeline
from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
from bart_tpu_torch.inference.samplers import EnsembleSampler
from bart_tpu_torch.rt import forward as fwd_mod
from bart_tpu_torch.rt import fused
from bart_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
PMIN = [-5.0, -2.0, -2.0, 0.0, 0.55, -9.0]
PMAX = [-1.0, 1.0, 1.0, 1.0, 1.2, 1.5]
STEP = [0.01, 0.01, 0.0, 0.0, 0.001, 0.1]
#: the forward's spans in the order they open, each with its parent
FORWARD_SPANS = [("forward", None), ("forward.profiles", "forward"),
                 ("forward.radii", "forward.profiles"),
                 ("forward.rows", "forward"), ("forward.spectrum", "forward"),
                 ("forward.bands", "forward")]


@pytest.fixture
def recorder():
    """The process's recorder, cleared, switched on for the test and off
    after it."""
    rec = profiling.recorder()
    rec.clear()
    was = profiling.recording(True)
    yield rec
    profiling.recording(was)
    rec.clear()


@pytest.fixture(scope="module")
def models():
    inp = demo_inputs(nlayer=8, nwave=64, nlines=100, t_step=520.0)
    ecl = build_demo_model(inp, device="cpu", dtype=torch.float64,
                           budget_bytes=1e7)
    return {"eclipse": ecl,
            "transit": build_demo_model(inp, device="cpu",
                                        dtype=torch.float64,
                                        grid=ecl.opacity,
                                        solution="transit"),
            "folded eclipse": build_demo_model(
                inp, device="cpu", dtype=torch.float64, fold=4,
                budget_bytes=1e7)}


def _params(fm, n=3):
    p = np.array(DEMO_PARAMS, dtype=np.float64)
    if fm.config.solution == "transit":
        p = np.insert(p, fm.config.n_pt, fm.r0_km)
    return torch.tensor(np.repeat(p[None], n, axis=0))


def _sampler(fm):
    data = fm(_params(fm, 1))[0][0].numpy()
    space = ParamSpace(pinit=DEMO_PARAMS, pmin=PMIN, pmax=PMAX,
                       stepsize=STEP)
    like = Likelihood(fm, space, data, 0.03 * data, device="cpu")
    return EnsembleSampler(loglike_fn=like, nfree=space.nfree,
                           nmodel=len(data), nchains=4, pmin=space.free_min,
                           pmax=space.free_max,
                           stepsize=space.stepsize[space.ifree])


def _raise(*args, **kwargs):
    raise AssertionError("entered while the recorder is off and no "
                         "profiler records")


@pytest.mark.parametrize("work", ["span", "forward", "block", "stage"])
def test_off_spans_do_nothing(models, monkeypatch, tmp_path, work):
    """With the recorder off and no profiler, a span is the shared null
    context: no record_function is entered, no CUDA event made, nothing
    recorded; the stage timer still writes its line."""
    profiling.recording(False)
    profiling.recorder().clear()
    monkeypatch.setattr(profiling, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    fm = models["eclipse"]
    if work == "span":
        assert profiling.span("forward") is profiling.span("x")
        with profiling.span("forward"):
            pass
    elif work == "forward":
        fm(_params(fm))
    elif work == "block":
        s = _sampler(fm)
        gen = torch.Generator().manual_seed(3)
        state = s.init_state(gen, dtype=torch.float64)
        s.run_block(state, gen, 2, graphed=False)
    else:
        log = tmp_path / "t.jsonl"
        with profiling.stage_timer("pressure", str(log), verbose=False):
            pass
        assert json.loads(log.read_text())["stage"] == "pressure"
    snap = profiling.recorder().snapshot()
    assert snap["spans"] == {} and snap["blocks"] == []


def _stage_ranges(prof):
    return sorted(((e.time_range.start, -e.time_range.end, e.name[6:])
                   for e in prof.events() if e.name.startswith("stage:")))


@pytest.mark.parametrize("path", ["eclipse", "transit", "folded eclipse"])
def test_forward_spans_in_order_and_nested(models, path):
    """Under a CPU torch.profiler one eager forward shows the forward's
    spans as ``stage:`` ranges in the order they open, each inside its
    parent and after its previous sibling's end; the recorder stays
    empty."""
    fm = models[path]
    params = _params(fm)
    fm(params)
    profiling.recording(False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fm(params)
    ranges = _stage_ranges(prof)
    assert [r[2] for r in ranges] == [n for n, _ in FORWARD_SPANS]
    where = {name: (s, -e) for s, e, name in ranges}
    for name, parent in FORWARD_SPANS[1:]:
        ps, pe = where[parent]
        assert ps <= where[name][0] and where[name][1] <= pe, name
    kids = [n for n, p in FORWARD_SPANS if p == "forward"]
    for a, b in zip(kids, kids[1:]):
        assert where[a][1] <= where[b][0], (a, b)
    assert profiling.recorder().snapshot()["spans"] == {}


def test_spans_record_on_perf_counter(recorder, monkeypatch):
    """With the recorder on, each span adds its perf_counter duration to
    its count and total; a nested span's total lies inside its parent's;
    nothing synchronises, under a profiler too."""
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    t0 = time.perf_counter()
    with profiling.span("outer"):
        with profiling.span("inner"):
            time.sleep(0.002)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("inner"):
                pass
    t1 = time.perf_counter()
    snap = recorder.snapshot()
    n, total = snap["spans"]["inner"]
    on, outer = snap["spans"]["outer"]
    assert n == 2 and on == 1
    assert 0.002 <= total <= outer <= t1 - t0
    assert [r[2] for r in _stage_ranges(prof)] == ["inner"]


@pytest.mark.parametrize("path", ["eclipse", "folded eclipse"])
def test_forward_and_block_spans_recorded(models, recorder, monkeypatch,
                                          path):
    """A CPU block of 2 steps with the recorder on: the sampler's spans
    (the block's two from its marks) and one forward span a likelihood
    call (the initial state's and each step's), each forward's layers
    inside it, no synchronise."""
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    s = _sampler(models[path])
    gen = torch.Generator().manual_seed(5)
    recorder.clear()
    state = s.init_state(gen, dtype=torch.float64)
    s.run_block(state, gen, 2, graphed=False)
    spans = recorder.snapshot()["spans"]
    assert {k: v[0] for k, v in spans.items()} == {
        "sampler.init": 1, "sampler.draws": 1, "sampler.replays": 1,
        "forward": 3, "forward.profiles": 3, "forward.radii": 3,
        "forward.rows": 3, "forward.spectrum": 3, "forward.bands": 3}
    assert recorder.snapshot()["blocks"] == []       # no card: no events
    inside = sum(spans[name][1] for name in (
        "forward.profiles", "forward.rows", "forward.spectrum",
        "forward.bands"))
    assert spans["forward.radii"][1] <= spans["forward.profiles"][1]
    assert inside <= spans["forward"][1]
    assert spans["sampler.draws"][1] > 0 and spans["sampler.replays"][1] > 0


class _Event:
    """A timing event's stand-in at a fixed device time (ms), complete
    once ``done``."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_block_stretches_from_marks(recorder):
    """A block's marks on fixed clocks: the host-clock spans between
    them, and the device stretches (draws, replays, the gap since the
    previous block's end) once the block's last event has completed; a
    block still running waits, a mark out of order is dropped."""
    rec = recorder
    for k, (t, ms) in enumerate([(1.0, 10.0), (1.5, 12.0), (4.0, 52.0)]):
        rec.mark(k, t, _Event(ms))
    late = _Event(95.0, done=False)
    rec.mark(2, 4.5, _Event(99.0))                 # out of order: dropped
    for k, (t, ms) in enumerate([(5.0, 60.0), (5.25, 63.0)]):
        rec.mark(k, t, _Event(ms))
    rec.mark(2, 6.0, late)
    snap = rec.snapshot()
    assert snap["blocks"] == [(2.0, 40.0, None)] and snap["nblocks"] == 1
    late.done = True
    snap = rec.snapshot()
    assert snap["blocks"] == [(2.0, 40.0, None), (3.0, 32.0, 8.0)]
    assert snap["spans"]["sampler.draws"] == pytest.approx((2, 0.75))
    assert snap["spans"]["sampler.replays"] == pytest.approx((2, 3.25))


def _fake_nvcc(tmp_path):
    """A stand-in for nvcc that writes an empty file at its ``-o``."""
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then : > \"$2\"; fi\n"
                    "  shift\ndone\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_kernel_counters_and_load_span(recorder, monkeypatch, tmp_path):
    """A kernel's first load through a stubbed nvcc and ctypes: one
    build, one load, one ``kernels.load`` span; the next load is the
    cached library and counts nothing."""
    nvcc = _fake_nvcc(tmp_path)
    monkeypatch.setattr(fused, "_nvcc", lambda: nvcc)
    monkeypatch.setattr(fused, "_libs", {})
    monkeypatch.setattr(fused.build, "BUILD_DIR", tmp_path / "build")
    loaded = []

    def cdll(path):
        loaded.append(path)
        return types.SimpleNamespace(
            bart_fused_eclipse=types.SimpleNamespace())

    monkeypatch.setattr(fused.ctypes, "CDLL", cdll)
    before = profiling.counters()
    lib = fused.load_kernel("fused_eclipse")
    assert fused.load_kernel("fused_eclipse") is lib and len(loaded) == 1
    assert os.path.isfile(loaded[0])
    after = profiling.counters()
    for name in ("kernels.builds", "kernels.loads"):
        assert after.get(name, 0) - before.get(name, 0) == 1, name
    n, total = recorder.snapshot()["spans"]["kernels.load"]
    assert n == 1 and total >= 0.0


class _FakeGraph:
    """torch.cuda.CUDAGraph's stand-in: replay does nothing."""

    def replay(self):
        pass


def test_forward_capture_counted(models, recorder, monkeypatch):
    """A graphed() forward's capture, its streams and graph faked on the
    CPU: ``graphs.captures`` counts one, ``forward.capture`` holds the
    warm-ups' and the capture's three forwards."""
    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda dev: stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: profiling._NULL)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(fwd_mod, "graph_capture", lambda g: profiling._NULL)
    fm = models["eclipse"]
    before = profiling.counters().get("graphs.captures", 0)
    g = fwd_mod._ForwardGraph(fm, _params(fm))
    assert profiling.counters()["graphs.captures"] == before + 1
    spans = recorder.snapshot()["spans"]
    assert spans["forward.capture"][0] == 1 and spans["forward"][0] == 3
    assert spans["forward"][1] <= spans["forward.capture"][1]
    assert g(_params(fm)) is g.out


def test_pipeline_stage_spans_once(work_cfg, recorder):
    """Pipeline.run (--justTEA) with the recorder on: each stage's span
    once (the stage methods open them, the timer does not again), and
    stage_timing.jsonl keeps its keys."""
    cfg, loc = work_cfg
    Pipeline(cfg, just_tea=True, device="cpu").run()
    spans = recorder.snapshot()["spans"]
    assert {k: v[0] for k, v in spans.items()} == {
        "pressure": 1, "abundances": 1, "atmosphere": 1}
    recs = [json.loads(line) for line in
            (loc / "stage_timing.jsonl").read_text().splitlines()]
    assert [r["stage"] for r in recs] == ["pressure", "abundances",
                                          "atmosphere"]
    assert all(set(r) == {"stage", "wall_s", "ts"} for r in recs)


@pytest.mark.parametrize("stage", ["linelist", "opacity", "forward_setup"])
def test_direct_stage_calls_record(work_cfg, recorder, stage):
    """The stage methods called directly, as the benchmark calls them,
    record their spans without the stage timer."""
    cfg, _ = work_cfg
    pipe = Pipeline(cfg, device="cpu", dtype=torch.float64)
    pressure = pipe.stage_pressure()
    atm = pipe.stage_atmosphere(pressure, pipe.stage_abundances())
    wn = cfg.wavenumber_grid()
    tli = pipe.stage_linelist(wn)
    grid = pipe.stage_opacity(tli, wn, pressure, atm) \
        if stage != "linelist" else None
    if stage == "forward_setup":
        pipe.stage_forward(atm, wn, grid)
    spans = recorder.snapshot()["spans"]
    assert spans[stage][0] == 1
    assert spans["atmosphere"][0] == 1


@pytest.fixture
def work_cfg(tmp_path):
    """The demo eclipse cfg at 8 layers x 25 cm-1 on its 300 strongest
    lines, writing under tmp_path."""
    from bart_tpu_torch.linelist.tli import TliData, load_tli, save_tli

    src = load_tli(str(REPO / "examples" / "demo_inputs"
                       / "CH4_demo.tli.npz"))
    lines = {"CH4": src.lines["CH4"].strongest(300)}
    save_tli(TliData(["CH4"], lines, src.wn_min, src.wn_max),
             str(tmp_path / "lines.tli.npz"))
    loc = tmp_path / "out"
    ov = {"n_layers": "8", "tempdelt": "650", "wndelt": "25",
          "quiet": "True", "loc_dir": str(loc),
          "linedb": str(tmp_path / "lines.tli.npz")}
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = config.load_config(str(REPO / "examples" / "torch_demo"
                                     / "eclipse.cfg"), ov)
    return cfg, loc


def test_device_trace_writes_spans(models, tmp_path):
    """``--profile DIR``'s trace: the Chrome trace and spans.json with
    the forward's spans, the recorder switched back off after it."""
    fm = models["eclipse"]
    profiling.recorder().clear()
    with profiling.device_trace(str(tmp_path / "prof"), fm.device):
        fm(_params(fm))
    assert not profiling.recording()
    out = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert out["spans"]["forward"][0] == 1
    assert set(out) == {"spans", "counters", "blocks"}
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    profiling.recorder().clear()


def _innermost_idle():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke.innermost_idle


@pytest.mark.parametrize("gaps, want", [
    # inside "forward" alone, then inside the nested "forward.rows"
    ([(1.0, 2.0)], {"forward": 1.0}),
    ([(3.0, 4.0)], {"forward.rows": 1.0}),
    # across the nested span's edges: each piece to the innermost open
    ([(2.0, 6.0)], {"forward": 1.5, "forward.rows": 2.5}),
    # across the outer span's end: the rest to "other"
    ([(8.0, 12.0)], {"forward": 2.0, "other": 2.0}),
    # two gaps, the first starting before every span
    ([(0.0, 1.0), (4.5, 5.5)],
     {"other": 0.5, "forward": 0.5, "forward.rows": 1.0}),
])
def test_idle_goes_to_innermost_span(gaps, want):
    """chip_smoke.py's split of idle gaps by the program's spans: each
    piece of a gap goes to the innermost span open over it (the one that
    started last), none counted twice, the rest to "other"."""
    stages = [(0.5, 10.0, "forward"), (3.0, 5.0, "forward.rows"),
              (5.0, 5.5, "forward.rows")]
    idle = _innermost_idle()(gaps, stages)
    assert idle == pytest.approx(want)
    assert sum(idle.values()) == pytest.approx(sum(e - s for s, e in gaps))


# --- the card ---------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graph captures and CUDA events")
    return torch.device("cuda")


@pytest.mark.gpu
def test_block_timeline_and_capture_on_card(card, recorder):
    """Three graphed blocks with the recorder on: one capture counted,
    three blocks of three stretches (the first without the gap before
    it), the later blocks' stretches adding up to their span on the
    device between their ends."""
    inp = demo_inputs(nlayer=23, nwave=300, nlines=400, t_step=260.0)
    fm = build_demo_model(inp, device=card, budget_bytes=1e8)
    s = _sampler_on(fm)
    gen = torch.Generator(device=card).manual_seed(7)
    before = profiling.counters().get("graphs.captures", 0)
    state = s.init_state(gen)
    for _ in range(3):
        state = s.run_block(state, gen, 20)[0]
        state.loglike.cpu()
    torch.cuda.synchronize()
    snap = recorder.snapshot()
    assert snap["counters"]["graphs.captures"] == before + 1
    assert snap["nblocks"] == 3 and snap["blocks"][0][2] is None
    for draws, replays, gap in snap["blocks"]:
        assert draws > 0 and replays > 0 and (gap is None or gap > 0)
    assert snap["spans"]["sampler.capture"][0] == 1
    assert snap["spans"]["sampler.step"][0] == 3     # 2 warm-ups, capture
    assert snap["spans"]["sampler.draws"][0] == 3
    assert snap["spans"]["sampler.replays"][0] == 3


def _sampler_on(fm):
    dev = fm.device
    truth = torch.tensor(np.array(DEMO_PARAMS)[None], dtype=torch.float32,
                         device=dev)
    data = fm(truth)[0][0].double().cpu().numpy()
    space = ParamSpace(pinit=DEMO_PARAMS, pmin=PMIN, pmax=PMAX,
                       stepsize=STEP)
    like = Likelihood(fm, space, data, 0.03 * data)
    return EnsembleSampler(loglike_fn=like, nfree=space.nfree,
                           nmodel=len(data), nchains=64, pmin=space.free_min,
                           pmax=space.free_max,
                           stepsize=space.stepsize[space.ifree])
