"""What keeps the ranks of bart_tpu_torch's (chain, wn) mesh in step across
cards, on the CPU: the fingerprint and the agreement check of the
replicated sampler state (``parallel.mesh``), ``run_mcmc`` on a 2 x 2 mesh
through a checkpoint and a resume, the NCCL group's binding to the rank's
card (``init_distributed``), graph capture without garbage collection,
the teardown after the graphs, and the rank runner, the guard and the
table build of ``chip_smoke.py --nccl4``.

The ranks are four OS processes (tests/torch_mesh_cards_worker.py) that
form one gloo group through a file rendezvous, with jax and bart_tpu
blocked; this process runs the same retrieval unmeshed.  The card-only
case (marked gpu) runs the agreement check on four NCCL ranks, one a
card, and skips without four cards.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mesh_cards_worker as W
from bart_tpu_torch.inference.likelihood import Likelihood
from bart_tpu_torch.parallel import init_distributed
from bart_tpu_torch.parallel import mesh as pmesh
from bart_tpu_torch.parallel.mesh import fingerprint

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_mesh_cards_worker.py"
#: the mesh of the ranks, and the seconds they may take (~15 s here)
N_CHAIN, N_WN = 2, 2
TIMEOUT = 400
#: share of chains whose accept decisions may differ between the meshed
#: and the unmeshed retrieval (chip_smoke.py's MESH_FLIP_SHARE)
FLIP_SHARE = 0.01

sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _spawn(job: Path, world: int, worker: Path = WORKER, env=None):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           **(env or {})}
    return [subprocess.Popen(
        [sys.executable, str(worker), str(job), str(r), str(world),
         str(N_CHAIN)], cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]


def _collect(procs, job: Path) -> list:
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(job / f"rank{r}.npz")) for r in range(len(procs))]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The four ranks (started first) and, while they run, the unmeshed
    retrieval: (each rank's outputs, the job directory, the unmeshed
    result)."""
    job = tmp_path_factory.mktemp("mesh_cards")
    procs = _spawn(job, N_CHAIN * N_WN)
    try:
        fm, space, data, uncert = W.build()
        ref = W.retrieve(Likelihood(fm, space, data, uncert), space, 2,
                         str(tmp_path_factory.mktemp("mesh_cards_ref")))
    finally:
        ranks = _collect(procs, job)
    return ranks, job, ref


# ---------------------------------------------------------------------
# the fingerprint

def _one_ulp(x: torch.Tensor, i: int) -> torch.Tensor:
    y = x.clone().reshape(-1)
    if y.dtype == torch.bool:
        y[i] = ~y[i]
    elif y.is_floating_point():
        y[i] = torch.nextafter(y[i], torch.tensor(np.inf, dtype=y.dtype))
    else:
        y[i] += 1
    return y.reshape(x.shape)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.int64, torch.bool])
def test_fingerprint_sees_one_ulp(dtype):
    """Equal tensors give equal fingerprints; one element one ulp (one
    unit, a flipped bool) away changes it, wherever the element is."""
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(512, 6, generator=gen) * 1e3).to(dtype)
    base = fingerprint(x)
    assert base.dtype == torch.int64 and base.shape == (2,)
    assert torch.equal(fingerprint(x.clone()), base)
    for i in (0, 7, x.numel() - 1):
        assert not torch.equal(fingerprint(_one_ulp(x, i)), base), i


def test_fingerprint_sees_a_swap_and_each_tensor():
    """Two elements swapped change the fingerprint (positions are
    weighted); each tensor has its own pair of sums."""
    x = torch.arange(1.0, 101.0, dtype=torch.float64)
    y = x.clone()
    y[[3, 4]] = y[[4, 3]]
    assert not torch.equal(fingerprint(y), fingerprint(x))
    a, b = torch.ones(4), torch.zeros(4)
    assert torch.equal(fingerprint(a, b)[:2], fingerprint(a))
    assert torch.equal(fingerprint(a, b)[2:], fingerprint(b))


# ---------------------------------------------------------------------
# the agreement check and run_mcmc on four ranks

def test_agreement_passes_on_four_agreeing_ranks(run):
    ranks, _, _ = run
    assert len(ranks) == 4
    for o in ranks:
        assert int(o["agree/ok"]) == 1


@pytest.mark.parametrize("field", list(W.STATE))
def test_agreement_raises_on_every_rank_for_one_ulp(run, field):
    """Rank 2's copy of one field one ulp off: every rank raises, naming
    what differs."""
    ranks, _, _ = run
    for r, o in enumerate(ranks):
        msg = str(o[f"agree/{field}"])
        assert f"the ranks' {field} differ" in msg, (r, msg)
        assert f"rank {r} of a 2 x 2 mesh" in msg


def test_run_mcmc_resumed_on_a_mesh_equals_the_whole_run(run):
    """Two blocks with a checkpoint, and one block, a checkpoint and a
    resume: on every rank the same posterior, best fit and acceptance,
    bit for bit, and the same on every rank."""
    ranks, _, _ = run
    first = ranks[0]
    for o in ranks:
        for key in ("posterior", "bestp", "best_loglike", "accept"):
            np.testing.assert_array_equal(o[f"resumed/{key}"],
                                          o[f"whole/{key}"], err_msg=key)
            np.testing.assert_array_equal(o[f"whole/{key}"],
                                          first[f"whole/{key}"], err_msg=key)
    assert first["whole/posterior"].shape == (W.RUN["nchains"], 4,
                                              2 * W.RUN["block"])


def test_run_mcmc_on_a_mesh_writes_from_rank_0_alone(run):
    """The shared directories hold one set of files, rank 0's: the
    resumed run's equal the whole run's."""
    _, job, _ = run
    for d in ("whole", "split"):
        assert sorted(p.name for p in (job / d).iterdir()) == [
            "MCMC.log", "ck.npz", "ck.npz.pos.dat", "output.npy"]
    np.testing.assert_array_equal(np.load(job / "split" / "output.npy"),
                                  np.load(job / "whole" / "output.npy"))


def test_run_mcmc_on_a_mesh_decides_as_the_unmeshed_run(run):
    """The 2 x 2 run's accept decisions against the unmeshed run's from
    the same seed: within chip_smoke's 1% of chains (float64 band sums
    in another order), and the posteriors within 1e-12."""
    ranks, _, ref = run
    post = ranks[0]["whole/posterior"]           # [chains, nfree, steps]
    moved = np.any(np.diff(post, axis=2) != 0, axis=1)
    moved_ref = np.any(np.diff(ref.posterior, axis=2) != 0, axis=1)
    assert moved_ref.any()
    assert np.mean(np.any(moved != moved_ref, axis=1)) <= FLIP_SHARE
    np.testing.assert_allclose(post, ref.posterior, rtol=1e-12)


def test_run_mcmc_raises_on_every_rank_when_a_state_drifts(run):
    """Rank 2's log-likelihoods one ulp off: run_mcmc raises on every rank
    after the first block, instead of letting the ranks part ways."""
    ranks, job, _ = run
    for r, o in enumerate(ranks):
        msg = str(o["drift"])
        assert "sampler states after block 0 differ" in msg, (r, msg)
    # rank 0 raised before it wrote anything but the first checkpoint
    assert not (job / "drift" / "output.npy").exists()


# ---------------------------------------------------------------------
# the capture: no garbage collection inside it

class _OldGraph:
    """Stands for a CUDA graph held in a reference cycle (a sampler and
    its StepGraph): records whether a capture was under way when it was
    destroyed."""

    def __init__(self, log: list, state: dict):
        self.log, self.state, self.cycle = log, state, self

    def __del__(self):
        self.log.append(self.state["capturing"])


def test_graph_capture_collects_first_and_never_inside(monkeypatch):
    """``device.graph_capture`` frees graphs left in cycles before the
    capture starts, and no automatic collection runs inside it, however
    much garbage the captured code makes: a graph destroyed mid-capture
    invalidates the capture (rank 0 of a 2 x 2 NCCL mesh, the eleventh
    capture of phase 13)."""
    import contextlib
    import gc

    from bart_tpu_torch import device

    log, state = [], {"capturing": False}

    @contextlib.contextmanager
    def fake_graph(graph):
        state["capturing"], state["freed_before"] = True, len(log)
        state["collector_on"] = gc.isenabled()
        for _ in range(20):
            _OldGraph(log, state)
        for _ in range(50000):             # past every collection threshold
            x = []
            x.append(x)
        yield
        state["capturing"] = False

    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    assert gc.isenabled()
    _OldGraph(log, state)
    with device.graph_capture(object()):
        pass
    assert state["freed_before"] == 1 and state["collector_on"] is False
    assert gc.isenabled()
    gc.collect()
    assert log == [False] * 21


# ---------------------------------------------------------------------
# the NCCL group on the rank's card, and make_mesh's set-up

class _Recorder:
    """Stands in for torch.distributed's group functions, recording
    what is asked of them."""

    def __init__(self, world: int = 4, rank: int = 0):
        self.world, self.rank = world, rank
        self.init_kw, self.groups, self.reduces = None, [], []

    def init_process_group(self, **kw):
        self.init_kw = kw

    def get_world_size(self):
        return self.world

    def get_rank(self):
        return self.rank

    def is_initialized(self):
        return True

    def get_backend(self):
        return "nccl"

    def new_group(self, ranks):
        self.groups.append(tuple(ranks))
        return f"group{len(self.groups) - 1}"

    def all_reduce(self, x, group=None):
        self.reduces.append(group)


@pytest.fixture
def fake_cards(monkeypatch):
    """Four CUDA devices as far as the device checks can tell."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    rec = _Recorder()
    for name in ("init_process_group", "get_world_size", "get_rank",
                 "is_initialized", "get_backend", "new_group",
                 "all_reduce"):
        monkeypatch.setattr(dist, name, getattr(rec, name))
    return rec


@pytest.mark.parametrize("local_rank", range(4))
def test_init_distributed_binds_an_nccl_group_to_the_ranks_card(
        fake_cards, monkeypatch, local_rank):
    """On a card the backend is NCCL and the group is bound to
    cuda:LOCAL_RANK (``device_id``): PyTorch then creates the
    communicators at once, before any CUDA graph captures a
    collective."""
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    assert init_distributed("tcp://localhost:29500", 4, local_rank,
                            timeout_s=30.0) is True
    kw = fake_cards.init_kw
    assert kw["backend"] == "nccl"
    assert kw["device_id"] == torch.device(f"cuda:{local_rank}")
    assert kw["world_size"] == 4 and kw["rank"] == local_rank
    assert kw["timeout"].total_seconds() == 30.0


def test_init_distributed_binds_no_device_on_gloo(fake_cards):
    """gloo (the CPU, or ranks that share a card) has no device to bind."""
    init_distributed("tcp://localhost:29500", 4, 1, device="cpu")
    assert fake_cards.init_kw["backend"] == "gloo"
    assert "device_id" not in fake_cards.init_kw
    init_distributed("tcp://localhost:29500", 4, 1, backend="gloo",
                     device="cuda:0")
    assert "device_id" not in fake_cards.init_kw


@pytest.mark.parametrize("n_chain", [1, 2, 4])
def test_make_mesh_sets_up_every_group_it_uses(fake_cards, n_chain):
    """make_mesh creates one group per chain coordinate on every rank and
    issues no collective: on a group bound to the card, PyTorch splits
    each new group's communicator from the world's at once."""
    fake_cards.rank = 3
    mesh = pmesh.make_mesh(n_chain, device="cpu")
    n_wn = 4 // n_chain
    assert fake_cards.groups == [tuple(range(c * n_wn, (c + 1) * n_wn))
                                 for c in range(n_chain)]
    assert fake_cards.reduces == []
    assert mesh.wn_group == f"group{3 // n_wn}" and mesh.collectives == 0


def test_dryrun_collects_the_graphs_before_the_teardown(monkeypatch):
    """The dryrun runs the garbage collector just before it destroys the
    group: NCCL does not destroy a communicator while a CUDA graph that
    captured one of its collectives lives, and a sampler keeps its graphs
    in a reference cycle."""
    import gc

    import torch.distributed as dist

    from bart_tpu_torch.parallel import distributed as pdist
    from bart_tpu_torch.parallel import dryrun

    calls = []
    monkeypatch.setattr(pdist, "init_distributed", lambda **kw: True)
    monkeypatch.setattr(pmesh, "make_mesh", lambda **kw: "mesh")
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    for name in ("dryrun_multichip", "demo_scale_shard_check",
                 "folded_shard_check"):
        monkeypatch.setattr(dryrun, name,
                            lambda mesh, sizes, name=name: calls.append(name))
    monkeypatch.setattr(gc, "collect", lambda: calls.append("collect"))
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda: calls.append("destroy"))
    assert dryrun.main(["--tiny"]) == 0
    assert calls == ["dryrun_multichip", "demo_scale_shard_check",
                     "folded_shard_check", "collect", "destroy"]


# ---------------------------------------------------------------------
# chip_smoke.py --nccl4's guard

@pytest.mark.parametrize("cards", range(4))
def test_nccl4_refuses_fewer_than_four_cards(monkeypatch, cards):
    """With fewer than four CUDA devices ``--nccl4`` raises before
    anything else, naming the count it found."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--nccl4"])
    with pytest.raises(RuntimeError, match=f"needs 4 CUDA devices.*found "
                                           f"{cards}$"):
        chip_smoke.main()


class _FakeRank:
    """Stands for one rank subprocess of ``chip_smoke.run_ranks``: keeps
    its command and environment, and exits with ``codes[rank]`` (None:
    it runs on until killed); a rank that exits 0 has written its record
    as ``mesh_rank_run`` does."""

    def __init__(self, codes, cmd, env, **kw):
        self.cmd, self.env = cmd, env
        self.rank = int(env["RANK"])
        self.code = codes[self.rank]
        self.pid = 1000 + self.rank
        job = cmd[cmd.index("--mesh-rank") + 1]
        if self.code == 0:
            with open(os.path.join(job, f"rank{self.rank}.json"), "w") as f:
                json.dump({"rank": self.rank}, f)
            if self.rank == 0:
                np.savez(os.path.join(job, "rank0.npz"), x=np.ones(2))

    def poll(self):
        return self.code

    def wait(self):
        self.code = -9
        return self.code


@pytest.fixture
def fake_ranks(monkeypatch):
    """``chip_smoke.run_ranks`` with its subprocesses faked: (the started
    ranks, the process groups killed, the exit codes to give)."""
    import signal

    started, killed, codes = [], [], {}

    def popen(cmd, **kw):
        started.append(_FakeRank(codes, cmd, **kw))
        return started[-1]

    monkeypatch.setattr(chip_smoke.subprocess, "Popen", popen)
    monkeypatch.setattr(os, "killpg", lambda pid, sig: killed.append(
        (pid, sig == signal.SIGKILL)))
    return started, killed, codes


def test_nccl4_runs_four_nccl_ranks_one_a_card(monkeypatch, tmp_path,
                                               fake_ranks):
    """With four cards, phase 13's job goes to four rank processes, rank r
    with LOCAL_RANK r (its card: the job names no device) in one world of
    four over NCCL on localhost, each in a session of its own."""
    started, killed, codes = fake_ranks
    codes.update({r: 0 for r in range(4)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    world = chip_smoke.nccl4_devices()
    job = chip_smoke.nccl4_job({"grid": "g", "fine": "f"},
                               {"eclipse": np.ones(3)},
                               (np.ones(3), np.ones(3)))
    recs, saved, _ = chip_smoke.run_ranks(str(tmp_path), "ranks", job, world)
    assert [r["rank"] for r in recs] == [0, 1, 2, 3] and "x" in saved
    assert [(p.env["RANK"], p.env["LOCAL_RANK"], p.env["WORLD_SIZE"],
             p.env["MASTER_ADDR"]) for p in started] == [
        (str(r), str(r), "4", "localhost") for r in range(4)]
    assert len({p.env["MASTER_PORT"] for p in started}) == 1
    written = json.loads((tmp_path / "ranks" / "job.json").read_text())
    assert written["backend"] == "nccl" and written["device"] is None
    assert written["layouts"] == {"1x4": [1, 4], "4x1": [4, 1],
                                  "2x2": [2, 2]}
    assert all(v == list(chip_smoke.CASE_KERNEL)
               for v in written["cases"].values())
    assert written["truth"] == [2, 2] and killed == []


def test_run_ranks_kills_the_others_when_one_rank_fails(tmp_path,
                                                        fake_ranks):
    """A rank that exits non-zero fails the phase at once, naming it, and
    the ranks still running are killed (they would wait in a
    collective), phase 10's groups as phase 13's world."""
    started, killed, codes = fake_ranks
    codes.update({0: None, 1: None, 2: 1, 3: None})
    with pytest.raises(RuntimeError, match="2x2: rank 2 exited 1"):
        chip_smoke.run_ranks(str(tmp_path), "2x2", {"backend": "gloo"}, 4,
                             timeout=30)
    assert killed == [(1000, True), (1001, True), (1003, True)]


def test_tables_built_across_cards_equal_one_build():
    """Phase 13's set-up: the opacity table built with its temperature
    rows shared out among three devices (threads) equals one build, bit
    for bit."""
    from bart_tpu_torch.demo import demo_inputs
    from bart_tpu_torch.opacity.grid import build_opacity_grid

    inp = demo_inputs(nlayer=6, nwave=301, nlines=200, t_step=300.0)
    one = build_opacity_grid({"CH4": inp.lines}, inp.wn, inp.t_grid,
                             inp.pressure, budget_bytes=1e7, device="cpu")
    got = chip_smoke.tables_on_cards(inp.lines, inp.wn, inp.t_grid,
                                     inp.pressure, 1e7, ["cpu"] * 3)
    assert got.sigma.shape == one.sigma.shape == (1, 9, 6, 301)
    assert torch.equal(got.sigma, one.sigma)
    np.testing.assert_array_equal(got.t_grid, one.t_grid)


# ---------------------------------------------------------------------
# the card-only case

@pytest.mark.gpu
def test_agreement_on_four_nccl_ranks(tmp_path):
    """The agreement check and the checkpointed run_mcmc on four NCCL
    ranks, one a card (the worker on cuda:LOCAL_RANK)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    worker = tmp_path / "nccl_worker.py"
    worker.write_text(WORKER.read_text().replace(
        'init_distributed(f"file://{job}/rendezvous", world, rank, '
        'device="cpu",', 'init_distributed(f"file://{job}/rendezvous", '
        'world, rank, device=f"cuda:{rank}",').replace(
        'make_mesh(n_chain, device="cpu")',
        'make_mesh(n_chain, device=f"cuda:{rank}")'))
    ranks = _collect(_spawn(tmp_path, 4, worker, {"PYTHONPATH": os.pathsep
                                                  .join([str(REPO), str(
                                                      WORKER.parent)])}),
                     tmp_path)
    for o in ranks:
        assert int(o["agree/ok"]) == 1
        assert "the ranks' positions differ" in str(o["agree/positions"])
