"""bart_tpu_torch's multi-device execution (bart_tpu_torch/parallel) on the
CPU, against the unsharded port and against bart_tpu's ``shard_model`` on
conftest's 8 virtual devices, at float64.

The ranks are OS processes (tests/torch_parallel_worker.py) that form gloo
groups through a file rendezvous, with jax and bart_tpu blocked: this
process computes every bart_tpu reference, writes bart_tpu's tables as
numpy files and reads what the ranks write back.  The meshes are 1x2, 2x1
and 2x2 (and 1x4 and 1x1 for the sampler checks); each rank computes six
forwards (eclipse and transit K = 1 with CIA, Rayleigh and cloud rows,
folded rtosamp 4 eclipse and transit with ``fold_adapt=None``, the
on-the-fly tiles, the energy balance) on 301 wn points that pad to 302.
Every group of ranks runs under a time limit; they run at once, beside
the bart_tpu references (about two minutes on one worker).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

import bart_tpu.opacity.extinction as jext
from bart_tpu import constants as jconst
from bart_tpu.linelist.molecules import get_molecule
from bart_tpu.obs.bands import build_band_matrix as jbands
from bart_tpu.opacity.grid import build_opacity_grid as jbuild
from bart_tpu.parallel import mesh as jmesh
from bart_tpu.rt.forward import ForwardConfig as JConfig
from bart_tpu.rt.forward import ForwardModel as JModel
from bart_tpu.utils.grids import folded_fine_grid

import torch_parallel_worker as W
from bart_tpu_torch.demo import DEMO_PARAMS, demo_inputs
from bart_tpu_torch.parallel import (Mesh, init_distributed,
                                     pad_tables_for_mesh, shard_model,
                                     table_shardings)

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
#: the meshes the forwards are held on: name -> (n_chain, n_wn)
LAYOUTS = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
#: every group of ranks: name -> (n_chain, n_wn, what it runs)
GROUPS = {
    "1x2": (1, 2, {"cases": list(W.CASES), "mcmc": True}),
    "2x1": (2, 1, {"cases": list(W.CASES), "toy": True}),
    "2x2": (2, 2, {"cases": list(W.CASES), "snooker": True}),
    "1x4": (1, 4, {"cases": ["eclipse"], "snooker": True}),
    "1x1": (1, 1, {"toy": True}),
}
#: seconds a group of ranks may take (they take ~30 s together)
TIMEOUT = 400
CASE_LAYOUTS = [f"{c}-{lay}" for c in W.CASES for lay in LAYOUTS]


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cutoff(inp) -> float:
    """The wing reach of the on-the-fly tiles (build_opacity_grid's)."""
    mol = get_molecule("CH4")
    return jext.wing_cutoff(20.0, float(inp.wn[-1]), float(inp.t_grid[0]),
                            float(inp.pressure[-1]) * jconst.BAR_TO_BARYE,
                            mol.mass * jconst.AMU, mol.diameter * 1e-8,
                            jext.BroadeningSpec())


def _jax_model(inp, name: str, grids: dict, cutoff: float):
    """bart_tpu's float64 model of a case (torch_parallel_worker.CASES)."""
    solution, cfg, _, fold = W.CASES[name]
    if solution == "transit":
        bands, kw = jbands(inp.wn, inp.filters), inp.transit_config_kwargs
    else:
        bands = jbands(inp.wn, inp.filters, star_flux=inp.star_flux,
                       rprs=inp.system.rprs)
        kw = inp.config_kwargs
    opacity = ({"CH4": jext.tile_lines(inp.lines, inp.wn, cutoff,
                                       tile_size=W.TILE)}
               if fold == 0 else grids[fold])
    return JModel(
        JConfig(**kw, **cfg), wn_grid=inp.wn, pressure=inp.pressure,
        species=inp.species, base_abundances=inp.base_q, opacity=opacity,
        system=inp.system, bands=bands, cia_tables=[inp.cia],
        broadening=jext.BroadeningSpec() if fold == 0 else None,
        fold_osamp=max(fold, 1), fold_adapt=None, dtype=jnp.float64)


def _jax_sharded(fmj, P, n_chain: int, n_wn: int):
    """bart_tpu's shard_model on an n_chain x n_wn mesh of the virtual
    devices, the chains sharded over 'chain': (band, spectrum, valid)."""
    mesh = jmesh.make_mesh(n_chain=n_chain, n_wn=n_wn,
                           devices=jax.devices()[:n_chain * n_wn])
    jmesh.shard_model(fmj, mesh)
    batch = jax.device_put(jnp.asarray(P),
                           NamedSharding(mesh, PartitionSpec("chain", None)))
    return tuple(np.asarray(x) for x in fmj.batched()(batch))


def _spawn(data: str, cutoff: float, obs: np.ndarray, tmp_path_factory):
    """Start every group of ranks at once: group -> (its directory, its
    processes)."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = {}
    for group, (n_chain, n_wn, what) in GROUPS.items():
        job = tmp_path_factory.mktemp(f"parallel_{group}")
        json.dump({**what, "data_dir": data, "cutoff": cutoff,
                   "obs": obs.tolist()}, open(job / "job.json", "w"))
        world = n_chain * n_wn
        procs[group] = (job, [subprocess.Popen(
            [sys.executable, str(WORKER), str(job), str(r), str(world),
             str(n_chain)], cwd=str(REPO), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(world)])
    return procs


def _collect(procs) -> dict:
    """Wait for every rank (each group within TIMEOUT s; any that is left
    is killed): group -> ([each rank's outputs], its directory)."""
    out = {}
    try:
        for group, (job, ps) in procs.items():
            logs = [p.communicate(timeout=TIMEOUT)[0].decode() for p in ps]
            for p, log in zip(ps, logs):
                assert p.returncode == 0, f"{group}:\n{log}"
            out[group] = ([dict(np.load(job / f"rank{r}.npz"))
                           for r in range(len(ps))], job)
    finally:
        for _, ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The cases' files, the ranks (started as soon as the files are
    written) and, while they run, every reference: bart_tpu sharded on
    each layout, the unsharded port, its snooker block and its run_mcmc.
    -> (references, ranks)."""
    data = tmp_path_factory.mktemp("parallel_data")
    inp = demo_inputs(**W.INPUTS)
    grids = {K: jbuild({"CH4": inp.lines}, folded_fine_grid(inp.wn, K),
                       inp.t_grid, inp.pressure, cond_batch=80,
                       dtype=jnp.float64) for K in (1, 4)}
    cutoff = _cutoff(inp)
    refs = {"data": str(data), "inp": inp, "cases": {}}
    for name, (_, _, _, fold) in W.CASES.items():
        P = W.case_params(name)
        fmj = _jax_model(inp, name, grids, cutoff)
        tables = {k: np.asarray(v) for k, v in fmj.tables.items()}
        extra = {"sigma": np.asarray(grids[fold].sigma)} if fold else {}
        np.savez(data / f"{name}.npz", params=P, **extra,
                 **{f"table/{k}": v for k, v in tables.items()})
        refs["cases"][name] = dict(P=P, tables=tables)
    fmt, _ = W.load_case(str(data), inp, "eclipse", cutoff)
    pinit = np.concatenate([DEMO_PARAMS[:-1], W.CASES["eclipse"][2],
                            DEMO_PARAMS[-1:]])
    obs = fmt(torch.tensor(pinit[None]))[0][0].numpy()
    procs = _spawn(str(data), cutoff, obs, tmp_path_factory)
    try:
        for name, ref in refs["cases"].items():
            P = ref["P"]
            fmt, _ = W.load_case(str(data), inp, name, cutoff)
            ref["port"] = tuple(x.numpy() for x in fmt(torch.tensor(P)))
            ref["sharded"] = {
                lay: _jax_sharded(_jax_model(inp, name, grids, cutoff), P,
                                  *nm) for lay, nm in LAYOUTS.items()}
        fmt, _ = W.load_case(str(data), inp, "eclipse", cutoff)
        refs["snooker"] = W.snooker_block(fmt, obs)
        res = W.mcmc_run(fmt, obs, str(data / "mcmc_unsharded"))
        refs["mcmc"] = (res.posterior, res.models)
    finally:
        ranks = _collect(procs)
    return refs, ranks


@pytest.fixture(scope="module")
def refs(run):
    return run[0]


@pytest.fixture(scope="module")
def ranks(run):
    return run[1]


def _split(case_layout: str):
    case, layout = case_layout.rsplit("-", 1)
    return case, layout


# ---------------------------------------------------------------------
# the mesh and the tables

@pytest.mark.parametrize("group", list(GROUPS))
def test_mesh_coordinates(ranks, group):
    """rank = chain x n_wn + wn, as bart_tpu's devices.reshape(n_chain,
    n_wn); each rank sees the mesh's shape."""
    n_chain, n_wn, _ = GROUPS[group]
    outs, _ = ranks[group]
    assert len(outs) == n_chain * n_wn
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(
            o["coords"], [r, r // n_wn, r % n_wn, n_chain, n_wn])


def test_table_shardings_match_bart_tpu():
    """The same wn axis for every key bart_tpu lists; the energy
    balance's trapezoid weights shard like the wn grid."""
    ref = jmesh.table_shardings(jmesh.make_mesh(1, 2, jax.devices()[:2]))
    mine = table_shardings()
    for k, sh in ref.items():
        spec = tuple(sh.spec)
        assert mine[k] == (spec.index("wn") if "wn" in spec else None), k
    assert set(mine) - set(ref) == {"wn_trapz"} and mine["wn_trapz"] == 0


@pytest.mark.parametrize("n_wn", [2, 4])
@pytest.mark.parametrize("case", ["eclipse", "folded", "onthefly"])
def test_pad_tables_matches_bart_tpu(refs, case, n_wn):
    """pad_tables_for_mesh on the same numpy tables as bart_tpu's, array
    for array and dtype for dtype, for gridded, folded and line-tile
    tables; and on torch tensors, the same values."""
    tables = refs["cases"][case]["tables"]
    mesh = jmesh.make_mesh(1, n_wn, jax.devices()[:n_wn])
    ref = {k: np.asarray(v) for k, v in jmesh.pad_tables_for_mesh(
        {k: jnp.asarray(v) for k, v in tables.items()}, mesh).items()}
    got = pad_tables_for_mesh(tables, n_wn)
    got_t = pad_tables_for_mesh({k: torch.tensor(v)
                                 for k, v in tables.items()}, n_wn)
    assert set(got) == set(ref) == set(got_t)
    padded = 0
    for k, v in ref.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(got_t[k].numpy(), v, err_msg=k)
        padded += got[k].shape != tables[k].shape
    assert padded >= 3         # wn, band_w and a table grew
    assert ref["wn"].shape[0] % n_wn == 0


def test_pad_tables_rejects_mismatched_tiles(refs):
    """Two species tiled on different grids: the reference's error."""
    t = dict(refs["cases"]["onthefly"]["tables"])
    t.update({k.replace("lt0", "lt1"): v[:-1] for k, v in t.items()
              if k.startswith("lt0")})
    mesh = jmesh.make_mesh(1, 2, jax.devices()[:2])
    with pytest.raises(ValueError, match="same wn grid and tile_size"):
        jmesh.pad_tables_for_mesh({k: jnp.asarray(v) for k, v in t.items()},
                                  mesh)
    with pytest.raises(ValueError, match="same wn grid and tile_size"):
        pad_tables_for_mesh(t, 2)


def test_adaptive_split_is_refused(refs):
    """A folded model with the adaptive fine/smooth split cannot be
    sharded: the reference's message, pointing at rtadapt."""
    from bart_tpu_torch.demo import build_demo_model
    from bart_tpu_torch.opacity.grid import OpacityGrid

    inp = refs["inp"]
    z = np.load(Path(refs["data"]) / "folded.npz")
    grid = OpacityGrid(["CH4"], inp.t_grid, inp.pressure,
                       folded_fine_grid(inp.wn, 4), torch.tensor(z["sigma"]))
    fm = build_demo_model(inp, dtype=torch.float64, grid=grid, fold=4,
                          fold_adapt=0.02, device="cpu")
    assert fm._idx_fine is not None and fm._idx_smooth is not None
    mesh = Mesh(n_chain=1, n_wn=2, rank=0, device=torch.device("cpu"),
                backend="gloo", wn_group=None)
    with pytest.raises(ValueError, match="rtadapt"):
        shard_model(fm, mesh)
    assert fm.mesh is None


def test_graphs_refused_on_a_gloo_mesh(refs):
    """A CUDA graph cannot capture gloo's collectives: ``graphed()`` on a
    model sharded over a gloo mesh raises before any capture, and the
    sampler's ``graphs`` (which picks the eager loop) says no on a card;
    NCCL says yes."""
    from bart_tpu_torch.inference.samplers import EnsembleSampler, capturable

    fm, _ = W.load_case(refs["data"], refs["inp"], "eclipse", 25.0)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    sampler = EnsembleSampler(loglike_fn=fm, nfree=1, nmodel=1, nchains=4,
                              pmin=[0.0], pmax=[1.0])
    fm.mesh = Mesh(n_chain=1, n_wn=2, rank=0, device=cpu, backend="gloo",
                   wn_group=None)
    fm.device = cuda                       # past graphed()'s device check
    with pytest.raises(RuntimeError, match="gloo mesh"):
        fm.graphed()
    assert not capturable(fm) and capturable(lambda p: p)
    assert not sampler.graphs(cuda) and not sampler.graphs(cpu)
    fm.mesh = Mesh(n_chain=1, n_wn=2, rank=0, device=cpu, backend="nccl",
                   wn_group=None)
    assert capturable(fm)
    assert sampler.graphs(cuda) and not sampler.graphs(cpu)


def test_init_distributed_without_a_group_returns_false(monkeypatch):
    """No world size asked for (no argument, no WORLD_SIZE): no group."""
    import torch.distributed as dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_distributed(device="cpu") is False
    assert not dist.is_initialized()


# ---------------------------------------------------------------------
# the sharded forwards

@pytest.mark.parametrize("case_layout", CASE_LAYOUTS)
def test_sharded_forward_matches_unsharded_port(refs, ranks, case_layout):
    """Bands, valid and the gathered spectrum's first n_wn_orig points of
    every rank against the unsharded port at 1e-12."""
    case, layout = _split(case_layout)
    band, spec, valid = refs["cases"][case]["port"]
    n = spec.shape[1]
    for o in ranks[layout][0]:
        assert int(o[f"{case}/n_wn_orig"]) == n
        np.testing.assert_array_equal(o[f"{case}/valid"], valid)
        np.testing.assert_allclose(o[f"{case}/band"], band, rtol=1e-12)
        np.testing.assert_allclose(o[f"{case}/spectrum"][:, :n], spec,
                                   rtol=1e-12)
    assert not valid[3] and valid.sum() >= 2
    if case == "ebalance":    # the veto passes some chains, stops others
        np.testing.assert_array_equal(valid, [1, 1, 1, 0, 0, 0])


@pytest.mark.parametrize("case_layout", CASE_LAYOUTS)
def test_sharded_forward_matches_bart_tpu_shard_model(refs, ranks,
                                                      case_layout):
    """Bands, valid and the whole gathered spectrum, padding included,
    against bart_tpu's shard_model on the same layout at 1e-12."""
    case, layout = _split(case_layout)
    jband, jspec, jvalid = refs["cases"][case]["sharded"][layout]
    for o in ranks[layout][0]:
        np.testing.assert_array_equal(o[f"{case}/valid"], jvalid)
        np.testing.assert_allclose(o[f"{case}/band"], jband, rtol=1e-12)
        assert o[f"{case}/spectrum"].shape == jspec.shape
        np.testing.assert_allclose(o[f"{case}/spectrum"], jspec, rtol=1e-12,
                                   atol=1e-300)


@pytest.mark.parametrize("case_layout", CASE_LAYOUTS)
def test_one_collective_and_shard_bytes(refs, ranks, case_layout):
    """Each rank: one all-reduce in the forward, its block of chains and
    its wn shard in the spectrum it returns, and total / n_wn of the
    wn-indexed table (total: the unsharded table padded to the mesh) on
    its device."""
    case, layout = _split(case_layout)
    n_chain, n_wn = LAYOUTS[layout]
    t = refs["cases"][case]["tables"]
    C = len(refs["cases"][case]["P"])
    key = {1: "sigma", 4: "sigmak", 0: "lt0_wn0"}[W.CASES[case][3]]
    if key == "lt0_wn0":
        tot = t[key].nbytes // t[key].shape[0] * (
            t[key].shape[0] + (-t[key].shape[0]) % n_wn)
    else:
        rows = t[key].nbytes + t.get(
            "frows" if key == "sigma" else "frowsk", np.zeros(0)).nbytes
        W_ = t[key].shape[-1]
        tot = rows // W_ * (W_ + (-W_) % n_wn)
    padded_w = refs["cases"][case]["sharded"][layout][1].shape[1]
    for o in ranks[layout][0]:
        assert int(o[f"{case}/collectives"]) == 1
        assert str(o[f"{case}/device"]) == "cpu"
        assert int(o[f"{case}/held_bytes"]) * n_wn == tot
        assert o[f"{case}/local_spectrum"].shape == (C // n_chain,
                                                     padded_w // n_wn)


# ---------------------------------------------------------------------
# the sampler on a mesh

def test_snooker_block_2x2_equals_1x4_and_unsharded(refs, ranks):
    """A 3-step snooker block of 8 chains on 2x2 and on 1x4, on every
    rank, equal to the unsharded block at 1e-12: the ensemble state is
    replicated and the variates are drawn alike on every rank."""
    pb0, lb0 = refs["snooker"]
    assert np.isfinite(lb0).all() and lb0.shape == (3, 8)
    for group in ("2x2", "1x4"):
        for o in ranks[group][0]:
            np.testing.assert_allclose(o["snooker/loglike"], lb0, rtol=1e-12)
            np.testing.assert_allclose(o["snooker/positions"], pb0,
                                       rtol=1e-12)


def test_two_process_smoke(ranks):
    """The twin of test_parallel.py's two-process smoke: 16 snooker chains
    on the toy forward split over 2 processes (a 2x1 gloo mesh), the
    block's statistics equal to one process's at 1e-9."""
    s1 = ranks["1x1"][0][0]["toy"]
    assert np.all(np.isfinite(s1))
    for o in ranks["2x1"][0]:
        np.testing.assert_allclose(o["toy"], s1, rtol=1e-9)


def test_run_mcmc_on_a_mesh(refs, ranks):
    """run_mcmc and best_fit_outputs on a 1x2 gloo mesh: every rank's
    posterior and models equal the unsharded run's at 1e-12; only rank 0
    wrote the files, the same files as the unsharded run's; the log says
    the steps ran eagerly on the gloo mesh."""
    post, models = refs["mcmc"]
    outs, job = ranks["1x2"]
    for o in outs:
        np.testing.assert_allclose(o["mcmc/posterior"], post, rtol=1e-12)
        np.testing.assert_allclose(o["mcmc/models"], models, rtol=1e-12)
    d, ref = job / "mcmc", Path(refs["data"]) / "mcmc_unsharded"
    names = sorted(p.name for p in d.rglob("*"))
    assert names == sorted(p.name for p in ref.rglob("*"))
    np.testing.assert_allclose(np.load(d / "output.npy"), post, rtol=1e-12)
    log = (d / "MCMC.log").read_text()
    assert "mesh 1 x 2 (gloo) on cpu: eager steps" in log
    # best_fit_outputs: the spectrum and the atmosphere put together from
    # the wn shards, written by rank 0 alone
    np.testing.assert_allclose(
        np.loadtxt(d / "bestfit" / "bestfit_spectrum.dat"),
        np.loadtxt(ref / "bestfit" / "bestfit_spectrum.dat"), rtol=1e-10)
    assert (d / "bestfit" / "bestfit.atm").read_text() == (
        ref / "bestfit" / "bestfit.atm").read_text()


def test_dryrun_under_torchrun(tmp_path):
    """The dryrun (snooker block, shard bytes, one collective) on a 2x2
    gloo mesh of four CPU ranks, at its tiny size, under torchrun."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "4", "-m", "bart_tpu_torch.parallel.dryrun",
         "--device", "cpu", "--tiny", "--timeout", "120"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dryrun_multichip(2x2, gloo): OK" in proc.stdout
    assert "demo_scale_shard_check: OK" in proc.stdout
    assert "folded_shard_check: OK" in proc.stdout
