"""One rank of tests/test_torch_parallel.py: bart_tpu_torch's forwards on a
(chain, wn) mesh of gloo ranks on the CPU.

Launched as ``world`` separate OS processes that form one torch.distributed
group through a file rendezvous in the job directory; jax and bart_tpu
are blocked here, so a rank runs the port alone.  The test process writes
the job (the bart_tpu tables of each case and the parameters, as numpy
files) and reads what each rank writes back; the model builders and the
sampler block below are shared with it, so that its unsharded runs are
built the same way.

Usage: python torch_parallel_worker.py <job_dir> <rank> <world> <n_chain>
"""

import json
import os
import sys

import numpy as np

#: the small demo problem (tests/test_fused.py's fixture scale; 301 wn
#: points pad to 302 on two wn shards)
INPUTS = dict(nlayer=12, nwave=301, nlines=300, t_step=520.0)
#: chains of a forward batch, and the tile size of the on-the-fly case
NCHAINS, TILE = 6, 64
#: case -> (solution, ForwardConfig options, cloud-top/Rayleigh parameters
#: inserted before log CH4, fold K (1: K = 1 table, 0: on the fly))
CASES = {
    "eclipse": ("eclipse", {"scattering": "ray", "cloudtop": True},
                (1.0, 0.5), 1),
    "transit": ("transit", {"scattering": "ray", "cloudtop": True},
                (1.0, 0.5), 1),
    "folded": ("eclipse", {"quadrature": "expsum"}, (), 4),
    "folded-transit": ("transit", {}, (), 4),
    "onthefly": ("eclipse", {"scattering": "ray"}, (0.5,), 0),
    "ebalance": ("eclipse", {"ebalance": True}, (), 1),
}
#: the snooker block: chains, steps, seed
SNOOKER = dict(nchains=8, nsteps=3, seed=0)


def case_params(name: str) -> np.ndarray:
    """The case's [NCHAINS, n_params] batch: chains around the demo
    parameters; chain 3 has T far above tmax (invalid).  The energy
    balance case spreads beta (index 4) so that it vetoes some chains
    and passes others."""
    from bart_tpu_torch.demo import DEMO_PARAMS, DEMO_PARAMS_TRANSIT

    solution, _, extra, _ = CASES[name]
    base = DEMO_PARAMS_TRANSIT if solution == "transit" else DEMO_PARAMS
    base = np.concatenate([base[:-1], extra, base[-1:]])
    rng = np.random.default_rng(len(name))
    P = np.tile(base, (NCHAINS, 1)) + rng.normal(0, 0.01, (NCHAINS,
                                                           len(base)))
    if solution == "transit":
        P[:, 5] += rng.normal(0, 100.0, NCHAINS)
    if name == "ebalance":
        P[:, 4] = np.linspace(1.7, 2.05, NCHAINS)
    P[3, 4] = 3.0
    return P


def port_model(inp, name: str, sigma: np.ndarray | None, cutoff: float):
    """This package's model of the case on the CPU in float64 (before its
    tables are replaced by bart_tpu's)."""
    import torch

    from bart_tpu_torch.obs.bands import build_band_matrix
    from bart_tpu_torch.opacity.extinction import BroadeningSpec, tile_lines
    from bart_tpu_torch.opacity.grid import OpacityGrid
    from bart_tpu_torch.rt.forward import ForwardConfig, ForwardModel
    from bart_tpu_torch.utils.grids import folded_fine_grid

    solution, cfg, _, fold = CASES[name]
    f64 = dict(device="cpu", dtype=torch.float64)
    if solution == "transit":
        bands = build_band_matrix(inp.wn, inp.filters, **f64)
        kw = inp.transit_config_kwargs
    else:
        bands = build_band_matrix(inp.wn, inp.filters,
                                  star_flux=inp.star_flux,
                                  rprs=inp.system.rprs, **f64)
        kw = inp.config_kwargs
    if fold == 0:
        opacity = {"CH4": tile_lines(inp.lines, inp.wn, cutoff,
                                     tile_size=TILE, device="cpu")}
    else:
        opacity = OpacityGrid(["CH4"], inp.t_grid, inp.pressure,
                              folded_fine_grid(inp.wn, fold),
                              torch.tensor(sigma))
    return ForwardModel(
        ForwardConfig(**kw, **cfg), wn_grid=inp.wn, pressure=inp.pressure,
        species=inp.species, base_abundances=inp.base_q, opacity=opacity,
        system=inp.system, bands=bands, cia_tables=[inp.cia],
        broadening=BroadeningSpec() if fold == 0 else None,
        fold_osamp=max(fold, 1), fold_adapt=None, **f64)


def load_case(data: str, inp, name: str, cutoff: float):
    """(model with bart_tpu's tables carried over, params) of a case, from
    the files the test wrote in ``data``."""
    z = np.load(os.path.join(data, f"{name}.npz"))
    tables = {k.split("/", 1)[1]: z[k] for k in z.files
              if k.startswith("table/")}
    fm = port_model(inp, name, z["sigma"] if "sigma" in z.files else None,
                    cutoff)
    fm._tables = fm.tables_from_jax(tables)
    return fm, z["params"]


def snooker_block(fm, data: np.ndarray):
    """A 3-step snooker block of 8 chains from seed 0 on the eclipse
    case's model: (positions [3, 8, nfree], loglike [3, 8])."""
    import torch

    from bart_tpu_torch.demo import DEMO_PARAMS
    from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
    from bart_tpu_torch.inference.samplers import EnsembleSampler

    pinit = np.concatenate([DEMO_PARAMS[:-1], CASES["eclipse"][2],
                            DEMO_PARAMS[-1:]])
    space = ParamSpace(pinit=pinit,
                       pmin=[-5, -2, -2, 0, 0.55, 1e-3, -2, -9],
                       pmax=[-1, 1, 1, 1, 1.2, 10.0, 2, 1.5],
                       stepsize=[0.01, 0.01, 0, 0, 0.001, 0, 0, 0.1])
    like = Likelihood(fm, space, data, 0.03 * np.abs(data))
    sampler = EnsembleSampler(
        loglike_fn=like, nfree=space.nfree, nmodel=len(data),
        nchains=SNOOKER["nchains"], walk="snooker", pmin=space.free_min,
        pmax=space.free_max, stepsize=space.stepsize[space.ifree])
    gen = torch.Generator().manual_seed(SNOOKER["seed"])
    state = sampler.init_state(gen, dtype=torch.float64)
    _, pb, lb, _ = sampler.run_block(state, gen, SNOOKER["nsteps"])
    return pb.numpy(), lb.numpy()


def mcmc_run(fm, data: np.ndarray, out_dir: str):
    """run_mcmc on the eclipse case's model (6 chains, 12 eager steps a
    chain, snooker) with every output file in ``out_dir``, then
    best_fit_outputs into ``out_dir``/bestfit; returns the result."""
    from bart_tpu_torch.post.bestfit import best_fit_outputs

    from bart_tpu_torch.demo import DEMO_PARAMS
    from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
    from bart_tpu_torch.inference.retrieval import run_mcmc

    pinit = np.concatenate([DEMO_PARAMS[:-1], CASES["eclipse"][2],
                            DEMO_PARAMS[-1:]])
    space = ParamSpace(pinit=pinit,
                       pmin=[-5, -2, -2, 0, 0.55, 1e-3, -2, -9],
                       pmax=[-1, 1, 1, 1, 1.2, 10.0, 2, 1.5],
                       stepsize=[0.01, 0.01, 0, 0, 0.001, 0, 0, 0.1])
    like = Likelihood(fm, space, data, 0.03 * np.abs(data))
    os.makedirs(f"{out_dir}/bestfit", exist_ok=True)
    res = run_mcmc(like, space, nchains=6, numit=72, burnin=4, block=4,
                   seed=3, verbose=False, savemodel=f"{out_dir}/models.npy",
                   savefile=f"{out_dir}/output.npy",
                   logfile=f"{out_dir}/MCMC.log",
                   checkpoint=f"{out_dir}/ck.npz")
    best_fit_outputs(fm, like, space, res, f"{out_dir}/bestfit",
                     store={"filters": [], "data": data})
    return res


class ToyForward:
    """The two-process smoke's toy forward (tests/distributed_worker.py's
    [p0 + p1, p0 - p1, p0 p1]) split over the chain axis of a mesh as
    ForwardModel splits a forward: each chain block's models and validity
    in a zeroed buffer, summed over the mesh in one all-reduce."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.device = mesh.device

    def __call__(self, p):
        import torch

        lo, hi = self.mesh.chain_block(p.shape[0])
        buf = torch.zeros(p.shape[0], 4, dtype=p.dtype)
        q = p[lo:hi]
        buf[lo:hi, :3] = torch.stack([q[:, 0] + q[:, 1], q[:, 0] - q[:, 1],
                                      q[:, 0] * q[:, 1]], dim=1)
        self.mesh.all_reduce(buf)
        return buf[:, :3], buf[:, :3], buf[:, 3] == 0


def toy_stats(mesh) -> np.ndarray:
    """tests/distributed_worker.py's block on the toy forward: 16 snooker
    chains, 4 steps from seed 7 -> (sum lb, sum lb^2, sum pb, sum pb^2)."""
    import torch

    from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
    from bart_tpu_torch.inference.samplers import EnsembleSampler

    space = ParamSpace([0.5, -0.2], [-5, -5], [5, 5], [0.1, 0.1])
    like = Likelihood(ToyForward(mesh), space, np.array([1.2, 0.4, -0.3]),
                      np.array([0.05, 0.05, 0.05]))
    sampler = EnsembleSampler(
        loglike_fn=like, nfree=2, nmodel=3, nchains=16, walk="snooker",
        pmin=space.free_min, pmax=space.free_max,
        stepsize=space.stepsize[space.ifree])
    gen = torch.Generator().manual_seed(7)
    state = sampler.init_state(gen, dtype=torch.float64)
    _, pb, lb, _ = sampler.run_block(state, gen, 4)
    return np.array([float(lb.sum()), float((lb * lb).sum()),
                     float(pb.sum()), float((pb * pb).sum())])


def main(job: str, rank: int, world: int, n_chain: int) -> None:
    import torch

    from bart_tpu_torch.demo import demo_inputs
    from bart_tpu_torch.parallel import (init_distributed, make_mesh,
                                         shard_model)

    torch.set_num_threads(1)
    meta = json.load(open(os.path.join(job, "job.json")))
    init_distributed(f"file://{job}/rendezvous", world, rank, device="cpu",
                     timeout_s=120)
    mesh = make_mesh(n_chain, device="cpu")
    out = {"coords": np.array([mesh.rank, mesh.chain, mesh.wn,
                               mesh.n_chain, mesh.n_wn])}
    if meta.get("toy"):
        out["toy"] = toy_stats(mesh)
    inp = demo_inputs(**INPUTS)
    for name in meta.get("cases", ()):
        fm, P = load_case(meta["data_dir"], inp, name, meta["cutoff"])
        shard_model(fm, mesh)
        t = fm.tables
        n0 = mesh.collectives
        band, spec, valid = fm(torch.tensor(P))
        out[f"{name}/collectives"] = np.array(mesh.collectives - n0)
        out[f"{name}/band"] = band.numpy()
        out[f"{name}/valid"] = valid.numpy()
        out[f"{name}/local_spectrum"] = spec.numpy()
        out[f"{name}/spectrum"] = mesh.gather(spec, len(P)).numpy()
        # this rank's columns of the wn-indexed table, and all it holds
        held = (t["tab"].plain() if "tab" in t else t["tabk"].bins()
                if "tabk" in t else t["lt0_wn0"])
        out[f"{name}/held_bytes"] = np.array(held.nbytes)
        out[f"{name}/n_wn_orig"] = np.array(fm.n_wn_orig)
        out[f"{name}/device"] = np.array(str(fm.device))
        if name == "eclipse" and meta.get("snooker"):
            pb, lb = snooker_block(fm, np.asarray(meta["obs"]))
            out["snooker/positions"], out["snooker/loglike"] = pb, lb
        if name == "eclipse" and meta.get("mcmc"):
            res = mcmc_run(fm, np.asarray(meta["obs"]),
                           os.path.join(job, "mcmc"))
            out["mcmc/posterior"] = res.posterior
            out["mcmc/models"] = res.models
    np.savez(os.path.join(job, f"rank{rank}.npz"), **out)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    sys.modules["jax"] = None          # any `import jax` now fails
    sys.modules["bart_tpu"] = None     # and any import of bart_tpu
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
    assert not any(k.split(".")[0] in ("jax", "bart_tpu")
                   for k, v in sys.modules.items() if v is not None)
