"""One rank of tests/test_torch_mesh_cards.py: the checks that keep the ranks
of a (chain, wn) mesh in step, on gloo ranks on the CPU.

Launched as ``world`` separate OS processes that form one torch.distributed
group through a file rendezvous in the job directory; jax and bart_tpu
are blocked.  In order, on a 2 x 2 mesh:

* ``Mesh.agree`` on a state every rank draws alike (it must pass), then
  once per field with rank 2's copy of that field moved by one ulp (it
  must raise on every rank);
* ``run_mcmc`` on a sharded model: two blocks in one run with a
  checkpoint, and the same two blocks as one block, a checkpoint and a
  resume (every output file in a directory the ranks share: rank 0
  writes, the others read the checkpoint back);
* ``run_mcmc`` with rank 2's log-likelihoods moved by one ulp: it must
  raise on every rank after the first block.

Each rank writes what it saw to rank<r>.npz.  The model builder and the
retrieval are shared with the test, which runs them unmeshed.

Usage: python torch_mesh_cards_worker.py <job_dir> <rank> <world> <n_chain>
"""

import os
import sys

import numpy as np

#: the small demo problem (8 layers x 121 wn: 61 points a wn shard)
INPUTS = dict(nlayer=8, nwave=121, nlines=60, t_step=650.0)
#: the retrieval: chains, steps a block, seed
RUN = dict(nchains=16, block=4, seed=3)
#: the fields of the state the agreement check covers, and their shapes
STATE = {"positions": (16, 4), "loglike": (16,), "naccept": (16,)}


def build(device: str = "cpu"):
    """(model, space, data, uncert): the demo eclipse model in float64 and
    data at the demo parameters with 3% uncertainties."""
    import torch

    from bart_tpu_torch.demo import (DEMO_PARAMS, build_demo_model,
                                     demo_inputs)
    from bart_tpu_torch.inference.likelihood import ParamSpace

    inp = demo_inputs(**INPUTS)
    fm = build_demo_model(inp, dtype=torch.float64, budget_bytes=1e7,
                          device=device)
    data = fm(torch.tensor(DEMO_PARAMS[None]))[0][0].numpy()
    space = ParamSpace(pinit=DEMO_PARAMS, pmin=[-5, -2, -2, 0, 0.55, -9],
                       pmax=[-1, 1, 1, 1, 1.2, 1.5],
                       stepsize=[0.01, 0.01, 0.0, 0.0, 0.001, 0.1])
    return fm, space, data, 0.03 * np.abs(data)


def retrieve(like, space, nblocks: int, out_dir: str, **kw):
    """run_mcmc of ``nblocks`` blocks of RUN with a checkpoint after every
    block, every file in ``out_dir``."""
    from bart_tpu_torch.inference.retrieval import run_mcmc

    os.makedirs(out_dir, exist_ok=True)
    n, b = RUN["nchains"], RUN["block"]
    return run_mcmc(like, space, nchains=n, numit=n * b * nblocks, burnin=0,
                    block=b, seed=RUN["seed"], grtest=False, verbose=False,
                    savefile=os.path.join(out_dir, "output.npy"),
                    logfile=os.path.join(out_dir, "MCMC.log"),
                    checkpoint=os.path.join(out_dir, "ck.npz"),
                    checkpoint_every=1, **kw)


def result_arrays(res, prefix: str) -> dict:
    return {f"{prefix}/posterior": res.posterior,
            f"{prefix}/bestp": res.bestp,
            f"{prefix}/best_loglike": np.asarray(res.best_loglike),
            f"{prefix}/accept": np.asarray(res.accept_rate)}


def agreement(mesh, rank: int) -> dict:
    """Mesh.agree on a state drawn alike on every rank, then per field
    with rank 2's copy one ulp off: {"agree": 1} and per field its
    message (empty if nothing was raised)."""
    import torch

    gen = torch.Generator().manual_seed(5)
    state = {"positions": torch.randn(STATE["positions"], generator=gen,
                                      dtype=torch.float64),
             "loglike": -torch.rand(STATE["loglike"], generator=gen,
                                    dtype=torch.float64) * 100,
             "naccept": torch.randint(0, 50, STATE["naccept"],
                                      generator=gen)}
    state = {k: v.to(mesh.device) for k, v in state.items()}
    mesh.agree(*state.values())
    out = {"agree/ok": np.asarray(1)}
    for field in STATE:
        moved = {k: v.clone() for k, v in state.items()}
        if rank == 2:
            x = moved[field].reshape(-1)
            x[3] = (x[3] + 1 if field == "naccept" else torch.nextafter(
                x[3], torch.full_like(x[3], np.inf)))
        try:
            mesh.agree(*moved.values(), what=field)
            out[f"agree/{field}"] = np.asarray("")
        except RuntimeError as e:
            out[f"agree/{field}"] = np.asarray(str(e))
    return out


class Drift:
    """A likelihood whose log-likelihoods are one ulp above the wrapped
    one's: the state of the rank that holds it drifts from the others'."""

    def __init__(self, like):
        self.like = like

    def __getattr__(self, name):
        return getattr(self.like, name)

    def __call__(self, free):
        import torch

        logl, model = self.like(free)
        return torch.nextafter(logl, torch.full_like(logl, np.inf)), model


def main(job: str, rank: int, world: int, n_chain: int) -> None:
    import torch
    import torch.distributed as dist

    from bart_tpu_torch.inference.likelihood import Likelihood
    from bart_tpu_torch.parallel import (init_distributed, make_mesh,
                                         shard_model)

    torch.set_num_threads(1)
    init_distributed(f"file://{job}/rendezvous", world, rank, device="cpu",
                     timeout_s=120)
    mesh = make_mesh(n_chain, device="cpu")
    out = agreement(mesh, rank)
    fm, space, data, uncert = build()
    shard_model(fm, mesh)
    like = Likelihood(fm, space, data, uncert)
    out.update(result_arrays(retrieve(like, space, 2, f"{job}/whole"),
                             "whole"))
    retrieve(like, space, 1, f"{job}/split")
    out.update(result_arrays(
        retrieve(like, space, 2, f"{job}/split", resume=True), "resumed"))
    try:
        retrieve(Drift(like) if rank == 2 else like, space, 2,
                 f"{job}/drift")
        out["drift"] = np.asarray("")
    except RuntimeError as e:
        out["drift"] = np.asarray(str(e))
    np.savez(os.path.join(job, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.modules["jax"] = None          # any `import jax` now fails
    sys.modules["bart_tpu"] = None     # and any import of bart_tpu
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
