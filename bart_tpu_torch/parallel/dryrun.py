"""The multi-device dryrun: a snooker MCMC block over a (chain, wn) mesh
of ranks, then the two sharding proofs (twin of the JAX package's
``__graft_entry__.dryrun_multichip``, ``demo_scale_shard_check`` and
``folded_shard_check``).

* ``dryrun_multichip``: the demo problem at 12 layers x 256 wn x 400
  lines sharded over the mesh, data at the truth, a 2-step snooker block
  of 4 chains per chain coordinate; the log-likelihoods must be finite
  and the ranks' states equal (``Mesh.agree``).
* ``demo_scale_shard_check``: the demo-scale table (100 layers x 2501 wn
  x 27 T-nodes; 64 lines: the line count changes the table's values, not
  its layout) sharded over the mesh: each rank holds total / n_wn of the
  K = 1 table's columns, and a forward issues exactly one collective
  (the mesh's count), the all-reduce of the band fluxes.
* ``folded_shard_check``: the same for the folded table (K = 8, bfloat16,
  40 layers x 1024 output bins, ``fold_adapt=None``).

Each rank builds the whole opacity table on its device (the build is
set-up; on the CPU it takes minutes at demo scale), moves it to the host,
lays the model out there and keeps only its shard on the device
(parallel.mesh.shard_model).  So the bytes a rank checks and prints are
the shard it holds for the forward, not its device's peak: during set-up
the device held the whole table once (ranks that share one card, each
their own copy).  A run that must not hold the whole table on a card
builds it on the host, or loads it (opacity.grid.load_grid), before
shard_model.  Run it under torchrun, one rank a card:

    torchrun --standalone --nproc_per_node N -m bart_tpu_torch.parallel.dryrun

or with ranks that share one card, over gloo:

    torchrun --standalone --nproc_per_node N -m bart_tpu_torch.parallel.dryrun \\
        --backend gloo --device cuda:0

``--device cpu --tiny`` runs it on the CPU at a few layers and points.
"""

from __future__ import annotations

import argparse
import gc
import sys

import numpy as np
import torch

__all__ = ["dryrun_multichip", "demo_scale_shard_check",
           "folded_shard_check", "main"]

#: (nlayer, nwave, nlines, t_step) of each problem
SIZES = {
    "full": {"problem": (12, 256, 400, 100.0), "demo": (100, 2501, 64, 100.0),
             "folded": (40, 1024, 64, 100.0)},
    "tiny": {"problem": (6, 64, 40, 1300.0), "demo": (8, 301, 16, 1300.0),
             "folded": (6, 64, 16, 1300.0)},
}
TRUTH = np.array([-2.0, 0.0, 1.0, 0.0, 0.98, -0.5])


def _build_problem(mesh, nlayer, nwave, nlines, t_step, fold=1,
                   fold_bf16=False):
    """The demo eclipse problem (float32) on the host, its whole opacity
    table built on the rank's device and then moved to the host (set-up:
    not the shard the rank holds afterwards)."""
    from bart_tpu_torch.demo import build_demo_model, demo_inputs
    from bart_tpu_torch.opacity.grid import build_opacity_grid
    from bart_tpu_torch.utils.grids import folded_fine_grid

    inp = demo_inputs(nlayer, nwave, nlines, t_step=t_step)
    grid = build_opacity_grid({"CH4": inp.lines},
                              folded_fine_grid(inp.wn, fold), inp.t_grid,
                              inp.pressure, device=mesh.device)
    grid.sigma = grid.sigma.cpu()
    return build_demo_model(inp, device="cpu", grid=grid, fold=fold,
                            fold_adapt=None, fold_bf16=fold_bf16)


def _held(fm) -> torch.Tensor:
    """The columns in use of the model's wn-indexed table: [R, L, W] of
    the K = 1 table, [R, L, W, K] of the folded one."""
    t = fm.tables
    return t["tabk"].bins() if "tabk" in t else t["tab"].plain()


def _say(mesh, msg: str) -> None:
    if mesh.rank == 0:
        print(msg, flush=True)


def dryrun_multichip(mesh, sizes: dict = SIZES["full"]) -> None:
    """A 2-step snooker block over the mesh on the small problem."""
    from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
    from bart_tpu_torch.inference.samplers import EnsembleSampler
    from bart_tpu_torch.parallel.mesh import shard_model

    fm = shard_model(_build_problem(mesh, *sizes["problem"]), mesh)
    data = fm(torch.tensor(TRUTH[None]))[0][0].double().cpu().numpy()
    space = ParamSpace(pinit=TRUTH, pmin=[-5, -2, -2, 0, 0.55, -9],
                       pmax=[-1, 1, 1, 1, 1.2, 1.5],
                       stepsize=[0.01, 0.01, 0.0, 0.0, 0.001, 0.1])
    like = Likelihood(fm, space, data, 0.03 * np.abs(data) + 1e-12)
    nchains = 4 * mesh.n_chain
    sampler = EnsembleSampler(
        loglike_fn=like, nfree=space.nfree, nmodel=len(data),
        nchains=nchains, walk="snooker", pmin=space.free_min,
        pmax=space.free_max, stepsize=space.stepsize[space.ifree])
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    state = sampler.init_state(gen, dtype=fm.dtype)
    state, pb, lb, mb = sampler.run_block(state, gen, 2)
    mesh.agree(state.positions, state.loglike, state.naccept)
    lb = lb.cpu().numpy()
    if lb.shape != (2, nchains) or not np.all(np.isfinite(lb)):
        raise RuntimeError(f"dryrun_multichip: loglike {lb}")
    _say(mesh, f"dryrun_multichip({mesh.n_chain}x{mesh.n_wn}, "
               f"{mesh.backend}): OK - 2 MCMC steps on {nchains} chains "
               f"({'graphed' if sampler.graphs(mesh.device) else 'eager'}), "
               f"the ranks' states equal, loglike finite: "
               f"{lb[-1]}")


def _shard_check(mesh, fm, what: str) -> None:
    """Shard ``fm`` over the mesh; then the rank's bytes of the
    wn-sharded table must be total / n_wn (total: the unsharded table's
    bytes, padded to the mesh), a forward of 4 chains per chain
    coordinate must issue exactly one collective, and its bands must be
    finite."""
    from bart_tpu_torch.parallel.mesh import shard_model

    full = _held(fm)
    W = full.shape[2]
    total = full.nbytes // W * (W + (-W) % mesh.n_wn)
    shard_model(fm, mesh)
    held = _held(fm)
    tab = fm.tables["tabk" if "tabk" in fm.tables else "tab"]
    if held.device != mesh.device or held.nbytes * mesh.n_wn != total:
        raise RuntimeError(f"{what}: {held.nbytes} B on rank {mesh.rank} "
                           f"({held.device}) x {mesh.n_wn} != {total} B")
    params = torch.tensor(np.tile(TRUTH, (4 * mesh.n_chain, 1)),
                          dtype=fm.dtype)
    n0 = mesh.collectives
    band = fm(params)[0]
    n = mesh.collectives - n0
    if n != 1 or not bool(torch.isfinite(band).all()):
        raise RuntimeError(f"{what}: {n} collectives in a forward, bands "
                           f"{band}")
    _say(mesh, f"{what}: OK - table {total / 2**20:.3f} MiB sharded "
               f"{mesh.n_wn}-way ({held.nbytes / 2**20:.3f} MiB held a rank "
               f"for the forward, {tab.tab.nbytes / 2**20:.3f} MiB "
               f"allocated with the 16-byte row alignment; not the set-up "
               f"peak: the table was built whole on the device), one "
               f"collective in a forward (the band-flux all-reduce)")


def demo_scale_shard_check(mesh, sizes: dict = SIZES["full"]) -> None:
    """The K = 1 table at demo scale: shard bytes and one collective."""
    _shard_check(mesh, _build_problem(mesh, *sizes["demo"]),
                 "demo_scale_shard_check")


def folded_shard_check(mesh, sizes: dict = SIZES["full"]) -> None:
    """The folded (K = 8, bfloat16) table: shard bytes and one
    collective."""
    _shard_check(mesh, _build_problem(mesh, *sizes["folded"], fold=8,
                                      fold_bf16=True),
                 "folded_shard_check")


def main(argv=None) -> int:
    import torch.distributed as dist

    from bart_tpu_torch.parallel.distributed import init_distributed
    from bart_tpu_torch.parallel.mesh import make_mesh

    ap = argparse.ArgumentParser(prog="python -m bart_tpu_torch.parallel."
                                 "dryrun", description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl on a card, gloo on "
                    "the CPU)")
    ap.add_argument("--device", default=None,
                    help="this rank's device (default: cuda:LOCAL_RANK)")
    ap.add_argument("--tiny", action="store_true",
                    help="a few layers and points (for the CPU)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a rendezvous or collective may take")
    args = ap.parse_args(argv)
    if not init_distributed(backend=args.backend, device=args.device,
                            timeout_s=args.timeout) and not dist.is_initialized():
        print("dryrun: no process group (WORLD_SIZE unset): run it under "
              "torchrun", file=sys.stderr)
        return 2
    try:
        world = dist.get_world_size()
        mesh = make_mesh(n_chain=2 if world % 2 == 0 and world > 1 else 1,
                         device=args.device)
        sizes = SIZES["tiny" if args.tiny else "full"]
        dryrun_multichip(mesh, sizes)
        demo_scale_shard_check(mesh, sizes)
        folded_shard_check(mesh, sizes)
    finally:
        gc.collect()         # the block's graphs first (distributed.py)
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
