"""Retrieval orchestration: blocks of on-device MCMC with host-side
control between them (port of bart_tpu/inference/retrieval.py:run_mcmc).

Ported: the block loop with the burn-in DE-gamma adaptation, an
in-memory sample store, Gelman-Rubin and rank-normalised split-R-hat
(bart_tpu.inference.gr, shared host numpy) with the optional grexit,
and ``RetrievalResult``.  Not yet ported: checkpoint/resume,
savemodel/modelper, the MCMC.log file and the least-squares pre-fit
(ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from bart_tpu_torch.inference.gr import (effective_sample_size, gelman_rubin,
                                   split_rhat_rank)
from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
from bart_tpu_torch.inference.samplers import EnsembleSampler

__all__ = ["RetrievalResult", "run_mcmc"]


@dataclasses.dataclass
class RetrievalResult:
    posterior: np.ndarray      # [nchain, nfree, niter] post burn-in
    bestp: np.ndarray          # [nfree]
    best_loglike: float
    accept_rate: float
    psrf: np.ndarray           # final Gelman-Rubin per free param
    pnames: list[str]
    space: ParamSpace
    niter_total: int
    converged: bool
    psrf_rank: np.ndarray | None = None  # rank-normalised split-R-hat
    fgamma_final: float = 1.0  # DE gamma scale after burn-in adaptation
    ess: np.ndarray | None = None        # bulk effective sample size


def run_mcmc(like: Likelihood, space: ParamSpace, *, nchains: int = 10,
             numit: int = 50000, burnin: int = 500, walk: str = "snooker",
             seed: int = 0, block: int = 100, thinning: int = 1,
             grtest: bool = True, grexit: bool = False,
             grbreak: float = 1.01, init: np.ndarray | None = None,
             fgamma: float = 1.0, snooker_frac: float = 0.1,
             z_thin: int = 30, verbose: bool = True,
             dtype: torch.dtype = torch.float64) -> RetrievalResult:
    """Run a retrieval on the likelihood's device.  ``numit`` is the
    TOTAL number of samples across chains (reference semantics).  The
    sampler state is kept in ``dtype`` whatever the forward model's."""
    t_start = time.time()

    def log(msg):
        if verbose:
            print(msg)

    sampler = EnsembleSampler(
        loglike_fn=like, nfree=space.nfree,
        nmodel=int(like.data.shape[0]), nchains=nchains, walk=walk,
        pmin=space.free_min, pmax=space.free_max, fgamma=fgamma,
        snooker_frac=snooker_frac, z_thin=z_thin,
    )
    gen = torch.Generator(device=like.device)
    gen.manual_seed(seed)
    state = sampler.init_state(gen, init, dtype=dtype)

    iters_per_chain = max(int(np.ceil(numit / nchains)), block)
    nblocks = int(np.ceil(iters_per_chain / block))
    store = np.empty((nblocks * block, nchains, space.nfree),
                     np.dtype(str(dtype).removeprefix("torch.")))
    psrf = np.full(space.nfree, np.inf)
    psrf_rank = np.full(space.nfree, np.inf)
    converged = False
    done = 0
    # Burn-in gamma adaptation, as bart_tpu: multiplicative feedback
    # outside the [0.15, 0.45] acceptance deadband, active over the
    # second half of burn-in only, frozen afterwards.
    acc_lo, acc_hi, fg_floor = 0.15, 0.45, 0.25
    fg = float(fgamma)
    prev_nacc = int(state.naccept.sum())
    for ib in range(nblocks):
        state, pb, _, _ = sampler.run_block(state, gen, block, fgamma=fg)
        store[done:done + block] = pb.cpu().numpy()
        done += block

        if done <= burnin:
            nacc = int(state.naccept.sum())
            block_acc = (nacc - prev_nacc) / (block * nchains)
            prev_nacc = nacc
            if done > burnin // 2:
                if block_acc < acc_lo:
                    fg_new = fg * float(np.exp(4.0 * (block_acc - acc_lo)))
                elif block_acc > acc_hi:
                    fg_new = fg * float(np.exp(2.0 * (block_acc - acc_hi)))
                else:
                    fg_new = fg
                fg = float(np.clip(fg_new, fg_floor, 2.0))
            if done + block > burnin:
                log(f"burn-in gamma adaptation frozen: fgamma {fg:.3f}"
                    f" (block accept {block_acc:.3f})")

        if grtest and done > burnin and (ib + 1) % 10 == 0:
            chains = store[burnin:done].transpose(1, 0, 2)
            psrf = gelman_rubin(chains)
            psrf_rank = split_rhat_rank(chains)
            log(f"iter {done * nchains:8d}/{numit}  "
                f"GR: {np.array2string(psrf, precision=4)}  "
                f"split-Rhat: {np.array2string(psrf_rank, precision=4)}")
            if grexit and np.all(psrf_rank < grbreak):
                log("split-R-hat convergence reached — early exit (grexit).")
                converged = True
                break

    posterior = store[burnin:done:thinning].transpose(1, 2, 0).copy()
    ess = None
    if grtest:
        chains = store[burnin:done].transpose(1, 0, 2)
        psrf = gelman_rubin(chains)
        psrf_rank = split_rhat_rank(chains)
        ess = effective_sample_size(chains)
        converged = converged or bool(np.all(psrf_rank < grbreak))

    total = done * nchains
    accept = int(state.naccept.sum()) / total
    best_logl = float(state.best_loglike)
    elapsed = time.time() - t_start
    log(f"MCMC done: {total} samples in {elapsed:.1f}s "
        f"({total / elapsed:.0f} samples/s), accept={accept:.3f}")
    log(f"best chi2 = {-2 * best_logl:.4f}")
    pnames = ([space.pnames[i] for i in space.ifree] if space.pnames
              else [f"p{i}" for i in space.ifree])
    return RetrievalResult(
        posterior=posterior,
        bestp=state.best_pos.cpu().numpy(),
        best_loglike=best_logl,
        accept_rate=accept,
        psrf=psrf,
        pnames=pnames,
        space=space,
        niter_total=total,
        converged=converged,
        psrf_rank=psrf_rank,
        fgamma_final=fg,
        ess=ess,
    )
