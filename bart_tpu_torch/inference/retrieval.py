"""Retrieval orchestration: blocks of on-device MCMC with host-side
control between them (port of bart_tpu/inference/retrieval.py).

The chain ensemble advances ``block`` iterations at a time: on a CUDA
likelihood a block is the replay of one captured sampler step
(``samplers.StepGraph``), on the CPU the eager loop of steps.  Between
blocks the host adapts the DE gamma during burn-in, runs Gelman-Rubin and
the rank-normalised split-R-hat (with the optional grexit), appends the
block to the sample store and writes checkpoints.

Outputs as bart_tpu's:
* ``savefile``    posterior [nchain, nfree, niter] (.npy)
* ``logfile``     MCMC.log with a " Best-fit params" block
* ``savemodel``   band fluxes [nchain, nmodel, niter_total], split into
                  numbered files every ``modelper`` iterations per chain
* ``checkpoint``  the sampler state, the generator's state and the gamma
                  scale (.npz), the samples in memmap sidecars; a run
                  resumed from it (``resume``) repeats the uninterrupted
                  run's samples bit for bit.  The files are this
                  package's: a torch generator's state stands where
                  bart_tpu keeps its JAX key.

Not ported: the least-squares pre-fit (``leastsq``, ROADMAP queue 1,
item 15).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from bart_tpu_torch.device import resolve_device
from bart_tpu_torch.inference.gr import (effective_sample_size, gelman_rubin,
                                         split_rhat_rank)
from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
from bart_tpu_torch.inference.samplers import EnsembleSampler, SamplerState

__all__ = ["RetrievalResult", "run_mcmc", "save_checkpoint",
           "load_checkpoint"]


class _SampleStore:
    """Append-only per-iteration sample store, [cap, nchain, nparam].

    Iteration-major layout keeps every append a contiguous write, so a
    disk-backed store (``path`` given) costs O(block) per flush — the
    checkpoint .npz then only carries the small sampler state, never the
    accumulated posterior (fixes the O(N^2) re-concatenation the round-1
    checkpointing had)."""

    def __init__(self, nchain: int, nparam: int, cap: int, dtype,
                 path: str | None = None, n0: int = 0):
        self.path = path
        self.cap = cap
        dt = np.dtype(dtype)
        if path is not None:
            nbytes = cap * nchain * nparam * dt.itemsize
            # create, or extend in place when resuming to a longer run
            with open(path, "ab") as f:
                if f.tell() < nbytes:
                    f.truncate(nbytes)
            self.buf = np.memmap(path, dt, "r+", shape=(cap, nchain, nparam))
        else:
            self.buf = np.empty((cap, nchain, nparam), dt)
        self.n = n0

    def append(self, block) -> None:
        """block: [nsteps, nchain, nparam] (the sampler's native order)."""
        ns = block.shape[0]
        self.buf[self.n:self.n + ns] = block
        self.n += ns

    def flush(self) -> None:
        if self.path is not None:
            self.buf.flush()

    def iterations(self, start: int = 0) -> np.ndarray:
        """[nsteps, nchain, nparam] view of iterations [start, n)."""
        return self.buf[start:self.n]

    def samples(self, start: int = 0, step: int = 1) -> np.ndarray:
        """[nchain, nparam, nsteps] — the reference's output.npy layout
        (code/bestFit.py:431-433)."""
        return np.array(self.buf[start:self.n:step]).transpose(1, 2, 0)


def save_checkpoint(path: str, state: SamplerState, done_iters: int,
                    generator: torch.Generator, fgamma: float = 1.0) -> None:
    """The sampler state, the iterations done, the generator's state and
    the gamma scale, at a block boundary, in an .npz.  The sample history
    lives in the memmap sidecars ``<path>.pos.dat`` / ``<path>.mod.dat``,
    flushed by _SampleStore."""
    arrays = {f"state/{k}": v.cpu().numpy()
              for k, v in state._asdict().items()}
    arrays["done_iters"] = np.asarray(done_iters)
    arrays["generator"] = generator.get_state().numpy()
    arrays["fgamma"] = np.asarray(fgamma)
    np.savez(path, **arrays)


def load_checkpoint(path: str, device: str | torch.device = "cuda"):
    """-> (state on ``device`` (the card unless the caller asks for the
    CPU), done_iters, the generator's state (a CPU uint8 tensor for
    ``Generator.set_state``), fgamma)."""
    device = resolve_device(device)
    z = np.load(path)
    state = SamplerState(**{
        k.split("/", 1)[1]: torch.as_tensor(z[k], device=device)
        for k in z.files if k.startswith("state/")})
    return (state, int(z["done_iters"]), torch.as_tensor(z["generator"]),
            float(z["fgamma"]))


@dataclasses.dataclass
class RetrievalResult:
    posterior: np.ndarray      # [nchain, nfree, niter] post burn-in
    models: np.ndarray | None  # [nchain, nmodel, niter_total] if savemodel
                               # (the whole history, burn-in included)
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
             grbreak: float = 1.01, leastsq: bool = False,
             chisqscale: bool = False, init: np.ndarray | None = None,
             savefile: str | None = None, savemodel: str | None = None,
             modelper: int = 0, logfile: str | None = None,
             checkpoint: str | None = None, checkpoint_every: int = 20,
             resume: bool = False, fgamma: float = 1.0,
             snooker_frac: float = 0.1, z_thin: int = 30,
             verbose: bool = True,
             dtype: torch.dtype = torch.float64) -> RetrievalResult:
    """Run a retrieval on the likelihood's device.  ``numit`` is the
    TOTAL number of samples across chains (reference semantics).  The
    sampler state is kept in ``dtype`` whatever the forward model's."""
    if leastsq:
        raise NotImplementedError(
            "run_mcmc: the least-squares pre-fit (leastsq) is not ported "
            "yet (ROADMAP queue 1, item 15)")
    t_start = time.time()
    log_lines: list[str] = []

    def log(msg):
        if verbose:
            print(msg)
        log_lines.append(msg)

    nmodel = int(like.data.shape[0])
    if chisqscale:
        # scale uncertainties for reduced chi2 == 1 at the initial guess
        free0 = torch.as_tensor(space.free_init[None], dtype=torch.float64,
                                device=like.device)
        chi0 = float(like.chisq(free0)[0])
        scale = np.sqrt(chi0 / max(nmodel - space.nfree, 1))
        like.uncert = like.uncert * scale
        log(f"chisqscale: uncertainties scaled by {scale:.4f}")

    sampler = EnsembleSampler(
        loglike_fn=like, nfree=space.nfree, nmodel=nmodel, nchains=nchains,
        walk=walk, pmin=space.free_min, pmax=space.free_max,
        stepsize=space.stepsize[space.ifree], fgamma=fgamma,
        snooker_frac=snooker_frac, z_thin=z_thin)
    gen = torch.Generator(device=like.device)
    gen.manual_seed(seed)

    done0 = 0
    fg = float(fgamma)
    if resume and checkpoint and os.path.isfile(checkpoint):
        state, done0, gen_state, fg = load_checkpoint(checkpoint,
                                                      like.device)
        gen.set_state(gen_state)
        nz_ckpt = int(state.z_archive.shape[0])
        if nz_ckpt != sampler.nz:
            # the checkpoint's archive size wins: the ring-buffer index
            # arithmetic of _step uses sampler.nz
            log(f"checkpoint z-archive size {nz_ckpt} != configured "
                f"{sampler.nz}; using the checkpoint's size")
            sampler.nz = nz_ckpt
        log(f"resumed from {checkpoint} at iteration {done0} "
            f"(fgamma {fg:.3f})")
    else:
        state = sampler.init_state(
            gen, None if init is None else np.asarray(init), dtype=dtype)

    iters_per_chain = max(int(np.ceil(numit / nchains)), block)
    nblocks = int(np.ceil(max(iters_per_chain - done0, 0) / block))
    cap = done0 + nblocks * block
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    pos_store = _SampleStore(
        nchains, space.nfree, cap, np_dtype,
        path=(checkpoint + ".pos.dat") if checkpoint else None, n0=done0)
    model_store = (
        _SampleStore(nchains, nmodel, cap, np_dtype,
                     path=(checkpoint + ".mod.dat") if checkpoint else None,
                     n0=done0)
        if savemodel else None)
    psrf = np.full(space.nfree, np.inf)
    psrf_rank = np.full(space.nfree, np.inf)
    converged = False
    done_iters = done0
    # Burn-in gamma adaptation of the DE walkers, as bart_tpu:
    # multiplicative feedback outside the [0.15, 0.45] acceptance
    # deadband, active over the second half of burn-in only, frozen
    # afterwards.
    adapt_gamma = walk in ("snooker", "demc")
    acc_lo, acc_hi, fg_floor = 0.15, 0.45, 0.25
    prev_nacc = int(state.naccept.sum())
    for ib in range(nblocks):
        state, pb, _, mb = sampler.run_block(state, gen, block, fgamma=fg)
        done_iters += block
        pos_store.append(pb.cpu().numpy())     # [nsteps, nchain, nfree]
        if model_store is not None:
            model_store.append(mb.cpu().numpy())

        if adapt_gamma and done_iters <= burnin:
            nacc = int(state.naccept.sum())
            block_acc = (nacc - prev_nacc) / (block * nchains)
            prev_nacc = nacc
            if done_iters > burnin // 2:
                if block_acc < acc_lo:
                    fg_new = fg * float(np.exp(4.0 * (block_acc - acc_lo)))
                elif block_acc > acc_hi:
                    fg_new = fg * float(np.exp(2.0 * (block_acc - acc_hi)))
                else:
                    fg_new = fg
                fg = float(np.clip(fg_new, fg_floor, 2.0))
            if done_iters + block > burnin:
                log(f"burn-in gamma adaptation frozen: fgamma {fg:.3f}"
                    f" (block accept {block_acc:.3f})")

        if checkpoint and (ib + 1) % checkpoint_every == 0:
            pos_store.flush()
            if model_store is not None:
                model_store.flush()
            save_checkpoint(checkpoint, state, done_iters, gen, fg)

        if grtest and done_iters > burnin and (ib + 1) % 10 == 0:
            chains = np.asarray(
                pos_store.iterations(start=burnin)).transpose(1, 0, 2)
            psrf = gelman_rubin(chains)
            psrf_rank = split_rhat_rank(chains)
            log(f"iter {done_iters * nchains:8d}/{numit}  "
                f"GR: {np.array2string(psrf, precision=4)}  "
                f"split-Rhat: {np.array2string(psrf_rank, precision=4)}  "
                f"accept: "
                f"{int(state.naccept.sum()) / (done_iters * nchains):.3f}")
            if grexit and np.all(psrf_rank < grbreak):
                log("split-R-hat convergence reached — early exit (grexit).")
                converged = True
                break

    posterior = pos_store.samples(start=burnin, step=thinning)
    # models keep the whole iteration history, burn-in included (MC3's
    # savemodel; modelper counts raw iterations)
    models = model_store.samples() if model_store is not None else None
    ess = None
    if grtest:
        chains = np.asarray(
            pos_store.iterations(start=burnin)).transpose(1, 0, 2)
        psrf = gelman_rubin(chains)
        psrf_rank = split_rhat_rank(chains)
        ess = effective_sample_size(chains)
        el = max(time.time() - t_start, 1e-9)
        log(f"bulk ESS: {np.array2string(ess, precision=0)}  "
            f"(min ESS/s {np.nanmin(ess) / el:.2f})")
        converged = converged or bool(np.all(psrf_rank < grbreak))

    bestp = state.best_pos.cpu().numpy()
    best_logl = float(state.best_loglike)
    total = done_iters * nchains
    accept = int(state.naccept.sum()) / total
    elapsed = time.time() - t_start
    log(f"MCMC done: {total} samples in {elapsed:.1f}s "
        f"({total / elapsed:.0f} samples/s), accept={accept:.3f}")
    log(f"best chi2 = {-2 * best_logl:.4f}")
    pnames = ([space.pnames[i] for i in space.ifree] if space.pnames
              else [f"p{i}" for i in space.ifree])

    if savefile:
        np.save(savefile, posterior)
    if checkpoint:
        pos_store.flush()
        if model_store is not None:
            model_store.flush()
        save_checkpoint(checkpoint, state, done_iters, gen, fg)
    if savemodel and models is not None:
        np.save(savemodel, models)
        if modelper > 0:
            # one numbered file every ``modelper`` iterations per chain,
            # modelper * nchains models each (BART.py:208-216)
            base, ext = os.path.splitext(savemodel)
            split_files = []
            for k in range(-(-models.shape[2] // modelper)):
                fname = f"{base}{k:02d}{ext}"
                np.save(fname, models[:, :, k * modelper:(k + 1) * modelper])
                split_files.append(fname)
            if walk == "unif":
                # unif sweeps move the numbered files into a subdirectory
                # named after savemodel (BART.py:582-597)
                os.makedirs(base, exist_ok=True)
                for fname in split_files:
                    os.replace(fname,
                               os.path.join(base, os.path.basename(fname)))
    if logfile:
        # posterior std for the log's uncertainty column
        uncert = posterior.transpose(1, 0, 2).reshape(
            space.nfree, -1).std(axis=1)
        with open(logfile, "w") as f:
            f.write("\n".join(log_lines) + "\n\n")
            # " Best-fit params" block, parseable by the reference's
            # bestFit.read_MCMC_out (code/bestFit.py:74-92)
            f.write(" Best-fit params    Uncertainties   S/N      Sample "
                    "Span\n")
            for j in range(space.nfree):
                sn = abs(bestp[j]) / uncert[j] if uncert[j] > 0 else 0.0
                f.write(f" {bestp[j]: .7e}  {uncert[j]: .7e}  {sn:9.2f}  "
                        f"{pnames[j]}\n")
            f.write("\n")

    return RetrievalResult(
        posterior=posterior,
        models=models,
        bestp=bestp,
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
