"""Ensemble MCMC on the device: the snooker, DE-MC, Metropolis random walk
and uniform-sweep walkers (port of bart_tpu/inference/samplers.py).

* ``mrw``     Gaussian proposals scaled by ``stepsize``, folded at the
              bounds.
* ``demc``    ter Braak (2006) DE-MC: x' = x + gamma (x_r1 - x_r2) + e with
              gamma = 2.38 / sqrt(2 nfree), ``gamma_jump_frac`` of the
              moves full jumps (gamma = 1).
* ``snooker`` ter Braak & Vrugt (2008) DE-MC(Z): proposals from a thinned
              past archive Z; parallel-direction moves x + gamma (z1 - z2)
              + e, and ``snooker_frac`` snooker moves along (x - z3) with
              the |x' - z3|^{d-1} / |x - z3|^{d-1} Metropolis correction.
* ``unif``    uniform draws over the bounds; every valid draw is kept.

JAX keys cannot be reproduced in torch, so the random numbers of a step
are drawn apart from the step, as raw uniforms and normals: the walk's
Variates, whose fields are bart_tpu's draws in its draw order.  ``_step``
takes them as input and works out the indices (archive slots, DE
partners) itself, from the uniforms and, for the archive, the device-side
fill count; one step can so be replayed against bart_tpu fed the same
numbers.

A block (``run_block``) draws all its variates before its first step,
from an explicit ``torch.Generator``, step by step in the order the steps
read them (``draw_block``).  On the CPU the block is a Python loop of
steps.  On a CUDA device one step is captured as a CUDA graph
(``StepGraph``) and replayed once per step: the counterpart of bart_tpu's
jitted ``lax.scan`` block.  The graph reads slice ``i`` of the block's
variates, ``i`` a device counter it increments itself, and the DE gamma
scale from a device scalar filled between blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

__all__ = ["SamplerState", "SnookerVariates", "DemcVariates", "MrwVariates",
           "UnifVariates", "EnsembleSampler", "StepBuffers", "StepGraph"]


def _reflect(x: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """Fold proposals into [lo, hi] by reflection at the boundaries
    (keeps a symmetric step kernel symmetric)."""
    span = hi - lo
    y = torch.remainder(x - lo, 2.0 * span)
    y = torch.where(y > span, 2.0 * span - y, y)
    return torch.where(span > 0, lo + y, x)


def _index(u: torch.Tensor, m) -> torch.Tensor:
    """A uniform index in [0, m) from a uniform in [0, 1): floor(u m),
    clipped to m - 1 (``m`` an int or an int64 device scalar)."""
    return torch.clamp((u * m).to(torch.int64), max=m - 1)


class SamplerState(NamedTuple):
    """Device-resident ensemble state."""

    positions: torch.Tensor   # [nchain, nfree]
    loglike: torch.Tensor     # [nchain]
    models: torch.Tensor      # [nchain, nmodel] current band fluxes
    z_archive: torch.Tensor   # [nz, nfree] past states
    z_count: torch.Tensor     # int64 scalar: filled archive slots
    best_pos: torch.Tensor    # [nfree]
    best_loglike: torch.Tensor
    naccept: torch.Tensor     # [nchain] int64
    niter: torch.Tensor       # int64 scalar


class SnookerVariates(NamedTuple):
    """A snooker step's draws (bart_tpu samplers.py:218-246, then the
    accept uniform at :264)."""

    u_z1: torch.Tensor    # [n] uniform -> archive index, parallel move
    u_z2: torch.Tensor    # [n] uniform -> archive index, parallel move
    u_z3: torch.Tensor    # [n] uniform -> archive index, snooker anchor
    noise: torch.Tensor   # [n, d] standard normal (scaled by eps)
    u_gs: torch.Tensor    # [n, 1] uniform: snooker gamma 1.2 + u_gs
    u_sn: torch.Tensor    # [n] uniform: snooker move where < snooker_frac
    u_acc: torch.Tensor   # [n] uniform: Metropolis accept draw


class DemcVariates(NamedTuple):
    """A DE-MC step's draws (samplers.py:201-213, then :264)."""

    u_r1: torch.Tensor    # [n] uniform -> first partner chain
    u_r2: torch.Tensor    # [n] uniform -> second partner chain
    u_jump: torch.Tensor  # [n, 1] uniform: full jump where < gamma_jump_frac
    noise: torch.Tensor   # [n, d] standard normal (scaled by eps)
    u_acc: torch.Tensor   # [n] uniform: Metropolis accept draw


class MrwVariates(NamedTuple):
    """A random-walk step's draws (samplers.py:189, then :264)."""

    noise: torch.Tensor   # [n, d] standard normal (scaled by stepsize)
    u_acc: torch.Tensor   # [n] uniform: Metropolis accept draw


class UnifVariates(NamedTuple):
    """A uniform-sweep step's draw (samplers.py:196); no accept draw is
    read: every valid proposal is kept."""

    u: torch.Tensor       # [n, d] uniform over [pmin, pmax)


#: walk -> its Variates; each field is drawn in field order, a standard
#: normal if its name is ``noise``, else a uniform in [0, 1)
_VARIATES = {"snooker": SnookerVariates, "demc": DemcVariates,
             "mrw": MrwVariates, "unif": UnifVariates}


@dataclasses.dataclass
class EnsembleSampler:
    """Batched multi-chain sampler.

    ``loglike_fn(free [nchain, nfree]) -> (logl [nchain], model
    [nchain, nmodel])``.
    """

    loglike_fn: Any
    nfree: int
    nmodel: int
    nchains: int
    walk: str = "snooker"
    pmin: np.ndarray | None = None     # [nfree] bounds (folds, unif, init)
    pmax: np.ndarray | None = None
    stepsize: np.ndarray | None = None  # [nfree] mrw proposal sigmas
    nz: int = 0                        # archive size (0 -> the nz rule)
    z_thin: int = 30                   # archive append period
    snooker_frac: float = 0.1
    gamma_jump_frac: float = 0.1       # demc full-jump probability
    eps: float = 1e-6                  # parallel-move jitter scale
    fgamma: float = 1.0                # scale on the DE gamma (MC3 fgamma)

    def __post_init__(self):
        if self.walk not in _VARIATES:
            raise ValueError(f"unknown walk {self.walk!r}; have "
                             f"{sorted(_VARIATES)}")
        if self.pmin is None or self.pmax is None:
            raise ValueError("EnsembleSampler needs pmin and pmax")
        if self.walk == "mrw" and self.stepsize is None:
            raise ValueError("walk 'mrw' needs stepsize")
        if self.walk == "demc" and self.nchains < 3:
            raise ValueError("walk 'demc' needs at least 3 chains")
        if self.nz == 0:
            # the archive holds >= 10 append epochs of the ensemble
            self.nz = max(10 * self.nfree, 10 * self.nchains, 100)
        self._consts = {}    # (device, dtype) -> (pmin, pmax, stepsize)
        self._graphs = {}    # (device, dtype, nsteps, nz) -> StepGraph

    def _bounds(self, device: torch.device, dtype: torch.dtype):
        """(pmin, pmax, stepsize) as tensors on ``device`` in ``dtype``,
        made once per (device, dtype): a capture may not copy them from
        the host."""
        key = (device, dtype)
        if key not in self._consts:
            self._consts[key] = tuple(
                None if a is None else torch.as_tensor(
                    np.asarray(a, np.float64), dtype=dtype, device=device)
                for a in (self.pmin, self.pmax, self.stepsize))
        return self._consts[key]

    # ------------------------------------------------------------------
    def init_state(self, generator: torch.Generator,
                   init_positions: np.ndarray | None = None,
                   dtype: torch.dtype = torch.float64) -> SamplerState:
        """Initial ensemble: given positions, or uniform in [pmin, pmax];
        the archive starts as that population plus uniform draws."""
        dev = generator.device
        lo, hi, _ = self._bounds(dev, dtype)
        if init_positions is None:
            pos = lo + (hi - lo) * torch.rand(
                (self.nchains, self.nfree), generator=generator,
                dtype=dtype, device=dev)
        else:
            pos = torch.as_tensor(np.asarray(init_positions), dtype=dtype,
                                  device=dev)
        logl, models = self.loglike_fn(pos)
        zinit = lo + (hi - lo) * torch.rand(
            (self.nz, self.nfree), generator=generator, dtype=dtype,
            device=dev)
        ncopy = min(self.nchains, self.nz)
        zinit[:ncopy] = pos[:ncopy]
        ibest = torch.argmax(logl)
        i64 = dict(dtype=torch.int64, device=dev)
        return SamplerState(
            positions=pos,
            loglike=logl,
            models=models,
            z_archive=zinit,
            z_count=torch.tensor(max(ncopy, 2), **i64),
            best_pos=pos[ibest],
            best_loglike=logl[ibest],
            naccept=torch.zeros(self.nchains, **i64),
            niter=torch.tensor(0, **i64),
        )

    # ------------------------------------------------------------------
    def _draw_shapes(self) -> list[tuple[int, ...]]:
        """Per field of the walk's Variates, one step's shape."""
        n, d = self.nchains, self.nfree
        shape = {"noise": (n, d), "u": (n, d), "u_gs": (n, 1),
                 "u_jump": (n, 1)}
        return [shape.get(f, (n,)) for f in _VARIATES[self.walk]._fields]

    def empty_variates(self, nsteps: int, dtype: torch.dtype,
                       device: torch.device):
        """The walk's Variates for ``nsteps`` steps, [nsteps, ...] per
        field, uninitialised."""
        return _VARIATES[self.walk](*(
            torch.empty((nsteps, *s), dtype=dtype, device=device)
            for s in self._draw_shapes()))

    def draw_block(self, generator: torch.Generator, nsteps: int,
                   dtype: torch.dtype = torch.float64, out=None):
        """A block's variates, [nsteps, ...] per field, drawn on the
        generator's device step by step and field by field: the numbers
        a loop that drew each step's variates just before the step would
        read.  Written into ``out`` (a StepGraph's buffers) when given."""
        if out is None:
            out = self.empty_variates(nsteps, dtype, generator.device)
        names = out._fields
        for k in range(nsteps):
            for name, buf in zip(names, out):
                draw = torch.randn if name == "noise" else torch.rand
                draw(buf.shape[1:], generator=generator, out=buf[k])
        return out

    # ------------------------------------------------------------------
    def _propose(self, state: SamplerState, v, gamma_scale):
        """One synchronous ensemble proposal -> (xnew, log_mh_corr)."""
        n, d = self.nchains, self.nfree
        pos = state.positions
        lo, hi, step = self._bounds(pos.device, pos.dtype)
        zero = torch.zeros_like(state.loglike)

        if self.walk == "mrw":
            return _reflect(pos + v.noise * step, lo, hi), zero

        if self.walk == "unif":
            return lo + (hi - lo) * v.u, zero

        gamma = gamma_scale * 2.38 / np.sqrt(2.0 * d)
        noise = self.eps * v.noise
        if self.walk == "demc":
            ar = torch.arange(n, device=pos.device)
            r1 = _index(v.u_r1, n - 1)
            r1 = torch.where(r1 >= ar, r1 + 1, r1)             # r1 != i
            # r2 != i and r2 != r1 (order-stable double skip)
            r2 = _index(v.u_r2, n - 2)
            r2 = torch.where(r2 >= torch.minimum(ar, r1), r2 + 1, r2)
            r2 = torch.where(r2 >= torch.maximum(ar, r1), r2 + 1, r2)
            one = torch.ones_like(v.u_jump)
            g = torch.where(v.u_jump < self.gamma_jump_frac, one,
                            gamma * one)
            return _reflect(pos + g * (pos[r1] - pos[r2]) + noise, lo,
                            hi), zero

        # snooker: archive indices from the device-side fill count
        Z = state.z_archive
        nz_eff = torch.clamp(state.z_count, min=3)
        z1, z2, z3 = (_index(u, nz_eff) for u in (v.u_z1, v.u_z2, v.u_z3))
        # parallel-direction move: symmetric kernel, folded at the bounds
        x_par = _reflect(pos + gamma * (Z[z1] - Z[z2]) + noise, lo, hi)

        # snooker move along (x - z3), left unfolded (its Metropolis
        # correction assumes the raw move)
        gs = 1.2 + v.u_gs
        dz = pos - Z[z3]
        dz_norm2 = torch.clamp(torch.sum(dz * dz, dim=1, keepdim=True),
                               min=1e-300)

        def proj(u):
            return (torch.sum(u * dz, dim=1, keepdim=True) / dz_norm2) * dz

        x_sn = pos + gs * (proj(Z[z1]) - proj(Z[z2]))
        num = torch.sum((x_sn - Z[z3]) ** 2, dim=1)
        den = torch.sum(dz * dz, dim=1)
        log_corr_sn = 0.5 * (d - 1) * (
            torch.log(torch.clamp(num, min=1e-300))
            - torch.log(torch.clamp(den, min=1e-300)))

        use_sn = v.u_sn < self.snooker_frac
        xnew = torch.where(use_sn[:, None], x_sn, x_par)
        return xnew, torch.where(use_sn, log_corr_sn, zero)

    def _step(self, state: SamplerState, v,
              gamma_scale=None) -> SamplerState:
        """Propose, evaluate, accept and append to the archive.  Reads
        nothing from the host: a CUDA graph can capture it."""
        if gamma_scale is None:
            gamma_scale = self.fgamma
        xnew, log_corr = self._propose(state, v, gamma_scale)
        logl_new, models_new = self.loglike_fn(xnew)

        if self.walk == "unif":           # sweep: record valid draws
            accept = torch.isfinite(logl_new)
        else:
            accept = torch.log(v.u_acc) < logl_new - state.loglike + log_corr
        pos = torch.where(accept[:, None], xnew, state.positions)
        logl = torch.where(accept, logl_new, state.loglike)
        models = torch.where(accept[:, None], models_new.to(state.models),
                             state.models)

        # archive append every z_thin iterations (ring buffer)
        do_append = (state.niter % self.z_thin) == 0
        idx = (state.z_count + torch.arange(self.nchains,
                                            device=pos.device)) % self.nz
        z_new = state.z_archive.index_copy(0, idx, pos)
        z_archive = torch.where(do_append, z_new, state.z_archive)
        z_count = torch.where(
            do_append, torch.clamp(state.z_count + self.nchains, max=self.nz),
            state.z_count)

        # the best chain, by index_select: indexing by a device scalar
        # would read it on the host
        ibest = torch.argmax(logl, dim=0, keepdim=True)
        best_l = logl.index_select(0, ibest)[0]
        better = best_l > state.best_loglike
        return SamplerState(
            positions=pos,
            loglike=logl,
            models=models,
            z_archive=z_archive,
            z_count=z_count,
            best_pos=torch.where(better, pos.index_select(0, ibest)[0],
                                 state.best_pos),
            best_loglike=torch.where(better, best_l, state.best_loglike),
            naccept=state.naccept + accept.to(torch.int64),
            niter=state.niter + 1,
        )

    # ------------------------------------------------------------------
    def step_graph(self, state: SamplerState, nsteps: int) -> "StepGraph":
        """This sampler's StepGraph for blocks of ``nsteps`` on the
        state's device and dtype and the current archive size, captured
        at the first call and kept."""
        pos = state.positions
        key = (pos.device, pos.dtype, nsteps, self.nz)
        if key not in self._graphs:
            self._graphs[key] = StepGraph(self, state, nsteps)
        return self._graphs[key]

    def run_block(self, state: SamplerState, generator: torch.Generator,
                  nsteps: int, fgamma: float | None = None,
                  graphed: bool | None = None):
        """Advance ``nsteps`` iterations; the block's variates are drawn
        first (``draw_block``).  ``graphed`` (by default: whether the
        state is on a CUDA device) replays the captured step
        (``step_graph``) instead of the eager loop; it raises rather than
        run eagerly.  Returns (state, positions [nsteps, nchain, nfree],
        loglike [nsteps, nchain], models [nsteps, nchain, nmodel]) on the
        state's device."""
        fg = self.fgamma if fgamma is None else fgamma
        pos = state.positions
        if graphed is None:
            graphed = pos.device.type == "cuda"
        if graphed:
            graph = self.step_graph(state, nsteps)
            self.draw_block(generator, nsteps, out=graph.variates)
            return graph.run(state, fg)
        vb = self.draw_block(generator, nsteps, pos.dtype)
        # the gamma scale as the graph reads it: a device scalar
        gscale = torch.full((), fg, dtype=pos.dtype, device=pos.device)
        pb, lb, mb = [], [], []
        for k in range(nsteps):
            state = self._step(state, type(vb)(*(x[k] for x in vb)), gscale)
            pb.append(state.positions)
            lb.append(state.loglike)
            mb.append(state.models)
        return state, torch.stack(pb), torch.stack(lb), torch.stack(mb)


class StepBuffers:
    """One sampler step over static buffers: the state, a block's
    variates [nsteps, ...], the block's outputs [nsteps, ...], the gamma
    scale and the step counter ``i`` [1], all on the state's device.  A
    step reads variates[i], writes the new state back into the state
    buffers and outputs[i], and increments ``i``; so one step, once
    captured, replays as the next.  ``run`` drives the steps eagerly:
    ``StepGraph`` replays them."""

    def __init__(self, sampler: EnsembleSampler, state: SamplerState,
                 nsteps: int):
        pos = state.positions
        dev, dtype = pos.device, pos.dtype
        self.sampler, self.nsteps = sampler, nsteps
        self.state = SamplerState(*(x.clone() for x in state))
        self.variates = sampler.empty_variates(nsteps, dtype, dev)
        self.i = torch.zeros(1, dtype=torch.int64, device=dev)
        self.gscale = torch.ones((), dtype=dtype, device=dev)
        self.positions = pos.new_empty((nsteps, *pos.shape))
        self.loglike = state.loglike.new_empty((nsteps,
                                                *state.loglike.shape))
        self.models = state.models.new_empty((nsteps, *state.models.shape))

    def _body(self) -> None:
        """One step on the buffers."""
        v = type(self.variates)(*(x.index_select(0, self.i)[0]
                                  for x in self.variates))
        new = self.sampler._step(self.state, v, self.gscale)
        for dst, src in zip(self.state, new):
            dst.copy_(src)
        self.positions.index_copy_(0, self.i, new.positions[None])
        self.loglike.index_copy_(0, self.i, new.loglike[None])
        self.models.index_copy_(0, self.i, new.models[None])
        self.i.add_(1)

    def _steps(self) -> None:
        for _ in range(self.nsteps):
            self._body()

    def run(self, state: SamplerState, fgamma: float):
        """The block from ``state`` on the variates in the buffers ->
        (state, positions, loglike, models), as EnsembleSampler.run_block
        returns them (copies: the next block reuses the buffers)."""
        for dst, src in zip(self.state, state):
            dst.copy_(src)
        self.i.zero_()
        self.gscale.fill_(fgamma)
        self._steps()
        return (SamplerState(*(x.clone() for x in self.state)),
                self.positions.clone(), self.loglike.clone(),
                self.models.clone())


#: eager steps run on a side stream before the capture (PyTorch's rule
#: for graphs: they load every kernel and settle the allocator)
_WARMUP = 2


class StepGraph(StepBuffers):
    """StepBuffers whose step is captured once as a CUDA graph and
    replayed ``nsteps`` times a block.  The kernel wrappers' Python
    launch counts see the warm-up and the capture, never a replay.  Only
    on a CUDA device; a failed capture or replay raises."""

    def __init__(self, sampler: EnsembleSampler, state: SamplerState,
                 nsteps: int):
        dev = state.positions.device
        if dev.type != "cuda":
            raise RuntimeError(f"StepGraph: a CUDA graph needs a CUDA "
                               f"state, got one on {dev}")
        super().__init__(sampler, state, nsteps)
        for x in self.variates:       # valid draws for the warm-up steps
            x.fill_(0.5)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(_WARMUP):
                self.i.zero_()
                self._body()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._body()

    def _steps(self) -> None:
        for _ in range(self.nsteps):
            self.graph.replay()
