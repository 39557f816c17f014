"""Ensemble MCMC on the device: the DE-MC(Z) snooker walker (port of
bart_tpu/inference/samplers.py).

ter Braak & Vrugt (2008): proposals from a thinned past archive Z; 90%
parallel-direction moves x + gamma (z1 - z2) + e, 10% snooker moves
along (x - z3) with the |x' - z3|^{d-1} / |x - z3|^{d-1} Metropolis
correction.  The whole ensemble advances in one step of batched ops.

JAX keys cannot be reproduced in torch, so the random numbers of a step
are drawn apart from the step (``draw_variates``, on the device, from an
explicit ``torch.Generator``) and ``_propose``/``_step`` take them as
input.  The variates are those of bart_tpu's snooker step in its draw
order (samplers.py:218-246, then the accept uniform at :264), so one
step can be replayed against bart_tpu fed the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

__all__ = ["SamplerState", "Variates", "EnsembleSampler"]


def _reflect(x: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """Fold proposals into [lo, hi] by reflection at the boundaries
    (keeps a symmetric step kernel symmetric)."""
    span = hi - lo
    y = torch.remainder(x - lo, 2.0 * span)
    y = torch.where(y > span, 2.0 * span - y, y)
    return torch.where(span > 0, lo + y, x)


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


class Variates(NamedTuple):
    """The random numbers of one snooker step, in bart_tpu's order."""

    z1: torch.Tensor      # [n] int64 archive index, parallel move
    z2: torch.Tensor      # [n] int64 archive index, parallel move
    z3: torch.Tensor      # [n] int64 archive index, snooker anchor
    noise: torch.Tensor   # [n, d] standard normal (scaled by eps)
    gs: torch.Tensor      # [n, 1] snooker gamma, uniform in [1.2, 2.2)
    u_sn: torch.Tensor    # [n] uniform: snooker move where < snooker_frac
    u_acc: torch.Tensor   # [n] uniform: Metropolis accept draw


@dataclasses.dataclass
class EnsembleSampler:
    """Batched multi-chain snooker sampler.

    ``loglike_fn(free [nchain, nfree]) -> (logl [nchain], model
    [nchain, nmodel])``.
    """

    loglike_fn: Any
    nfree: int
    nmodel: int
    nchains: int
    walk: str = "snooker"
    pmin: np.ndarray | None = None
    pmax: np.ndarray | None = None
    nz: int = 0                        # archive size (0 -> the nz rule)
    z_thin: int = 30                   # archive append period
    snooker_frac: float = 0.1
    eps: float = 1e-6                  # parallel-move jitter scale
    fgamma: float = 1.0                # scale on the DE gamma (MC3 fgamma)

    def __post_init__(self):
        if self.walk != "snooker":
            raise NotImplementedError(
                f"walk {self.walk!r} is not ported yet (ROADMAP queue 1, "
                "item 8: mrw, demc, unif); only 'snooker' is")
        if self.nz == 0:
            # the archive holds >= 10 append epochs of the ensemble
            self.nz = max(10 * self.nfree, 10 * self.nchains, 100)

    # ------------------------------------------------------------------
    def init_state(self, generator: torch.Generator,
                   init_positions: np.ndarray | None = None,
                   dtype: torch.dtype = torch.float64) -> SamplerState:
        """Initial ensemble: given positions, or uniform in [pmin, pmax];
        the archive starts as that population plus uniform draws."""
        dev = generator.device
        lo = torch.as_tensor(self.pmin, dtype=dtype, device=dev)
        hi = torch.as_tensor(self.pmax, dtype=dtype, device=dev)
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
    def draw_variates(self, generator: torch.Generator,
                      state: SamplerState) -> Variates:
        """One step's random numbers, drawn on the generator's device
        without a host round trip (archive indices from uniforms scaled
        by the device-side fill count)."""
        n, d = self.nchains, self.nfree
        dev = generator.device
        dtype = state.positions.dtype
        nz_eff = torch.clamp(state.z_count, min=3).to(dtype)

        def uniform(shape):
            return torch.rand(shape, generator=generator, dtype=dtype,
                              device=dev)

        def index():
            return torch.minimum((uniform((n,)) * nz_eff).to(torch.int64),
                                 nz_eff.to(torch.int64) - 1)

        z1, z2, z3 = index(), index(), index()
        noise = torch.randn((n, d), generator=generator, dtype=dtype,
                            device=dev)
        gs = 1.2 + uniform((n, 1))
        return Variates(z1, z2, z3, noise, gs, uniform((n,)), uniform((n,)))

    def _propose(self, state: SamplerState, v: Variates, gamma_scale):
        """One synchronous snooker proposal -> (xnew, log_mh_corr)."""
        d = self.nfree
        pos = state.positions
        dtype = pos.dtype
        Z = state.z_archive
        lo = torch.as_tensor(self.pmin, dtype=dtype, device=pos.device)
        hi = torch.as_tensor(self.pmax, dtype=dtype, device=pos.device)
        gamma = gamma_scale * 2.38 / np.sqrt(2.0 * d)
        noise = self.eps * v.noise
        # parallel-direction move: symmetric kernel, folded at the bounds
        x_par = _reflect(pos + gamma * (Z[v.z1] - Z[v.z2]) + noise, lo, hi)

        # snooker move along (x - z3), left unfolded (its Metropolis
        # correction assumes the raw move)
        dz = pos - Z[v.z3]
        dz_norm2 = torch.clamp(torch.sum(dz * dz, dim=1, keepdim=True),
                               min=1e-300)

        def proj(u):
            return (torch.sum(u * dz, dim=1, keepdim=True) / dz_norm2) * dz

        x_sn = pos + v.gs * (proj(Z[v.z1]) - proj(Z[v.z2]))
        num = torch.sum((x_sn - Z[v.z3]) ** 2, dim=1)
        den = torch.sum(dz * dz, dim=1)
        log_corr_sn = 0.5 * (d - 1) * (
            torch.log(torch.clamp(num, min=1e-300))
            - torch.log(torch.clamp(den, min=1e-300)))

        use_sn = v.u_sn < self.snooker_frac
        xnew = torch.where(use_sn[:, None], x_sn, x_par)
        log_corr = torch.where(use_sn, log_corr_sn,
                               torch.zeros_like(log_corr_sn))
        return xnew, log_corr

    def _step(self, state: SamplerState, v: Variates,
              gamma_scale=None) -> SamplerState:
        """Propose, evaluate, accept and append to the archive."""
        if gamma_scale is None:
            gamma_scale = self.fgamma
        xnew, log_corr = self._propose(state, v, gamma_scale)
        logl_new, models_new = self.loglike_fn(xnew)

        log_ratio = logl_new - state.loglike + log_corr
        accept = torch.log(v.u_acc) < log_ratio
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

        ibest = torch.argmax(logl)
        better = logl[ibest] > state.best_loglike
        return SamplerState(
            positions=pos,
            loglike=logl,
            models=models,
            z_archive=z_archive,
            z_count=z_count,
            best_pos=torch.where(better, pos[ibest], state.best_pos),
            best_loglike=torch.where(better, logl[ibest],
                                     state.best_loglike),
            naccept=state.naccept + accept.to(torch.int64),
            niter=state.niter + 1,
        )

    # ------------------------------------------------------------------
    def run_block(self, state: SamplerState, generator: torch.Generator,
                  nsteps: int, fgamma: float | None = None):
        """Advance ``nsteps`` iterations (a Python loop of steps).
        Returns (state, positions [nsteps, nchain, nfree], loglike
        [nsteps, nchain], models [nsteps, nchain, nmodel]) on the
        device."""
        gscale = self.fgamma if fgamma is None else fgamma
        pb, lb, mb = [], [], []
        for _ in range(nsteps):
            state = self._step(state, self.draw_variates(generator, state),
                               gscale)
            pb.append(state.positions)
            lb.append(state.loglike)
            mb.append(state.models)
        return state, torch.stack(pb), torch.stack(lb), torch.stack(mb)
