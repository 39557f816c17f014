"""Likelihood, parameter freezing/sharing and Gaussian priors, batched
over chains (port of bart_tpu/inference/likelihood.py).

Stepsize semantics (MC3): > 0 free; == 0 fixed at its initial value;
< 0 shared, copying free parameter (-stepsize - 1).  Rejected samples
(invalid forward model or out of bounds) get loglike = -inf.  With
``wlike`` (MC3's wavelet likelihood) the last three entries of the full
parameter vector are the noise parameters (gamma, sigma_r, sigma_w), the
forward model gets the rest, and chi^2 is -2 times the Carter & Winn
log-likelihood of the residuals.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bart_tpu_torch.device import resolve_device
from bart_tpu_torch.inference.wavelet import wavelet_loglike

__all__ = ["ParamSpace", "Likelihood"]


@dataclasses.dataclass
class ParamSpace:
    """Maps the free-parameter subspace to the full model vector."""

    pinit: np.ndarray     # [npars] initial values
    pmin: np.ndarray      # [npars]
    pmax: np.ndarray      # [npars]
    stepsize: np.ndarray  # [npars]
    pnames: list[str] | None = None

    def __post_init__(self):
        self.pinit = np.asarray(self.pinit, np.float64)
        self.pmin = np.asarray(self.pmin, np.float64)
        self.pmax = np.asarray(self.pmax, np.float64)
        self.stepsize = np.asarray(self.stepsize, np.float64)
        self.ifree = np.where(self.stepsize > 0)[0]
        self.ishare = np.where(self.stepsize < 0)[0]
        self.nfree = len(self.ifree)
        self.npars = len(self.pinit)
        self._consts = {}    # (device, dtype) -> (pinit, ifree)

    def expand(self, free: torch.Tensor) -> torch.Tensor:
        """free[..., nfree] -> full[..., npars] (fixed and shared
        entries filled).  ``pinit`` and the free indices are put on the
        device once per (device, dtype): a capture may not copy them from
        the host."""
        key = (free.device, free.dtype)
        if key not in self._consts:
            self._consts[key] = (
                torch.as_tensor(self.pinit, dtype=free.dtype,
                                device=free.device),
                torch.as_tensor(self.ifree, device=free.device))
        pinit, ifree = self._consts[key]
        full = pinit.expand(*free.shape[:-1], self.npars).clone()
        full.index_copy_(full.dim() - 1, ifree, free)
        for j in self.ishare:
            full[..., j] = full[..., int(-self.stepsize[j]) - 1]
        return full

    @property
    def free_min(self) -> np.ndarray:
        return self.pmin[self.ifree]

    @property
    def free_max(self) -> np.ndarray:
        return self.pmax[self.ifree]

    @property
    def free_init(self) -> np.ndarray:
        return self.pinit[self.ifree]


class Likelihood:
    """log L(free) = -chi2/2 with bounds, validity and optional Gaussian
    priors (MC3 prior/priorlow/priorup).

    The likelihood lives on the forward model's ``device``; a forward
    without one (a plain callable) runs on ``device``, the card unless
    the caller asks for the CPU."""

    def __init__(self, forward, space: ParamSpace, data: np.ndarray,
                 uncert: np.ndarray, prior: np.ndarray | None = None,
                 priorlow: np.ndarray | None = None,
                 priorup: np.ndarray | None = None, wlike: bool = False,
                 device: str | torch.device = "cuda"):
        self.forward = forward
        self.space = space
        self.wlike = wlike
        fwd_device = getattr(forward, "device", None)
        self.device = (fwd_device if fwd_device is not None
                       else resolve_device(device))
        f64 = torch.float64
        self.data = torch.tensor(np.asarray(data), dtype=f64,
                                 device=self.device)
        self.uncert = torch.tensor(np.asarray(uncert), dtype=f64,
                                   device=self.device)
        self.prior = prior
        self.priorlow = priorlow
        self.priorup = priorup

        def free_part(a):
            return torch.tensor(np.asarray(a, np.float64)[space.ifree],
                                dtype=f64, device=self.device)

        self._lo = free_part(space.pmin)
        self._hi = free_part(space.pmax)
        self._prior = (None if prior is None else
                       tuple(free_part(a) for a in (prior, priorlow, priorup)))

    @property
    def mesh(self):
        """The (chain, wn) mesh the forward model is split over
        (parallel.mesh.shard_model), or None."""
        return getattr(self.forward, "mesh", None)

    def __call__(self, free: torch.Tensor):
        """free [C, nfree] -> (loglike [C], model [C, nfilt])."""
        full = self.space.expand(free)
        if self.wlike:
            model, _, valid = self.forward(full[..., :-3])
            chi2 = -2.0 * wavelet_loglike(model - self.data, full[..., -3],
                                          full[..., -2], full[..., -1])
        else:
            model, _, valid = self.forward(full)
            resid = (model - self.data) / self.uncert
            chi2 = torch.sum(resid * resid, dim=-1)

        inb = torch.all((free >= self._lo.to(free.dtype))
                        & (free <= self._hi.to(free.dtype)), dim=-1)
        logl = -0.5 * chi2
        if self._prior is not None:
            pr, plo, pup = (a.to(free.dtype) for a in self._prior)
            d = free - pr
            sig = torch.where(d < 0, plo, pup)
            has = (plo > 0) | (pup > 0)
            logl = logl - 0.5 * torch.sum(
                torch.where(has, (d / sig) ** 2, torch.zeros_like(d)),
                dim=-1)
        logl = torch.where(valid.to(logl.device) & inb, logl,
                           torch.full_like(logl, -torch.inf))
        return logl, model

    def chisq(self, free: torch.Tensor) -> torch.Tensor:
        """chi^2 [C] = -2 log L (priors included; inf where rejected)."""
        return -2.0 * self(free)[0]
