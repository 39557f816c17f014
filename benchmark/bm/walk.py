"""The reference snooker walk (ter Braak & Vrugt 2008, DE-MC(Z)) in numpy
float64: the proposal of one synchronous ensemble step from the previous
positions, the past archive and the step's variates, and the archive's
appends.  The index rules (a uniform u picks floor(u m), the archive's
fill count at least 3), the reflection at the bounds of the parallel move,
the ring of archive slots and the draw order of the variates are the
program's conventions, restated here."""

from __future__ import annotations

import numpy as np
import torch

#: the snooker step's draws in the order the sampler reads them, with
#: their shapes for n chains of d parameters; ``noise`` is a standard
#: normal, the rest uniforms in [0, 1)
FIELDS = ("u_z1", "u_z2", "u_z3", "noise", "u_gs", "u_sn", "u_acc")


def field_shape(name: str, n: int, d: int) -> tuple:
    return {"noise": (n, d), "u_gs": (n, 1)}.get(name, (n,))


def draw_block(gen_state: torch.Tensor, nsteps: int, n: int, d: int,
               device: torch.device, upto: int | None = None) -> list:
    """The variates of a block drawn from a generator in ``gen_state``,
    step by step and field by field: [{field: array}] for steps
    0 .. ``upto`` (all when None), float64."""
    g = torch.Generator(device=device)
    g.set_state(gen_state)
    out = []
    for _ in range(nsteps if upto is None else upto + 1):
        step = {}
        for f in FIELDS:
            draw = torch.randn if f == "noise" else torch.rand
            step[f] = draw(field_shape(f, n, d), generator=g,
                           dtype=torch.float64, device=device)
        out.append({k: v.cpu().numpy() for k, v in step.items()})
    return out


def initial_archive(gen_state: torch.Tensor, nz: int, lo: np.ndarray,
                    hi: np.ndarray, pos0: np.ndarray,
                    device: torch.device):
    """(Z [nz, d], fill count): uniform draws over the bounds from a
    generator in ``gen_state``, the starting positions in the first
    slots."""
    g = torch.Generator(device=device)
    g.set_state(gen_state)
    lo_t = torch.as_tensor(lo, dtype=torch.float64, device=device)
    hi_t = torch.as_tensor(hi, dtype=torch.float64, device=device)
    z = lo_t + (hi_t - lo_t) * torch.rand((nz, len(lo)), generator=g,
                                          dtype=torch.float64, device=device)
    z = z.cpu().numpy()
    n = min(len(pos0), nz)
    z[:n] = pos0[:n]
    return z, max(n, 2)


def append(Z: np.ndarray, count: int, pos: np.ndarray, niter: int,
           z_thin: int) -> int:
    """The archive after step ``niter`` (counted from 0) accepted
    ``pos``: every z_thin-th step writes the positions at slots
    (count + i) mod nz.  Returns the new fill count."""
    nz, n = len(Z), len(pos)
    if niter % z_thin:
        return count
    Z[(count + np.arange(n)) % nz] = pos
    return min(count + n, nz)


def _index(u: np.ndarray, m: int) -> np.ndarray:
    return np.minimum((u * m).astype(np.int64), m - 1)


def reflect(x, lo, hi):
    span = hi - lo
    y = np.remainder(x - lo, 2.0 * span)
    y = np.where(y > span, 2.0 * span - y, y)
    return np.where(span > 0, lo + y, x)


def propose(pos: np.ndarray, Z: np.ndarray, count: int, v: dict,
            lo: np.ndarray, hi: np.ndarray, fgamma: float = 1.0,
            eps: float = 1e-6, snooker_frac: float = 0.1):
    """(proposals [n, d], log Metropolis corrections [n]): the parallel
    move x + gamma (z1 - z2) + eps e folded at the bounds, or with
    probability ``snooker_frac`` the snooker move along x - z3 with the
    |x' - z3|^(d-1) / |x - z3|^(d-1) correction."""
    n, d = pos.shape
    gamma = fgamma * 2.38 / np.sqrt(2.0 * d)
    m = max(count, 3)
    z1, z2, z3 = (_index(v[f], m) for f in ("u_z1", "u_z2", "u_z3"))
    x_par = reflect(pos + gamma * (Z[z1] - Z[z2]) + eps * v["noise"], lo, hi)
    dz = pos - Z[z3]
    dz2 = np.maximum(np.sum(dz * dz, axis=1, keepdims=True), 1e-300)

    def proj(u):
        return (np.sum(u * dz, axis=1, keepdims=True) / dz2) * dz

    x_sn = pos + (1.2 + v["u_gs"]) * (proj(Z[z1]) - proj(Z[z2]))
    num = np.sum((x_sn - Z[z3]) ** 2, axis=1)
    den = np.sum(dz * dz, axis=1)
    corr = 0.5 * (d - 1) * (np.log(np.maximum(num, 1e-300))
                            - np.log(np.maximum(den, 1e-300)))
    sn = v["u_sn"] < snooker_frac
    return np.where(sn[:, None], x_sn, x_par), np.where(sn, corr, 0.0)
