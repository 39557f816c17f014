"""The (chain, wn) mesh of ranks and the wn split of the forward model's
tables (port of bart_tpu/parallel/mesh.py on torch.distributed).

A mesh lays the ranks of a process group out in a 2-D grid, rank =
chain * n_wn + wn:

* the **chain axis** splits a batch of chains into contiguous blocks,
  one per chain coordinate;
* the **wn axis** splits every wavenumber-indexed table (the opacity
  table, the wn grid, the band matrix, the line tiles of the on-the-fly
  mode) into contiguous shards, so that each rank holds 1 / n_wn of it.

Each output wavenumber is independent in the forward model (lines were
bucketed at table-build time), so a meshed forward needs exactly ONE
collective: an all-reduce over the world of a zeroed [C, nfilt + ...]
buffer into which each rank has written the partial band fluxes of its
chain block and wn shard (rt.forward.ForwardModel).  XLA inserts that
psum for the JAX package; here it is written out, and the mesh counts it
(``Mesh.collectives``).  Only ``all_reduce`` is used, so one code path
serves NCCL and gloo (whose CUDA tensors support all_reduce and
broadcast only).  NCCL collectives can be captured in a CUDA graph,
gloo's cannot (``Mesh.capturable``).

The ensemble state is replicated, so every rank must hold the same state
after every block, bit for bit: ``Mesh.agree`` checks it with one
all-reduce of a fingerprint of the state's bits and raises on every rank
when any rank differs (inference.retrieval.run_mcmc calls it after each
block).  Ranks that drifted apart would otherwise take different host
decisions between blocks, and a collective one of them skips waits
forever.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bart_tpu_torch.parallel.distributed import local_device

__all__ = ["Mesh", "make_mesh", "fingerprint", "table_shardings",
           "pad_tables_for_mesh", "shard_tables", "shard_model"]

#: int dtype of each element size, to read a tensor's bits
_BITS = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}


def fingerprint(*tensors: torch.Tensor) -> torch.Tensor:
    """int64 [2 len(tensors)] on the tensors' device: per tensor, the sums
    of the low and of the high 32 bits of its elements' bit patterns,
    each element weighted by its position (mod 65521, plus 1).  Equal
    tensors give equal fingerprints; a change of one ulp in one element
    changes the low sum, and a swap of two elements the weights.  The
    sums wrap modulo 2^64, which keeps them independent of the order of
    summation."""
    out = []
    for x in tensors:
        x = x.detach().contiguous().reshape(-1)
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        bits = x.view(_BITS[x.element_size()]).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out += [((bits & 0xFFFFFFFF) * w).sum(),
                (((bits >> 32) & 0xFFFFFFFF) * w).sum()]
    return torch.stack(out)


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of the (chain, wn) mesh: its coordinates, its
    device, the group of the ranks that share its chain coordinate
    (``wn_group``) and the count of collectives it has issued."""

    n_chain: int
    n_wn: int
    rank: int
    device: torch.device
    backend: str
    wn_group: object
    collectives: int = 0

    @property
    def shape(self) -> dict:
        return {"chain": self.n_chain, "wn": self.n_wn}

    @property
    def chain(self) -> int:
        return self.rank // self.n_wn

    @property
    def wn(self) -> int:
        return self.rank % self.n_wn

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this mesh's collectives
        (NCCL: yes; gloo: no)."""
        return self.backend == "nccl"

    def chain_block(self, nchains: int) -> tuple[int, int]:
        """The rows [lo, hi) of a batch of ``nchains`` chains that this
        rank's chain coordinate computes (possibly empty)."""
        return (nchains * self.chain // self.n_chain,
                nchains * (self.chain + 1) // self.n_chain)

    def wn_block(self, n: int) -> tuple[int, int]:
        """The columns [lo, hi) of a wn axis of length ``n`` (a multiple
        of n_wn) that this rank holds."""
        if n % self.n_wn:
            raise ValueError(f"wn axis of {n} does not divide into "
                             f"{self.n_wn} shards: pad_tables_for_mesh first")
        w = n // self.n_wn
        return self.wn * w, (self.wn + 1) * w

    def all_reduce(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """Sum ``x`` in place over the world (or ``group``) and count the
        collective; returns ``x``.  The count is Python's: a CUDA graph
        that captured the call replays it uncounted."""
        import torch.distributed as dist

        self.collectives += 1
        dist.all_reduce(x, group=group)
        return x

    def agree(self, *tensors: torch.Tensor, what: str = "state") -> None:
        """Raise on every rank unless every rank holds the same
        ``tensors``, bit for bit: one all-reduce (MAX) of each rank's
        ``fingerprint`` and its bitwise complement gives the largest and
        the smallest fingerprint over the world, which must be equal.
        Reads the result on the host.  Counted as a collective."""
        import torch.distributed as dist

        fp = fingerprint(*tensors)
        both = torch.cat([fp, ~fp])
        self.collectives += 1
        dist.all_reduce(both, op=dist.ReduceOp.MAX)
        n = fp.numel()
        hi, lo = both[:n], ~both[n:]
        if not torch.equal(hi, lo):
            raise RuntimeError(
                f"the ranks' {what} differ (rank {self.rank} of a "
                f"{self.n_chain} x {self.n_wn} mesh: fingerprint "
                f"{fp.tolist()}, the world's smallest {lo.tolist()} and "
                f"largest {hi.tolist()}): a replicated state has drifted "
                "apart")

    def gather(self, x: torch.Tensor, nchains: int | None = None
               ) -> torch.Tensor:
        """[..., W_local] -> [..., W_local n_wn]: this rank's wn shard put
        together with the other ranks' shards, on every rank (one
        all-reduce of a zeroed buffer).  With ``nchains`` ``x`` is this
        rank's block of chains [hi - lo, W_local] of a batch of
        ``nchains`` (``chain_block``; what a meshed forward returns as
        its spectrum) and the result the whole [nchains, W], reduced over
        the world; without, every chain coordinate holds ``x`` alike and
        it is reduced over ``wn_group``.  W carries the mesh's trailing
        padding: the first ``n_wn_orig`` points are the unsharded
        model's."""
        w = x.shape[-1]
        cols = slice(self.wn * w, (self.wn + 1) * w)
        if nchains is None:
            out = x.new_zeros(*x.shape[:-1], w * self.n_wn)
            out[..., cols] = x
            return self.all_reduce(out, self.wn_group)
        out = x.new_zeros(nchains, w * self.n_wn)
        lo, hi = self.chain_block(nchains)
        out[lo:hi, cols] = x
        return self.all_reduce(out)


def make_mesh(n_chain: int = 1, n_wn: int | None = None,
              device: str | torch.device | None = None) -> Mesh:
    """This rank's (chain, wn) mesh over the initialised process group
    (parallel.distributed.init_distributed).  With ``n_wn=None`` all
    ranks left go to the wn axis; n_chain x n_wn must be the world size.
    ``device`` is the rank's device, ``local_device(device)``.  Every rank
    must call it alike: it creates one group per chain coordinate (on
    an NCCL group bound to the rank's card, ``init_distributed``, each
    with its communicator made at once)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.distributed.init_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_wn is None:
        n_wn = world // n_chain
    if n_chain < 1 or n_wn < 1 or n_chain * n_wn != world:
        raise ValueError(f"a {n_chain} x {n_wn} mesh needs {n_chain * n_wn} "
                         f"ranks, the group has {world}")
    groups = [dist.new_group(list(range(c * n_wn, (c + 1) * n_wn)))
              for c in range(n_chain)]
    return Mesh(n_chain=n_chain, n_wn=n_wn, rank=rank,
                device=local_device(device), backend=dist.get_backend(),
                wn_group=groups[rank // n_wn])


def table_shardings() -> dict:
    """The wn axis of each forward-model table key, or None where the
    table is replicated (bart_tpu.parallel.mesh.table_shardings).  Keys
    not listed replicate (the CIA source tables are interpolated onto the
    sharded wn grid locally); the on-the-fly line tiles ``lt{k}_*`` shard
    their tile axis 0, which IS the wn axis (tile t covers grid slice
    [t W, (t + 1) W)).  ``wn_trapz`` is the meshed energy balance's
    trapezoid weights (shard_model)."""
    return {
        "wn": 0,
        "wn_trapz": 0,
        "sigma": 3,       # [mol, nT, layer, wn]
        "frows": 2,       # [rows, layer, wn]
        # folded layouts: the trailing axis is the OUTPUT wn bin
        "sigmak": 3,      # [K, rows, layer, wn]
        "frowsk": 3,
        "band_w": 1,      # [nfilt, wn]
        "pressure": None,
        "p_barye": None,
        "base_q": None,
        "h2he_ratio": None,
        "masses": None,
        "mu": None,
        "mu_w": None,
    }


def _wn_axis(key: str):
    return 0 if key.startswith("lt") else table_shardings().get(key)


def _pad(a, axis: int, n: int):
    """``a`` (numpy or torch) with ``n`` zeros (False for bool) appended
    along ``axis``."""
    shape = list(a.shape)
    shape[axis] = n
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a.new_zeros(shape)], dim=axis)
    return np.concatenate([a, np.zeros(shape, a.dtype)], axis=axis)


def _repeat_last(a, n: int):
    """``a`` [N] (numpy or torch) with its last value appended n times."""
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[-1:].expand(n)])
    return np.concatenate([a, np.repeat(a[-1:], n)])


def pad_tables_for_mesh(tables: dict, mesh) -> dict:
    """Pad every wn-indexed table so that the wn axis divides the mesh's
    wn axis (``mesh`` a Mesh or the number of wn shards), exactly as
    bart_tpu.parallel.mesh.pad_tables_for_mesh, on numpy arrays or torch
    tensors.

    The wn grid pads by repeating its end point (zero-width trapezoid
    segments: no effect on integrals) and the band matrix and the tables
    pad with zeros (padded points carry no band weight), so sharded
    results equal unsharded ones; the whole spectrum just carries
    trailing padded samples.  On-the-fly tiles (``lt{k}_*``) pad the tile
    axis instead, and the wn grid grows to exactly n_tiles x tile_size.
    """
    n_wn = mesh if isinstance(mesh, int) else mesh.n_wn
    out = dict(tables)
    lt_keys = sorted({k.split("_", 1)[0] for k in tables if k.startswith("lt")})

    if lt_keys:
        nt, W = tables[f"{lt_keys[0]}_wn_tiles"].shape
        for p in lt_keys[1:]:
            if tuple(tables[f"{p}_wn_tiles"].shape) != (nt, W):
                raise ValueError(
                    "sharded on-the-fly mode requires every species to "
                    "be tiled with the same wn grid and tile_size: "
                    f"{lt_keys[0]} has (nt, W)=({nt}, {W}) but {p} has "
                    f"{tuple(tables[f'{p}_wn_tiles'].shape)}")
        nt_pad = (-nt) % n_wn
        for p in lt_keys:
            for suf in ("wn0", "s296", "elower", "gamma_air", "n_air",
                        "weight", "grid_mask"):
                out[f"{p}_{suf}"] = _pad(tables[f"{p}_{suf}"], 0, nt_pad)
            wt = tables[f"{p}_wn_tiles"]
            if nt_pad:
                fill = wt[-1:, -1:]
                fill = (fill.expand(nt_pad, W) if isinstance(wt, torch.Tensor)
                        else np.broadcast_to(fill, (nt_pad, W)))
                out[f"{p}_wn_tiles"] = (
                    torch.cat([wt, fill]) if isinstance(wt, torch.Tensor)
                    else np.concatenate([wt, fill]))
        pad = (nt + nt_pad) * W - tables["wn"].shape[0]
    else:
        pad = (-tables["wn"].shape[0]) % n_wn
        if pad == 0:
            return out
        for k in ("sigma", "frows", "sigmak", "frowsk"):
            if k in tables:
                out[k] = _pad(tables[k], tables[k].ndim - 1, pad)

    if pad:
        out["wn"] = _repeat_last(tables["wn"], pad)
        out["band_w"] = _pad(tables["band_w"], 1, pad)
    return out


def shard_tables(tables: dict, mesh: Mesh, device=None) -> dict:
    """This rank's shard of every table (each wn-indexed one's columns
    ``mesh.wn_block`` along its wn axis, every other one whole), copied to
    ``device`` (default: the mesh's).  The wn axes must divide the mesh
    (``pad_tables_for_mesh``).  A shard is always a copy, so the rank
    holds no reference to the whole table."""
    device = mesh.device if device is None else device
    out = {}
    for k, v in tables.items():
        v = torch.as_tensor(v)
        axis = _wn_axis(k)
        if axis is None:
            out[k] = v.to(device)
        else:
            lo, hi = mesh.wn_block(v.shape[axis])
            out[k] = v.narrow(axis, lo, hi - lo).to(device, copy=True)
    return out


def shard_model(fm, mesh: Mesh):
    """Re-home a ForwardModel's tables onto the mesh in place: pad the wn
    axis to divide the mesh, keep this rank's shard of every wn-indexed
    table, lay the K = 1 table (RowsTable) or the folded one
    (FoldedTable) out again for the shard, and put the tables on the
    mesh's device.  Sets ``fm.n_wn_orig`` and ``fm.mesh``: the model's
    forward then runs its chain block on its wn shard and sums the band
    fluxes over the mesh in one all-reduce.

    Build the model on the CPU (``device="cpu"``): the padding and the
    slicing then happen on the host, and only the rank's shard reaches
    its card; build the Likelihood on the sharded model.  The adaptive
    fold split is refused: it permutes wn columns."""
    from bart_tpu_torch.obs.bands import _trapz_weights
    from bart_tpu_torch.rt.fused import (FoldedTable, fold_table,
                                         folded_table, unfold_table)

    if getattr(fm, "_idx_fine", None) is not None:
        raise ValueError(
            "wn-sharded execution requires a contiguous wn axis: build "
            "the ForwardModel with fold_adapt=None (config rtadapt = "
            "False) — the adaptive fine/smooth bin split permutes wn "
            "columns, which would turn the one all-reduce of the forward "
            "into gather/scatter collectives")
    if fm.mesh is not None:
        raise ValueError("shard_model: the model is sharded already")
    t = fm.tables
    host = {k: v for k, v in t.items() if k not in ("tab", "tabk")}
    ft = t.get("tabk")
    if ft is not None:                  # [K, rows, L, W]: a view
        host["sigmak"] = fold_table(ft.bins().flatten(-2), ft.K)
    padded = pad_tables_for_mesh(host, mesh)
    if fm.config.ebalance:
        wn64 = padded["wn"].cpu().double().numpy()
        padded["wn_trapz"] = torch.as_tensor(
            _trapz_weights(wn64), dtype=fm.dtype, device=t["wn"].device)
    local = shard_tables(padded, mesh, device=t["wn"].device)
    dev = mesh.device
    if ft is not None:
        fk = folded_table(unfold_table(local.pop("sigmak")), ft.K)
        layouts = {"tabk": FoldedTable(fk.tab.to(dev), fk.K, fk.W)}
    elif "tab" in t:
        layouts = fm._k1_tables(local.pop("sigma"), local.pop("frows", None),
                                device=dev)
    else:
        layouts = {}
    fm.n_wn_orig = int(t["wn"].shape[0])
    fm._tables = {**{k: v.to(dev) for k, v in local.items()}, **layouts}
    fm._rehome(dev)
    fm.mesh = mesh
    return fm
