"""Multi-process start-up on torch.distributed (port of
bart_tpu/parallel/distributed.py).

Every rank runs the same program; ``init_distributed()`` joins it to one
process group, after which ``parallel.mesh.make_mesh`` lays the ranks out
on the (chain, wn) mesh and the same retrieval code runs on each.  The
group comes from explicit arguments or from the variables torchrun sets
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):

    torchrun --standalone --nproc_per_node N -m <module>

The backend is NCCL for a CUDA device and gloo for the CPU unless the
caller names one; one rank a card (``cuda:LOCAL_RANK``) is the NCCL
layout.  An NCCL group is bound to the rank's card (``device_id``), so
PyTorch creates its communicator at once, and the groups that
``make_mesh`` splits from it theirs, instead of at each group's first
collective: a CUDA graph cannot capture a collective whose communicator
does not exist yet.  Ranks that share one card must use gloo (NCCL
refuses two ranks on one device), and name the card
(``device="cuda:0"``).

NCCL destroys a communicator only once every CUDA graph that captured
one of its collectives is gone, and a sampler keeps its graphs in a
reference cycle: drop the samplers and run ``gc.collect()`` before
``torch.distributed.destroy_process_group()``, or the teardown can
wait for ever (``parallel.dryrun.main`` does).
"""

from __future__ import annotations

import datetime
import os

import torch

from bart_tpu_torch.device import resolve_device

__all__ = ["init_distributed", "is_multihost", "local_device"]


def local_device(device: str | torch.device | None = None) -> torch.device:
    """This rank's device: ``device`` when given, else the card of the
    rank's LOCAL_RANK (0 without one), ``cuda:{LOCAL_RANK}``.  Raises
    when that card does not exist, so that ranks share a card only when
    the caller names it."""
    if device is not None:
        return resolve_device(device)
    local = int(os.environ.get("LOCAL_RANK", 0))
    dev = resolve_device(f"cuda:{local}")
    if local >= torch.cuda.device_count():
        raise RuntimeError(
            f"LOCAL_RANK {local} but only {torch.cuda.device_count()} CUDA "
            "device(s): name the device to let ranks share a card")
    return dev


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     *, backend: str | None = None,
                     device: str | torch.device | None = None,
                     timeout_s: float = 600.0) -> bool:
    """Join this process to a torch.distributed group, from the arguments
    or torchrun's variables.  Returns False, and forms no group, when no
    group is asked for (no ``world_size`` and no WORLD_SIZE); else True
    if the group has more than one rank.

    ``init_method`` defaults to ``env://`` (MASTER_ADDR, MASTER_PORT);
    ``tcp://localhost:<port>`` or ``file://<path>`` name a rendezvous
    directly.  ``backend`` defaults to NCCL on a CUDA ``device`` and gloo
    on the CPU; ``device`` defaults to ``local_device()``.  An NCCL group
    is bound to that device (``device_id``: its communicators are created
    eagerly).  A rendezvous or a collective that does not complete in
    ``timeout_s`` raises (NCCL: its watchdog aborts the process)."""
    import torch.distributed as dist

    if world_size is None:
        if "WORLD_SIZE" not in os.environ:
            return False
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    dev = local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # NCCL: bound to the card, the communicators are made now (eagerly)
    bind = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        world_size=int(world_size), rank=int(rank),
        timeout=datetime.timedelta(seconds=timeout_s), **bind)
    return dist.get_world_size() > 1


def is_multihost() -> bool:
    """Whether this process is one of several in a group."""
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_world_size() > 1
