"""Device resolution and the float32 precision pin.

The JAX package pins ``Precision.HIGHEST`` on every chi^2-sensitive
contraction (bart_tpu/rt/fused.py:140,198, obs/bands.py:99,
rt/forward.py:566).  PyTorch's counterpart is to keep TF32 off: a
float32 matmul on the card then runs in full float32, and cuDNN (whose
TF32 default is on) is pinned the same way.  ``resolve_device`` sets
both flags, so every path that resolves a device runs at full float32.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device) -> torch.device:
    """An explicit device -> ``torch.device``.

    ``"cuda"`` without a visible GPU raises: the port never falls back
    to the CPU behind the caller's back.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False")
    return dev
