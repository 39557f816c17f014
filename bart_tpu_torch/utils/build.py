"""Where the package puts the libraries it compiles at first use.

The CUDA kernels (rt/fused.py, nvcc) and the native HITRAN scanner
(native/hitran_native.py, g++) are built into one directory inside the
package, ``bart_tpu_torch/build/``, as bart_tpu builds its scanner beside
its source: in a checkout and in an installed package alike the
libraries stay with the sources they were built from.  Each library is
named by a hash of its sources and flags and is written under a
temporary name and moved into place, so processes that build at once
never load a half-written file.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["BUILD_DIR", "build_dir"]

BUILD_DIR = Path(__file__).resolve().parents[1] / "build"


def build_dir() -> Path:
    """Create ``BUILD_DIR`` if it is missing and return it.  Raises
    RuntimeError, naming the directory, if it cannot be created or
    written: the caller does not fall back to anything."""
    path = BUILD_DIR
    try:
        path.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        raise RuntimeError(
            f"cannot create the build directory {path}: {e}") from e
    if not os.access(path, os.W_OK | os.X_OK):
        raise RuntimeError(f"the build directory {path} is not writable")
    return path
