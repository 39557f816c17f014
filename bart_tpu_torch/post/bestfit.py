"""Best-fit post-processing (port of bart_tpu/post/bestfit.py): so far
``read_mcmc_log``, a host copy, which reads the " Best-fit params" block
of an MCMC.log that run_mcmc writes."""

from __future__ import annotations

import numpy as np

__all__ = ["read_mcmc_log"]


def read_mcmc_log(path: str):
    """(best-fit parameters, their uncertainties) from the last
    " Best-fit params" block of the log at ``path`` (the reference's
    bestFit.read_MCMC_out)."""
    lines = open(path).readlines()
    ini = None
    for i in range(len(lines) - 1, -1, -1):
        if lines[i].startswith(" Best-fit params"):
            ini = i + 1
            break
    if ini is None:
        raise ValueError(f"{path}: no Best-fit params block")
    bestp, uncert = [], []
    for line in lines[ini:]:
        if not line.strip():
            break
        f = line.split()
        bestp.append(float(f[0]))
        uncert.append(float(f[1]))
    return np.asarray(bestp), np.asarray(uncert)
