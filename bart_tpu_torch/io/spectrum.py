"""Spectrum-file reader (reference: code/readtransit.py:23-64).

This package's own host copy of bart_tpu/io/spectrum.py.

Parses the two-column spectrum files transit writes and this package's
post-processing writes (``bestfit_spectrum.dat``): wavelength [um] vs
flux (eclipse/direct) or modulation (transit), one header line allowed.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_spectrum"]


def read_spectrum(path: str, wn: bool = True):
    """-> (x, value) with x ascending.

    ``wn=True`` converts the wavelength column to wavenumber [cm-1]
    (the reference's readspectrum(..., wn=True) behavior); otherwise x
    stays in microns.  Rows are re-sorted ascending in x either way.
    """
    rows = np.loadtxt(path, comments="#", ndmin=2)
    wl_um, val = rows[:, 0], rows[:, 1]
    if wn:
        x = 1e4 / wl_um
    else:
        x = wl_um
    order = np.argsort(x)
    return x[order], val[order]
