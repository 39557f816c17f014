"""Photometric filter bandpass I/O.

This package's own host copy of bart_tpu/io/filters.py.

Reads the 2-column (wavelength [um], transmission) ASCII format of the
reference (reference: code/wine.py:16-66, inputs/filters/*).  Returns
wavenumber-ascending arrays in cm-1.
"""

from __future__ import annotations

import numpy as np

from bart_tpu_torch import constants as const

__all__ = ["read_filter"]


def read_filter(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load a filter bandpass file.

    Comments ('#') and blank lines before the data are skipped.  The data
    columns are wavelength in microns and spectral response.  Output is
    (wavenumber [cm-1], transmission), sorted by ascending wavenumber
    (i.e. the file's wavelength order reversed — reference
    code/wine.py:58-64).
    """
    wavel = []
    transm = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            fields = s.split()
            wavel.append(float(fields[0]))
            transm.append(float(fields[1]))
    wavel = np.asarray(wavel, np.float64)
    transm = np.asarray(transm, np.float64)
    wn = 1.0 / (wavel * const.MICRON_TO_CM)
    order = np.argsort(wn)
    return wn[order], transm[order]
