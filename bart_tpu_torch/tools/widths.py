"""Broadening-width estimator tool (this package's own host copy of
bart_tpu/tools/widths.py, on its own driver/config.py; the widths in
float64 torch on the CPU).

Equivalent of the reference's scripts/broadening.py get_widths
(reference: scripts/broadening.py:10-88): print the min/max Doppler and
Lorentz HWHM implied by a retrieval config — used to choose nwidth and
shard/tile sizes.

    python -m bart_tpu_torch.tools.widths -c <config>
"""

from __future__ import annotations

import argparse

import torch

from bart_tpu_torch import constants as const
from bart_tpu_torch.driver.config import load_config
from bart_tpu_torch.linelist.molecules import get_molecule
from bart_tpu_torch.physics.voigt import doppler_hwhm, lorentz_hwhm_collision


def get_widths(cfg) -> dict:
    """Min/max Doppler and Lorentz HWHM [cm-1] over the cfg's wn range,
    T range and pressure range, for the species of ``out_spec``."""
    wn = cfg.wavenumber_grid()
    wn_min, wn_max = float(wn[0]), float(wn[-1])
    f64 = dict(dtype=torch.float64)
    t_min = torch.tensor(cfg.tlow, **f64)
    t_max = torch.tensor(cfg.thigh, **f64)
    p_min = cfg.p_top * const.BAR_TO_BARYE
    p_max = cfg.p_bottom * const.BAR_TO_BARYE

    species = [s.partition("_")[0] for s in cfg.out_spec.split()]
    mols = [get_molecule(s) for s in species if s not in ("H", "C", "N", "O", "e-")]
    masses = torch.tensor([m.mass for m in mols], **f64) * const.AMU
    diams = torch.tensor([m.diameter for m in mols], **f64) * 1e-8

    h2 = get_molecule("H2")
    he = get_molecule("He")
    qp = torch.tensor([0.85, 0.15], **f64)
    mp = torch.tensor([h2.mass, he.mass], **f64) * const.AMU
    dp = torch.tensor([h2.diameter, he.diameter], **f64) * 1e-8

    d_min = float(doppler_hwhm(wn_min, t_min, masses.max()))
    d_max = float(doppler_hwhm(wn_max, t_max, masses.min()))
    l_min = min(
        float(lorentz_hwhm_collision(p_min, t_max, m, d, qp, mp, dp))
        for m, d in zip(masses, diams)
    )
    l_max = max(
        float(lorentz_hwhm_collision(p_max, t_min, m, d, qp, mp, dp))
        for m, d in zip(masses, diams)
    )
    return {"doppler_min": d_min, "doppler_max": d_max,
            "lorentz_min": l_min, "lorentz_max": l_max}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bart_tpu_torch.tools.widths")
    ap.add_argument("-c", "--config_file", required=True)
    args = ap.parse_args(argv)
    w = get_widths(load_config(args.config_file))
    print("Doppler minimum and maximum HWHM (cm-1): "
          f"{w['doppler_min']:.3e}, {w['doppler_max']:.3e}")
    print("Lorentz minimum and maximum HWHM (cm-1): "
          f"{w['lorentz_min']:.3e}, {w['lorentz_max']:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
