#!/usr/bin/env python3
"""Write the in-repo inputs of bart_tpu_torch's CLI demo.

The demo cfgs of bart_tpu (examples/demo_eclipse.cfg, demo_transit.cfg)
read the system, the abundance table and the filters from a reference
checkout that does not ship with this repository.  This script writes
their counterparts from what the repository holds, next to itself:

* ``system.tep``: the synthetic system of bart_tpu_torch/demo.py
  (``SYSTEM``) in the TEP format of examples/inputs/WASP-12b.tep;
* ``filters/fdemo01.dat`` .. ``fdemo10.dat``: the ten top-hats of
  ``demo.demo_filters()`` as wavelength [um] and response;
* ``abundances.txt``: H, He, C, N and O, the photospheric values of
  Asplund et al. 2009 (ARA&A 47, 481, Table 1) with standard atomic
  weights, in the reference's five columns;
* six cfgs on the line list and CIA table of examples/demo_inputs:
  ``eclipse.cfg`` and ``transit.cfg`` (bart_tpu's demo cfgs with these
  paths), ``eclipse_tea.cfg`` (thermochemical equilibrium of ten species
  with the shipped NASA-7 tables in place of the uniform abundances),
  ``eclipse_fold.cfg`` and ``transit_fold.cfg`` (the publication
  accuracy: rtosamp = 32, adaptive split, bfloat16 tables), and
  ``eclipse_fold_f32.cfg`` (the same with the reference's default
  float32 fine tables: foldtable16 left out).

The data in the eclipse and transit cfgs are the band fluxes of the
port's own pipeline stages at the demo truth (``demo.TRUTH``,
``demo.TRUTH_TRANSIT``) on the cfgs' full grid, with 3% Gaussian noise
(numpy seeds 42 and 43); the fold cfgs carry those of their geometry
(chip_smoke.py --cli-fold checks that the folded bands at the truth sit
within 0.3 sigma of the K = 1 ones).  Everything runs on the CPU in
float64.  The opacity table is built at the T-nodes that bracket the
truth's profile only (1300-1500 K of the cfgs' 400-3000 K at 100 K): the
forward's linear interpolation on a uniform T grid reads no other node,
so the band fluxes are those of the whole table, at a ninth of the
build.

    python3 examples/torch_demo/make_inputs.py
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import torch  # noqa: E402

from bart_tpu_torch import constants as const  # noqa: E402
from bart_tpu_torch.demo import (SYSTEM, TRUTH, TRUTH_TRANSIT,  # noqa: E402
                                 demo_filters)
from bart_tpu_torch.driver.config import load_config  # noqa: E402
from bart_tpu_torch.driver.pipeline import Pipeline  # noqa: E402
from bart_tpu_torch.physics.pt import pt_generator  # noqa: E402

#: Asplund et al. 2009, Table 1 (photospheric, log eps, H = 12), and the
#: standard atomic weights: (Z, symbol, dex, name, molar mass)
ELEMENTS = [(1, "H", 12.00, "Hydrogen", 1.00794),
            (2, "He", 10.93, "Helium", 4.002602),
            (6, "C", 8.43, "Carbon", 12.0107),
            (7, "N", 7.83, "Nitrogen", 14.0067),
            (8, "O", 8.69, "Oxygen", 15.9994)]
#: the noise seeds of the eclipse and transit data
SEEDS = {"eclipse": 42, "transit": 43}
NOISE = 0.03

_COMMON = """\
[MCMC]
loc_dir = ./demo_out_{name}/

tep_name = ./system.tep

; Pressure grid:
n_layers = 100
p_top    = 1e-5
p_bottom = 100.0
log      = True

abun_basic = ./abundances.txt
solar_times = 1
COswap = False

{atmosphere}

{data}

filters = {filters}

molfit = CH4
Tmin =  400.0
Tmax = 3000.0
PTtype = line

{params}

numit   = 50000
nchains = 8
burnin  = 500
walk    = snooker
leastsq = False
chisqscale = False
grtest  = True
grexit  = True
plots   = True
logfile = MCMC.log

; Spectrum sampling:
wllow  = 2.0
wlhigh = 4.0
wlfct  = 1e-4
wndelt = 1.0
wnosamp = 2160
{fold}
refpress = 0.1
solution = {solution}
raygrid  = 0 20 40 60 80
toomuch  = 10.0
ethresh  = 1e-6
nwidth   = 20

tlow     = 400
thigh    = 3000
tempdelt = 100
opacityfile = opacity_CH4.npz

linedb = ../demo_inputs/CH4_demo.tli.npz
csfile = ../demo_inputs/CIA_H2H2_demo.dat
"""

_UNIFORM = """\
; Uniform-abundance atmosphere (demo path):
out_spec = H2 He CH4
uniform  = 0.85 0.149 1e-3"""

_TEA = """\
; Thermochemical-equilibrium atmosphere (the TEA-equivalent stage) with
; the shipped GRI-Mech NASA-7 tables:
in_elem    = H He C N O
thermofile = builtin
out_spec   = H_g He_ref C_g N_g O_g H2_ref CO_g CO2_g CH4_g H2O_g"""

_PARAMS = {
    "eclipse": """\
parnames = kappa   g1     g2    alpha  beta   CH4
params   = -2.0    0.0    1.0   0.0    0.98   -0.5
pmin     = -5.0   -2.0   -2.0   0.0    0.55   -9.0
pmax     = -1.0    1.0    1.0   1.0    1.2     1.5
stepsize = 0.01    0.01   0.0   0.0    0.001   0.1""",
    "transit": """\
parnames = kappa   g1     g2    alpha  beta   Radius  CH4
params   = -2.0    0.0    1.0   0.0    0.98   96514    -0.5
pmin     = -5.0   -2.0   -2.0   0.0    0.55   75000    -9.0
pmax     = -1.0    1.0    1.0   1.0    1.2   115000     1.5
stepsize = 0.01    0.01   0.0   0.0    0.001    100      0.1""",
}

_FOLD = """
; Publication accuracy: 32 sub-samples a bin folded into the kernels,
; the adaptive split, bfloat16 fine tables
rtosamp = 32
rtadapt = True
foldtable16 = True
"""

_FOLD_F32 = """
; Publication accuracy: 32 sub-samples a bin folded into the kernels,
; the adaptive split; float32 fine tables (foldtable16's default, off)
rtosamp = 32
rtadapt = True
"""

#: cfg name -> (loc_dir suffix, solution, atmosphere, fold block)
CFGS = {"eclipse": ("eclipse", "eclipse", _UNIFORM, ""),
        "transit": ("transit", "transit", _UNIFORM, ""),
        "eclipse_tea": ("tea", "eclipse", _TEA, ""),
        "eclipse_fold": ("fold", "eclipse", _UNIFORM, _FOLD),
        "transit_fold": ("transit_fold", "transit", _UNIFORM, _FOLD),
        "eclipse_fold_f32": ("fold_f32", "eclipse", _UNIFORM, _FOLD_F32)}


def _numbers(key: str, values) -> str:
    vals = [f"{v:.6e}" for v in values]
    rows = [" ".join(vals[i:i + 5]) for i in range(0, len(vals), 5)]
    return f"{key:<6} = " + "\n         ".join(rows)


def write_cfg(out: str, name: str, data=None, uncert=None) -> str:
    suffix, solution, atmosphere, fold = CFGS[name]
    source = "eclipse" if solution == "eclipse" else "transit"
    if data is None:
        block = "data   = None\nuncert = None"
    else:
        truth = TRUTH if source == "eclipse" else TRUTH_TRANSIT
        block = (f"; Synthetic {source} data, the pipeline's band fluxes at"
                 f" the truth\n; [{' '.join(f'{v:g}' for v in truth)}] with"
                 f" {NOISE:.0%} noise (make_inputs.py, seed "
                 f"{SEEDS[source]}):\n" + _numbers("data", data) + "\n"
                 + _numbers("uncert", uncert))
    filters = "\n          ".join(f"./filters/fdemo{k:02d}.dat"
                                  for k in range(1, 11))
    text = (f"; bart_tpu_torch CLI demo: CH4 {solution} retrieval on in-repo "
            "inputs.\n; Written by make_inputs.py; run with\n"
            f";   python3 -m bart_tpu_torch -c examples/torch_demo/{name}.cfg"
            "\n" + _COMMON.format(
                name=suffix, atmosphere=atmosphere, data=block,
                filters=filters, params=_PARAMS[source],
                fold=fold, solution=solution))
    path = os.path.join(out, f"{name}.cfg")
    with open(path, "w") as f:
        f.write(text)
    return path


def write_system(out: str) -> None:
    s = SYSTEM
    rows = [("planetname", "demo-b", "-", "-"),
            ("startype", "G", "-", "-"),
            ("Ts", repr(s.t_star), "K", "bart_tpu_torch.demo"),
            ("Rs", repr(s.r_star / const.RSUN), "Rsun", "bart_tpu_torch.demo"),
            ("loggstar", repr(s.logg_star), "cgs", "bart_tpu_torch.demo"),
            ("a", repr(s.sma / const.AU), "AU", "bart_tpu_torch.demo"),
            ("Rp", repr(s.r_planet / const.RJUP), "Rjup",
             "bart_tpu_torch.demo"),
            ("Mp", repr(s.m_planet / const.MJUP), "Mjup",
             "bart_tpu_torch.demo")]
    with open(os.path.join(out, "system.tep"), "w") as f:
        f.write("# The synthetic system of bart_tpu_torch/demo.py (SYSTEM), "
                "written by\n# examples/torch_demo/make_inputs.py. Format per "
                "the reference TEP convention.\n"
                "# parameter     value                   uncert    unit     "
                "origin\n\n")
        for name, value, unit, origin in rows:
            f.write(f"{name:<15} {value:<23} -1        {unit:<8} {origin}\n")


def write_filters(out: str) -> None:
    os.makedirs(os.path.join(out, "filters"), exist_ok=True)
    for k, (wn, resp) in enumerate(demo_filters(), start=1):
        wl = 1.0 / (wn * const.MICRON_TO_CM)       # um, descending
        with open(os.path.join(out, "filters", f"fdemo{k:02d}.dat"),
                  "w") as f:
            f.write(f"# Top-hat filter {k} of bart_tpu_torch/demo.py "
                    f"({wn[0]:.0f}-{wn[-1]:.0f} cm-1)\n"
                    "# wavelength [um]   response\n")
            for w, r in zip(wl[::-1], resp[::-1]):
                f.write(f"{float(w)!r}  {float(r)!r}\n")


def write_abundances(out: str) -> None:
    with open(os.path.join(out, "abundances.txt"), "w") as f:
        f.write("# Elemental abundances: a five-element excerpt written for "
                "the bart_tpu_torch\n# CLI demo (make_inputs.py): "
                "photospheric values of Asplund et al. 2009,\n# ARA&A 47, "
                "481, Table 1, and standard atomic weights.\n"
                "# Columns: ordinal, symbol, dex abundances, name, molar "
                "mass.\n")
        for z, sym, dex, name, mass in ELEMENTS:
            f.write(f"{z:3d}  {sym:2s}  {dex:5.2f}  {name:10s}  "
                    f"{mass:12.8f}\n")


def truth_tgrid(cfg, truth) -> tuple[float, float]:
    """(tlow, thigh): the cfg's T-nodes that bracket the truth's PT
    profile on its pressure grid."""
    from bart_tpu_torch.utils.grids import pressure_grid

    p = torch.tensor(pressure_grid(cfg.n_layers, cfg.p_top, cfg.p_bottom,
                                   cfg.log))
    s = SYSTEM
    T, valid = pt_generator(
        p, torch.tensor(truth[:5])[None], cfg.PTtype,
        [s.r_star, s.t_star, cfg.tint, s.sma, s.g_planet_cgs, cfg.tint_type])
    assert bool(valid[0])
    lo = cfg.tlow + cfg.tempdelt * np.floor((float(T.min()) - cfg.tlow)
                                            / cfg.tempdelt)
    hi = cfg.tlow + cfg.tempdelt * np.ceil((float(T.max()) - cfg.tlow)
                                           / cfg.tempdelt)
    return float(lo), float(max(hi, lo + cfg.tempdelt))


def truth_bands(path: str, truth: np.ndarray, work: str) -> np.ndarray:
    """The band fluxes of the cfg at ``path`` at ``truth``, through the
    pipeline's stages on the CPU in float64."""
    cfg = load_config(path, {"quiet": "True"})
    tlow, thigh = truth_tgrid(cfg, truth)
    cfg = load_config(path, {"loc_dir": work, "tlow": str(tlow),
                             "thigh": str(thigh), "quiet": "True"})
    pipe = Pipeline(cfg, device="cpu", dtype=torch.float64)
    atm = pipe.stage_atmosphere(pipe.stage_pressure(),
                                pipe.stage_abundances())
    wn = cfg.wavenumber_grid()
    grid = pipe.stage_opacity(pipe.stage_linelist(wn), wn, atm.pressure,
                              atm)
    fm = pipe._build_forward(atm, wn, grid)
    band, _, valid = fm(torch.tensor(truth[None]))
    assert bool(valid[0])
    return band[0].numpy()


def main() -> int:
    write_system(HERE)
    write_filters(HERE)
    write_abundances(HERE)
    data = {}
    with tempfile.TemporaryDirectory() as work:
        for source, truth in (("eclipse", TRUTH),
                              ("transit", TRUTH_TRANSIT)):
            path = write_cfg(HERE, source)
            band = truth_bands(path, truth, work)
            uncert = NOISE * band
            rng = np.random.default_rng(SEEDS[source])
            data[source] = (band + rng.normal(0.0, 1.0, band.shape) * uncert,
                            uncert)
            print(f"{source}: bands at the truth {band}")
    for name, (_, solution, _, _) in CFGS.items():
        source = "eclipse" if solution == "eclipse" else "transit"
        print("wrote", write_cfg(HERE, name, *data[source]))
    return 0

if __name__ == "__main__":
    sys.exit(main())
