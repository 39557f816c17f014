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

With ``--wasp12b`` it writes instead the twins of bart_tpu's flagship,
examples/wasp12b_eclipse.cfg and wasp12b_eclipse_fold.cfg (a 4-molecule
H2O/CO2/CO/CH4 eclipse retrieval of WASP-12b over the four Spitzer IRAC
channels, on examples/demo_inputs/wasp12b_4mol.tli.npz): ``filters/
firac1.dat`` .. ``firac4.dat``, top-hat stand-ins for the IRAC channels'
half-response bands, and ``wasp12b_eclipse.cfg`` and
``wasp12b_eclipse_fold.cfg``, with every key of the originals but two
(``abun_basic`` is ``abundances.txt``, ``filters`` the stand-ins) and the
paths relative to this directory.  Their data are the port's model at the
truth, noise-free, with 2.5% uncertainties (the originals' pin policy):
the K = 1 depths from the pipeline's stages on the CPU in float64 (both
cfgs get them); ``--wasp12b-fold`` then re-pins the folded cfg to the
folded model (rtosamp = 32, expsum, bfloat16 fine tables) on the card and
records the delta against the K = 1 pin.  Both build the opacity table at
each layer's two T-nodes around the truth's profile only: the forward's
linear interpolation reads no other node, so the bands are those of the
whole table.

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
    python3 examples/torch_demo/make_inputs.py --wasp12b
    python3 examples/torch_demo/make_inputs.py --wasp12b-fold   # card
"""

from __future__ import annotations

import argparse
import datetime
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


#: The flagship twins: the IRAC channels' half-response bands [um] of the
#: top-hat stand-ins, the truth (parnames of the cfgs) and the
#: uncertainty, a share of the depth
IRAC_BANDS = ((3.19, 3.94), (4.00, 5.02), (4.98, 6.41), (6.45, 9.34))
WASP12B_TRUTH = np.array([-0.5, -0.2, 1.0, 0.0, 1.1, -1.0, 1.0, -1.0, -1.0])
WASP12B_UNCERT = 0.025

_WASP12B = """\
; bart_tpu_torch WASP-12b-class retrieval{title}:
; 4 Spitzer IRAC channels, H2O/CO2/CO/CH4 with synthetic line data -- the
; twin of bart_tpu's examples/{orig}.cfg on in-repo inputs.
; Every key is the original's but two: abun_basic is the port's Asplund
; excerpt and filters are top-hat stand-ins for the IRAC channels; paths
; are relative to this directory.  Written by make_inputs.py; run with
;   python3 examples/torch_demo/run_wasp12b.py{flag}
[MCMC]
loc_dir = ./wasp12b_out{suffix}/

tep_name = ../inputs/WASP-12b.tep

n_layers = 100
p_top    = 1e-5
p_bottom = 100.0
log      = True

abun_basic = ./abundances.txt
solar_times = 1
COswap = False

out_spec = H He C N O H2 CO CO2 CH4 H2O
uniform  = 1e-9 0.15 1e-9 1e-9 1e-9 0.85 1e-4 1e-4 1e-4 1e-4

{data}

filters = ./filters/firac1.dat
          ./filters/firac2.dat
          ./filters/firac3.dat
          ./filters/firac4.dat

molfit = H2O CO2 CO CH4
Tmin =  400.0
Tmax = 3000.0
PTtype = line

parnames = kappa  g1    g2   alpha  beta   H2O   CO2   CO   CH4
params   = -0.5  -0.2   1.0  0.0    1.1   -1.0    1.0  -1.0  -1.0
pmin     = -5.0  -3.0  -2.0  0.0    0.55  -9.0   -9.0  -9.0  -9.0
pmax     =  2.0   2.0   3.0  1.0    1.4    3.0    3.0   3.0   3.0
stepsize = 0.01   0.01  0.0  0.0    0.001  0.1    0.1   0.1   0.1

numit   = {numit}
nchains = 10
burnin  = 1000
walk    = snooker
grtest  = True
grexit  = True
plots   = True
logfile = MCMC.log

wnlow  = 910.0
wnhigh = 3400.0
wndelt = 1.0
nwidth = 60
ethresh = 1e-99

refpress = 0.1
solution = eclipse
raygrid  = 0 20 40 60 80

tlow     = 400
thigh    = 3000
tempdelt = 100
opacityfile = {opac}

linedb = ../demo_inputs/wasp12b_4mol.tli.npz
csfile = ../demo_inputs/CIA_H2H2_demo.dat
{fold}"""

_WASP12B_FOLD = """
; publication-accuracy mode (the original's): rtosamp = 32 folded
; kernels, the expsum angular quadrature, bfloat16-stored fine tables
rtosamp = 32
quadrature = expsum
foldtable16 = True
"""

_WASP12B_DATA = """\
; Synthetic eclipse depths = the port's {model}
; AT the truth `params` below, noise-free, at this config's own settings
; (100 layers, wndelt 1.0, nwidth 60); uncert = 2.5% of depth.
; run_wasp12b.py{flag} asserts that model(truth) reproduces them to
; < 0.5 sigma, so any numerical drift of the forward model fails the
; regression.  Re-pin policy (the original's): a re-pin is
; self-referential at the pin point (it only guards future drift), so it
; records its delta against the old pin here.  Pin history:
{history}
"""


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


def write_wasp12b_cfg(out: str, fold: bool, data=None,
                      history: tuple = ()) -> str:
    """Write wasp12b_eclipse.cfg (``fold``: wasp12b_eclipse_fold.cfg)
    with ``data`` (uncert: WASP12B_UNCERT of it) and the pin history's
    lines; data None writes ``data = None``."""
    if data is None:
        block = "data   = None\nuncert = None"
    else:
        block = (_WASP12B_DATA.format(
            model="folded model (rtosamp = 32)" if fold else "forward model",
            flag=" --fold" if fold else "",
            history="\n".join(f";   {h}" for h in history))
            + _numbers("data", data) + "\n"
            + _numbers("uncert", WASP12B_UNCERT * np.asarray(data)))
    name = "wasp12b_eclipse_fold" if fold else "wasp12b_eclipse"
    text = _WASP12B.format(
        title=" at publication accuracy" if fold else "",
        orig=name, flag=" --fold" if fold else "",
        suffix="_fold" if fold else "", data=block,
        numit=150000 if fold else 100000,
        opac="opacity_4mol_fold32.npz" if fold else "opacity_4mol.npz",
        fold=_WASP12B_FOLD if fold else "")
    path = os.path.join(out, f"{name}.cfg")
    with open(path, "w") as f:
        f.write(text)
    return path


def write_irac_filters(out: str) -> None:
    os.makedirs(os.path.join(out, "filters"), exist_ok=True)
    for k, (lo, hi) in enumerate(IRAC_BANDS, start=1):
        wl = np.linspace(lo, hi, 76)
        with open(os.path.join(out, "filters", f"firac{k}.dat"), "w") as f:
            f.write(f"# Synthetic stand-in for the Spitzer IRAC channel {k} "
                    f"filter: a top-hat over\n# its half-response band "
                    f"{lo:.2f}-{hi:.2f} um (make_inputs.py), not the "
                    "measured curve\n# wavelength [um]   response\n")
            for w in wl:
                f.write(f"{float(w)!r}  1.0\n")


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
    T = truth_profile(cfg, truth)
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


def truth_profile(cfg, truth) -> np.ndarray:
    """T [L] of the truth's PT profile on the cfg's pressure grid, in
    float64, with the cfg's system (as the pipeline forms it)."""
    from bart_tpu_torch.io.tep import PlanetSystem
    from bart_tpu_torch.utils.grids import pressure_grid

    s = PlanetSystem.from_tep(cfg.tep_name)
    p = torch.tensor(pressure_grid(cfg.n_layers, cfg.p_top, cfg.p_bottom,
                                   cfg.log))
    T, valid = pt_generator(
        p, torch.tensor(np.asarray(truth[:5], np.float64))[None], cfg.PTtype,
        [s.r_star, s.t_star, cfg.tint, s.sma, s.g_planet_cgs, cfg.tint_type])
    assert bool(valid[0])
    return T[0].numpy()


def pinned_bands(path: str, truth: np.ndarray, work: str, device: str,
                 dtype: torch.dtype, overrides: dict | None = None
                 ) -> np.ndarray:
    """The band fluxes of the cfg at ``path`` at ``truth``: the
    pipeline's stages (the folded ones when the cfg sets rtosamp) on
    ``device`` in ``dtype``, the opacity table built at each layer's two
    T-nodes around the truth's profile (the only nodes the forward's
    interpolation reads there; the others stay zero).  ``overrides``
    go to load_config."""
    from bart_tpu_torch.opacity.grid import (OpacityGrid, build_budget,
                                             build_opacity_grid)
    from bart_tpu_torch.utils.grids import folded_fine_grid

    cfg = load_config(path, {"loc_dir": work, "quiet": "True",
                             **(overrides or {})})
    pipe = Pipeline(cfg, device=device, dtype=dtype)
    atm = pipe.stage_atmosphere(pipe.stage_pressure(),
                                pipe.stage_abundances())
    wn = cfg.wavenumber_grid()
    wn_rt = folded_fine_grid(wn, cfg.fold_K) if cfg.fold_K > 1 else wn
    tli = pipe.stage_linelist(wn_rt)
    t_all = np.arange(cfg.tlow, cfg.thigh + cfg.tempdelt / 2, cfg.tempdelt)
    # each layer's lower node, as rt.fused.interp_weights brackets T
    x = (truth_profile(cfg, truth) - t_all[0]) / cfg.tempdelt
    i0 = np.clip(np.floor(x).astype(int), 0, len(t_all) - 2)
    lo, hi = int(i0.min()), int(i0.max()) + 1
    sigma = None
    for i in np.unique(i0):
        layers = np.flatnonzero(i0 == i)
        g = build_opacity_grid(
            dict(tli.lines), wn_rt, t_all[i:i + 2], atm.pressure[layers],
            spec=pipe._broadening(atm), nwidth=cfg.nwidth,
            ethresh=cfg.ethresh,
            q_tables=getattr(tli, "partition", None) or {},
            budget_bytes=build_budget(pipe.device), device=pipe.device,
            dtype=dtype)
        if sigma is None:
            sigma = torch.zeros((len(g.species), hi - lo + 1,
                                 len(atm.pressure), len(wn_rt)),
                                dtype=g.sigma.dtype, device=g.sigma.device)
        sigma[:, i - lo:i - lo + 2, torch.as_tensor(layers)] = g.sigma
    grid = OpacityGrid(g.species, t_all[lo:hi + 1], atm.pressure, wn_rt,
                       sigma)
    fm = pipe._build_forward(atm, wn, grid)
    band, _, valid = fm(torch.tensor(truth[None], dtype=dtype,
                                     device=pipe.device))
    assert bool(valid[0])
    return band[0].double().cpu().numpy()


def wasp12b(device: str, fold: bool) -> int:
    """``--wasp12b``: the IRAC stand-ins and both flagship twins with the
    K = 1 pin (CPU, float64); ``--wasp12b-fold``: the folded twin
    re-pinned to the folded model on ``device`` (float32, the kernels')."""
    today = datetime.date.today().isoformat()
    with tempfile.TemporaryDirectory() as work:
        if not fold:
            write_irac_filters(HERE)
            for f in (False, True):
                write_wasp12b_cfg(HERE, f)
            band = pinned_bands(os.path.join(HERE, "wasp12b_eclipse.cfg"),
                                WASP12B_TRUTH, work, "cpu", torch.float64)
            hist = (f"{today} initial pin: the pipeline's stages on the CPU "
                    "in float64", "           (make_inputs.py --wasp12b)")
            for f in (False, True):
                print("wrote", write_wasp12b_cfg(
                    HERE, f, band, hist + (("           (the K = 1 depths; "
                                            "--wasp12b-fold re-pins them",
                                            "           to the folded "
                                            "model)") if f else ())))
            print(f"K = 1 bands at the truth: {band}")
            return 0
        path = os.path.join(HERE, "wasp12b_eclipse_fold.cfg")
        old = load_config(path, {"quiet": "True"})
        from bart_tpu_torch.driver.config import load_data_array

        k1 = load_data_array(old.data)
        band = pinned_bands(path, WASP12B_TRUTH, work, device, torch.float32)
    delta = (band - k1) / (WASP12B_UNCERT * k1)
    name = torch.cuda.get_device_name(0) if device == "cuda" else device
    hist = (f"{today} initial pin: the K = 1 depths (make_inputs.py "
            "--wasp12b)",
            f"{today} re-pin to the folded model on the card, float32",
            f"           ({name}; make_inputs.py --wasp12b-fold):",
            "           delta vs the K = 1 pin "
            + " / ".join(f"{d:+.3f}" for d in delta),
            "           sigma, the rtosamp = 1 discretization error at "
            "these bands")
    print("wrote", write_wasp12b_cfg(HERE, True, band, hist))
    print(f"folded bands at the truth: {band}; delta vs K = 1 {delta} sigma")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wasp12b", action="store_true",
                    help="write the flagship twins with the K = 1 pin (CPU)")
    ap.add_argument("--wasp12b-fold", action="store_true",
                    help="re-pin the folded flagship twin on --device")
    ap.add_argument("--device", default="cuda",
                    help="the device of --wasp12b-fold (default: cuda)")
    args = ap.parse_args(argv)
    if args.wasp12b or args.wasp12b_fold:
        return wasp12b(args.device, args.wasp12b_fold)
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
