"""Library-API cookbook of bart_tpu_torch (counterpart of
examples/quickstart.py, the reference's scripts/quickguide.py).

A runnable walkthrough of the port's building blocks in six steps:
grids, a PT profile, equilibrium chemistry, a line list and its opacity
table, the forward model (replayed as a CUDA graph on the card) and a
small retrieval.  On the card unless told otherwise:

  python3 examples/torch_demo/quickstart.py [--device cpu]
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    from bart_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)

    # --- 1. pressure + wavenumber grids (makeP / makesample equivalents)
    from bart_tpu_torch.utils.grids import pressure_grid, wavenumber_grid

    pressure = pressure_grid(40, 1e-5, 100.0)             # bar, top-first
    wn = wavenumber_grid(wllow=2.5, wlhigh=4.0, wndelt=2.0)
    print(f"grids: {len(pressure)} layers, {len(wn)} wavenumbers "
          f"[{wn[0]:.0f}, {wn[-1]:.0f}] cm-1")

    # --- 2. a temperature profile (PT.py equivalents; 6 models) --------
    from bart_tpu_torch.io.tep import PlanetSystem
    from bart_tpu_torch.physics.pt import pt_generator

    # the synthetic system of examples/torch_demo/system.tep
    system = PlanetSystem(6075.0, 7.97e8, 4.37, 7.05e9, 9.44e7, 1.32e27)
    pt_args = [system.r_star, system.t_star, 100.0, system.sma,
               system.g_planet_cgs, "const"]
    f64 = dict(dtype=torch.float64, device=dev)
    T, valid = pt_generator(
        torch.tensor(pressure, **f64),
        torch.tensor([[-2.0, 0.0, 1.0, 0.0, 0.98]], **f64), "line", pt_args)
    print(f"PT 'line' profile: {float(T.min()):.0f}-{float(T.max()):.0f} K "
          f"(valid={bool(valid.all())})")

    # --- 3. equilibrium chemistry (TEA equivalent) ---------------------
    from bart_tpu_torch.chem.tea import equilibrium_abundances
    from bart_tpu_torch.chem.thermo_tables import builtin_tables
    from bart_tpu_torch.io.abundances import read_elements

    species = ["H", "He", "C", "O", "H2", "CO", "CO2", "CH4", "H2O"]
    elems = read_elements(os.path.join(HERE, "abundances.txt"))
    tables = builtin_tables(species)          # shipped GRI-Mech NASA-7 data
    q_eq = equilibrium_abundances(
        species, ["H", "He", "C", "O"], pressure, T[0].cpu().numpy(), elems,
        g_tables=tables,
    )
    print(f"equilibrium: CH4/CO at 1 bar = "
          f"{q_eq[-10, species.index('CH4')]:.2e} / "
          f"{q_eq[-10, species.index('CO')]:.2e}")

    # --- 4. a line list + opacity grid (pylineread + --justOpacity) ----
    from bart_tpu_torch.linelist.tli import synthetic_linelist
    from bart_tpu_torch.opacity.grid import build_opacity_grid

    lines = synthetic_linelist("CH4", float(wn[0]), float(wn[-1]), 800,
                               seed=1)
    grid = build_opacity_grid({"CH4": lines}, wn,
                              np.arange(400.0, 3001.0, 325.0), pressure,
                              device=dev)
    print(f"opacity grid: sigma{tuple(grid.sigma.shape)}")

    # --- 5. the forward model (BARTfunc + transit equivalents) ---------
    from bart_tpu_torch.io.kurucz import blackbody_star
    from bart_tpu_torch.obs.bands import build_band_matrix
    from bart_tpu_torch.rt.forward import ForwardConfig, ForwardModel

    centers = np.linspace(wn[0] + 60, wn[-1] - 60, 6)
    filters = [(np.linspace(c - 50, c + 50, 41), np.ones(41))
               for c in centers]
    starfl, _ = blackbody_star(wn, system.t_star)
    bands = build_band_matrix(wn, filters, star_flux=starfl,
                              rprs=system.rprs, device=dev)
    fm = ForwardModel(
        ForwardConfig(solution="eclipse", pt_type="line", molfit=("CH4",)),
        wn_grid=wn, pressure=pressure, species=["H2", "He", "CH4"],
        base_abundances=np.tile([0.85, 0.149, 1e-3], (len(pressure), 1)),
        opacity=grid, system=system, bands=bands, device=dev,
    )
    pinit = np.array([-2.0, 0.0, 1.0, 0.0, 0.98, -0.5])
    truth = torch.tensor(pinit[None], dtype=fm.dtype, device=dev)
    # one CUDA graph replay a call on the card (bart_tpu's jitted())
    forward = fm.graphed() if dev.type == "cuda" else fm.batched()
    bandflux = forward(truth)[0][0].double().cpu().numpy()
    print(f"forward model: {bands.nfilters} band depths: "
          + " ".join(f"{x:.9e}" for x in bandflux))

    # --- 6. a tiny retrieval (MC3 equivalent) --------------------------
    from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace
    from bart_tpu_torch.inference.retrieval import run_mcmc

    uncert = 0.03 * bandflux
    space = ParamSpace(
        pinit=pinit, pmin=[-5, -2, -2, 0, 0.55, -6],
        pmax=[-1, 1, 1, 1, 1.2, 1.5],
        stepsize=[0.1, 0.0, 0.0, 0.0, 0.01, 0.1],  # fit kappa, beta, CH4
    )
    like = Likelihood(fm, space, bandflux, uncert)
    result = run_mcmc(like, space, nchains=8, numit=4000, burnin=100,
                      walk="snooker", seed=1, verbose=False, grtest=False)
    print(f"retrieval: best-fit {result.bestp} vs truth "
          f"{pinit[space.ifree]}  (kappa and the CH4 factor are "
          f"degenerate at this S/N: the posterior is wide along that "
          f"direction, as a pairwise plot shows)")
    print(f"best loglike {result.best_loglike:.2f}, "
          f"accept rate {result.accept_rate:.2f}")
    print("quickstart OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
