"""The staged retrieval pipeline (port of bart_tpu/driver/pipeline.py).

Equivalent of the reference driver BART.py's main flow (reference:
BART.py:36-651, call stack in SURVEY.md section 3.1): pressure grid ->
abundances -> initial PT -> atmosphere (uniform or equilibrium) ->
line list -> opacity grid -> MCMC -> post-processing, with the same
stage gating:

* file-presence resume (the reference's runMCMC bitmask,
  BART.py:464-493): a stage whose output file exists is skipped;
* ``--justTEA`` stops after the atmosphere (BART.py:548-550);
* ``--justOpacity`` stops after the opacity grid (BART.py:571-573);
* ``--justPlots`` re-runs only post-processing (BART.py:599);
* ``--resume`` continues into an existing output directory.

The files each stage writes are bart_tpu's, so either package can pick
up a directory the other filled.  The host stages (pressure,
abundances, equilibrium chemistry, line list) run in numpy as
bart_tpu's do; the initial PT profile and radii, the opacity build, the
forward model and the MCMC run on ``device``, the card unless the
caller asks for the CPU.  matplotlib is imported by the post stage
only.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from bart_tpu_torch.device import resolve_device
from bart_tpu_torch.driver.config import RetrievalConfig, load_data_array

__all__ = ["Pipeline"]


class Pipeline:
    def __init__(
        self,
        cfg: RetrievalConfig,
        just_tea: bool = False,
        just_opacity: bool = False,
        just_plots: bool = False,
        just_spectrum: bool = False,
        resume: bool = False,
        *,
        device: str | torch.device = "cuda",
        dtype: torch.dtype = torch.float32,
    ):
        self.cfg = cfg
        self.just_tea = just_tea
        self.just_opacity = just_opacity
        self.just_plots = just_plots
        self.just_spectrum = just_spectrum
        self.resume = resume
        self.device = resolve_device(device)
        self.dtype = dtype
        self.date_dir = os.path.abspath(cfg.loc_dir)
        os.makedirs(self.date_dir, exist_ok=True)

    def log(self, msg: str) -> None:
        if not self.cfg.quiet:
            print(f"[bart_tpu_torch] {msg}")

    # -- stage helpers -------------------------------------------------
    def _out(self, name: str | None, default: str) -> str:
        name = name or default
        if not os.path.isabs(name):
            name = os.path.join(self.date_dir, os.path.basename(name))
        return name

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def run(self):
        from bart_tpu_torch.utils.profiling import stage_timer

        cfg = self.cfg
        os.makedirs(self.date_dir, exist_ok=True)
        tlog = os.path.join(self.date_dir, "stage_timing.jsonl")
        quiet = cfg.quiet

        def timer(name):
            return stage_timer(name, tlog, not quiet, self.device)

        if cfg.molfile:
            # user molecular data extends/overrides the registry
            # (reference `molfile` -> transit/inputs/molecules.dat,
            # scripts/broadening.py:146-188)
            from bart_tpu_torch.linelist.molecules import register_molecules

            register_molecules(cfg.molfile)
            self.log(f"molfile: registered species from {cfg.molfile}")

        with timer("pressure"):
            pressure = self.stage_pressure()
        with timer("abundances"):
            elems = self.stage_abundances()
        with timer("atmosphere"):
            atm = self.stage_atmosphere(pressure, elems)
        if self.just_tea:
            self.log("--justTEA: stopping after atmosphere generation.")
            return atm

        wn = cfg.wavenumber_grid()
        # folded rtosamp: the opacity table lives on the K-times-finer
        # midpoint grid; outputs/bands stay on `wn` (the folded kernels
        # average each bin's sub-samples)
        if cfg.fold_K > 1:
            from bart_tpu_torch.utils.grids import folded_fine_grid

            wn_rt = folded_fine_grid(wn, cfg.fold_K)
        else:
            wn_rt = wn
        with timer("linelist"):
            tli = self.stage_linelist(wn_rt)
        with timer("opacity"):
            grid = self.stage_opacity(tli, wn_rt, pressure, atm)
        if self.just_opacity:
            self.log("--justOpacity: stopping after opacity table.")
            return grid
        if self.just_spectrum:
            with timer("spectrum"):
                return self.stage_spectrum(atm, wn, grid)

        with timer("forward_setup"):
            fm, like, space = self.stage_forward(atm, wn, grid)
        if cfg.fold_K > 1:
            # a folded model keeps its own tables (bin-mean, folded and
            # smooth): the fine table is not read again, so let it go
            fm.opacity = grid = None
        if self.just_plots:
            result = None
        else:
            with timer("mcmc"):
                result = self.stage_mcmc(like, space)
        if cfg.plots:
            with timer("post"):
                self.stage_post(fm, like, space, result)
        return result

    # ------------------------------------------------------------------
    def stage_pressure(self) -> np.ndarray:
        """Pressure grid (BART.py:497-499 / makeP)."""
        from bart_tpu_torch.utils.grids import (
            pressure_grid, read_pressure_file, write_pressure_file,
        )

        cfg = self.cfg
        path = self._out(cfg.press_file, "atm.pres")
        if os.path.isfile(path) and (self.resume or cfg.press_file):
            self.log(f"pressure grid: reusing {path}")
            return read_pressure_file(path)
        p = pressure_grid(cfg.n_layers, cfg.p_top, cfg.p_bottom, cfg.log)
        write_pressure_file(p, path)
        self.log(f"pressure grid: {cfg.n_layers} layers "
                 f"{cfg.p_top:g}-{cfg.p_bottom:g} bar -> {path}")
        return p

    def stage_abundances(self):
        """Elemental abundances with metallicity/COswap
        (BART.py:512-515 / makeAbun)."""
        from bart_tpu_torch.io.abundances import (
            read_elements, scale_abundances, write_elements,
        )

        cfg = self.cfg
        table = read_elements(cfg.abun_basic)
        table = scale_abundances(table, cfg.solar_times, cfg.COswap)
        path = self._out(cfg.abun_file, "abundances.abn")
        write_elements(table, path)
        return table

    def stage_atmosphere(self, pressure: np.ndarray, elems):
        """Atmosphere file: uniform or thermochemical equilibrium
        (BART.py:502-546).  The initial PT profile and the hydrostatic
        radii are computed on the device; the validity flag is read once,
        at set-up."""
        from bart_tpu_torch.io.atm import (Atmosphere, read_atm,
                                           write_atm_transit)
        from bart_tpu_torch.io.tep import PlanetSystem
        from bart_tpu_torch.physics import pt as pt_mod
        from bart_tpu_torch.physics.hydro import radius_profile
        from bart_tpu_torch.physics.stoich import mean_molar_mass, strip_janaf

        cfg = self.cfg
        path = self._out(cfg.atmfile, "atmosphere.atm")
        if os.path.isfile(path):
            self.log(f"atmosphere: reusing {path}")
            return read_atm(path)

        system = PlanetSystem.from_tep(cfg.tep_name)
        species = [strip_janaf(s) for s in cfg.out_spec.split()]

        # initial PT profile (InitialPT.initialPT2 equivalent,
        # BART.py:519-526): PTinit params, else the PT block of params.
        pt_params = cfg.PTinit
        if pt_params is None and cfg.params is not None:
            pt_params = cfg.params[: pt_mod.n_pt_params[cfg.PTtype]]
        if pt_params is None:
            raise ValueError("need PTinit or params to build the initial "
                             "PT profile")
        if cfg.PTtype == "line":
            pt_args = [system.r_star, system.t_star, cfg.tint, system.sma,
                       system.g_planet_cgs, cfg.tint_type]
        else:
            pt_args = None
        p_t = self._t(pressure)
        T_t, valid = pt_mod.pt_generator(p_t, self._t(pt_params)[None],
                                         cfg.PTtype, pt_args)
        if not bool(valid[0]):
            raise ValueError("initial PT parameters give a non-physical "
                             "profile")
        T = T_t[0].cpu().numpy()

        if cfg.uniform is not None:
            # uniform-abundance path (BART.py:502-510 / makeatm.uniform)
            q = np.tile(np.asarray(cfg.uniform, np.float64),
                        (len(pressure), 1))
        else:
            # thermochemical equilibrium (TEA subprocess replacement),
            # float64 numpy on the host
            from bart_tpu_torch.chem.tea import equilibrium_abundances

            g_tables = None
            if cfg.thermofile:
                # JANAF-grade tabulated thermochemistry (reference:
                # TEA readJANAF.py; SURVEY.md 2.4) — NASA-7 file or
                # the shipped GRI-Mech data ('builtin')
                from bart_tpu_torch.chem.thermo_tables import builtin_tables

                tpath = (None if cfg.thermofile.lower() == "builtin"
                         else cfg.thermofile)
                g_tables = builtin_tables(species, path=tpath)
                self.log(f"thermochemistry: tables from "
                         f"{cfg.thermofile} ({len(g_tables)} species)")
            self.log("TEA-equivalent equilibrium chemistry...")
            q = equilibrium_abundances(
                species, cfg.in_elem.split(), pressure, T, elems,
                maxiter=cfg.maxiter, g_tables=g_tables,
            )

        mu = mean_molar_mass(species, q, elems)
        rad = radius_profile(
            p_t, T_t, self._t(mu)[None], cfg.refpress,
            system.r_planet / 1000.0, system.g_planet_si,
        )[0].cpu().numpy()
        atm = Atmosphere(species, pressure, T, q, rad)
        write_atm_transit(atm, path)
        self.log(f"atmosphere: {len(species)} species -> {path}")
        return atm

    def stage_linelist(self, wn: np.ndarray):
        """Line database (pylineread/TLI equivalent, SURVEY.md 3.5)."""
        from bart_tpu_torch.linelist import tli as tli_mod
        from bart_tpu_torch.linelist.hitran import read_par

        cfg = self.cfg
        if cfg.linedb is None:
            self.log("no linedb given — continuum-only opacity")
            return tli_mod.TliData([], {}, float(wn[0]), float(wn[-1]))
        if cfg.linedb.endswith((".npz", ".tli")):
            data = tli_mod.load_tli(cfg.linedb)
        else:  # HITRAN .par directly
            lists = read_par(cfg.linedb)
            data = tli_mod.TliData(
                list(lists), lists, float(wn[0]), float(wn[-1])
            )
        # trim to the spectrum range plus wing margin:
        for name in data.species:
            data.lines[name] = data.lines[name].trim(
                float(wn[0]) - 30.0, float(wn[-1]) + 30.0
            )
        self.log(f"line list: {data.total_lines()} lines, "
                 f"{list(data.lines)}")
        return data

    def stage_opacity(self, tli, wn: np.ndarray, pressure: np.ndarray,
                      atm=None):
        """Opacity grid build/reuse (BART.py:560-569), built on the
        device; ``osamp`` > 1 stores bin-averaged cross-sections."""
        from bart_tpu_torch.opacity.grid import (build_budget,
                                                 build_opacity_grid,
                                                 load_grid, save_grid)

        cfg = self.cfg
        path = self._out(cfg.opacityfile, "opacity.npz")
        if not path.endswith(".npz"):
            path = path + ".npz"
        if os.path.isfile(path):
            self.log(f"opacity grid: reusing {path}")
            return load_grid(path, device=self.device)

        lines = {k: v for k, v in tli.lines.items()}
        t_grid = np.arange(cfg.tlow, cfg.thigh + cfg.tempdelt / 2,
                           cfg.tempdelt)
        t0 = time.time()
        grid = build_opacity_grid(
            lines, wn, t_grid, pressure,
            spec=self._broadening(atm),
            nwidth=cfg.nwidth, ethresh=cfg.ethresh,
            q_tables=getattr(tli, "partition", None) or {},
            budget_bytes=build_budget(self.device), osamp=cfg.osamp,
            device=self.device, dtype=self.dtype,
        )
        save_grid(grid, path)
        self.log(f"opacity grid {tuple(grid.sigma.shape)} built "
                 f"in {time.time()-t0:.1f}s -> {path}")
        return grid

    def _broadening(self, atm):
        """Collision-broadening bath from the baseline atmosphere's own
        H2/He mixing ratios (reference reads them from the atm file,
        code/BARTfunc.py:189-201); defaults when no atm is available."""
        from bart_tpu_torch.opacity.extinction import BroadeningSpec

        if atm is None:
            return BroadeningSpec()
        spec = BroadeningSpec.from_abundances(atm.species, atm.abundances)
        self.log(f"broadening bath from atm: q_H2={spec.q_h2:.4f} "
                 f"q_He={spec.q_he:.4f}")
        return spec

    def stage_spectrum(self, atm, wn: np.ndarray, grid):
        """One-shot spectrum from the atm file's own profiles — the
        standalone `transit -c cfg` use case (reference SURVEY.md 2.2:
        transit CLI without BART's MCMC around it), through the fused
        kernels.  Writes the outspec-format file and returns
        (wn, spectrum)."""
        from bart_tpu_torch import constants as const

        fm = self._build_forward(atm, wn, grid)
        rad = (None if atm.radius is None
               else atm.radius[None] * const.KM_TO_CM)
        spectrum = fm.spectrum_from_profiles(
            atm.temperature[None], atm.abundances[None], rad
        )[0].cpu().numpy()
        path = self._out(self.cfg.outspec, "spectrum.dat")
        with open(path, "w") as f:
            f.write("#wvl [um]    flux/modulation\n")
            for w, s in zip(wn[::-1], spectrum[::-1]):
                f.write(f"{1e4/w:.7e}  {s:.7e}\n")
        self.log(f"--justSpectrum: {len(wn)} samples -> {path}")
        return wn, spectrum

    def stage_forward(self, atm, wn: np.ndarray, grid):
        """Forward model + likelihood assembly (BARTfunc init
        equivalent)."""
        from bart_tpu_torch.inference.likelihood import Likelihood, ParamSpace

        cfg = self.cfg
        fm = self._build_forward(atm, wn, grid)

        cfgdir = self.date_dir
        data = load_data_array(cfg.data, cfgdir)
        uncert = load_data_array(cfg.uncert, cfgdir)
        if data is None and cfg.walk == "unif":
            # the reference synthesizes dummy data for unif sweeps
            # (makecfg.py:178-190)
            data = np.zeros(fm.bands.nfilters)
            uncert = np.ones(fm.bands.nfilters)
        if data is None:
            raise ValueError("no data given (and walk != 'unif')")

        space = ParamSpace(
            pinit=cfg.params, pmin=cfg.pmin, pmax=cfg.pmax,
            stepsize=cfg.stepsize, pnames=cfg.parnames,
        )
        like = Likelihood(fm, space, data, uncert, wlike=cfg.wlike)
        return fm, like, space

    def _build_forward(self, atm, wn: np.ndarray, grid):
        """Construct the ForwardModel (tables, bands, CIA, geometry) on
        the device."""
        from bart_tpu_torch.io.filters import read_filter
        from bart_tpu_torch.io.kurucz import (blackbody_star,
                                              read_kurucz_pck, stellar_flux)
        from bart_tpu_torch.io.tep import PlanetSystem
        from bart_tpu_torch.obs.bands import build_band_matrix
        from bart_tpu_torch.opacity.cia import read_cia, read_cia_hitran
        from bart_tpu_torch.rt.forward import ForwardConfig, ForwardModel

        cfg = self.cfg
        system = PlanetSystem.from_tep(cfg.tep_name)
        filters = [read_filter(f) for f in (cfg.filters or [])]
        if not filters:
            # spectrum-only runs need no filters; band-integrate a
            # dummy boxcar so the model contract holds
            fw = np.linspace(wn[2], wn[-3], 64)
            filters = [(fw, np.ones_like(fw))]

        starfl = None
        if cfg.solution in ("eclipse", "transit"):
            if cfg.kurucz and os.path.isfile(cfg.kurucz):
                kgrid = read_kurucz_pck(cfg.kurucz)
                sf, swn, tmod, gmod = stellar_flux(
                    kgrid, system.t_star, system.logg_star
                )
                starfl = np.interp(wn, swn, sf)
                self.log(f"stellar model: Kurucz T={tmod} logg={gmod}")
            else:
                starfl, _ = blackbody_star(wn, system.t_star)
                self.log("stellar model: blackbody (no Kurucz grid)")

        dd = dict(device=self.device, dtype=self.dtype)
        if cfg.solution == "eclipse":
            bands = build_band_matrix(wn, filters, star_flux=starfl,
                                      rprs=system.rprs, **dd)
        else:
            bands = build_band_matrix(wn, filters, **dd)

        cia_tables = []
        for path in cfg.csfile or []:
            try:
                cia_tables.append(read_cia(path))
            except ValueError:
                cia_tables.append(read_cia_hitran(path))

        fconfig = ForwardConfig(
            solution=cfg.solution,
            pt_type=cfg.PTtype,
            molfit=tuple(cfg.molfit or ()),
            tmin=cfg.Tmin, tmax=cfg.Tmax,
            cloudtop=cfg.cloudtop is not None,
            cloudrad=(tuple(np.asarray(cfg.cloudrad) * cfg.cloudfct / 1e5)
                      if cfg.cloudrad is not None else None),
            cloudext=cfg.cloudext,
            scattering=("polar" if isinstance(cfg.scattering, str)
                        and "polar" in cfg.scattering
                        else ("ray" if cfg.scattering is not None else None)),
            ebalance=cfg.ebalance,
            refpress=cfg.refpress,
            raygrid=tuple(cfg.raygrid) if cfg.raygrid is not None
                    else (0.0, 20.0, 40.0, 60.0, 80.0),
            quadrature=cfg.quadrature, nquad=cfg.nquad,
            tint=cfg.tint, tint_type=cfg.tint_type,
        )
        fm = ForwardModel(
            fconfig, wn_grid=wn, pressure=atm.pressure, species=atm.species,
            base_abundances=atm.abundances, opacity=grid, system=system,
            bands=bands, cia_tables=cia_tables,
            fold_osamp=cfg.fold_K,
            fold_adapt=(0.02 if cfg.rtadapt else None),
            fold_bf16=cfg.foldtable16, **dd,
        )
        if cfg.fold_K > 1:
            self.log(f"folded rtosamp: {cfg.fold_K} sub-samples per "
                     f"{cfg.wndelt} cm-1 bin, in-kernel averaging")
        self.store = dict(system=system, starfl=starfl, filters=filters)
        return fm

    def stage_mcmc(self, like, space):
        """The retrieval itself (BART.py:576-580 mpiexec equivalent): on
        a card every block replays one captured step."""
        from bart_tpu_torch.inference.retrieval import run_mcmc

        cfg = self.cfg
        return run_mcmc(
            like, space,
            nchains=cfg.nchains, numit=cfg.numit, burnin=cfg.burnin,
            walk=cfg.walk, thinning=cfg.thinning,
            grtest=cfg.grtest, grexit=cfg.grexit, grbreak=cfg.grbreak,
            leastsq=cfg.leastsq, chisqscale=cfg.chisqscale,
            seed=cfg.seed,
            snooker_frac=cfg.snooker_frac, z_thin=cfg.z_thin,
            savefile=os.path.join(self.date_dir, "output.npy"),
            savemodel=(self._out(cfg.savemodel, "models.npy")
                       if cfg.savemodel else None),
            modelper=cfg.modelper,
            checkpoint=os.path.join(self.date_dir, "mcmc_checkpoint.npz"),
            resume=self.resume,
            logfile=os.path.join(self.date_dir, cfg.logfile),
            verbose=not cfg.quiet,
            dtype=self.dtype,
        )

    def stage_post(self, fm, like, space, result):
        """Post-processing: plots + best fit + contribution functions
        (BART.py:599-651)."""
        from bart_tpu_torch.post.bestfit import best_fit_outputs

        cfg = self.cfg
        post_dir = self.date_dir
        if result is None:
            # --justPlots: reload posterior from disk
            from bart_tpu_torch.inference.retrieval import RetrievalResult
            from bart_tpu_torch.post.bestfit import read_mcmc_log

            post = np.load(os.path.join(post_dir, "output.npy"))
            bestp, _ = read_mcmc_log(os.path.join(post_dir, cfg.logfile))
            result = RetrievalResult(
                posterior=post, models=None, bestp=bestp,
                best_loglike=np.nan, accept_rate=np.nan,
                psrf=np.full(space.nfree, np.nan),
                pnames=[space.pnames[i] for i in space.ifree]
                if space.pnames else [f"p{i}" for i in space.ifree],
                space=space, niter_total=post.shape[2], converged=False,
            )
        best_fit_outputs(
            fm, like, space, result, post_dir,
            fext=cfg.fext, store=getattr(self, "store", {}),
            aux=dict(
                savefiles=cfg.savefiles, outtau=cfg.outtau,
                outintens=cfg.outintens, outtoomuch=cfg.outtoomuch,
                outsample=cfg.outsample, toomuch=cfg.toomuch,
            ),
        )
        self.log(f"post-processing written to {post_dir}")
        return result
