"""The forward model: parameters -> band fluxes, batched over chains
(port of bart_tpu/rt/forward.py, gridded opacity, K=1, eclipse, direct
and transit geometry, with CIA, Rayleigh and gray-cloud rows).

    bandflux [C, nfilt], spectrum [C, W], valid [C] = fm(params [C, n])

Parameter layout as the reference (BARTfunc.py:173-179):
[ PT params (nPT) | radius [km] (transit only) | cloudtop [bar] |
  log10 Rayleigh factor | log10 abundance factors (nmolfit) ].
Invalid samples (T outside [tmin, tmax], scaled metals summing above 1,
the optional energy-balance veto) are computed on clipped profiles and
flagged: nothing is skipped by value, so every call has the same shapes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bart_tpu import constants as const
from bart_tpu_torch.device import resolve_device
from bart_tpu_torch.obs.bands import BandMatrix, band_integrate
from bart_tpu_torch.opacity.cia import LOSCHMIDT, CiaTable, cia_weights
from bart_tpu_torch.opacity.cloud import (cloud_deck_extinction,
                                          extended_cloud_extinction)
from bart_tpu_torch.opacity.grid import OpacityGrid
from bart_tpu_torch.opacity.rayleigh import h2_rayleigh_cross_section
from bart_tpu_torch.physics.hydro import anchor_index, radius_profile
from bart_tpu_torch.physics.pt import n_pt_params, pt_generator
from bart_tpu_torch.rt.eclipse import expsum_weights, raygrid_weights
from bart_tpu_torch.rt.fused import (fused_eclipse, fused_transit,
                                     interp_weights)
from bart_tpu_torch.rt.transit_geom import slant_geometry

__all__ = ["ForwardModel", "ForwardConfig"]


@dataclasses.dataclass(frozen=True)
class ForwardConfig:
    """Static configuration (bart_tpu.rt.forward.ForwardConfig)."""

    solution: str = "eclipse"        # 'eclipse' | 'transit' | 'direct'
    pt_type: str = "line"
    molfit: tuple = ()               # species whose abundances are fitted
    tmin: float = 400.0
    tmax: float = 3000.0
    cloudtop: bool = False
    cloudrad: tuple | None = None
    cloudext: float = 0.0
    scattering: str | None = None
    ebalance: bool = False
    refpress: float = 0.1            # p0 [bar] where R(p0) = Rp
    raygrid: tuple = (0.0, 20.0, 40.0, 60.0, 80.0)
    quadrature: str = "raygrid"      # 'raygrid' | 'expsum'
    nquad: int = 8
    tint: float = 100.0
    tint_type: str = "const"

    @property
    def n_radfit(self) -> int:
        return int(self.solution == "transit")

    @property
    def n_cloud(self) -> int:
        return int(self.cloudtop)

    @property
    def n_ray(self) -> int:
        return int(self.scattering is not None)

    @property
    def n_pt(self) -> int:
        return n_pt_params[self.pt_type]

    @property
    def n_params(self) -> int:
        return (self.n_pt + self.n_radfit + self.n_cloud + self.n_ray
                + len(self.molfit))


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"ForwardModel: {what} is not ported yet (ROADMAP queue 1, {item})")


class ForwardModel:
    """Static tables on ``device`` plus the batched forward function.

    The tables live in one dict (``tables``) under bart_tpu's keys, so a
    model can also run on tables carried over from the JAX package
    (``tables_from_jax``).
    """

    def __init__(self, config: ForwardConfig, *, wn_grid: np.ndarray,
                 pressure: np.ndarray, species: list[str],
                 base_abundances: np.ndarray, opacity: OpacityGrid,
                 system, bands: BandMatrix,
                 cia_tables: list[CiaTable] = (),
                 species_masses: np.ndarray | None = None,
                 fold_osamp: int = 1,
                 device: str | torch.device = "cpu",
                 dtype: torch.dtype = torch.float32):
        cfg = config
        if int(fold_osamp) > 1:
            raise _not_ported("folded rtosamp (fold_osamp > 1)", "item 13")
        if cfg.solution not in ("eclipse", "direct", "transit"):
            raise ValueError(f"unknown solution {cfg.solution!r}")
        if not isinstance(opacity, OpacityGrid):
            raise _not_ported("on-the-fly line-tile opacity", "item 11")
        if cfg.pt_type != "line":
            raise _not_ported(f"PT model {cfg.pt_type!r}", "item 3")

        self.config = cfg
        self.system = system
        self.bands = bands
        self.opacity = opacity
        self.device = resolve_device(device)
        self.dtype = dtype
        dev = self.device

        def t_(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        sp = np.asarray(species)
        self.species = list(species)
        self.i_h2 = int(np.where(sp == "H2")[0][0])
        self.i_he = int(np.where(sp == "He")[0][0])
        self.i_metals = np.where(
            (sp != "He") & (sp != "H2") & (sp != "H-") & (sp != "e-"))[0]
        self.i_molfit = np.array(
            [int(np.where(sp == m)[0][0]) for m in cfg.molfit], int)
        self.i_opac = np.array(
            [int(np.where(sp == m)[0][0]) for m in opacity.species], int)
        if species_masses is None:
            from bart_tpu.linelist.molecules import get_molecule

            species_masses = np.array([get_molecule(s).mass
                                       for s in species])

        base_abundances = np.asarray(base_abundances, np.float64)
        self.t_min = float(opacity.t_grid[0])
        self.t_step = float(opacity.t_grid[1] - opacity.t_grid[0])
        self.n_t = len(opacity.t_grid)
        if cfg.quadrature == "expsum":
            mu, w = expsum_weights(cfg.nquad)
            self._powers = True
        elif cfg.quadrature == "raygrid":
            mu, w = raygrid_weights(cfg.raygrid)
            self._powers = False
        else:
            raise ValueError(f"quadrature must be 'raygrid' or 'expsum', "
                             f"got {cfg.quadrature!r}")

        self._tables = {
            "wn": t_(wn_grid),
            "pressure": t_(pressure),
            "p_barye": t_(np.asarray(pressure) * const.BAR_TO_BARYE),
            "base_q": t_(base_abundances),
            "h2he_ratio": t_(base_abundances[:, self.i_h2]
                             / base_abundances[:, self.i_he]),
            "masses": t_(species_masses),
            "sigma": opacity.sigma.to(device=dev, dtype=dtype),
            "mu": t_(mu),
            "mu_w": t_(w),
            "band_w": bands.weights.to(device=dev, dtype=dtype),
        }

        # CIA collider indices and tables (reference cia.c)
        self.cia_idx = []
        for k, tab in enumerate(cia_tables):
            self.cia_idx.append(
                tuple(int(np.where(sp == s)[0][0]) for s in tab.species))
            self._tables[f"cia{k}_temps"] = t_(tab.temps)
            self._tables[f"cia{k}_wn"] = t_(tab.wn)
            self._tables[f"cia{k}_abs"] = t_(tab.absorption)

        # Continuum rows of the rows contraction, on the host in float64:
        # each CIA table's T-nodes interpolated to the wn grid, the H2
        # Rayleigh cross-section, a row of ones per gray cloud.
        wn64 = np.asarray(wn_grid, np.float64)
        nL, nW = len(pressure), len(wn64)
        rows = []
        for tab in cia_tables:
            wn_interp = np.stack([
                np.interp(wn64, np.asarray(tab.wn, np.float64),
                          np.asarray(row, np.float64), left=0.0, right=0.0)
                for row in np.asarray(tab.absorption)])
            rows.append(np.broadcast_to(wn_interp[:, None, :],
                                        (len(tab.temps), nL, nW)))
        if cfg.scattering is not None:
            rows.append(np.broadcast_to(
                h2_rayleigh_cross_section(wn64)[None, None, :], (1, nL, nW)))
        if cfg.cloudtop:
            rows.append(np.ones((1, nL, nW)))
        if cfg.cloudrad is not None and cfg.cloudext:
            rows.append(np.ones((1, nL, nW)))
        if rows:
            self._tables["frows"] = t_(np.concatenate(rows, axis=0))
        self.i0 = anchor_index(pressure, cfg.refpress)
        self.r0_km = system.r_planet / 1000.0
        self.g0_si = system.g_planet_si
        self.pt_args = [system.r_star, system.t_star, cfg.tint, system.sma,
                        system.g_planet_cgs, cfg.tint_type]

    # -----------------------------------------------------------------
    @property
    def tables(self) -> dict[str, torch.Tensor]:
        return self._tables

    @property
    def sigma(self) -> torch.Tensor:
        return self._tables["sigma"]

    def tables_from_jax(self, numpy_tables: dict) -> dict[str, torch.Tensor]:
        """Carry bart_tpu ForwardModel tables (as numpy arrays) over to
        this model: the opacity table, band weights, base abundances,
        quadrature and the rest, on this model's device and dtype.
        Raises if the keys or shapes differ from this model's."""
        mine = self._tables
        if set(numpy_tables) != set(mine):
            raise ValueError(
                f"table keys differ: missing {sorted(set(mine) - set(numpy_tables))}, "
                f"unexpected {sorted(set(numpy_tables) - set(mine))}")
        out = {}
        for k, v in numpy_tables.items():
            a = np.asarray(v)
            if a.shape != tuple(mine[k].shape):
                raise ValueError(f"table {k!r} has shape {a.shape}, this "
                                 f"model needs {tuple(mine[k].shape)}")
            out[k] = torch.tensor(a, dtype=self.dtype,
                                     device=self.device)
        return out

    def __call__(self, params: torch.Tensor,
                 tables: dict[str, torch.Tensor] | None = None):
        """params [C, n_params] -> (bandflux [C, nfilt], spectrum [C, W],
        valid [C] bool)."""
        t = self._tables if tables is None else tables
        cfg = self.config
        if params.dim() != 2 or params.shape[-1] != cfg.n_params:
            raise ValueError(
                f"params has shape {tuple(params.shape)}; config "
                f"{cfg.solution}/{cfg.pt_type} with molfit={cfg.molfit} "
                f"expects [C, {cfg.n_params}]")
        params = params.to(device=self.device, dtype=self.dtype)
        T_safe, q, rad_cm, valid = self._profiles(params, t)
        spectrum = self._spectrum(params, t, T_safe, q, rad_cm)

        if cfg.ebalance and cfg.solution in ("eclipse", "direct"):
            # energy-balance veto (BARTfunc.py:366-383)
            sysm = self.system
            e_in = (const.SIGMA_SB * sysm.t_star**4 * sysm.r_star**2
                    * np.pi * sysm.r_planet**2 / sysm.sma**2
                    * const.JOULE_TO_ERG)
            e_out = torch.trapezoid(spectrum, t["wn"], dim=-1) * 4.0 * (
                sysm.r_planet * 100.0) ** 2
            valid = valid & (e_out <= e_in)

        bandflux = band_integrate(t["band_w"], spectrum)
        return bandflux, spectrum, valid

    def batched(self):
        """The forward over a chain batch as a plain callable."""
        return lambda batch: self(batch)

    # -----------------------------------------------------------------
    def _profiles(self, params: torch.Tensor, t: dict):
        """params [C, n] -> (T [C, L], q [C, L, S], radius [C, L] cm,
        valid [C])."""
        cfg = self.config
        nPT = cfg.n_pt
        pressure = t["pressure"]

        # 1. temperature profile (BARTfunc.py:320-330)
        T, valid = pt_generator(pressure, params[:, :nPT], cfg.pt_type,
                                self.pt_args)
        T = T.to(self.dtype)
        valid = valid & torch.all((T >= cfg.tmin) & (T <= cfg.tmax), dim=1)
        T_safe = torch.clamp(T, cfg.tmin, cfg.tmax)

        # 2. abundance scaling + H2/He renormalisation (BARTfunc.py:332-347)
        base_q = t["base_q"]
        C = params.shape[0]
        q = base_q.expand(C, *base_q.shape).clone()
        off = nPT + cfg.n_radfit + cfg.n_cloud + cfg.n_ray
        for k, im in enumerate(self.i_molfit):
            q[:, :, im] = base_q[:, im] * 10.0 ** params[:, off + k, None]
        qfree = 1.0 - torch.sum(q[:, :, self.i_metals], dim=2)
        valid = valid & torch.all(qfree >= 0.0, dim=1)
        qfree_safe = torch.clamp(qfree, min=0.0)
        r = t["h2he_ratio"]
        q[:, :, self.i_h2] = r * qfree_safe / (1.0 + r)
        q[:, :, self.i_he] = qfree_safe / (1.0 + r)

        # 3. hydrostatic radii, re-derived per sample, anchored at the
        #    fitted radius in transit (set_radius, BARTfunc.py:351)
        mmm = torch.matmul(q, t["masses"])                          # [C, L]
        r0 = params[:, nPT] if cfg.n_radfit else self.r0_km
        rad_km = radius_profile(pressure, T_safe, mmm, cfg.refpress,
                                r0, self.g0_si, i0=self.i0)
        return T_safe, q, rad_km * const.KM_TO_CM, valid

    def _fused_rows(self, params: torch.Tensor, t: dict, T_safe, q, rad_cm):
        """(tab [R, L, W], wrows [C, L, R]): the extinction as one rows
        contraction.  Columns in bart_tpu's order: line rows (molecule x
        T-node), CIA T-node rows, Rayleigh, cloud deck, extended cloud;
        the weight formulas mirror the unfused extinction term by term."""
        cfg = self.config
        nPT = cfg.n_pt
        sigma = t["sigma"]
        M, nT, L, W = sigma.shape
        C = T_safe.shape[0]
        n_tot = t["p_barye"] / (const.K_BOLTZ * T_safe)           # [C, L]
        n_mol = q[:, :, self.i_opac] * n_tot[..., None]           # [C, L, M]
        w_t = interp_weights(self.n_t, self.t_min, self.t_step, T_safe)
        cols = [(n_mol[..., None] * w_t[:, :, None, :]).reshape(C, L, M * nT)]

        for k, (i1, i2) in enumerate(self.cia_idx):
            n1n2 = (q[:, :, i1] * n_tot / LOSCHMIDT) * (
                q[:, :, i2] * n_tot / LOSCHMIDT)
            cols.append(cia_weights(t[f"cia{k}_temps"], T_safe)
                        * n1n2[..., None])

        if cfg.scattering is not None:
            if cfg.scattering == "polar":                 # mode 2, unscaled
                factor = torch.ones_like(T_safe[:, 0])
            else:                                         # mode 1: 10^param
                factor = 10.0 ** params[:, nPT + cfg.n_radfit + cfg.n_cloud]
            cols.append((factor[:, None] * q[:, :, self.i_h2]
                         * n_tot)[..., None])

        if cfg.cloudtop:
            ctop = params[:, nPT + cfg.n_radfit]          # top pressure [bar]
            cols.append(cloud_deck_extinction(
                t["pressure"], torch.log10(torch.clamp(ctop, min=1e-30)), 1))

        if cfg.cloudrad is not None and cfg.cloudext:
            cols.append(extended_cloud_extinction(
                rad_cm / const.KM_TO_CM, cfg.cloudrad[0], cfg.cloudrad[1],
                cfg.cloudext)[..., None])

        tab = sigma.reshape(M * nT, L, W)
        if "frows" in t:
            tab = torch.cat([tab, t["frows"]], dim=0)
        return tab, torch.cat(cols, dim=2)

    def _spectrum(self, params, t, T_safe, q, rad_cm):
        """Extinction rows -> geometry -> spectrum [C, W] through the
        fused eclipse or transit kernel."""
        tab, wrows = self._fused_rows(params, t, T_safe, q, rad_cm)
        if self.config.solution == "transit":
            G, wgt = slant_geometry(rad_cm)
            absorbed = fused_transit(tab, wrows, G, wgt)
            return (rad_cm[:, -1:] ** 2 + absorbed) / (
                self.system.r_star * 100.0) ** 2
        dr = rad_cm[:, :-1] - rad_cm[:, 1:]
        drp = torch.cat([torch.zeros_like(dr[:, :1]), dr], dim=1)
        return fused_eclipse(tab, t["wn"], t["mu"], t["mu_w"], wrows,
                             T_safe, drp, powers=self._powers)
