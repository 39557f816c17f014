"""The forward model: parameters -> band fluxes, batched over chains
(port of bart_tpu/rt/forward.py: gridded opacity at K = 1 and folded
rtosamp, or on-the-fly line tiles; eclipse, direct and transit geometry,
every PT family, with CIA, Rayleigh and gray-cloud rows).

    bandflux [C, nfilt], spectrum [C, W], valid [C] = fm(params [C, n])

Beside the fused forward, the unfused extinction [C, L, W] of the
post-processing (``diagnostics``: profiles, radii, extinction, valid)
and the spectrum of explicit profiles (``spectrum_from_profiles``, as a
forward computes it).

Parameter layout as the reference (BARTfunc.py:173-179):
[ PT params (nPT) | radius [km] (transit only) | cloudtop [bar] |
  log10 Rayleigh factor | log10 abundance factors (nmolfit) ].
Invalid samples (T outside [tmin, tmax], scaled metals summing above 1,
the optional energy-balance veto) are computed on clipped profiles and
flagged: nothing is skipped by value, so every call has the same shapes.

On-the-fly mode (``opacity`` a {species: LineTiles} dict from
opacity.extinction.tile_lines; the reference's non-gridded extinction):
no table, the Voigt cross-sections of every layer's (T, p) are computed
in each forward (``osamp`` > 1: bin-averaged), as plain torch ops, in
chunks of conditions whose temporaries fit ``budget_bytes``.  The
extinction and the radiative transfer are then the unfused ones
(rt.tau.tau_vertical and rt.eclipse.eclipse_flux, or
rt.transit_geom.transit_depth); no fused kernel runs.

Folded rtosamp (``fold_osamp`` = K > 1, docs/LINE_SAMPLING.md): the
opacity table is tabulated on utils.grids.folded_fine_grid(wn_grid, K)
and the folded kernels average each output bin's K sub-samples after the
exponential.  With ``fold_adapt`` only the bins that have line structure
inside them (opacity.grid.fine_bin_mask) go through the folded kernel;
the smooth bins run the K = 1 kernel on the bin-mean table, and
``_assemble`` puts the two pieces back in wn order.  Each dispatch part's
table (line rows and continuum rows) is assembled once, here, in its
kernel's layout (K = 1: a RowsTable; folded: a FoldedTable), so that a
forward copies no table.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bart_tpu_torch import constants as const
from bart_tpu_torch.device import resolve_device
from bart_tpu_torch.obs.bands import BandMatrix, band_integrate
from bart_tpu_torch.opacity.cia import (LOSCHMIDT, CiaTable, cia_extinction,
                                        cia_weights)
from bart_tpu_torch.opacity.cloud import (cloud_deck_extinction,
                                          extended_cloud_extinction)
from bart_tpu_torch.opacity.extinction import (BroadeningSpec, LineTiles,
                                               cond_bytes,
                                               cross_section_grid)
from bart_tpu_torch.opacity.grid import (OpacityGrid, fine_bin_mask,
                                         interp_opacity)
from bart_tpu_torch.opacity.rayleigh import (h2_rayleigh_cross_section,
                                             rayleigh_extinction)
from bart_tpu_torch.physics.hydro import anchor_index, radius_profile
from bart_tpu_torch.physics.pt import n_pt_params, pt_generator
from bart_tpu_torch.rt.eclipse import (eclipse_flux, expsum_weights,
                                       raygrid_weights)
from bart_tpu_torch.rt.fused import (FoldedTable, RowsTable, folded_table,
                                     fused_eclipse, fused_eclipse_folded,
                                     fused_transit, fused_transit_folded,
                                     interp_weights, prepare_slant,
                                     rows_table, unfold_table)
from bart_tpu_torch.rt.tau import tau_vertical
from bart_tpu_torch.rt.transit_geom import slant_geometry, transit_depth
from bart_tpu_torch.utils.grids import folded_fine_grid

__all__ = ["ForwardModel", "ForwardConfig"]

# the tensors of a LineTiles, held in the tables as lt{k}_<field>
_LT_FIELDS = ("wn_tiles", "grid_mask", "wn0", "s296", "elower", "gamma_air",
              "n_air", "weight")


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


class ForwardModel:
    """Static tables on ``device`` plus the batched forward function.

    The tables live in one dict (``tables``) under bart_tpu's keys, so a
    model can also run on tables carried over from the JAX package
    (``tables_from_jax``).  A K = 1 model holds its one dispatch part's
    table as ``tab`` (a RowsTable: line rows, then continuum rows), of
    which ``sigma`` and ``frows`` are views.  A folded model
    (``fold_osamp`` > 1) holds, in place of bart_tpu's
    ``sigmak``/``frowsk`` and ``sigmas``/``frowss``, one table per
    dispatch part: ``tabk`` (a FoldedTable: line and continuum rows of the
    folded bins, bfloat16 with ``fold_bf16``) and, with an adaptive split,
    ``tabs`` (a RowsTable: the bin-mean rows of the smooth bins);
    ``sigma`` is then the bin-mean table.  An on-the-fly model holds
    each species' LineTiles as ``lt{k}_wn_tiles``, ``lt{k}_wn0`` and the
    rest (bart_tpu's keys), and no opacity table.
    """

    def __init__(self, config: ForwardConfig, *, wn_grid: np.ndarray,
                 pressure: np.ndarray, species: list[str],
                 base_abundances: np.ndarray,
                 opacity: OpacityGrid | dict[str, LineTiles],
                 system, bands: BandMatrix,
                 cia_tables: list[CiaTable] = (),
                 species_masses: np.ndarray | None = None,
                 broadening: BroadeningSpec | None = None,
                 nwidth: float = 20.0,
                 osamp: int = 1,
                 fold_osamp: int = 1,
                 fold_adapt: float | None = 0.02,
                 fold_bf16: bool = False,
                 budget_bytes: float = 2e9,
                 device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32):
        cfg = config
        if cfg.solution not in ("eclipse", "direct", "transit"):
            raise ValueError(f"unknown solution {cfg.solution!r}")
        # folded rtosamp: ``wn_grid`` is the output grid, ``opacity`` is
        # tabulated on the K-times-finer folded_fine_grid
        self.fold = max(int(fold_osamp), 1)
        on_the_fly = isinstance(opacity, dict)
        if self.fold > 1 and on_the_fly:
            raise ValueError(
                "folded rtosamp requires a precomputed opacity grid "
                "(the on-the-fly mode evaluates lines at arbitrary "
                "resolution already — use osamp there)")

        self.config = cfg
        self.system = system
        self.bands = bands
        self.opacity = None if on_the_fly else opacity
        self.line_tiles = opacity if on_the_fly else None
        self.device = resolve_device(device)
        self.dtype = dtype
        dev = self.device
        # on-the-fly mode: the line-profile settings and the bin width of
        # osamp > 1
        self.broadening = broadening
        self.nwidth = nwidth
        self.osamp = int(osamp)
        self.wndelt = (float(wn_grid[1] - wn_grid[0]) if len(wn_grid) > 1
                       else 1.0)
        self.fold_bf16 = bool(fold_bf16) and self.fold > 1
        # static adaptive split (set by _fold_setup): output-bin indices,
        # as numpy arrays and as tensors on the device
        self._idx_fine = self._idx_smooth = None
        self._idx_fine_t = self._idx_smooth_t = None

        def t_(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        sp = np.asarray(species)
        self.species = list(species)
        self.i_h2 = int(np.where(sp == "H2")[0][0])
        self.i_he = int(np.where(sp == "He")[0][0])
        self.i_molfit = np.array(
            [int(np.where(sp == m)[0][0]) for m in cfg.molfit], int)
        # the index arrays a forward gathers with live on the device: a
        # capture may not copy them from the host
        self.i_metals = torch.as_tensor(np.where(
            (sp != "He") & (sp != "H2") & (sp != "H-") & (sp != "e-"))[0],
            device=dev)
        opac_species = list(opacity) if on_the_fly else opacity.species
        self.i_opac = torch.as_tensor(
            [int(np.where(sp == m)[0][0]) for m in opac_species],
            device=dev)
        self._graphs = {}   # chain count -> _ForwardGraph (graphed())
        if species_masses is None:
            from bart_tpu_torch.linelist.molecules import get_molecule

            species_masses = np.array([get_molecule(s).mass
                                       for s in species])

        base_abundances = np.asarray(base_abundances, np.float64)
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
        self.i0 = anchor_index(pressure, cfg.refpress)
        self.r0_km = system.r_planet / 1000.0
        self.g0_si = system.g_planet_si
        # the fixed PT arguments, of 'line' only
        self.pt_args = ([system.r_star, system.t_star, cfg.tint, system.sma,
                         system.g_planet_cgs, cfg.tint_type]
                        if cfg.pt_type == "line" else None)

        if on_the_fly:
            self._line_tile_setup(opacity, budget_bytes)
        else:
            self._grid_setup(opacity, wn_grid, len(pressure), cia_tables,
                             fold_adapt)

    def _line_tile_setup(self, line_tiles: dict[str, LineTiles],
                         budget_bytes: float) -> None:
        """The on-the-fly model's tables: each species' tiles under
        bart_tpu's keys (lt{k}_<field>) on the model's device and dtype,
        and the conditions one cross-section call takes, from the deepest
        species' bytes a condition."""
        self._lt_meta = {}        # species -> (k, cutoff)
        itemsize = torch.tensor([], dtype=self.dtype).element_size()
        per_cond = 1
        for k, (name, tiles) in enumerate(line_tiles.items()):
            self._lt_meta[name] = (k, float(tiles.cutoff))
            for f in _LT_FIELDS:
                self._tables[f"lt{k}_{f}"] = getattr(tiles, f).to(
                    device=self.device,
                    dtype=torch.bool if f == "grid_mask" else self.dtype)
            per_cond = max(per_cond, cond_bytes(tiles, self.osamp, itemsize))
        self._cond_chunk = max(1, int(budget_bytes // per_cond))

    def _grid_setup(self, opacity: OpacityGrid, wn_grid: np.ndarray,
                    n_layers: int, cia_tables, fold_adapt) -> None:
        """The gridded model's tables: the continuum rows and the opacity
        table in the fused kernels' layouts (K = 1 or folded)."""
        cfg, dev, dtype = self.config, self.device, self.dtype
        self.t_min = float(opacity.t_grid[0])
        self.t_step = float(opacity.t_grid[1] - opacity.t_grid[0])
        self.n_t = len(opacity.t_grid)

        # Continuum rows of the rows contraction, on the host in float64
        # (on the fine grid when folded): each CIA table's T-nodes
        # interpolated to the wn grid, the H2 Rayleigh cross-section, a
        # row of ones per gray cloud.  They are the same for every layer.
        wn64 = folded_fine_grid(np.asarray(wn_grid, np.float64), self.fold)
        rows = []
        for tab in cia_tables:
            rows.extend(
                np.interp(wn64, np.asarray(tab.wn, np.float64),
                          np.asarray(row, np.float64), left=0.0, right=0.0)
                for row in np.asarray(tab.absorption))
        if cfg.scattering is not None:
            rows.append(h2_rayleigh_cross_section(wn64))
        if cfg.cloudtop:
            rows.append(np.ones_like(wn64))
        if cfg.cloudrad is not None and cfg.cloudext:
            rows.append(np.ones_like(wn64))
        frows = None
        if rows:
            frows = torch.as_tensor(np.stack(rows), dtype=dtype, device=dev
                                    )[:, None, :].expand(
                len(rows), n_layers, len(wn64))
        if self.fold > 1:
            self._fold_setup(opacity.sigma, frows, len(wn_grid), fold_adapt)
        else:
            self._tables.update(self._k1_tables(
                opacity.sigma.to(device=dev, dtype=dtype), frows))

    @staticmethod
    def _k1_tables(sigma: torch.Tensor, frows: torch.Tensor | None) -> dict:
        """The K = 1 model's table in the kernels' layout, laid out once:
        ``tab``, the RowsTable of the line rows [M*nT, L, W] with the
        continuum rows appended, and ``sigma`` [M, nT, L, W] and
        ``frows`` as views of it.  A table that needs neither continuum
        rows nor padding is taken as it is, not copied."""
        M, nT, L, W = sigma.shape
        blocks = [sigma.reshape(M * nT, L, W)]
        if frows is not None:
            blocks.append(frows)
        tab = rows_table(blocks)
        out = {"tab": tab,
               "sigma": tab.plain()[:M * nT].unflatten(0, (M, nT))}
        if frows is not None:
            out["frows"] = tab.plain()[M * nT:]
        return out

    def _fold_setup(self, sigma_fine: torch.Tensor,
                    frows: torch.Tensor | None, n_out: int,
                    fold_adapt: float | None) -> None:
        """The folded tables, on the model's device: the bin-mean
        ``sigma`` (the K = 1 table of the smooth bins and of anything
        that wants a coarse table), the static split of the output bins
        into fine and smooth, and one table per dispatch part."""
        K, t = self.fold, self._tables
        M, nT, L, Wf = sigma_fine.shape
        if Wf != K * n_out:
            raise ValueError(
                f"folded rtosamp={K}: opacity grid has {Wf} wn samples but "
                f"the output grid needs {K} x {n_out}")
        sig = sigma_fine.to(device=self.device, dtype=self.dtype)
        sig = sig.reshape(M * nT, L, n_out, K)
        sigbar = sig.mean(-1)                              # [M*nT, L, W]
        t["sigma"] = sigbar.reshape(M, nT, L, n_out)
        if fold_adapt:
            mask = fine_bin_mask(sig.reshape(M, nT, L, Wf), K,
                                 delta=float(fold_adapt)).cpu().numpy()
            if mask.any() and not mask.all():
                self._idx_fine = np.where(mask)[0]
                self._idx_smooth = np.where(~mask)[0]
        k_dt = torch.bfloat16 if self.fold_bf16 else self.dtype
        if frows is not None:
            frows = frows.reshape(frows.shape[0], L, n_out, K)
        if self._idx_fine is None:
            fine = [sig] + ([frows] if frows is not None else [])
        else:
            idx_f = torch.as_tensor(self._idx_fine, device=self.device)
            idx_s = torch.as_tensor(self._idx_smooth, device=self.device)
            self._idx_fine_t, self._idx_smooth_t = idx_f, idx_s
            fine = [sig[:, :, idx_f]]
            smooth = [sigbar[:, :, idx_s]]
            if frows is not None:
                # continuum rows are smooth by construction, but their
                # columns must follow the bin split
                fine.append(frows[:, :, idx_f])
                smooth.append(frows.mean(-1)[:, :, idx_s])
            t["tabs"] = rows_table(smooth)
            t["wn_f"], t["wn_s"] = t["wn"][idx_f], t["wn"][idx_s]
        t["tabk"] = folded_table(torch.cat(fine, dim=0).flatten(2), K, k_dt)

    # -----------------------------------------------------------------
    @property
    def tables(self) -> dict:
        return self._tables

    @property
    def sigma(self) -> torch.Tensor:
        return self._tables["sigma"]

    @property
    def wn(self) -> torch.Tensor:
        return self._tables["wn"]

    @property
    def pressure(self) -> torch.Tensor:
        return self._tables["pressure"]

    @property
    def mu(self) -> torch.Tensor:
        return self._tables["mu"]

    @property
    def mu_w(self) -> torch.Tensor:
        return self._tables["mu_w"]

    def tables_from_jax(self, numpy_tables: dict) -> dict:
        """Carry bart_tpu ForwardModel tables (as numpy arrays, under
        bart_tpu's keys and in its layouts) over to this model: the
        opacity table, band weights, base abundances, quadrature and the
        rest, on this model's device and dtype.  Of a K = 1 model,
        ``sigma`` and ``frows`` become ``tab`` (and views of it).  Of a
        folded model, ``sigmak`` [K, M*nT, L, W_f] and ``frowsk`` become
        this model's ``tabk`` and ``sigmas`` and ``frowss`` its ``tabs``;
        bfloat16 tables (numpy's ml_dtypes.bfloat16) stay bfloat16.  Of an
        on-the-fly model, the line tiles (``lt{k}_*``; ``grid_mask`` stays
        bool).  Raises if the keys or shapes differ from this model's."""
        mine = self._tables
        given = dict(numpy_tables)
        parts = {}
        for part, keys in (("tabk", ("sigmak", "frowsk")),
                           ("tabs", ("sigmas", "frowss"))):
            have = [given.pop(k) for k in keys if k in given]
            if have:
                parts[part] = have
        k1 = self.fold == 1 and self.line_tiles is None
        have = set(given) | set(parts) | ({"tab"} if k1 else set())
        if have != set(mine):
            raise ValueError(
                f"table keys differ: missing {sorted(set(mine) - have)}, "
                f"unexpected {sorted(have - set(mine))}")

        def carry(v):
            a = np.asarray(v)
            if a.dtype.name == "bfloat16":     # through float32: exact
                return torch.tensor(a.astype(np.float32), device=self.device
                                    ).to(torch.bfloat16)
            if a.dtype == bool:
                return torch.tensor(a, device=self.device)
            return torch.tensor(a, dtype=self.dtype, device=self.device)

        out = {k: carry(v) for k, v in given.items()}
        if k1:
            out.update(self._k1_tables(out["sigma"], out.get("frows")))
        if "tabk" in parts:
            # rows along axis 1 of bart_tpu's sub-sample-major layout
            tabk = torch.cat([carry(v) for v in parts["tabk"]], dim=1)
            if tabk.shape[0] != self.fold:
                raise ValueError(f"sigmak has K = {tabk.shape[0]}, this "
                                 f"model folds by {self.fold}")
            out["tabk"] = folded_table(unfold_table(tabk), self.fold)
        if "tabs" in parts:
            out["tabs"] = rows_table([carry(v) for v in parts["tabs"]])

        def shape(v):
            if isinstance(v, FoldedTable):
                return (*v.tab.shape[:2], v.W, v.K)
            if isinstance(v, RowsTable):
                return (*v.tab.shape[:2], v.W)
            return tuple(v.shape)

        for k, v in out.items():
            if shape(v) != shape(mine[k]):
                raise ValueError(
                    f"table {k!r} has shape {shape(v)}, this model needs "
                    f"{shape(mine[k])}")
        return out

    def _params(self, params: torch.Tensor) -> torch.Tensor:
        """params [C, n_params] on the model's device and dtype."""
        cfg = self.config
        if params.dim() != 2 or params.shape[-1] != cfg.n_params:
            raise ValueError(
                f"params has shape {tuple(params.shape)}; config "
                f"{cfg.solution}/{cfg.pt_type} with molfit={cfg.molfit} "
                f"expects [C, {cfg.n_params}]")
        return params.to(device=self.device, dtype=self.dtype)

    def __call__(self, params: torch.Tensor,
                 tables: dict[str, torch.Tensor] | None = None):
        """params [C, n_params] -> (bandflux [C, nfilt], spectrum [C, W],
        valid [C] bool)."""
        t = self._tables if tables is None else tables
        cfg = self.config
        params = self._params(params)
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

    def diagnostics(self, params: torch.Tensor):
        """The atmosphere of the post-processing (contribution functions,
        transmittance, PT envelopes): params [C, n_params] -> (T [C, L] K,
        q [C, L, S], radius [C, L] cm, extinction [C, L, W] cm-1, valid
        [C]).  The extinction is the unfused one; a folded model's comes
        from its bin-mean table on the output grid."""
        return self._atmosphere(self._params(params), self._tables)

    def diagnostics_batch(self):
        """``diagnostics`` over a parameter batch as a plain callable (the
        counterpart of ``batched()``)."""
        return lambda batch: self.diagnostics(batch)

    def spectrum_from_profiles(self, T, q, rad_cm=None) -> torch.Tensor:
        """The spectrum [C, W] of explicit profiles, past the PT and
        abundance parameters (a standalone spectrum of an atmosphere
        file): T [C, L] K, q [C, L, S] mole fractions and optionally the
        radii rad_cm [C, L] (re-derived hydrostatically from T and q when
        None).  T is clipped to [tmin, tmax]; the parameters the spectrum
        reads (cloud top, Rayleigh factor) are zero.  Computed as a
        forward computes it: through the fused kernels on a table, through
        the unfused extinction and radiative transfer on the fly."""
        t = self._tables
        cfg = self.config
        dd = dict(device=self.device, dtype=self.dtype)
        T_safe = torch.clamp(torch.as_tensor(T, **dd), cfg.tmin, cfg.tmax)
        q = torch.as_tensor(q, **dd)
        if rad_cm is None:
            mmm = torch.matmul(q, t["masses"])
            rad_cm = radius_profile(
                t["pressure"], T_safe, mmm, cfg.refpress, self.r0_km,
                self.g0_si, i0=self.i0) * const.KM_TO_CM
        else:
            rad_cm = torch.as_tensor(rad_cm, **dd)
        params = torch.zeros(T_safe.shape[0], cfg.n_params, **dd)
        return self._spectrum(params, t, T_safe, q, rad_cm)

    def graphed(self):
        """The forward over a chain batch as a CUDA graph replay, the
        counterpart of bart_tpu's ``jitted()``: one graph per chain count
        C, captured over a static [C, n_params] input buffer at the first
        call with that C.  The callable copies ``params`` into the buffer,
        replays and returns the graph's own output tensors, which the next
        call with the same C overwrites.  Only on a CUDA model: it raises
        on the CPU, and a failed capture raises."""
        if self.device.type != "cuda":
            raise RuntimeError(f"ForwardModel.graphed: a CUDA graph needs a "
                               f"CUDA model, this one is on {self.device}")

        def forward(params: torch.Tensor):
            C = int(params.shape[0])
            if C not in self._graphs:
                self._graphs[C] = _ForwardGraph(self, params)
            return self._graphs[C](params)

        return forward

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

    def _atmosphere(self, params: torch.Tensor, t: dict):
        """params [C, n] -> (T, q, radius [cm], extinction, valid)."""
        T_safe, q, rad_cm, valid = self._profiles(params, t)
        ext = self._extinction(params, t, T_safe, q, rad_cm)
        return T_safe, q, rad_cm, ext, valid

    def _line_cross_sections(self, t: dict, T_safe: torch.Tensor
                             ) -> torch.Tensor:
        """sigma [C, M, L, W] of the on-the-fly mode: each species'
        cross-sections at every layer's (T, p), in chunks of conditions
        of a size fixed at set-up (each condition is computed alone, so
        the chunks change no number)."""
        C, L = T_safe.shape
        T_c = T_safe.reshape(-1)
        p_c = t["p_barye"].expand(C, L).reshape(-1)
        spec = self.broadening or BroadeningSpec()
        n_grid = t["wn"].shape[0]
        sigs = []
        for name, (k, cutoff) in self._lt_meta.items():
            tiles = LineTiles(species=name, cutoff=cutoff, n_grid=n_grid,
                              **{f: t[f"lt{k}_{f}"] for f in _LT_FIELDS})
            sigs.append(torch.cat([
                cross_section_grid(tiles, T_c[i:i + self._cond_chunk],
                                   p_c[i:i + self._cond_chunk], spec,
                                   nwidth=self.nwidth, osamp=self.osamp,
                                   wndelt=self.wndelt).to(self.dtype)
                for i in range(0, C * L, self._cond_chunk)]).reshape(
                    C, L, n_grid))
        return torch.stack(sigs, dim=1)

    def _extinction(self, params: torch.Tensor, t: dict, T_safe, q,
                    rad_cm) -> torch.Tensor:
        """The unfused extinction [C, L, W] in cm-1: the line table
        interpolated in T (or, on the fly, the lines' cross-sections) and
        weighted by the molecules' densities, then CIA, Rayleigh (mode 1:
        10^param; 'polar', mode 2: unscaled), the cloud deck and the
        extended cloud, term by term as the fused rows."""
        cfg = self.config
        nPT = cfg.n_pt
        wn = t["wn"]
        n_tot = t["p_barye"] / (const.K_BOLTZ * T_safe)            # [C, L]
        if self.line_tiles is not None:
            sigma = self._line_cross_sections(t, T_safe)        # [C, M, L, W]
        else:
            sigma = interp_opacity(t["sigma"], self.t_min, self.t_step,
                                   self.n_t, T_safe)            # [C, M, L, W]
        n_mol = q[:, :, self.i_opac] * n_tot[..., None]         # [C, L, M]
        ext = torch.einsum("cmlw,clm->clw", sigma, n_mol)

        for k, (i1, i2) in enumerate(self.cia_idx):
            ext = ext + cia_extinction(
                t[f"cia{k}_temps"], t[f"cia{k}_wn"], t[f"cia{k}_abs"], wn,
                T_safe, q[:, :, i1] * n_tot / LOSCHMIDT,
                q[:, :, i2] * n_tot / LOSCHMIDT)

        if cfg.scattering is not None:
            n_h2 = q[:, :, self.i_h2] * n_tot
            if cfg.scattering == "polar":
                ext = ext + rayleigh_extinction(wn, n_h2, 0.0, mode=2)
            else:
                ext = ext + rayleigh_extinction(
                    wn, n_h2, params[:, nPT + cfg.n_radfit + cfg.n_cloud],
                    mode=1)

        if cfg.cloudtop:
            ctop = params[:, nPT + cfg.n_radfit]          # top pressure [bar]
            ext = ext + cloud_deck_extinction(
                t["pressure"], torch.log10(torch.clamp(ctop, min=1e-30)),
                wn.shape[0])

        if cfg.cloudrad is not None and cfg.cloudext:
            ext = ext + extended_cloud_extinction(
                rad_cm / const.KM_TO_CM, cfg.cloudrad[0], cfg.cloudrad[1],
                cfg.cloudext)[..., None]
        return ext

    def _fused_rows(self, params: torch.Tensor, t: dict, T_safe, q, rad_cm):
        """(parts, wrows [C, L, R]): the extinction as one rows
        contraction per dispatch part (tab, folded?, wn, output-bin
        indices or None): one K = 1 part, the RowsTable ``tab``; folded,
        the FoldedTable of the fine bins and, with an adaptive split, the
        RowsTable of the smooth bins.  No table is copied here.  Columns
        in bart_tpu's order:
        line rows (molecule x T-node), CIA T-node rows, Rayleigh, cloud
        deck, extended cloud; the weight formulas mirror the unfused
        extinction term by term."""
        cfg = self.config
        nPT = cfg.n_pt
        sigma = t["sigma"]
        M, nT, L, W = sigma.shape
        C = T_safe.shape[0]
        n_tot = t["p_barye"] / (const.K_BOLTZ * T_safe)           # [C, L]
        n_mol = q[:, :, self.i_opac] * n_tot[..., None]        # [C, L, M]
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

        wrows = torch.cat(cols, dim=2)
        if self.fold > 1:
            split = self._idx_fine is not None
            parts = [(t["tabk"], True, t["wn_f"] if split else t["wn"],
                      self._idx_fine_t)]
            if split:
                parts.append((t["tabs"], False, t["wn_s"],
                              self._idx_smooth_t))
            return parts, wrows
        return [(t["tab"], False, t["wn"], None)], wrows

    def _spectrum(self, params, t, T_safe, q, rad_cm):
        """Extinction rows -> geometry -> spectrum [C, W] through the
        fused eclipse or transit kernels, one launch per dispatch part;
        on the fly, the unfused extinction through the unfused radiative
        transfer."""
        if self.line_tiles is not None:
            ext = self._extinction(params, t, T_safe, q, rad_cm)
            if self.config.solution == "transit":
                return transit_depth(ext, rad_cm,
                                     self.system.r_star * 100.0)
            return eclipse_flux(tau_vertical(ext, rad_cm), T_safe, t["wn"],
                                t["mu"], t["mu_w"])
        parts, wrows = self._fused_rows(params, t, T_safe, q, rad_cm)
        n_wn = t["wn"].shape[0]
        if self.config.solution == "transit":
            G, wgt = slant_geometry(rad_cm)
            if G.is_cuda:
                # the kernels' lower-triangular tiles, made once for the
                # launches of this forward
                G = prepare_slant(G)
            absorbed = self._assemble(
                [((fused_transit_folded if folded else fused_transit)(
                    tab, wrows, G, wgt), idx)
                 for tab, folded, _, idx in parts], n_wn)
            return (rad_cm[:, -1:] ** 2 + absorbed) / (
                self.system.r_star * 100.0) ** 2
        dr = rad_cm[:, :-1] - rad_cm[:, 1:]
        drp = torch.cat([torch.zeros_like(dr[:, :1]), dr], dim=1)
        return self._assemble(
            [((fused_eclipse_folded if folded else fused_eclipse)(
                tab, wn_p, t["mu"], t["mu_w"], wrows, T_safe, drp,
                powers=self._powers), idx)
             for tab, folded, wn_p, idx in parts], n_wn)

    @staticmethod
    def _assemble(pieces, n_wn: int) -> torch.Tensor:
        """The output spectrum [C, n_wn] from the dispatch parts' pieces
        ((values [C, W_p], output-bin indices or None) pairs; a single
        piece without indices is the spectrum)."""
        if len(pieces) == 1 and pieces[0][1] is None:
            return pieces[0][0]
        first = pieces[0][0]
        out = torch.zeros((first.shape[0], n_wn), dtype=first.dtype,
                          device=first.device)
        for vals, idx in pieces:
            out[:, idx] = vals
        return out


class _ForwardGraph:
    """One chain count's forward captured as a CUDA graph over a static
    input buffer (ForwardModel.graphed), warmed up on the first call's
    parameters."""

    def __init__(self, fm: ForwardModel, params: torch.Tensor):
        dev = fm.device
        self.params = params.to(device=dev, dtype=fm.dtype, copy=True)
        side = torch.cuda.Stream(dev)      # PyTorch's rule: warm up aside
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                fm(self.params)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fm(self.params)

    def __call__(self, params: torch.Tensor):
        self.params.copy_(params)
        self.graph.replay()
        return self.out
