"""The plain reference of a cell: BART's eclipse forward model, its
likelihood and its snooker step, in float64, from the configuration's raw
inputs (cfg keys, line list, CIA table, filters, TEP file).

It imports nothing of the program.  Its formulas are the published ones
(Line et al. 2013 for the PT profile, the hydrostatic radius scheme of
BART's makeatm, HITRAN line strengths with Voigt profiles, the eclipse
intensity as a sum over layers of B e^{-tau/mu}, ter Braak & Vrugt 2008
for the snooker walk), written out plainly; where the program fixes a
convention of its own (the line-wing truncation by tiles of 256 points,
the adaptive split of the folded bins, the index rules of the walk) the
reference follows it, as noted at each place.

The opacity table is the reference's own, built line by line
(``build_table``) from the line list; nothing the program made is read.
Heavy arrays (the table, extinction, optical depth) are torch float64
tensors on the device given; the profiles, the per-entry cross-sections
with scipy's Voigt profile (``cross_sections``) and the walk are
numpy/scipy on the host.
"""

from __future__ import annotations

import hashlib
import json
import math
import os

import numpy as np
import scipy.special as sps
import torch

# BART's constants (cgs), as the configuration's forward model states them
H_PLANCK = 6.6260755e-27
C_LIGHT = 2.99792458e10
K_BOLTZ = 1.380658e-16
K_BOLTZ_VOIGT = 1.380649e-16     # the wing-reach bound's Boltzmann constant
C2 = H_PLANCK * C_LIGHT / K_BOLTZ
AMU = 1.66053906660e-24
RJUP, RSUN, AU, MJUP = 7.1492e7, 6.96e8, 1.495978707e11, 1.8983e27
G_NEWTON = 6.67430e-11
LOSCHMIDT = 2.6867811e19
R_GAS = 6.02214076e23 * 1.380649e-23       # J mol-1 K-1
TREF = 296.0
TAU_CLAMP = 88.0
TILE = 256              # the program's line-bucketing tile (points)
CUTOFF_MAX = 25.0       # HITRAN far-wing truncation [cm-1]
BUILD_CHUNK = 2**25     # (T node, line, point) triples a build step holds

#: mass [amu], collision diameter [A], linear?, symmetry number,
#: rotational constants [cm-1], vibrational fundamentals ((wn, g), ...)
MOLECULES = {
    "H2O": (18.010565, 3.20, False, 2, (27.877, 14.512, 9.285),
            ((3657.1, 1), (1594.7, 1), (3755.9, 1))),
    "CO2": (43.989830, 3.94, True, 2, (0.39021,),
            ((1333.0, 1), (667.4, 2), (2349.1, 1))),
    "CO": (27.994915, 3.69, True, 1, (1.93128,), ((2143.3, 1),)),
    "CH4": (16.031300, 4.10, False, 12, (5.2412, 5.2412, 5.2412),
            ((2916.5, 1), (1533.3, 2), (3019.5, 3), (1310.8, 3))),
    "H2": (2.015650, 2.89, True, 2, (59.3344,), ((4401.2, 1),)),
    "He": (4.002602, 2.27, None, 1, (), ()),
    "H": (1.007825, 2.40, None, 1, (), ()),
    "C": (12.000000, 3.00, None, 1, (), ()),
    "N": (14.003074, 3.00, None, 1, (), ()),
    "O": (15.994915, 2.90, None, 1, (), ()),
}


# --- readers ---------------------------------------------------------------

def read_tep(path: str) -> dict:
    """TEP file -> {name: float} of the numeric values."""
    out = {}
    with open(path) as f:
        for line in f:
            fields = line.split("#")[0].split()
            if len(fields) >= 2:
                try:
                    out[fields[0]] = float(fields[1])
                except ValueError:
                    pass
    return out


def read_filter(path: str):
    """(wn ascending [cm-1], response) of a (wavelength [um], response)
    file."""
    a = np.loadtxt(path, comments="#")
    wn = 1.0 / (a[:, 0] * 1e-4)
    order = np.argsort(wn)
    return wn[order], a[order, 1]


def read_cia(path: str):
    """((species, species), temps [nT], wn [nw], absorption [nT, nw]
    cm-1 amagat-2) of a grid-format CIA table."""
    pair, temps, rows = ("H2", "H2"), None, []
    with open(path) as f:
        for line in f:
            s = line.split()
            if not s or s[0].startswith("#"):
                continue
            if s[0] == "i":
                pair = (s[1], s[2])
            elif s[0] == "t":
                temps = np.array([float(x) for x in s[1:]])
            else:
                rows.append([float(x) for x in s])
    a = np.array(rows)
    return pair, temps, a[:, 0], a[:, 1:].T.copy()


def read_lines(path: str) -> dict:
    """{species: {field: array}} of a TLI .npz line list."""
    z = np.load(path)
    return {str(sp): {f: z[f"{sp}/{f}"] for f in
                      ("wn0", "s296", "elower")}
            for sp in z["__species__"]}


def _floats(s: str) -> np.ndarray:
    return np.array([float(x) for x in s.split()])


def _bool(s: str) -> bool:
    return s.strip().lower() in ("true", "1", "yes")


# --- the published physics ---------------------------------------------

def planck(wn, T):
    """B_wn(T) [erg s-1 cm-2 sr-1 / cm-1]; torch or numpy."""
    x = C2 * wn / T
    em1 = torch.expm1(x) if isinstance(x, torch.Tensor) else np.expm1(x)
    return 2.0 * H_PLANCK * C_LIGHT**2 * wn**3 / em1


def pt_line(p, kappa, g1, g2, alpha, beta, r_star, t_star, t_int, sma,
            grav):
    """Line et al. (2013) Eqs. 13-16: p [L] bar, parameters [S] -> T
    [S, L] (float64, numpy)."""
    kap, ga1, ga2 = (10.0 ** np.asarray(v)[:, None] for v in (kappa, g1, g2))
    alpha, beta = np.asarray(alpha)[:, None], np.asarray(beta)[:, None]
    t_irr = beta * math.sqrt(r_star / (2.0 * sma)) * t_star
    tau = kap * (p * 1e6) / grav

    def xi(g):
        gt = g * tau
        return (2.0 / 3.0) * (1.0 + (1.0 + (0.5 * gt - 1.0) * np.exp(-gt)) / g
                              + g * (1.0 - 0.5 * tau**2) * sps.expn(2, gt))

    t4 = 0.75 * (t_int**4 * (2.0 / 3.0 + tau)
                 + t_irr**4 * (1.0 - alpha) * xi(ga1)
                 + t_irr**4 * alpha * xi(ga2))
    return t4 ** 0.25


def radius_km(p, T, mmm, p0, r0_km, g0):
    """Hydrostatic radii [S, L] km, top-first: BART makeatm's scheme (the
    anchor at the layer nearest p0 from T/mu interpolated in log p, then
    trapezoids in ln p outward with gravity g0 (R0/r)^2)."""
    n = len(p)
    i0 = int(np.argmin(np.abs(p - p0)))
    tm = T / mmm
    logp = np.log10(p)
    tm0 = np.array([np.interp(np.log10(p0), logp, row) for row in tm])
    rad = np.empty_like(tm)
    rad[:, i0] = r0_km + 0.5 * (tm[:, i0] + tm0) * R_GAS * np.log(
        p0 / p[i0]) / g0
    lnp = np.log(p)
    for js in (range(i0 + 1, n), range(i0 - 1, -1, -1)):
        r_prev = rad[:, i0]
        g_prev = g0 * r0_km**2 / r_prev**2
        for j in js:
            k = j - 1 if j > i0 else j + 1          # the layer before j
            a = 0.5 * (tm[:, j] + tm[:, k]) * R_GAS
            r = r_prev - a * (lnp[j] - lnp[k]) / g_prev
            g_prev = g_prev * r_prev**2 / r**2
            rad[:, j] = r_prev = r
    return rad


def partition(species: str, T):
    """Rigid-rotor x harmonic-oscillator Q(T) (ratios only matter)."""
    _, _, linear, sig, rot, vib = MOLECULES[species]
    T = np.asarray(T, np.float64)
    if linear is None:
        return np.ones_like(T)
    if linear:
        B = rot[0]
        q = (T / (C2 * B) + 1.0 / 3.0 + C2 * B / (15.0 * T)) / sig
    else:
        A, B, C = rot
        q = math.sqrt(math.pi) / sig * np.sqrt((T / C2) ** 3 / (A * B * C))
    for wn_i, g_i in vib:
        q = q * (1.0 - np.exp(-C2 * wn_i / T)) ** (-g_i)
    return q


def line_strength(species, lines, T):
    """HITRAN S(T) of ``lines`` at scalar T."""
    qr = partition(species, TREF) / partition(species, T)
    boltz = np.exp(-C2 * lines["elower"] * (1.0 / T - 1.0 / TREF))
    wn0 = lines["wn0"]
    stim = (1.0 - np.exp(-C2 * wn0 / T)) / (1.0 - np.exp(-C2 * wn0 / TREF))
    return lines["s296"] * qr * boltz * stim


def lorentz_hwhm(species, T, p_barye, q_h2, q_he, k_b=K_BOLTZ):
    """Collision-theory Lorentz HWHM [cm-1] against an H2/He bath."""
    m = MOLECULES[species][0] * AMU
    d = MOLECULES[species][1] * 1e-8
    coll = 0.0
    for q, partner in ((q_h2, "H2"), (q_he, "He")):
        mp = MOLECULES[partner][0] * AMU
        dp = MOLECULES[partner][1] * 1e-8
        coll = coll + q * ((d + dp) * 0.5) ** 2 * math.sqrt(1.0 / m + 1.0 / mp)
    return math.sqrt(2.0) / C_LIGHT / np.sqrt(T * math.pi * k_b) * p_barye \
        * coll


def doppler_hwhm(species, wn0, T, k_b=K_BOLTZ):
    m = MOLECULES[species][0] * AMU
    return wn0 / C_LIGHT * np.sqrt(2.0 * math.log(2.0) * k_b * T / m)


def _weideman(n: int):
    """(L, coefficients) of Weideman's (1994) rational series of n terms
    for the Faddeeva function."""
    m = 2 * n
    k = np.arange(-m + 1, m)
    ell = math.sqrt(n / math.sqrt(2.0))
    t = ell * np.tan(k * math.pi / m / 2.0)
    f = np.concatenate([[0.0], np.exp(-t**2) * (ell**2 + t**2)])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / (2 * m)
    return ell, np.flipud(a[1:n + 1])


#: 48 terms: within 4e-7 of scipy's wofz relative, 1e-15 absolute, over
#: the half-plane the profiles reach (y down to 1e-8, x to 1e4)
WEIDEMAN = _weideman(48)


def voigt(dx: torch.Tensor, sigma: torch.Tensor,
          gamma: torch.Tensor) -> torch.Tensor:
    """Normalised Voigt profile (scipy.special.voigt_profile's
    convention): Re w(z) / (sigma sqrt(2 pi)), z = (dx + i gamma) /
    (sigma sqrt 2), w by Weideman's series in complex128."""
    ell, a = WEIDEMAN
    s2 = sigma * math.sqrt(2.0)
    z = torch.complex(dx / s2, gamma / s2)
    d = ell - 1j * z
    t = (ell + 1j * z) / d
    p = torch.zeros_like(t)
    for ak in a.tolist():
        p.mul_(t).add_(ak)
    w = 2.0 * p / (d * d) + (1.0 / math.sqrt(math.pi)) / d
    return w.real / (s2 * math.sqrt(math.pi))


def smix(tau, mu, muw):
    """sum_q w_q mu_q e^{-min(tau, 88)/mu_q} (the raygrid quadrature)."""
    tau = torch.clamp(tau, max=TAU_CLAMP)
    out = torch.zeros_like(tau)
    for m, w in zip(mu.tolist(), muw.tolist()):
        out += (w * m) * torch.exp(-tau / m)
    return out


def raygrid(angles_deg):
    """(mu, w): trapezoid in mu over [0, 1] on the ray angles' cosines,
    the mu = 0 end added."""
    mu = np.sort(np.cos(np.deg2rad(np.asarray(angles_deg, np.float64))))
    grid = np.concatenate([[0.0], mu])
    tw = np.zeros(len(grid))
    tw[0] = 0.5 * (grid[1] - grid[0])
    tw[-1] = 0.5 * (grid[-1] - grid[-2])
    tw[1:-1] = 0.5 * (grid[2:] - grid[:-2])
    return mu, tw[1:]


def rounder(name: str | None):
    """float64 tensor -> float64 tensor rounded to the type ``name``
    (``tf32``: float32 with 10 mantissa bits, to nearest even; a float8
    type scaled by each row's largest magnitude over its own largest
    value first, as a table stored in it would be)."""
    if name is None:
        return lambda x: x
    if name == "tf32":
        def tf32(x):
            i = x.float().view(torch.int32)
            i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
            return i.view(torch.float32).double()
        return tf32
    dt = getattr(torch, name)
    if dt.itemsize == 1:
        top = torch.finfo(dt).max

        def f8(x):
            s = x.abs().amax(-1, keepdim=True) / top
            s = torch.where(s > 0, s, torch.ones_like(s))
            return (x / s).to(dt).double() * s
        return f8
    return lambda x: x.to(dt).double()


# --- the cell's reference ------------------------------------------------

class Reference:
    """The reference of one configuration under one traffic mix:
    ``config`` the configuration file's object, ``overrides`` the
    traffic's cfg keys, ``root`` the benchmark directory (data paths are
    relative to it)."""

    def __init__(self, config: dict, overrides: dict, root: str,
                 device: torch.device):
        c = dict(config["cfg"])
        c.update(overrides)
        self.c = c
        self.device = device
        path = {k: [os.path.join(root, v) for v in c[k].split()]
                for k in config["path_keys"]}
        tep = read_tep(path["tep_name"][0])
        self.r_star, self.t_star = tep["Rs"] * RSUN, tep["Ts"]
        self.sma = tep["a"] * AU
        self.r_planet, m_planet = tep["Rp"] * RJUP, tep["Mp"] * MJUP
        self.g0 = G_NEWTON * m_planet / self.r_planet**2          # m s-2
        L = int(c["n_layers"])
        self.pressure = (np.logspace(np.log10(float(c["p_top"])),
                                     np.log10(float(c["p_bottom"])), L)
                         if _bool(c.get("log", "True")) else
                         np.linspace(float(c["p_top"]),
                                     float(c["p_bottom"]), L))
        self.K = max(int(c.get("rtosamp", "1")), 1)
        self.adapt = _bool(c.get("rtadapt", "False")) and self.K > 1
        d = float(c["wndelt"])
        if "wnlow" in c:
            lo, hi = float(c["wnlow"]), float(c["wnhigh"])
        else:
            wlfct = float(c.get("wlfct", "1e-4"))
            lo = 1.0 / (float(c["wlhigh"]) * wlfct)
            hi = 1.0 / (float(c["wllow"]) * wlfct)
        n = int(np.floor((hi - lo) / d)) + 1
        self.wn = lo + d * np.arange(n)
        off = d * ((np.arange(self.K) + 0.5) / self.K - 0.5)
        self.wn_fine = (self.wn[:, None] + off[None, :]).reshape(-1) \
            if self.K > 1 else self.wn
        self.t_grid = np.arange(float(c["tlow"]),
                                float(c["thigh"]) + float(c["tempdelt"]) / 2,
                                float(c["tempdelt"]))
        self.species = c["out_spec"].split()
        self.base_q = np.tile(_floats(c["uniform"]), (L, 1))
        self.masses = np.array([MOLECULES[s][0] for s in self.species])
        sp = np.array(self.species)
        self.i_h2 = self.species.index("H2")
        self.i_he = self.species.index("He")
        self.molfit = c["molfit"].split()
        self.i_molfit = [self.species.index(m) for m in self.molfit]
        self.i_metals = np.where((sp != "He") & (sp != "H2") & (sp != "H-")
                                 & (sp != "e-"))[0]
        self.linedb = path["linedb"][0]
        self.lines = read_lines(self.linedb)
        self.line_species = list(self.lines)
        self.i_opac = [self.species.index(m) for m in self.line_species]
        self.q_h2 = float(np.mean(self.base_q[:, self.i_h2]))
        self.q_he = float(np.mean(self.base_q[:, self.i_he]))
        self.nwidth = float(c.get("nwidth", "20"))
        self.ethresh = float(c.get("ethresh", "0"))
        self.tmin, self.tmax = float(c["Tmin"]), float(c["Tmax"])
        self.p0 = float(c["refpress"])
        self.t_int = float(c.get("tint", "100"))
        if c.get("quadrature", "raygrid") != "raygrid":
            raise ValueError("the reference integrates over the raygrid "
                             "only")
        self.mu, self.muw = raygrid(_floats(c.get("raygrid",
                                                  "0 20 40 60 80")))
        self.cia = [read_cia(p) for p in path.get("csfile", [])]
        self.data, self.uncert = _floats(c["data"]), _floats(c["uncert"])
        self.pinit, self.pmin = _floats(c["params"]), _floats(c["pmin"])
        self.pmax, self.step = _floats(c["pmax"]), _floats(c["stepsize"])
        self.ifree = np.where(self.step > 0)[0]
        self.bands = self._band_matrix([read_filter(f)
                                        for f in path["filters"]])

    # -- bands -----------------------------------------------------------
    def _band_matrix(self, filters) -> np.ndarray:
        """[nfilt, W]: trapezoid over the filter's span of the output grid,
        normalised by the filter's integral, over the star's blackbody
        flux, times (Rp/Rs)^2."""
        wn = self.wn
        star = math.pi * planck(wn, self.t_star)
        W = np.zeros((len(filters), len(wn)))
        for i, (fwn, ftr) in enumerate(filters):
            idx = np.where((wn < fwn[-1]) & (wn > fwn[0]))[0]
            x = wn[idx]
            tw = np.zeros_like(x)
            tw[0], tw[-1] = 0.5 * (x[1] - x[0]), 0.5 * (x[-1] - x[-2])
            tw[1:-1] = 0.5 * (x[2:] - x[:-2])
            resp = np.interp(x, fwn, ftr)
            W[i, idx] = (resp / np.sum(resp * tw) * tw
                         * (self.r_planet / self.r_star) ** 2 / star[idx])
        return W

    # -- parameters and profiles ---------------------------------------
    def expand(self, free: np.ndarray) -> np.ndarray:
        full = np.tile(self.pinit, (free.shape[0], 1))
        full[:, self.ifree] = free
        return full

    def profiles(self, free: np.ndarray):
        """free [S, nfree] -> (T [S, L] clipped, q [S, L, nsp], radius
        [S, L] cm, valid [S])."""
        full = self.expand(np.asarray(free, np.float64))
        grav = 100.0 * self.g0
        T = pt_line(self.pressure, *full[:, :5].T, self.r_star, self.t_star,
                    self.t_int, self.sma, grav)
        valid = np.all((T >= self.tmin) & (T <= self.tmax), axis=1)
        T = np.clip(T, self.tmin, self.tmax)
        S, L = T.shape
        q = np.repeat(self.base_q[None], S, axis=0)
        for k, im in enumerate(self.i_molfit):
            q[:, :, im] = self.base_q[None, :, im] * 10.0 ** full[:, 5 + k,
                                                                  None]
        qfree = 1.0 - q[:, :, self.i_metals].sum(axis=2)
        valid &= np.all(qfree >= 0.0, axis=1)
        qfree = np.clip(qfree, 0.0, None)
        r = self.base_q[:, self.i_h2] / self.base_q[:, self.i_he]
        q[:, :, self.i_h2] = r * qfree / (1.0 + r)
        q[:, :, self.i_he] = qfree / (1.0 + r)
        rad = radius_km(self.pressure, T, q @ self.masses, self.p0,
                        self.r_planet / 1000.0, self.g0)
        return T, q, rad * 1e5, valid

    # -- the opacity table -------------------------------------------------
    def precisions(self, control: bool = False):
        """(fine, coarse) row types of ``load_table``: those the
        configuration states (a bfloat16 fine table with foldtable16,
        float32 rows else), or with ``control`` the next below them
        (float8 for bfloat16, TF32 for float32)."""
        bf16 = self.K > 1 and _bool(self.c.get("foldtable16", "False"))
        if not control:
            return ("bfloat16" if bf16 else None), None
        return ("float8_e4m3fn" if bf16 else "tf32"), "tf32"

    def load_table(self, sigma: np.ndarray, fine: str | None = None,
                   coarse: str | None = None) -> None:
        """The reference's own table [M, nT, L, W_rt] (``build_table``,
        stored in float32 as the configuration states) as float64 on the
        device, its fine-bin mask (folded) and its bin means.  ``fine``
        names the type the rows of the folded bins (lines and continuum)
        are rounded to first, ``coarse`` that of the K = 1 rows (the
        smooth bins' bin means; at K = 1 every row): ``bfloat16``,
        ``float8_e4m3fn``, ``tf32`` or None (as saved)."""
        sig = torch.as_tensor(sigma, device=self.device)
        M, nT, L, F = sig.shape
        K, W = self.K, len(self.wn)
        if (M != len(self.line_species) or F != K * W
                or nT != len(self.t_grid)):
            raise ValueError(f"table shape {tuple(sig.shape)} does not fit "
                             f"the configuration ({len(self.line_species)} "
                             f"molecules, {len(self.t_grid)} T, {W} x {K} "
                             f"points)")
        self.mask = self.fine_bins(sig, K) if self.adapt else None
        if K == 1:
            fine = coarse
        self.fine_round, self.coarse_round = rounder(fine), rounder(coarse)
        self.tf32 = rounder("tf32") if "tf32" in (fine, coarse) else None
        if fine == "tf32":
            self.fine_round = self.tf32
        if coarse == "tf32":
            self.coarse_round = self.tf32
        sig = sig.double()
        self.sigma_bar = self.coarse_round(
            sig.reshape(M, nT, L, W, K).mean(-1))
        self.sigma_fine = self.fine_round(sig)
        del sig

    @staticmethod
    def fine_bins(sig: torch.Tensor, K: int, delta: float = 0.02,
                  floor: float = 1e-12) -> torch.Tensor:
        """The configuration's adaptive split (rtadapt, split 0.02): a bin
        is fine where, for some molecule, T-node and layer, a sub-sample
        departs from the bin's mean by more than ``delta`` of it, among
        bin means above ``floor`` of the molecule's largest value."""
        M, nT, L, F = sig.shape
        fine = torch.zeros(F // K, dtype=torch.bool, device=sig.device)
        for m in range(M):
            top = sig[m].max().double()
            for it in range(nT):
                s = sig[m, it].double().reshape(L, F // K, K)
                sbar = s.mean(-1)
                dev = (s - sbar[..., None]).abs().amax(-1)
                rel = torch.where(sbar > 0, dev / torch.where(sbar > 0, sbar,
                                                             1.0), 0.0)
                fine |= ((rel > delta) & (sbar > floor * top)).any(0)
        return fine

    # -- the forward model ---------------------------------------------
    def _interp_w(self, T: torch.Tensor) -> torch.Tensor:
        """Linear weights [S, L, nT] on the uniform T grid, the bracket
        clipped to the grid and the fraction to [0, 1]."""
        t0, dt, n = self.t_grid[0], self.t_grid[1] - self.t_grid[0], \
            len(self.t_grid)
        x = (T - t0) / dt
        i0 = torch.clamp(torch.floor(x), 0, n - 2)
        f = torch.clamp(x - i0, 0.0, 1.0)
        w = torch.zeros(*T.shape, n, dtype=T.dtype, device=T.device)
        w.scatter_(-1, i0.long()[..., None], (1.0 - f)[..., None])
        w.scatter_add_(-1, i0.long()[..., None] + 1, f[..., None])
        return w

    def _cia(self, T: torch.Tensor, q: torch.Tensor, n_tot: torch.Tensor,
             rnd=None, wr=None) -> torch.Tensor:
        """CIA extinction [S, L, F] on the fine grid: the table linear in
        wn (zero outside it) and in T (edge values beyond its ends); with
        ``rnd``, its rows at the table's temperatures rounded by it (the
        continuum rows of a table stored in a narrower type), with ``wr``
        each row's weight."""
        wr = wr or (lambda x: x)
        out = 0.0
        wnf = self.wn_fine
        for (a, b), temps, twn, absn in self.cia:
            tab = np.stack([np.interp(wnf, twn, row, left=0.0, right=0.0)
                            for row in absn])
            tab = torch.as_tensor(tab, device=self.device)
            if rnd is not None:
                tab = rnd(tab)
            tt = torch.as_tensor(temps, device=self.device)
            it = torch.clamp(torch.searchsorted(tt, T.contiguous()) - 1, 0,
                             len(temps) - 2)
            f = torch.clamp((T - tt[it]) / (tt[it + 1] - tt[it]), 0.0, 1.0)
            n1 = q[..., self.species.index(a)] * n_tot / LOSCHMIDT
            n2 = q[..., self.species.index(b)] * n_tot / LOSCHMIDT
            nn = n1 * n2
            out = out + (tab[it] * wr((1 - f) * nn)[..., None]
                         + tab[it + 1] * wr(f * nn)[..., None])
        return out

    def spectrum(self, T, q, rad_cm) -> torch.Tensor:
        """Eclipse flux [S, W] (folded: each fine bin the mean of its K
        sub-samples' flux terms; each smooth bin the K = 1 flux of the
        bin-mean extinction) from profiles (numpy, float64)."""
        dev, f64 = self.device, torch.float64
        T = torch.as_tensor(T, dtype=f64, device=dev)
        q = torch.as_tensor(q, dtype=f64, device=dev)
        rad = torch.as_tensor(rad_cm, dtype=f64, device=dev)
        p = torch.as_tensor(self.pressure * 1e6, dtype=f64, device=dev)
        n_tot = p / (K_BOLTZ * T)                                 # [S, L]
        w = self._interp_w(T)
        n_mol = q[:, :, self.i_opac] * n_tot[..., None]           # [S, L, M]
        S, L = T.shape
        K, W = self.K, len(self.wn)

        def cia(rnd):
            return lambda wr: self._cia(T, q, n_tot, rnd, wr)

        def ext_of(sig, rnd, cia_rows):
            """Extinction [S, L, F]: the rows contraction of the table
            ``sig`` (its T-node rows by the interpolation weights times
            the molecule's density) plus the CIA rows; with TF32 rows
            (the control) the rows' weights are rounded as well."""
            wr = rnd if rnd is self.tf32 else (lambda x: x)
            e = 0.0
            for m in range(sig.shape[0]):
                e = e + torch.einsum("slt,tlw->slw",
                                     wr(w * n_mol[:, :, m, None]), sig[m])
            return e + cia_rows(wr)

        dr = rad[:, :-1] - rad[:, 1:]

        def tau_of(e):
            seg = 0.5 * (e[:, :-1] + e[:, 1:]) * dr[..., None]
            return torch.cat([torch.zeros_like(e[:, :1]),
                              torch.cumsum(seg, dim=1)], dim=1)

        mu = self.mu
        muw = self.muw
        if K == 1:
            Sm = smix(tau_of(ext_of(self.sigma_fine, self.fine_round,
                                    cia(self.fine_round))), mu, muw)
        else:
            ext_f = ext_of(self.sigma_fine, self.fine_round,
                           cia(self.fine_round)).reshape(S, L, W, K)
            Sm = torch.zeros(S, L, W, dtype=f64, device=dev)
            for k in range(K):
                Sm += smix(tau_of(ext_f[..., k]), mu, muw)
            Sm /= K
            del ext_f
            if self.mask is not None:
                ext_s = ext_of(self.sigma_bar, self.coarse_round,
                               lambda wr: self._cia(T, q, n_tot, None, wr)
                               .reshape(S, L, W, K).mean(-1))
                S1 = smix(tau_of(ext_s), mu, muw)
                Sm = torch.where(self.mask, Sm, S1)
        B = planck(torch.as_tensor(self.wn, device=dev), T[..., None])
        Bmid = 0.5 * (B[:, :-1] + B[:, 1:])
        flux = torch.sum(Bmid * (Sm[:, :-1] - Sm[:, 1:]), dim=1)
        return 2.0 * math.pi * (flux + B[:, -1] * Sm[:, -1])

    def models(self, free: np.ndarray, batch: int = 4):
        """free [S, nfree] -> (band fluxes [S, nfilt], valid [S]) in
        blocks of ``batch`` states (under a TF32 control the band
        integral, a matrix product, takes TF32 operands too)."""
        out, ok = [], []
        rnd = self.tf32 or (lambda x: x)        # a TF32 control's matmul
        Wb = rnd(torch.as_tensor(self.bands, device=self.device))
        for i in range(0, len(free), batch):
            T, q, rad, valid = self.profiles(free[i:i + batch])
            out.append((rnd(self.spectrum(T, q, rad)) @ Wb.T).cpu().numpy())
            ok.append(valid)
        return np.concatenate(out), np.concatenate(ok)

    def loglike(self, free: np.ndarray, model: np.ndarray,
                valid: np.ndarray) -> np.ndarray:
        """log L = -chi^2 / 2, -inf out of bounds or where the profiles
        are invalid."""
        chi2 = np.sum(((model - self.data) / self.uncert) ** 2, axis=1)
        inb = np.all((free >= self.pmin[self.ifree])
                     & (free <= self.pmax[self.ifree]), axis=1)
        return np.where(valid & inb, -0.5 * chi2, -np.inf)

    # -- the table, line by line ---------------------------------------
    def _lines_of(self, m: int):
        """(species, lines, cutoff) of molecule ``m``: the list trimmed to
        the grid +- 30 cm-1 and culled below ethresh of its strongest,
        and the half-width the program buckets lines by (nwidth times the
        larger of the coolest, deepest Lorentz and the hottest Doppler
        width at the grid's top, at most 25 cm-1)."""
        sp = self.line_species[m]
        grid = self.wn_fine
        lines = self.lines[sp]
        lo, hi = np.searchsorted(lines["wn0"], [grid[0] - 30.0,
                                                grid[-1] + 30.0])
        lines = {k: v[lo:hi] for k, v in lines.items()}
        if self.ethresh > 0:
            keep = lines["s296"] >= self.ethresh * lines["s296"].max()
            lines = {k: v[keep] for k, v in lines.items()}
        gl_max = lorentz_hwhm(sp, self.t_grid[0], self.pressure[-1] * 1e6,
                              self.q_h2, self.q_he, K_BOLTZ_VOIGT)
        gd_max = doppler_hwhm(sp, grid[-1], 4000.0, K_BOLTZ_VOIGT)
        return sp, lines, min(self.nwidth * max(gl_max, gd_max), CUTOFF_MAX)

    def fingerprint(self) -> str:
        """A digest of what the table is built from: the cfg keys and the
        line list's bytes."""
        h = hashlib.sha256(json.dumps(self.c, sort_keys=True).encode())
        with open(self.linedb, "rb") as f:
            h.update(f.read())
        return h.hexdigest()

    def build_table(self, rnd=None) -> torch.Tensor:
        """The table [M, nT, L, F] cm^2 on the device, float64, line by
        line: each line's Voigt profile (Weideman's series) added at the
        fine points within its reach, under the rules ``cross_sections``
        states.  Lines are taken in chunks of at most BUILD_CHUNK (T
        node, line, point) triples.  ``rnd`` (the control) rounds the
        wavenumbers and the entries by it."""
        rnd = rnd or (lambda x: x)
        dev, f64 = self.device, torch.float64
        grid = self.wn_fine
        n = len(grid)
        h = (grid[-1] - grid[0]) / (n - 1)
        g = rnd(torch.as_tensor(grid, dtype=f64, device=dev))
        t0 = torch.arange(n, device=dev) // TILE * TILE
        a, b = g[t0], g[torch.clamp(t0 + TILE - 1, max=n - 1)]
        T = self.t_grid
        nT, L = len(T), len(self.pressure)
        out = torch.zeros(len(self.line_species), nT, L, n, dtype=f64,
                          device=dev)
        for m in range(len(self.line_species)):
            sp, lines, cutoff = self._lines_of(m)
            wn0 = lines["wn0"]
            N = len(wn0)
            s = torch.as_tensor(np.stack([line_strength(sp, lines, t)
                                          for t in T]), device=dev)
            gd = doppler_hwhm(sp, wn0[None, :], T[:, None])     # [nT, N]
            sig = torch.as_tensor(gd / math.sqrt(2.0 * math.log(2.0)),
                                  device=dev)
            w0 = torch.as_tensor(wn0, device=dev)
            w0r = rnd(w0)
            for lay in range(L):
                gl = lorentz_hwhm(sp, T, float(self.pressure[lay]) * 1e6,
                                  self.q_h2, self.q_he)          # [nT]
                reach = torch.as_tensor(self.nwidth * np.maximum(
                    gd, gl[:, None]), device=dev)
                # a line reaches no farther than its tile's window
                R = min(float(reach.max()), cutoff + TILE * h)
                span = 2 * int(R / h) + 3
                j0 = torch.ceil((w0 - R - grid[0]) / h).long()
                glt = torch.as_tensor(gl, device=dev)[:, None, None]
                acc = torch.zeros(nT, n, dtype=f64, device=dev)
                step = max(1, BUILD_CHUNK // (nT * span))
                for c in range(0, N, step):
                    j = j0[c:c + step, None] + torch.arange(span, device=dev)
                    jc = j.clamp(0, n - 1)
                    wc = w0[c:c + step, None]
                    dx = g[jc] - w0r[c:c + step, None]            # [nc, sp]
                    ok = ((j >= 0) & (j < n) & (wc >= a[jc] - cutoff)
                          & (wc < b[jc] + cutoff))
                    ok = ok & (dx.abs() <= reach[:, c:c + step, None])
                    prof = voigt(dx, sig[:, c:c + step, None], glt)
                    val = torch.where(ok, s[:, c:c + step, None] * prof, 0.0)
                    acc.scatter_add_(1, jc.reshape(1, -1).expand(nT, -1),
                                     val.reshape(nT, -1))
                out[m, :, lay] = rnd(acc)
        return out

    def cross_sections(self, m: int, it: int, layer: int, j: np.ndarray,
                       rnd=None) -> tuple[np.ndarray, float]:
        """Cross-sections [len(j)] cm^2 of molecule ``m`` at T-node
        ``it``, layer ``layer`` and fine points ``j``, line by line with
        scipy's Voigt profile, and the scale of that row (the strength
        sum over the grid's span).  The lines are ``_lines_of``'s; each
        point sums the lines whose centres lie within the bucketing reach
        of its 256-point tile (the program's truncation rule), each
        profile cut at nwidth times the larger of its Doppler and Lorentz
        widths.  ``rnd`` (the control) rounds the wavenumbers and the
        results by it."""
        rnd = rnd or (lambda x: x)

        def r(a):
            return rnd(torch.as_tensor(np.asarray(a, np.float64))).numpy()

        sp, lines, cutoff = self._lines_of(m)
        grid = self.wn_fine
        T = float(self.t_grid[it])
        p = float(self.pressure[layer]) * 1e6
        s = line_strength(sp, lines, T)
        gd = doppler_hwhm(sp, lines["wn0"], T)
        gl = lorentz_hwhm(sp, T, p, self.q_h2, self.q_he)
        reach = self.nwidth * np.maximum(gd, gl)
        sigma_g = gd / math.sqrt(2.0 * math.log(2.0))
        out = np.zeros(len(j))
        n = len(grid)
        for i, jj in enumerate(np.asarray(j)):
            t0 = (jj // TILE) * TILE
            a, b = grid[t0], grid[min(t0 + TILE - 1, n - 1)]
            l0, l1 = np.searchsorted(lines["wn0"], [a - cutoff, b + cutoff])
            dx = r(grid[jj]) - r(lines["wn0"][l0:l1])
            prof = sps.voigt_profile(dx, sigma_g[l0:l1], gl)
            prof = np.where(np.abs(dx) <= reach[l0:l1], prof, 0.0)
            out[i] = np.sum(s[l0:l1] * prof)
        return r(out), float(np.sum(s) / (grid[-1] - grid[0]))
