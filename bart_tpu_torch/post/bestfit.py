"""Best-fit post-processing (port of bart_tpu/post/bestfit.py).

Equivalent of the reference's bestFit.py (reference:
code/bestFit.py:55-108 read_MCMC_out/get_params, :300-525 callTransit,
:528-688 plot_bestFit_Spectrum) without subprocesses: the best-fit
spectrum, atmosphere, PT envelopes and contribution functions all come
from the forward model on its own device (the batched forward on one
row, ``diagnostics`` and ``diagnostics_batch``, post/cf.py).
``read_mcmc_log`` is a host copy.  matplotlib (post/plots.py) is
imported inside ``best_fit_outputs`` only.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["read_mcmc_log", "best_fit_outputs"]


def read_mcmc_log(path: str):
    """(best-fit parameters, their uncertainties) from the last
    " Best-fit params" block of the log at ``path`` (the reference's
    bestFit.read_MCMC_out)."""
    lines = open(path).readlines()
    ini = None
    for i in range(len(lines) - 1, -1, -1):
        if lines[i].startswith(" Best-fit params"):
            ini = i + 1
            break
    if ini is None:
        raise ValueError(f"{path}: no Best-fit params block")
    bestp, uncert = [], []
    for line in lines[ini:]:
        if not line.strip():
            break
        f = line.split()
        bestp.append(float(f[0]))
        uncert.append(float(f[1]))
    return np.asarray(bestp), np.asarray(uncert)


def best_fit_outputs(fm, like, space, result, out_dir: str,
                     fext: str = ".png", store: dict | None = None,
                     aux: dict | None = None) -> None:
    """Write the full post-processing set: trace/pairwise/histogram,
    best-fit spectrum + .dat file, PT posterior envelope with CF
    overlay, contribution functions / transmittance, best-fit
    atmosphere file."""
    from bart_tpu_torch.io.atm import Atmosphere, write_atm_transit
    from bart_tpu_torch.post import plots
    from bart_tpu_torch.post.cf import (band_average,
                                        contribution_functions,
                                        transmittance)

    dev = fm.device
    f64 = dict(dtype=torch.float64, device=dev)
    store = store or {}
    posterior = result.posterior          # [nchain, nfree, niter]
    pnames = result.pnames

    # --- MCMC plots (mc3plots equivalents, BART.py:599-604) ---
    # For uniform atmospheres, rebase the fitted log-scale factors to
    # absolute log10 molar fractions (reference mc3plots.py:45-61).
    offsets = np.zeros(posterior.shape[1])
    molfit = list(getattr(fm.config, "molfit", ()))
    if molfit:
        nmol = len(molfit)
        mol_lo = space.npars - nmol - (3 if getattr(like, "wlike", False)
                                       else 0)
        base_q = fm.tables["base_q"].cpu().numpy()
        for jf, jp in enumerate(space.ifree):
            if mol_lo <= jp < mol_lo + nmol:
                i_sp = fm.i_molfit[jp - mol_lo]
                col = base_q[:, i_sp]
                if np.allclose(col, col[0]):    # uniform-abundance atm
                    offsets[jf] = np.log10(max(col[0], 1e-300))
    plots.trace(posterior, pnames, os.path.join(out_dir, "trace" + fext),
                offsets=offsets)
    plots.pairwise(posterior, pnames,
                   os.path.join(out_dir, "pairwise" + fext), offsets=offsets)
    plots.histogram(posterior, pnames,
                    os.path.join(out_dir, "posterior" + fext),
                    offsets=offsets)

    # --- best-fit forward evaluation (callTransit equivalent): the
    # batched forward and diagnostics on one row ---
    full_best = space.expand(torch.as_tensor(result.bestp, **f64)[None])
    if getattr(like, "wlike", False):
        full_best = full_best[..., :-3]   # drop (gamma, sigma_r, sigma_w)
    bandflux, spectrum, _ = fm.batched()(full_best)
    T_best, q_best, rad_cm, ext, _ = (
        a[0] for a in fm.diagnostics(full_best))
    wn = fm.wn.cpu().numpy()
    pressure = fm.pressure.cpu().numpy()

    # best-fit spectrum file (outspec format: wavelength um, value;
    # readtransit.py:23-64 contract)
    spec = spectrum[0].cpu().numpy()
    with open(os.path.join(out_dir, "bestfit_spectrum.dat"), "w") as f:
        f.write("#wvl [um]    flux/modulation\n")
        for w, s in zip(wn[::-1], spec[::-1]):
            f.write(f"{1e4/w:.7e}  {s:.7e}\n")

    # best-fit atmosphere (write_atmfile equivalent, bestFit.py:144-268)
    T_np = T_best.cpu().numpy()
    ext_np = ext.cpu().numpy()
    rad_np = rad_cm.cpu().numpy()
    atm_best = Atmosphere(
        species=fm.species, pressure=pressure, temperature=T_np,
        abundances=q_best.cpu().numpy(), radius=rad_np / 1e5,
    )
    write_atm_transit(atm_best, os.path.join(out_dir, "bestfit.atm"))
    plots.abundances_plot(atm_best, os.path.join(out_dir, "abundances" + fext))

    # --- spectrum plot with data ---
    filters = store.get("filters", [])
    data = store.get("data", like.data.cpu().numpy())
    uncert = store.get("uncert", like.uncert.cpu().numpy())
    if len(filters):
        band_wn = np.array([np.average(fw, weights=ft)
                            for fw, ft in filters])
    else:
        band_wn = np.linspace(wn[0], wn[-1], len(data))
    plots.spectrum_plot(
        wn, spec, band_wn, bandflux[0].cpu().numpy(), np.asarray(data),
        np.asarray(uncert),
        os.path.join(out_dir, "bestfit_spectrum" + fext),
        solution=fm.config.solution,
        starfl=store.get("starfl"),
        rprs=getattr(fm.system, "rprs", None),
    )

    # --- auxiliary transit-compatible dumps (reference output files
    # outintens / outtoomuch / outsample / tau.dat via savefiles;
    # SURVEY.md 2.2 "Outputs", cf.py:37-94 tau.dat contract) ---
    aux = aux or {}
    if aux.get("savefiles") or aux.get("outtau") or aux.get("outintens") \
            or aux.get("outtoomuch"):
        from bart_tpu_torch.rt.tau import tau_vertical

        tau = tau_vertical(ext, rad_cm)                    # [layer, wn]
        tau_np = tau.cpu().numpy()
    if aux.get("savefiles") or aux.get("outtau"):
        np.savez(os.path.join(out_dir, aux.get("outtau") or "tau.npz"),
                 tau=tau_np, wn=wn, pressure=pressure, radius_km=rad_np / 1e5)
    if aux.get("outintens") and fm.config.solution in ("eclipse", "direct"):
        from bart_tpu_torch.rt.eclipse import eclipse_intensity

        I = eclipse_intensity(tau, T_best, fm.wn, fm.mu).cpu().numpy()
        mu = fm.mu.cpu().numpy()
        with open(os.path.join(out_dir, aux["outintens"]), "w") as f:
            f.write("#wvl [um]  I(mu) [erg s-1 cm-2 cm sr-1] per angle "
                    f"mu={mu.tolist()}\n")
            for j in range(len(wn) - 1, -1, -1):
                f.write(f"{1e4/wn[j]:.7e} "
                        + " ".join(f"{I[m, j]:.7e}" for m in range(I.shape[0]))
                        + "\n")
    if aux.get("outtoomuch"):
        toomuch = float(aux.get("toomuch", 10.0))
        # topmost layer where tau >= toomuch, per wn (radius of the
        # tau=toomuch surface; reference outtoomuch file)
        hit = tau_np >= toomuch
        idx = np.where(hit.any(axis=0), hit.argmax(axis=0), len(rad_np) - 1)
        with open(os.path.join(out_dir, aux["outtoomuch"]), "w") as f:
            f.write("#wvl [um]   radius [km] where tau = toomuch\n")
            for j in range(len(wn) - 1, -1, -1):
                f.write(f"{1e4/wn[j]:.7e}  {rad_np[idx[j]]/1e5:.7e}\n")
    if aux.get("outsample"):
        with open(os.path.join(out_dir, aux["outsample"]), "w") as f:
            f.write(f"# wn grid: {len(wn)} samples, "
                    f"[{wn[0]:.6f}, {wn[-1]:.6f}] cm-1\n")
            f.write(f"# layers: {len(pressure)} "
                    f"[{pressure[0]:.3e}, {pressure[-1]:.3e}] bar\n")
            f.write(f"# raygrid mu: {fm.mu.cpu().numpy().tolist()}\n")

    # --- contribution functions / transmittance (BART.py:627-644) ---
    cf_overlay = None
    if fm.config.solution in ("eclipse", "direct"):
        cf_lw = contribution_functions(ext_np, rad_np, T_np, pressure, wn,
                                       device=dev)
        if len(filters):
            cf_bands = band_average(cf_lw, wn, filters, device=dev)
            np.save(os.path.join(out_dir, "cf.npy"), cf_bands)
            cf_overlay = cf_bands.mean(axis=1)
    else:
        tr_lw = transmittance(ext_np, rad_np, device=dev)
        if len(filters):
            tr_bands = band_average(tr_lw, wn, filters, device=dev)
            np.save(os.path.join(out_dir, "transmittance.npy"), tr_bands)
            # pseudo-CF for transit: d(transmittance)/dlnp
            cf_overlay = np.abs(np.gradient(tr_bands.mean(axis=1)))

    # --- PT posterior envelope (bestFit.py:429-525) ---
    # sample PT profiles from the posterior (thinned):
    flat = posterior.transpose(1, 0, 2).reshape(space.nfree, -1)
    if flat.shape[1] == 0:
        # No post-burn-in samples (numit <= burnin): envelope degenerates
        # to the best-fit profile rather than crashing on an empty
        # percentile (the reference would plot garbage here; we warn).
        print("# WARNING: empty post-burn-in posterior; PT envelope uses "
              "the best-fit profile only")
        T_batch = T_np[None, :]
    else:
        nsamp = min(300, flat.shape[1])
        idx = np.linspace(0, flat.shape[1] - 1, nsamp).astype(int)
        full_batch = space.expand(torch.as_tensor(flat[:, idx].T, **f64))
        if getattr(like, "wlike", False):
            full_batch = full_batch[..., :-3]
        T_batch = fm.diagnostics_batch()(full_batch)[0].cpu().numpy()
    plots.pt_envelope(
        pressure, T_batch, T_np,
        os.path.join(out_dir, "PT_envelope" + fext), cf_overlay=cf_overlay,
    )
