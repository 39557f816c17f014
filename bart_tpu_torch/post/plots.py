"""Posterior and spectrum plots.

This package's own host copy of bart_tpu/post/plots.py.

Equivalent of the reference's plot suite (reference: code/mc3plots.py
trace/pairwise/histogram; code/bestFit.py:429-525 PT posterior
envelopes; :528-688 best-fit spectrum) rendered with matplotlib Agg.
"""

from __future__ import annotations

import os

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

__all__ = ["trace", "pairwise", "histogram", "pt_envelope", "spectrum_plot"]


def _flat(posterior: np.ndarray) -> np.ndarray:
    """[nchain, nfree, niter] -> [nfree, nsamples]."""
    return posterior.transpose(1, 0, 2).reshape(posterior.shape[1], -1)


def _rebase(posterior: np.ndarray, offsets) -> np.ndarray:
    """Add per-parameter offsets (reference mc3plots.py:45-61: for
    uniform atmospheres the fitted log-scale factors are rebased to
    absolute log10 molar fractions by adding log10(q_uniform))."""
    if offsets is None:
        return posterior
    return posterior + np.asarray(offsets)[None, :, None]


def trace(posterior: np.ndarray, pnames, path: str,
          offsets=None) -> None:
    """Per-chain parameter traces (mc3plots trace equivalent)."""
    posterior = _rebase(posterior, offsets)
    nchain, nfree, niter = posterior.shape
    fig, axes = plt.subplots(nfree, 1, figsize=(8, 2 * nfree), sharex=True,
                             squeeze=False)
    for j in range(nfree):
        ax = axes[j, 0]
        for c in range(nchain):
            ax.plot(posterior[c, j], lw=0.5, alpha=0.7)
        ax.set_ylabel(pnames[j])
    axes[-1, 0].set_xlabel("iteration")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def pairwise(posterior: np.ndarray, pnames, path: str, nbins: int = 35,
             offsets=None) -> None:
    """Lower-triangle 2-D marginal histograms (mc3plots pairwise)."""
    flat = _flat(_rebase(posterior, offsets))
    nfree = flat.shape[0]
    fig, axes = plt.subplots(nfree, nfree, figsize=(2.2 * nfree, 2.2 * nfree),
                             squeeze=False)
    for i in range(nfree):
        for j in range(nfree):
            ax = axes[i, j]
            if j > i:
                ax.axis("off")
                continue
            if i == j:
                ax.hist(flat[i], bins=nbins, color="#4a78b5")
            else:
                ax.hist2d(flat[j], flat[i], bins=nbins, cmap="Blues")
            if i == nfree - 1:
                ax.set_xlabel(pnames[j])
            if j == 0:
                ax.set_ylabel(pnames[i])
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def histogram(posterior: np.ndarray, pnames, path: str, nbins: int = 40,
              offsets=None) -> None:
    """1-D marginal posteriors (mc3plots histogram)."""
    flat = _flat(_rebase(posterior, offsets))
    nfree = flat.shape[0]
    ncol = min(nfree, 4)
    nrow = -(-nfree // ncol)
    fig, axes = plt.subplots(nrow, ncol, figsize=(3 * ncol, 2.5 * nrow),
                             squeeze=False)
    for j in range(nfree):
        ax = axes[j // ncol, j % ncol]
        ax.hist(flat[j], bins=nbins, color="#4a78b5")
        ax.set_xlabel(pnames[j])
    for j in range(nfree, nrow * ncol):
        axes[j // ncol, j % ncol].axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def pt_envelope(
    pressure: np.ndarray,
    t_samples: np.ndarray,
    t_best: np.ndarray,
    path: str,
    cf_overlay: np.ndarray | None = None,
) -> None:
    """Posterior PT envelopes at the reference's percentiles
    (15.87/84.13 and 2.28/97.72; code/bestFit.py:429-525), with
    optional normalized contribution-function overlay."""
    lo1, hi1 = np.percentile(t_samples, [15.87, 84.13], axis=0)
    lo2, hi2 = np.percentile(t_samples, [2.28, 97.72], axis=0)
    median = np.median(t_samples, axis=0)

    fig, ax = plt.subplots(figsize=(6, 7))
    ax.fill_betweenx(pressure, lo2, hi2, color="#c6dbef", label="95.4%")
    ax.fill_betweenx(pressure, lo1, hi1, color="#6baed6", label="68.3%")
    ax.plot(median, pressure, "b-", lw=1.5, label="median")
    ax.plot(t_best, pressure, "r-", lw=1.5, label="best fit")
    if cf_overlay is not None:
        cf = cf_overlay / cf_overlay.max()
        tspan = ax.get_xlim()
        ax.plot(tspan[0] + cf * 0.25 * (tspan[1] - tspan[0]), pressure,
                "k--", lw=1, label="norm. CF")
    ax.set_yscale("log")
    ax.invert_yaxis()
    ax.set_xlabel("Temperature (K)")
    ax.set_ylabel("Pressure (bar)")
    ax.legend(loc="best")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def spectrum_plot(
    wn: np.ndarray,
    spectrum: np.ndarray,
    band_wn: np.ndarray,
    band_model: np.ndarray,
    data: np.ndarray,
    uncert: np.ndarray,
    path: str,
    solution: str = "eclipse",
    starfl: np.ndarray | None = None,
    rprs: float | None = None,
) -> None:
    """Best-fit spectrum with band-integrated points and data
    (bestFit.plot_bestFit_Spectrum equivalent)."""
    wl_um = 1e4 / wn
    if solution == "eclipse" and starfl is not None:
        spec_plot = spectrum / starfl * rprs**2
        ylabel = "Fp/Fs (Rp/Rs)^2"
    elif solution == "transit":
        spec_plot = spectrum
        ylabel = "transit depth (Rp/Rs)^2"
    else:
        spec_plot = spectrum
        ylabel = "Flux (erg s$^{-1}$ cm$^{-2}$ cm)"

    fig, ax = plt.subplots(figsize=(8.5, 5))
    ax.plot(wl_um, spec_plot, "b-", lw=0.7, alpha=0.7, label="best-fit model")
    ax.plot(1e4 / band_wn, band_model, "ko", ms=5, label="band-integrated")
    ax.errorbar(1e4 / band_wn, data, yerr=uncert, fmt="rs", ms=5,
                label="data", zorder=5)
    ax.set_xlabel("Wavelength (um)")
    ax.set_ylabel(ylabel)
    ax.legend(loc="best")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def abundances_plot(atm, path: str, species: list[str] | None = None) -> None:
    """Vertical abundance profiles (reference bestFit.plotabun,
    code/bestFit.py:691-745)."""
    species = species or atm.species
    fig, ax = plt.subplots(figsize=(6, 7))
    for name in species:
        j = atm.species.index(name)
        ax.loglog(atm.abundances[:, j], atm.pressure, lw=1.5, label=name)
    ax.invert_yaxis()
    ax.set_xlabel("Mole mixing fraction")
    ax.set_ylabel("Pressure (bar)")
    ax.set_xlim(1e-12, 2)
    ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
