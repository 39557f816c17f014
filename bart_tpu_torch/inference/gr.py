"""Gelman-Rubin convergence diagnostics (this package's own copy of
bart_tpu/inference/gr.py; host numpy).

The reference's grtest/grexit capability (reference: SURVEY.md section
2.3; demo cfg grtest/grexit True): potential scale reduction factor
computed across chains on the second half of the samples.

Two statistics:

* ``gelman_rubin`` — the classic PSRF the reference's MC3 computes
  (matching its grtest semantics).
* ``split_rhat_rank`` — rank-normalized split-R-hat (Vehtari,
  Gelman, Simpson, Carpenter & Buerkner 2021, "Rank-normalization,
  folding, and localization: an improved R-hat"): each chain is split
  in half (detects within-chain trends the classic statistic misses),
  draws are replaced by normal scores of their pooled ranks (robust to
  heavy tails and prior-plateau directions where variances are
  ill-behaved), and the max of the rank-normalized statistic on the
  draws and on the folded draws |x - median| (which detects scale
  mis-mixing) is reported.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gelman_rubin", "split_rhat_rank", "effective_sample_size"]


def gelman_rubin(chains: np.ndarray) -> np.ndarray:
    """PSRF per parameter.

    ``chains`` has shape [nchain, niter, nfree]; the first half of each
    chain is discarded as burn-in (standard split used by MC3).
    Returns psrf[nfree]; values near 1 indicate convergence.
    """
    chains = np.asarray(chains)
    nchain, niter, nfree = chains.shape
    x = chains[:, niter // 2 :, :]
    n = x.shape[1]
    if n < 2 or nchain < 2:
        return np.full(nfree, np.inf)

    mean_c = x.mean(axis=1)                   # [nchain, nfree]
    var_c = x.var(axis=1, ddof=1)             # within-chain variances
    W = var_c.mean(axis=0)
    B_over_n = mean_c.var(axis=0, ddof=1)     # = B/n
    var_plus = (n - 1) / n * W + B_over_n
    with np.errstate(divide="ignore", invalid="ignore"):
        psrf = np.sqrt((var_plus + B_over_n / nchain) / W)
    return np.where(W > 0, psrf, 1.0)


def _rhat_basic(x: np.ndarray) -> np.ndarray:
    """Classic R-hat on [nchain, n, nfree] (no further splitting)."""
    nchain, n, nfree = x.shape
    mean_c = x.mean(axis=1)
    var_c = x.var(axis=1, ddof=1)
    W = var_c.mean(axis=0)
    B_over_n = mean_c.var(axis=0, ddof=1)
    var_plus = (n - 1) / n * W + B_over_n
    with np.errstate(divide="ignore", invalid="ignore"):
        rhat = np.sqrt(var_plus / W)
    return np.where(W > 0, rhat, 1.0)


def _rank_normalize(x: np.ndarray) -> np.ndarray:
    """Pooled fractional ranks -> normal scores, per parameter.

    x [nchain, n, nfree] -> z of the same shape, where
    z = ndtri((rank - 3/8) / (N + 1/4))  (Blom offsets, as in the
    Vehtari et al. 2021 recommendation).  Ties take AVERAGE
    (fractional) ranks: with MCMC acceptance ~0.16 most draws are
    exact repeats, and position-based tie-breaking ranks cross-chain
    ties in chain order, inflating the between-chain variance.
    """
    from scipy.special import ndtri
    from scipy.stats import rankdata

    nchain, n, nfree = x.shape
    N = nchain * n
    flat = x.reshape(N, nfree)
    ranks = rankdata(flat, method="average", axis=0)   # 1-based
    z_flat = ndtri((ranks - 0.375) / (N + 0.25))
    return z_flat.reshape(nchain, n, nfree)


def _acov_fft(x: np.ndarray) -> np.ndarray:
    """Per-chain autocovariance via FFT.  x [nchain, n, nfree] ->
    acov [nchain, n, nfree] (biased normalization n, as in the
    Stan/Vehtari estimator)."""
    nchain, n, nfree = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(xc, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :n, :].real
    return acov / n


def effective_sample_size(chains: np.ndarray) -> np.ndarray:
    """Bulk effective sample size per parameter (Vehtari et al. 2021).

    ``chains`` [nchain, niter, nfree] (post-burn-in draws).  Each
    chain is split in half, draws are rank-normalized, per-chain
    autocovariances combine into the multi-chain correlation estimate
      rho_t = 1 - (W - mean_m acov_{m,t}) / var_plus
    summed with Geyer's initial monotone positive-pair sequence;
    ESS = M n / (1 + 2 sum rho).  Capped at M n log10(M n) (the
    estimator's reliability limit for antithetic chains).
    """
    chains = np.asarray(chains, np.float64)
    nchain, niter, nfree = chains.shape
    half = niter // 2
    if half < 4:
        return np.full(nfree, np.nan)
    x = np.concatenate(
        [chains[:, :half, :], chains[:, niter - half:, :]], axis=0)
    x = _rank_normalize(x)
    M, n, _ = x.shape

    acov = _acov_fft(x)                          # [M, n, nfree]
    mean_acov = acov.mean(axis=0)                # [n, nfree]
    W = (acov[:, 0, :] * n / (n - 1.0)).mean(axis=0)
    mean_c = x.mean(axis=1)
    B_over_n = mean_c.var(axis=0, ddof=1)
    var_plus = (n - 1.0) / n * W + B_over_n

    ess = np.empty(nfree)
    for j in range(nfree):
        if var_plus[j] <= 0:
            ess[j] = M * n
            continue
        rho = 1.0 - (W[j] - mean_acov[:, j]) / var_plus[j]
        # Geyer: sum consecutive pairs while positive, enforce
        # monotone decrease
        tau = -1.0  # accounts for rho_0 = 1 double-count below
        prev_pair = np.inf
        t = 0
        while t + 1 < n:
            pair = rho[t] + rho[t + 1]
            if pair < 0:
                break
            pair = min(pair, prev_pair)
            prev_pair = pair
            tau += 2.0 * pair
            t += 2
        tau = max(tau, 1.0 / np.log10(M * n + 10.0))
        ess[j] = min(M * n / tau, M * n * np.log10(M * n))
    return ess


def split_rhat_rank(chains: np.ndarray) -> np.ndarray:
    """Rank-normalized split-R-hat per parameter (Vehtari et al. 2021).

    ``chains`` [nchain, niter, nfree] — the draws to diagnose (pass the
    post-burn-in part; this function does NOT discard a warmup half,
    unlike ``gelman_rubin``, but it DOES split each chain in half).
    Returns max(bulk, tail-folded) statistic per parameter; < 1.01 is
    the published convergence recommendation.
    """
    chains = np.asarray(chains, np.float64)
    nchain, niter, nfree = chains.shape
    half = niter // 2
    if half < 2 or nchain < 1:
        return np.full(nfree, np.inf)
    # split each chain in half -> 2*nchain chains of length half
    x = np.concatenate(
        [chains[:, :half, :], chains[:, niter - half:, :]], axis=0)

    bulk = _rhat_basic(_rank_normalize(x))
    med = np.median(x.reshape(-1, nfree), axis=0)
    folded = np.abs(x - med)
    tail = _rhat_basic(_rank_normalize(folded))
    return np.maximum(bulk, tail)
