"""Thermochemical-equilibrium abundances (the TEA-equivalent stage).

This package's own host copy of bart_tpu/chem/tea.py.

The reference's TEA minimizes Gibbs free energy per layer with the
White, Johnson & Dantzig Lagrangian steepest-descent + lambda
correction (reference: SURVEY.md section 2.4 — lagrange.py,
lambdacorr.py, iterate.py, runatm.py looping over layers with
multiprocessing).  This module solves the same minimization with the
**element-potential (dual) method** (Reynolds' STANJAN family):

At the minimum of G = sum_i n_i (g_i/RT + ln(x_i p/p°)) subject to
element conservation, mole fractions satisfy exactly

    ln x_i = sum_j a_ij lam_j - g_i/RT - ln(p/p°)

for element potentials lam_j, with the total gas moles N an extra
unknown closing sum(x) = 1.  Damped Newton on (lam, ln N) — a dense
(nelem+1)-dimensional solve per layer, batched over all layers at
once.  The stage runs in float64 numpy regardless of the forward
model's dtype (equilibrium spans ~600 e-folds of abundance; f32 cannot
represent the intermediate exponentials), replacing TEA's per-layer
Python loop ("several minutes", manual tex:819) with milliseconds.
"""

from __future__ import annotations

import numpy as np

from bart_tpu_torch.chem.thermo import gibbs_rt
from bart_tpu_torch.physics.stoich import parse_formula, strip_janaf

__all__ = ["equilibrium_abundances", "solve_equilibrium", "solve_equilibrium_batch"]


def _stoich_matrix(species: list[str], elements: list[str]) -> np.ndarray:
    """a[i, j] = count of element j in species i ('e' column for ions)."""
    A = np.zeros((len(species), len(elements)))
    for i, sp in enumerate(species):
        if sp in ("e-", "e"):  # free electron
            A[i, elements.index("e")] = 1
            continue
        counts = parse_formula(strip_janaf(sp))
        for elem, n in counts.items():
            if elem == "e":
                if "e" in elements:
                    A[i, elements.index("e")] += n
                continue
            if elem not in elements:
                raise ValueError(
                    f"species {sp!r} contains element {elem!r} not in the "
                    f"input element list {elements}"
                )
            A[i, elements.index(elem)] += n
    return A


def solve_equilibrium_batch(
    A: np.ndarray,
    g_rt: np.ndarray,
    b: np.ndarray,
    ln_p_bar: np.ndarray,
    n_iter: int = 120,
    damp: float = 1.0,
) -> np.ndarray:
    """Batched element-potential Newton solve (float64 numpy).

    ``A`` [nspec, nelem]; ``g_rt`` [batch, nspec]; ``b`` [nelem]
    (any normalization); ``ln_p_bar`` [batch].  Returns x[batch, nspec].
    """
    A = np.asarray(A, np.float64)
    g_rt = np.atleast_2d(np.asarray(g_rt, np.float64))
    ln_p = np.asarray(ln_p_bar, np.float64).reshape(-1, 1)
    nbatch, nspec = g_rt.shape
    nelem = A.shape[1]
    b = np.asarray(b, np.float64)
    b = b / b.sum()

    # init: uniform composition
    x0 = np.full(nspec, 1.0 / nspec)
    rhs = g_rt + ln_p + np.log(x0)                      # [batch, nspec]
    lam = np.linalg.lstsq(A, rhs.T, rcond=None)[0].T    # [batch, nelem]
    m0 = x0 @ A                                         # [nelem]
    nu = np.full((nbatch, 1), np.log(b.sum() / max(m0.sum(), 1e-300)))

    eye = 1e-14 * np.eye(nelem + 1)
    for _ in range(n_iter):
        ln_x = lam @ A.T - g_rt - ln_p                  # [batch, nspec]
        ln_x = np.clip(ln_x, -600.0, 600.0)
        x = np.exp(ln_x)
        N = np.exp(np.clip(nu, -600.0, 600.0))          # [batch, 1]
        m = x @ A                                       # [batch, nelem]
        R = np.concatenate([N * m - b, x.sum(1, keepdims=True) - 1.0], axis=1)
        # Jacobian blocks:
        J_ll = N[:, :, None] * np.einsum("bi,ij,ik->bjk", x, A, A)
        J_ln = (N * m)[:, :, None]
        J_sl = m[:, None, :]
        J = np.concatenate(
            [
                np.concatenate([J_ll, J_ln], axis=2),
                np.concatenate([J_sl, np.zeros((nbatch, 1, 1))], axis=2),
            ],
            axis=1,
        )
        try:
            step = np.linalg.solve(J + eye, R[:, :, None])[:, :, 0]
        except np.linalg.LinAlgError:
            # singular/non-finite Jacobian in some batch element (e.g.
            # ill-posed thermo input): damped pseudo-inverse fallback
            J = np.where(np.isfinite(J), J, 0.0)
            R = np.where(np.isfinite(R), R, 0.0)
            step = np.einsum("bij,bj->bi",
                             np.linalg.pinv(J + 1e3 * eye), R)
        # step limiting (the reference's lambda-correction role):
        s = np.minimum(
            1.0, damp * 2.0 / np.maximum(np.abs(step).max(1, keepdims=True), 1e-12)
        )
        lam = lam - s * step[:, :nelem]
        nu = nu - s * step[:, nelem:]

    ln_x = lam @ A.T - g_rt - ln_p
    ln_x = np.clip(ln_x, -600.0, 600.0)
    x = np.exp(ln_x)
    return x / x.sum(1, keepdims=True)


def solve_equilibrium(A, g_rt, b, ln_p_bar, n_iter: int = 120, damp: float = 1.0):
    """Single-condition convenience wrapper around the batched solver
    (float64 numpy x[nspec]; bart_tpu's returns the same as a jnp array)."""
    x = solve_equilibrium_batch(
        np.asarray(A), np.asarray(g_rt)[None, :], np.asarray(b),
        np.asarray(ln_p_bar).reshape(1), n_iter=n_iter, damp=damp,
    )
    return x[0]


def equilibrium_abundances(
    species: list[str],
    elements: list[str],
    pressure_bar: np.ndarray,
    temperature: np.ndarray,
    elem_table,
    maxiter: int = 100,
    g_tables: dict | None = None,
) -> np.ndarray:
    """Equilibrium mole fractions q[nlayer, nspec] over the atmosphere.

    ``elements`` like the reference's in_elem ('H He C N O');
    ``elem_table`` an io.abundances.ElementTable giving the dex
    abundances (the reference's pre-atm elemental fractions,
    makeatm.make_preatm:606-691).
    """
    species = [strip_janaf(s) for s in species]
    if g_tables:
        covered = {strip_janaf(s) for s in g_tables}
        missing = [s for s in species if s not in covered]
        if missing and len(missing) < len(species):
            import warnings

            warnings.warn(
                f"g_tables (formation convention) cover only part of the "
                f"species set — {missing} fall back to the analytic "
                "free-atom thermochemistry.  The two conventions differ "
                "by per-element shifts and MUST NOT be mixed in one "
                "solve; supply tables for all species or none "
                "(chem/thermo_tables.py module doc).",
                stacklevel=2,
            )
    # drop elements that no species uses to keep the system nonsingular
    used = set()
    for sp in species:
        if sp in ("e-", "e"):
            used.add("e")
            continue
        used |= {e for e in parse_formula(sp) if e != "e"}
    elements = [e for e in elements if e in used]

    A = _stoich_matrix(species, elements)
    b = np.array([
        1.0 if e == "e" else 10.0 ** elem_table.dex_of(e) for e in elements
    ])

    T = np.asarray(temperature, np.float64)
    lnp = np.log(np.asarray(pressure_bar, np.float64))
    g = np.stack(
        [
            np.asarray(gibbs_rt(sp, T, (g_tables or {}).get(sp)), np.float64)
            for sp in species
        ],
        axis=1,
    )  # [nlayer, nspec]

    niter = max(60, min(maxiter * 2, 240))
    return solve_equilibrium_batch(A, g, b, lnp, n_iter=niter)
