"""The comparison that decides ``correct``: what the window produced, set
against the plain reference.

Three layers, each by numbers of its own:

* the table set-up built (``table_gap``, ``table_sum_gap``): entries
  drawn from the seed, recomputed line by line with scipy's Voigt
  profile; and (``table_row_gap``) every row's sum against the
  reference's own table;
* the forward and the likelihood (``model_gap``, ``loglike_gap``): states
  the window produced, drawn from the seed, through the reference forward
  on the reference's own table (its fine-bin split derived from it); and
  (``stage_model_gap``, ``stage_loglike_gap``) the forward's stage by
  itself, the reference forward on the program's table;
* the sampler (``prop_gap``, ``decisions_wrong``): steps of the window
  drawn from the seed, their proposals recomputed from the previous
  positions, the archive rebuilt from the run's own history and the
  variates redrawn from the run's generator; every chain that moved must
  have moved to its proposal, and each sampled chain's accept decision
  must be the reference's wherever the reference's margin is clear of
  ``decision_margin``.
"""

from __future__ import annotations

import numpy as np

from . import walk

#: the numbers a run can compare, in the order they are printed; a cell
#: compares those its limits file names
NUMBERS = ("table_gap", "table_sum_gap", "table_row_gap", "model_gap",
           "loglike_gap", "stage_model_gap", "stage_loglike_gap",
           "prop_gap", "decisions_wrong")
#: what a run compares: table entries, states of the window, steps of the
#: window and chains of each step
SAMPLES = {"table_entries": 1024, "states": 64, "steps": 4,
           "chains_per_step": 16}


def table_gaps(ref, sigma: np.ndarray, rng, n_entries: int,
               control=None) -> tuple[float, float]:
    """(table_gap, table_sum_gap) of entries of the program's table
    ``sigma`` [M, nT, L, F] drawn from the seed, 16 a row, against the
    reference's line-by-line cross-sections: the largest gap of an entry
    over |reference| + 1e-4 of the row's scale (the mean cross-section
    the row's lines give over the grid), and the gap of the entries' sum
    over the reference's sum.  ``control``: the reference with its
    wavenumbers and results rounded by that function (reference.rounder)
    takes the program's place."""
    M, nT, L, F = sigma.shape
    worst, got_sum, want_sum = 0.0, 0.0, 0.0
    for _ in range(max(1, n_entries // 16)):
        m, it, lay = rng.integers(M), rng.integers(nT), rng.integers(L)
        j = np.sort(rng.integers(F, size=16))
        want, scale = ref.cross_sections(int(m), int(it), int(lay), j)
        got = (sigma[m, it, lay, j].astype(np.float64) if control is None
               else ref.cross_sections(int(m), int(it), int(lay), j,
                                       control)[0])
        gap = np.abs(got - want) / (np.abs(want) + 1e-4 * scale)
        worst = max(worst, float(gap.max()))
        got_sum += float(np.sum(got))
        want_sum += float(np.sum(want))
    return worst, abs(got_sum - want_sum) / abs(want_sum)


def row_gap(sigma: np.ndarray, own: np.ndarray) -> float:
    """The largest gap of a row's sum (molecule, T node, layer) in the
    table ``sigma`` from the row's sum in the reference's own table
    ``own``, over the latter."""
    want = own.sum(-1, dtype=np.float64)
    got = sigma.sum(-1, dtype=np.float64)
    return float(np.max(np.abs(got - want) / np.where(want > 0, want, 1.0)))


def whole_table(sigma: np.ndarray, own: np.ndarray) -> dict:
    """The program's table ``sigma`` against the reference's own, every
    entry: the gap of the whole sum, the largest gap of a row's sum
    (molecule, T node, layer) over the row's, and the 50th, 99th and
    largest gap of an entry above 1e-6 of its molecule's largest."""
    out = {"sum_gap": float(abs(sigma.sum(dtype=np.float64)
                                - own.sum(dtype=np.float64))
                            / own.sum(dtype=np.float64))}
    out["row_sum_gap"] = row_gap(sigma, own)
    gaps = []
    for m in range(own.shape[0]):
        a, b = sigma[m].ravel(), own[m].ravel()
        big = b > 1e-6 * b.max()
        gaps.append(np.abs(a[big].astype(np.float64) - b[big]) / b[big])
    g = np.concatenate(gaps)
    out.update(entry_p50=float(np.quantile(g, 0.5)),
               entry_p99=float(np.quantile(g, 0.99)), entry_max=float(g.max()))
    return out


def states(record: dict, rng, n: int):
    """n (block, step, chain) triples of the window drawn from the seed."""
    nb = len(record["blocks"]) - record["first_window_block"]
    B, C = record["block"], record["chains"]
    b = record["first_window_block"] + rng.integers(nb, size=n)
    return b, rng.integers(B, size=n), rng.integers(C, size=n)


def model_gaps(ref, record: dict, rng, n: int, control_ref=None):
    """(model_gap, loglike_gap) of n states of the window: the largest
    relative gap of a band flux and the largest gap of a log-likelihood
    from the reference's at the same positions.  ``control_ref``: a
    reference in lower precision takes the program's place."""
    b, s, c = states(record, rng, n)
    free = np.stack([record["blocks"][i][0][j, k] for i, j, k in
                     zip(b, s, c)])
    want, valid = ref.models(free)
    ll_want = ref.loglike(free, want, valid)
    if control_ref is None:
        got = np.stack([record["blocks"][i][2][j, k] for i, j, k in
                        zip(b, s, c)]).astype(np.float64)
        ll_got = np.array([record["blocks"][i][1][j, k] for i, j, k in
                           zip(b, s, c)])
    else:
        got, gvalid = control_ref.models(free)
        ll_got = control_ref.loglike(free, got, gvalid)
    with np.errstate(invalid="ignore"):
        ok = np.isfinite(ll_want)
        mgap = float(np.max(np.abs(got[ok] - want[ok]) / np.abs(want[ok]),
                            initial=0.0))
        both_inf = ~ok & ~np.isfinite(ll_got)
        lgap = np.where(both_inf, 0.0, np.abs(ll_got - ll_want))
    return mgap, float(np.max(np.nan_to_num(lgap, nan=np.inf)))


def walk_gaps(ref, record: dict, rng, n_steps: int, per_step: int,
              margin: float, dtype=None):
    """(prop_gap, decisions_wrong) over n_steps steps of the window: the
    largest gap, in units of the prior's width, between a chain's new
    position and its proposal over every chain that moved; and the
    number of sampled chains whose accept decision differs from the
    reference's where the reference's log margin exceeds ``margin``.
    ``dtype`` (the control): the proposals of a walk computed in that
    type take the program's new positions' place."""
    B, C = record["block"], record["chains"]
    lo, hi = record["lo"], record["hi"]
    dev = record["device"]
    first = record["first_window_block"] * B
    total = len(record["blocks"]) * B
    picks = np.sort(first + rng.choice(total - first, size=n_steps,
                                       replace=False))

    def pos_after(k):                  # positions after step k (k >= -1)
        if k < 0:
            return record["init_pos"]
        return record["blocks"][k // B][0][k % B]

    Z, count = walk.initial_archive(record["gen_init"], record["nz"], lo,
                                    hi, record["init_pos"], dev)
    worst, wrong = 0.0, 0
    k = 0
    for pick in picks:
        while k < pick:                # the archive before step ``pick``
            count = walk.append(Z, count, pos_after(k), k, record["z_thin"])
            k += 1
        blk, i = divmod(int(pick), B)
        v = walk.draw_block(record["gen_blocks"][blk], B, C, len(lo), dev,
                            upto=i)[i]
        prev, new = pos_after(pick - 1), pos_after(pick)
        prop, corr = walk.propose(prev, Z, count, v, lo, hi,
                                  record["fgamma"], snooker_frac=record[
                                      "snooker_frac"])
        if dtype is not None:
            new = walk.propose(*(x.astype(dtype) for x in (prev, Z)), count,
                               {k: x.astype(dtype) for k, x in v.items()},
                               lo.astype(dtype), hi.astype(dtype),
                               record["fgamma"], snooker_frac=record[
                                   "snooker_frac"])[0].astype(np.float64)
        moved = np.any(new != prev, axis=1)
        if moved.any():
            worst = max(worst, float(np.max(np.abs(new[moved] - prop[moved])
                                            / (hi - lo))))
        sel = rng.choice(C, size=per_step, replace=False)
        m, valid = ref.models(prop[sel])
        ll_prop = ref.loglike(prop[sel], m, valid)
        blk_prev, i_prev = divmod(int(pick) - 1, B)
        ll_prev = record["blocks"][blk_prev][1][i_prev, sel]
        with np.errstate(invalid="ignore"):
            mg = ll_prop - ll_prev + corr[sel] - np.log(v["u_acc"][sel])
        accept = mg > 0
        clear = ~(np.abs(mg) <= margin)
        wrong += int(np.sum((accept != moved[sel]) & clear))
    return worst, wrong


def compare(ref, record: dict, sigma: np.ndarray, own: np.ndarray,
            seed: int, limits: dict, stage=None) -> dict:
    """{number: value} of one run, every number drawn from ``seed``:
    ``sigma`` the program's saved table, ``own`` the reference's (loaded
    in ``ref``), ``stage`` the reference with the program's table loaded
    (the stage numbers: None leaves them out)."""
    if sigma.shape != own.shape:
        raise ValueError(f"the program's table {sigma.shape} is not the "
                         f"configuration's {own.shape}")
    rng = np.random.default_rng([seed, 7])
    out = dict(zip(("table_gap", "table_sum_gap"), table_gaps(
        ref, sigma, rng, SAMPLES["table_entries"])))
    out["table_row_gap"] = row_gap(sigma, own)
    out["model_gap"], out["loglike_gap"] = model_gaps(
        ref, record, rng, SAMPLES["states"])
    if stage is not None:
        out["stage_model_gap"], out["stage_loglike_gap"] = model_gaps(
            stage, record, np.random.default_rng([seed, 8]),
            SAMPLES["states"])
    out["prop_gap"], out["decisions_wrong"] = walk_gaps(
        ref, record, rng, SAMPLES["steps"], SAMPLES["chains_per_step"],
        limits["decision_margin"])
    return out
