"""Retrieval-config preflight (``python -m bart_tpu_torch -c cfg --validate``).

This package's own host copy of bart_tpu/driver/validate.py.

Checks a configuration WITHOUT building anything: input files exist
and parse, data/uncert/filter counts agree, the parameter vectors are
mutually consistent and match the parameter layout the forward model
will expect (reference BARTfunc.py:173-179 — the reference has no
preflight at all; a bad key there surfaces hours into a run).

Returns (issues, notes): issues fail the preflight (exit 1), notes
are informational (stages that will build missing artifacts, inert
compatibility keys, etc.).
"""

from __future__ import annotations

import os

import numpy as np

from bart_tpu_torch.driver.config import RetrievalConfig, load_data_array

__all__ = ["validate_config", "run_validate"]


def _exists(path) -> bool:
    return bool(path) and os.path.isfile(str(path))


def validate_config(cfg: RetrievalConfig, cfgdir: str = "."
                    ) -> tuple[list[str], list[str]]:
    issues: list[str] = []
    notes: list[str] = []

    # --- input files -------------------------------------------------
    if not _exists(cfg.tep_name):
        issues.append(f"tep_name missing: {cfg.tep_name!r} (system "
                      "parameters are required for any forward model)")
    if not _exists(cfg.abun_basic):
        issues.append(f"abun_basic missing: {cfg.abun_basic!r}")
    for key in ("molfile", "kurucz", "press_file", "thermofile"):
        val = getattr(cfg, key)
        if val and val != "builtin" and not _exists(val):
            issues.append(f"{key} set but missing: {val!r}")
    for path in cfg.csfile or []:
        if not _exists(path):
            issues.append(f"csfile missing: {path!r}")

    has_opacity = _exists(cfg.opacityfile) or _exists(
        os.path.join(cfgdir, str(cfg.opacityfile or "")))
    if cfg.linedb:
        if not _exists(cfg.linedb):
            if has_opacity:
                notes.append(f"linedb missing ({cfg.linedb!r}) but the "
                             "opacity table exists and will be reused")
            else:
                issues.append(f"linedb missing: {cfg.linedb!r}")
    elif not has_opacity:
        issues.append("neither linedb nor an existing opacityfile given "
                      "— no line opacity source")
    if cfg.opacityfile and not has_opacity:
        notes.append(f"opacityfile {cfg.opacityfile!r} will be BUILT "
                     "(the --justOpacity stage)")
    if cfg.atmfile and not _exists(cfg.atmfile):
        notes.append(f"atmfile {cfg.atmfile!r} will be generated by the "
                     "atmosphere stage")

    # --- filters + data ---------------------------------------------
    nfilt = None
    if cfg.filters:
        from bart_tpu_torch.io.filters import read_filter

        nfilt = len(cfg.filters)
        for path in cfg.filters:
            if not _exists(path):
                issues.append(f"filter missing: {path!r}")
                continue
            try:
                fw, ft = read_filter(path)
                if len(fw) < 2 or not np.all(np.isfinite(ft)):
                    issues.append(f"filter unusable: {path!r}")
            except Exception as e:
                issues.append(f"filter failed to parse: {path!r}: {e}")
    elif cfg.walk != "unif":
        notes.append("no filters given: spectrum-only runs are fine, "
                     "retrievals band-integrate a dummy boxcar")

    for key in ("data", "uncert"):
        val = getattr(cfg, key)
        if val is None:
            if cfg.walk != "unif":
                issues.append(f"{key} not given (required unless "
                              "walk = unif)")
            continue
        try:
            arr = load_data_array(val, cfgdir)
        except Exception as e:
            issues.append(f"{key} failed to load: {e}")
            continue
        if nfilt is not None and arr is not None and len(arr) != nfilt:
            issues.append(f"{key} has {len(arr)} entries but "
                          f"{nfilt} filters are given")
        if key == "uncert" and arr is not None and np.any(
                np.asarray(arr) <= 0):
            issues.append("uncert contains non-positive entries")

    # --- wavenumber grid --------------------------------------------
    try:
        wn = cfg.wavenumber_grid()
        if len(wn) < 2:
            issues.append("wavenumber grid has fewer than 2 points")
    except Exception as e:
        issues.append(f"wavenumber grid underivable (set wnlow/wnhigh "
                      f"or wllow/wlhigh): {e}")

    # --- parameter vectors ------------------------------------------
    vecs = {k: getattr(cfg, k) for k in
            ("params", "pmin", "pmax", "stepsize")}
    given = {k: v for k, v in vecs.items() if v is not None}
    if cfg.walk != "unif" and len(given) < 4:
        issues.append(f"missing parameter vector(s): "
                      f"{sorted(set(vecs) - set(given))}")
    lengths = {k: len(v) for k, v in given.items()}
    if cfg.parnames is not None:
        lengths["parnames"] = len(cfg.parnames)
    if len(set(lengths.values())) > 1:
        issues.append(f"parameter vector lengths disagree: {lengths}")
    elif given:
        n = next(iter(lengths.values()))
        # expected layout (reference BARTfunc.py:173-179)
        from bart_tpu_torch.physics.pt import n_pt_params

        if cfg.PTtype not in n_pt_params:
            issues.append(f"unknown PTtype {cfg.PTtype!r} "
                          f"(choices: {sorted(n_pt_params)})")
        else:
            n_expected = (
                n_pt_params[cfg.PTtype]
                + int(cfg.solution == "transit")
                + int(cfg.cloudtop is not None)
                + int(cfg.scattering is not None)
                + len(cfg.molfit or [])
            )
            n_eff = n - (3 if cfg.wlike else 0)
            if n_eff != n_expected:
                issues.append(
                    f"params has {n_eff} model entries but "
                    f"{cfg.solution}/{cfg.PTtype} with "
                    f"molfit={cfg.molfit} cloudtop="
                    f"{cfg.cloudtop is not None} scattering="
                    f"{cfg.scattering is not None} expects {n_expected} "
                    f"(PT {n_pt_params[cfg.PTtype]} + radius "
                    f"{int(cfg.solution == 'transit')} + cloud + ray + "
                    f"molfit{' + 3 wlike' if cfg.wlike else ''})")
        if all(k in given for k in ("params", "pmin", "pmax")):
            p = np.asarray(cfg.params, float)
            lo = np.asarray(cfg.pmin, float)
            hi = np.asarray(cfg.pmax, float)
            if len(p) == len(lo) == len(hi):
                bad = np.where((p < lo) | (p > hi))[0]
                if bad.size:
                    issues.append(
                        f"params outside [pmin, pmax] at indices "
                        f"{bad.tolist()}")
        if "stepsize" in given:
            ss = np.asarray(cfg.stepsize, float)
            for j, s in enumerate(ss):
                if s < 0:
                    src = int(-s) - 1
                    if not (0 <= src < len(ss)) or ss[src] <= 0:
                        issues.append(
                            f"stepsize[{j}] shares parameter {src} "
                            "which is not a free parameter")
            if not np.any(ss > 0) and cfg.walk != "unif":
                issues.append("no free parameters (all stepsize <= 0)")

    # --- species / molfit -------------------------------------------
    from bart_tpu_torch.physics.stoich import strip_janaf

    out_species = [strip_janaf(s) for s in (cfg.out_spec or "").split()]
    for m in cfg.molfit or []:
        if m not in out_species:
            issues.append(f"molfit species {m!r} not in out_spec "
                          f"{out_species}")
    if cfg.uniform is not None and len(cfg.uniform) != len(out_species):
        issues.append(f"uniform has {len(cfg.uniform)} entries for "
                      f"{len(out_species)} out_spec species")

    # --- grids / bounds sanity --------------------------------------
    if cfg.Tmin >= cfg.Tmax:
        issues.append(f"Tmin {cfg.Tmin} >= Tmax {cfg.Tmax}")
    if cfg.tlow > cfg.Tmin or cfg.thigh < cfg.Tmax:
        notes.append(
            f"opacity T grid [{cfg.tlow}, {cfg.thigh}] does not cover "
            f"[Tmin, Tmax] = [{cfg.Tmin}, {cfg.Tmax}]: extinction is "
            "edge-clamped outside the grid")
    if cfg.solution not in ("eclipse", "transit", "direct"):
        issues.append(f"unknown solution {cfg.solution!r}")
    if cfg.walk not in ("snooker", "demc", "mrw", "unif"):
        issues.append(f"unknown walk {cfg.walk!r}")
    if cfg.quadrature not in ("raygrid", "expsum"):
        issues.append(f"unknown quadrature {cfg.quadrature!r}")
    return issues, notes


def run_validate(cfg: RetrievalConfig, cfgdir: str = ".") -> int:
    """Print the preflight report; return the process exit code."""
    issues, notes = validate_config(cfg, cfgdir)
    for n in notes:
        print(f"  note: {n}")
    for i in issues:
        print(f"  ISSUE: {i}")
    if issues:
        print(f"validate: {len(issues)} issue(s) found")
        return 1
    print("validate: config OK")
    return 0
