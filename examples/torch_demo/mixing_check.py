#!/usr/bin/env python3
"""Mixing of the CLI demo's eclipse retrieval under the sampler's settings.

Builds the table, forward model and likelihood of
examples/torch_demo/eclipse.cfg once through the pipeline's stages on the
card, then runs ``run_mcmc`` (512 chains, 10,000 steps, burn-in 5,000)
with float32 or float64 sampler state, a block of 100 or 250 steps and
seed 0 or 7, and prints for each run, as a JSON line, the acceptance,
rank-normalised split-R-hat, best chi^2 and the posterior's pulls from the
demo truth (the quantities of tests/test_end_to_end.py:71-87).  Outputs
go to build/mixing_check/.

    python3 examples/torch_demo/mixing_check.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from bart_tpu_torch.demo import TRUTH  # noqa: E402
from bart_tpu_torch.driver.config import load_config  # noqa: E402
from bart_tpu_torch.driver.pipeline import Pipeline  # noqa: E402
from bart_tpu_torch.inference.retrieval import run_mcmc  # noqa: E402

#: (sampler-state dtype, block, seed) of each run
VARIANTS = [(torch.float32, 100, 0), (torch.float64, 100, 0),
            (torch.float64, 250, 7), (torch.float32, 250, 7)]
NCHAINS, STEPS, BURNIN = 512, 10000, 5000


def main() -> int:
    cfg = load_config(os.path.join(HERE, "eclipse.cfg"), {
        "loc_dir": os.path.join(ROOT, "build", "mixing_check"),
        "quiet": "True"})
    pipe = Pipeline(cfg, device="cuda")
    atm = pipe.stage_atmosphere(pipe.stage_pressure(),
                                pipe.stage_abundances())
    wn = cfg.wavenumber_grid()
    grid = pipe.stage_opacity(pipe.stage_linelist(wn), wn, atm.pressure, atm)
    _, like, space = pipe.stage_forward(atm, wn, grid)
    truth = TRUTH[space.ifree]
    prior_std = (space.free_max - space.free_min) / np.sqrt(12.0)
    for dtype, block, seed in VARIANTS:
        t0 = time.time()
        res = run_mcmc(like, space, nchains=NCHAINS, numit=NCHAINS * STEPS,
                       burnin=BURNIN, block=block, seed=seed, verbose=False,
                       dtype=dtype)
        flat = res.posterior.transpose(1, 0, 2).reshape(space.nfree, -1)
        mean, std = flat.mean(1), flat.std(1)
        print(json.dumps(dict(
            dtype=str(dtype), block=block, seed=seed,
            s=round(time.time() - t0, 2), accept=res.accept_rate,
            fgamma=res.fgamma_final, rhat=res.psrf_rank.tolist(),
            chi2=-2.0 * res.best_loglike, mean=mean.tolist(),
            std=std.tolist(), constrained=(std < 0.5 * prior_std).tolist(),
            pulls=(np.abs(mean - truth) / np.maximum(std, 1e-12)).tolist())),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
