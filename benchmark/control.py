#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process on the
card: for each seed, a fresh ensemble on the cell's likelihood (its first
block and ``--blocks`` more, the window's shape), every number the check
can compare of the program against the reference (the lower readings),
and on the same sampled entries and states the numbers of the control,
the reference in the next precision below the configuration's taking the
program's place (the upper readings: its table built with bfloat16
wavenumbers and entries, its rows rounded as ``Reference.precisions``
says, the walk's proposals in float32 for its float64 state).  First a
line with the whole table's gaps and the control's row gap, then one
JSON line a seed, on standard output.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
        [--blocks 3]

The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from bm import cell, check, manifest
    from bm.reference import Reference, rounder

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    w = manifest.cell(args.workload)
    tp, lim = w["traffic_params"], w["limits"]
    spans = cell.Spans(dev)
    cfg, fm, like, space, table_path = cell.set_up(w, dev, spans)
    def reference(table, control=False):
        r = Reference(w["config_obj"], tp["cfg"], manifest.HERE, dev)
        r.load_table(table, *r.precisions(control))
        return r

    t0 = time.perf_counter()
    own = cell.reference_table(
        Reference(w["config_obj"], tp["cfg"], manifest.HERE, dev), w["name"])
    print(json.dumps({"reference_table_s": time.perf_counter() - t0}),
          flush=True)
    with np.load(table_path) as z:
        sigma = z["sigma"]
    # the reference on its own table and on the program's (the stage
    # numbers), each also in the control's precision
    ref, low = reference(own), reference(own, True)
    stage, stage_low = reference(sigma), reference(sigma, True)
    table_control = rounder("bfloat16")
    low_table = Reference(w["config_obj"], tp["cfg"], manifest.HERE,
                          dev).build_table(table_control).float().cpu()
    print(json.dumps({"whole_table": check.whole_table(sigma, own),
                      "control_row_gap": check.row_gap(low_table.numpy(),
                                                        own),
                      "fine_bins": [int(x.mask.sum()) if x.mask is not None
                                    else None for x in (ref, stage)]}),
          flush=True)
    del low_table
    for seed in args.seeds:
        t0 = time.perf_counter()
        sampler, gen, rec = cell.chains(w, cfg, like, space, seed, dev)
        state = cell.begin(sampler, gen, rec)
        for _ in range(args.blocks):
            state = cell.advance(sampler, gen, rec, state)
        t1 = time.perf_counter()
        prog = check.compare(ref, rec, sigma, own, seed, lim, stage)
        t2 = time.perf_counter()
        rng = np.random.default_rng([seed, 7])
        ctrl = dict(zip(("table_gap", "table_sum_gap"), check.table_gaps(
            ref, sigma, rng, check.SAMPLES["table_entries"],
            control=table_control)))
        ctrl["model_gap"], ctrl["loglike_gap"] = check.model_gaps(
            ref, rec, rng, check.SAMPLES["states"], control_ref=low)
        ctrl["prop_gap"] = check.walk_gaps(
            ref, rec, rng, check.SAMPLES["steps"], 1,
            lim["decision_margin"], dtype=np.float32)[0]
        ctrl["stage_model_gap"], ctrl["stage_loglike_gap"] = \
            check.model_gaps(stage, rec, np.random.default_rng([seed, 8]),
                             check.SAMPLES["states"], control_ref=stage_low)
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl,
                          "accept": float(np.mean(np.any(
                              np.diff(rec["blocks"][-1][0], axis=0) != 0,
                              axis=-1))),
                          "run_s": t1 - t0, "check_s": t2 - t1}),
              flush=True)
        del sampler, state
    return 0


if __name__ == "__main__":
    sys.exit(main())
