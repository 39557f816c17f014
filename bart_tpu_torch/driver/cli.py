"""Command-line interface (port of bart_tpu/driver/cli.py).

Mirrors the reference driver invocation (reference: BART.py:58-71):

    python -m bart_tpu_torch -c <config> [--justTEA | --justOpacity |
                                          --justPlots | --justSpectrum |
                                          --resume | --validate]
                             [--device cuda|cpu] [--key value ...]

Any config key can be overridden on the command line (the reference's
two-pass argparse behavior, BART.py:279-289).  ``--device`` picks the
device the stages run on: the card unless the caller asks for the CPU
(bart_tpu's CLI is pointed at the CPU by ``JAX_PLATFORMS``); without a
card, ``--device cuda`` raises before anything is read.
"""

from __future__ import annotations

import argparse
import os
import sys

from bart_tpu_torch.device import resolve_device
from bart_tpu_torch.driver.config import load_config
from bart_tpu_torch.driver.pipeline import Pipeline

__all__ = ["main"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="bart_tpu_torch",
        description="Bayesian Atmospheric Radiative Transfer on a CUDA "
                    "card (PyTorch port of bart_tpu)",
    )
    parser.add_argument("-c", "--config_file", metavar="FILE",
                        help="INI configuration file ([MCMC] section)")
    parser.add_argument("--justTEA", action="store_true",
                        help="run only the atmosphere/chemistry stage")
    parser.add_argument("--justOpacity", action="store_true",
                        help="run only up to the opacity-table build")
    parser.add_argument("--justPlots", action="store_true",
                        help="re-run only the post-processing")
    parser.add_argument("--justSpectrum", action="store_true",
                        help="compute one spectrum from the atm file's "
                             "own profiles and stop (the standalone "
                             "`transit -c cfg` use case)")
    parser.add_argument("--resume", action="store_true",
                        help="reuse existing stage outputs in loc_dir")
    parser.add_argument("--validate", action="store_true",
                        help="preflight: check inputs exist/parse and "
                             "parameter vectors are consistent, build "
                             "nothing (exit 1 on issues)")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="write a torch.profiler trace to DIR")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the stages (default: cuda; "
                             "'cpu' runs them on the host)")
    args, extra = parser.parse_known_args(argv)
    device = resolve_device(args.device)

    # --key value overrides:
    overrides = {}
    it = iter(extra)
    for tok in it:
        if tok.startswith("--"):
            key = tok[2:]
            try:
                overrides[key] = next(it)
            except StopIteration:
                overrides[key] = "True"

    cfg = load_config(args.config_file, overrides)
    if args.validate:
        from bart_tpu_torch.driver.validate import run_validate

        cfgdir = (os.path.dirname(os.path.abspath(args.config_file))
                  if args.config_file else os.getcwd())
        return run_validate(cfg, cfgdir)
    pipe = Pipeline(
        cfg,
        just_tea=args.justTEA,
        just_opacity=args.justOpacity,
        just_plots=args.justPlots,
        just_spectrum=args.justSpectrum,
        resume=args.resume,
        device=device,
    )
    from bart_tpu_torch.utils.profiling import device_trace

    with device_trace(args.profile, device):
        pipe.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
