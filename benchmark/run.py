#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number the
check compared with its limit, which also end standard error.  Without a
card, or with fewer than the cell asks for, it prints no result and exits
with 2.  If JAX or the JAX package was loaded in this process, it names
what it found on standard error and exits with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "cache")
#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "bart_tpu")


def loaded_forbidden() -> list:
    """The top-level names of FORBIDDEN modules in sys.modules, each name
    compared whole."""
    return sorted({m.split(".")[0] for m, v in list(sys.modules.items())
                   if v is not None} & set(FORBIDDEN))


def card_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return p.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path[:0] = [HERE, ROOT]
    from bm import manifest

    w = manifest.cell(args.workload)
    if not os.path.isdir(os.path.join(ROOT, "bart_tpu_torch")):
        print("run.py: the program (bart_tpu_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(w["chips"])):
        print(f"run.py: the cell needs {w['chips']} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import numpy as np

    from bm import cell

    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   T_START)
    found = loaded_forbidden()
    if found:
        print(f"run.py: modules loaded in this process that may not be: "
              f"{found}", file=sys.stderr)
        return 3

    if args.trace:
        names = {m["name"]: m for m in w["per_layer"]}
        metrics = {k: {"value": v, "unit": names[k]["unit"]}
                   for k, v in out["per_layer"].items() if k in names}
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]],
                               "unit": m["unit"]} for m in w["end_to_end"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(w["chips"]),
              "memory_peak_bytes": int(out["memory_peak_bytes"]),
              "card": card_limit()}
    if args.trace:
        device.update(busy_s=out["busy_s"], window_s=out["traced_window_s"])
    res = {"correct": bool(out["correct"]), "attempted": out["attempted"],
           "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace:
        res["breakdown"] = out["breakdown"]
    res["checks"] = {k: {"value": v if np.isfinite(v) else str(v),
                         "limit": lim}
                     for k, (v, lim) in out["checks"].items()}
    sys.stdout.flush()
    b = out["block_s"]
    print(f"window: {len(b)} blocks in {out['window_s']:.3f} s; a block "
          f"min {b.min():.4f} median {float(np.median(b)):.4f} max "
          f"{b.max():.4f} s; set-up {out['metrics']['setup_s']:.3f} s",
          file=sys.stderr)
    for k, (v, lim) in out["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
