#!/usr/bin/env python3
"""The port's benchmark from the checkout's root (bart_tpu_torch/bench.py):
one JSON line of likelihood evaluations per second on the card, the
extras on stderr.

    python3 bench_torch.py [--device cpu] [--tiny]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bart_tpu_torch.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
