"""``BENCHMARK.json`` and the files it names, found by name: a
configuration's file (its ``file`` entry), a traffic mix's parameters
(``workloads/<traffic>.json``), a cell's limits (``limits/<cell>.json``)
and a per-layer metric's reader (``metrics/<metric>.py``, a ``read(ctx)``
that returns a number or None)."""

from __future__ import annotations

import importlib.util
import json
import os
import re

#: the benchmark's directory; the repository's root is its parent
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str, man: dict | None = None) -> dict:
    """The cell's entry of ``workloads``, with its ``config`` object
    (the configuration's file), ``traffic_params``, ``limits`` and the
    metrics it reports: ``end_to_end`` and ``per_layer`` lists of
    entries."""
    man = man or manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; have {sorted(cells)}")
    w = dict(cells[name])
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    w["config_entry"] = conf
    w["config_obj"] = _json(os.path.join(ROOT, conf["file"]))
    w["traffic_params"] = _json(os.path.join(HERE, "workloads",
                                             w["traffic"] + ".json"))
    w["limits"] = _json(os.path.join(HERE, "limits", name + ".json"))

    def mine(m):
        return name in m.get("workloads", [name])

    w["end_to_end"] = [m for m in man["end_to_end"] if mine(m)]
    w["per_layer"] = [m for m in man["per_layer"] if mine(m)]
    return w


def reader(metric: str):
    """The ``read`` function of metrics/<metric>.py."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
