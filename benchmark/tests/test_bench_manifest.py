"""BENCHMARK.json and every file it names load by name, and every name and
unit keeps to the allowed characters."""

import json
import os
import re

import pytest

from benchtools import HERE, ROOT, manifest

MAN = manifest.manifest()
TOP = ["command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_size():
    assert list(MAN) == TOP
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_configuration_file(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and conf["reduced"] == []
    assert conf["file"].startswith("benchmark/configs/")
    with open(os.path.join(ROOT, conf["file"])) as f:
        obj = json.load(f)
    assert obj["name"] == conf["name"] and obj["source"] == conf["source"]
    assert obj["reduced"] == []
    for key in obj["path_keys"]:
        for p in obj["cfg"][key].split():
            assert os.path.isfile(os.path.join(HERE, p)), p
    assert any(w["config"] == conf["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("cellname", [w["name"] for w in MAN["workloads"]])
def test_cell_files_and_metrics(cellname):
    w = manifest.cell(cellname, MAN)
    assert set(w["traffic_params"]) >= {"cfg", "chains", "block"}
    from bm import check

    lim = set(w["limits"])
    assert lim >= {"table_gap", "table_sum_gap", "table_row_gap",
                   "prop_gap", "decisions_wrong", "decision_margin"}
    assert lim <= set(check.NUMBERS) | {"decision_margin"}
    assert lim >= {"model_gap", "loglike_gap"} or lim >= {
        "stage_model_gap", "stage_loglike_gap"}
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    e2e = [m["name"] for m in w["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert w["per_layer"]


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_names_and_readers(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in MAN["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in [m["name"] for m in MAN["end_to_end"]]
        assert callable(manifest.reader(metric["name"]))
        if "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


def test_layers_are_named_alike():
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert layers == {"driver set-up", "sampler graphs",
                      "sampler and likelihood", "forward model", "kernels",
                      "device"}
