"""The control at a tiny size on the CPU: control.py's readings of the
program (within every limit) and of the reference in the next precision
below the configuration's taking the program's place (outside the limits
of the table and of the band fluxes)."""

import json

import pytest

import benchtools
from benchtools import CELLS, manifest


def lim_of(w):
    return w["limits"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name, tmp_path, monkeypatch,
                                          capsys):
    import control
    from bm import cell

    w = manifest.cell(name)
    ov = benchtools.tiny_overrides(name, str(tmp_path))
    w["traffic_params"].update(chains=16)
    w["traffic_params"]["cfg"] = dict(w["traffic_params"]["cfg"], **ov)
    monkeypatch.setattr(manifest, "cell", lambda n, man=None: w)
    benchtools.tiny_harness(monkeypatch, str(tmp_path))
    set_up = cell.set_up
    monkeypatch.setattr(cell, "set_up", lambda w, dev, spans,
                        overrides=None: set_up(w, dev, spans, ov))
    assert control.main(["--workload", name, "--seeds", "2147483659",
                         "--blocks", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    table = json.loads(lines[1])
    assert table["control_row_gap"] > lim_of(w)["table_row_gap"], table
    line = json.loads(lines[-1])
    lim = w["limits"]
    assert all(v <= lim[k] for k, v in line["program"].items() if k in lim
               ), line
    for k in ("table_gap", "table_sum_gap"):
        assert line["control"][k] > lim[k], (k, line)
    fwd = [k for k in ("model_gap", "stage_model_gap") if k in lim]
    assert fwd and all(line["control"][k] > lim[k] for k in fwd), line
