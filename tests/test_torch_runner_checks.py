"""The flagship runner's checks hold under ``python -O``:
examples/torch_demo/run_wasp12b.py raises (or exits with a usage error)
where it used bare ``assert`` statements, which ``-O`` strips."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
RUNNER = REPO / "examples" / "torch_demo" / "run_wasp12b.py"


def test_runner_has_no_bare_assert():
    tree = ast.parse(RUNNER.read_text())
    asserts = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Assert)]
    assert asserts == []
    # the truth checks are explicit raises with the original's messages
    text = RUNNER.read_text()
    assert 'raise RuntimeError("truth parameters rejected by the forward ' \
           'model")' in text
    assert "committed WASP-12b depths no longer reproduce the truth" in text


def test_fold_and_short_is_a_usage_error_under_python_O():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-O", str(RUNNER), "--fold", "--short", "--device",
         "cpu", "--outdir", os.devnull],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    # argparse's usage error: exit 2, the message on stderr, no run
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "--fold and --short are exclusive" in proc.stderr
    assert "usage:" in proc.stderr
    assert "WASP-12b regression" not in proc.stdout
