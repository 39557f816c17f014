"""Nothing in the benchmark imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), the reference imports nothing of the program, and a run on a
machine without a card prints no result."""

import ast
import glob
import os
import subprocess
import sys
import types

import pytest

from benchtools import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "bart_tpu"}
#: the files that make up the reference and the comparison
REFERENCE = ["bm/reference.py", "bm/walk.py", "bm/check.py"]
SOURCES = sorted(glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True))


def imported(path: str) -> set:
    """Top-level names of the modules a source imports (relative imports
    left out)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_anywhere(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("rel", REFERENCE)
def test_reference_imports_nothing_of_the_program(rel):
    names = imported(os.path.join(HERE, rel))
    assert "bart_tpu_torch" not in names
    assert names <= {"__future__", "hashlib", "json", "math", "os", "numpy",
                     "scipy", "torch"}


def test_guard_compares_whole_names(monkeypatch):
    sys.path.insert(0, HERE)
    import run

    monkeypatch.setitem(sys.modules, "bart_tpu_torch_like",
                        types.ModuleType("bart_tpu_torch_like"))
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "bart_tpu.rt",
                        types.ModuleType("bart_tpu.rt"))
    assert run.loaded_forbidden() == ["bart_tpu"]


def test_no_card_no_result(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "wasp12b_eclipse.k1", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 2, p.stderr
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr
