"""bart_tpu_torch as an installed package: pyproject.toml ships every
non-Python file the port reads at run time, names its console script,
and the libraries it compiles at first use go to one directory inside
the package, which git ignores and which, when it cannot be written,
stops the build with its path instead of falling back."""

import fnmatch
import os
import subprocess
import sys
import textwrap
import tomllib
from pathlib import Path

import pytest

import bart_tpu_torch
from bart_tpu_torch.linelist import hitran
from bart_tpu_torch.native import hitran_native
from bart_tpu_torch.rt import fused
from bart_tpu_torch.utils import build

REPO = Path(__file__).resolve().parents[1]
PORT = Path(bart_tpu_torch.__file__).resolve().parent
PYPROJECT = tomllib.loads((REPO / "pyproject.toml").read_text())
#: the non-Python files the port reads at run time, relative to PORT
RUNTIME_GLOBS = ("csrc/*.cu", "csrc/*.cuh", "native/*.cpp",
                 "chem/data/*.dat")


def _shipped(rel: Path) -> bool:
    """Whether a package-data glob of pyproject.toml matches ``rel``, a
    path relative to the repository root."""
    for package, globs in PYPROJECT["tool"]["setuptools"][
            "package-data"].items():
        pdir = Path(*package.split("."))
        if pdir not in rel.parents:
            continue
        inner = rel.relative_to(pdir).as_posix()
        if any(fnmatch.fnmatch(inner, g) and inner.count("/")
               == g.count("/") for g in globs):
            return True
    return False


@pytest.mark.parametrize("pattern", RUNTIME_GLOBS)
def test_package_data_ships_what_the_port_reads(pattern):
    files = sorted(PORT.glob(pattern))
    assert files, pattern
    for f in files:
        rel = f.relative_to(REPO)
        assert _shipped(rel), f"{rel} is not in pyproject's package-data"


def test_every_non_python_file_of_the_port_is_shipped():
    """No file of the package but its Python modules, caches and built
    libraries lies outside the package-data globs."""
    skip = {"__pycache__", "build"}
    files = [f for f in PORT.rglob("*") if f.is_file()
             and f.suffix not in (".py", ".pyc")
             and not skip & set(f.relative_to(PORT).parts)]
    assert len(files) >= 8
    for f in files:
        assert _shipped(f.relative_to(REPO)), f


def test_console_script_is_the_cli():
    scripts = PYPROJECT["project"]["scripts"]
    assert scripts["bart-tpu-torch"] == "bart_tpu_torch.driver.cli:main"
    assert scripts["bart-tpu"] == "bart_tpu.driver.cli:main"
    module, attr = scripts["bart-tpu-torch"].split(":")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(f"""
            import importlib, sys
            sys.modules["jax"] = None
            sys.modules["bart_tpu"] = None
            main = getattr(importlib.import_module({module!r}), {attr!r})
            try:
                main(["--help"])
            except SystemExit as e:
                print("exit", e.code)
        """)], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("exit 0"), proc.stdout
    assert "--justSpectrum" in proc.stdout and "--device" in proc.stdout


def test_lazy_exports_cover_the_reference():
    import bart_tpu

    assert set(bart_tpu._LAZY) <= set(bart_tpu_torch._LAZY)
    from bart_tpu_torch.driver.config import load_config
    from bart_tpu_torch.driver.pipeline import Pipeline
    from bart_tpu_torch.linelist.tli import load_tli, save_tli

    assert bart_tpu_torch.Pipeline is Pipeline
    assert bart_tpu_torch.load_config is load_config
    assert bart_tpu_torch.load_tli is load_tli
    assert bart_tpu_torch.save_tli is save_tli
    assert {"Pipeline", "load_config", "load_tli",
            "save_tli"} <= set(dir(bart_tpu_torch))


def test_build_directories_lie_inside_the_package():
    """The kernels' and the scanner's libraries go to
    bart_tpu_torch/build/, keyed on their sources' hashes, and git
    ignores that directory."""
    assert build.BUILD_DIR == PORT / "build"
    for name in fused._KERNELS:
        so = fused._so_path(name)
        assert so.parent == build.BUILD_DIR
        assert so.name.startswith(f"{name}_") and so.suffix == ".so"
    lib = hitran_native.library_path()
    assert lib.parent == build.BUILD_DIR
    assert lib.name.startswith("libhitran_scan_")
    # ".gitignore"'s unanchored build/ ignores a build directory anywhere
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_unwritable_build_directory_raises_with_its_path(tmp_path,
                                                         monkeypatch):
    """A build directory that cannot be created stops the kernel build
    and the scanner with its path: read_par does not fall back to the
    numpy parser."""
    blocker = tmp_path / "not_a_directory"
    blocker.write_text("")
    bad = blocker / "build"
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "ok" / "build")
    assert build.build_dir().is_dir()
    monkeypatch.setattr(build, "BUILD_DIR", bad)
    with pytest.raises(RuntimeError, match=str(bad)):
        build.build_dir()
    with pytest.raises(RuntimeError, match="build directory"):
        fused.build_kernels(["fused_eclipse"])

    par = tmp_path / "one.par"
    par.write_text(" 61 2147.081134 2.706E-19 3.366E+01.0601.0664    "
                   "0.0000 0.69-.000026\n")
    monkeypatch.setattr(hitran_native, "_lib", None)
    with pytest.raises(RuntimeError, match=str(bad)):
        hitran.read_par(str(par))
