"""The port as a user installs it: every package listed, the ``ssa-torch``
console script, and where an installed copy builds its libraries.

Nothing here compiles: the build directory is read, never written.
"""
import importlib
import os
import shutil
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

from libssa_tpu_torch.util import cudabuild

ROOT = Path(__file__).resolve().parents[1]


def _pyproject() -> dict:
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)


def _port_packages() -> list[str]:
    pkg = ROOT / "libssa_tpu_torch"
    return sorted(".".join(init.parent.relative_to(ROOT).parts)
                  for init in pkg.rglob("__init__.py"))


def test_every_port_package_is_listed():
    """An unlisted package is missing from an install (``set_device_count``
    imports ``libssa_tpu_torch.parallel``)."""
    found = _port_packages()
    assert {"libssa_tpu_torch", "libssa_tpu_torch.parallel",
            "libssa_tpu_torch.experiments"} <= set(found)
    listed = set(_pyproject()["tool"]["setuptools"]["packages"])
    assert not set(found) - listed, sorted(set(found) - listed)


def test_kernel_sources_ship_with_the_package():
    """Every source the package builds at first use is package data."""
    data = _pyproject()["tool"]["setuptools"]["package-data"]["libssa_tpu_torch"]
    sources = sorted((ROOT / "libssa_tpu_torch" / "csrc").iterdir())
    assert len(sources) >= 8
    missing = [p.name for p in sources
               if not any(Path("csrc", p.name).match(g) for g in data)]
    assert not missing, missing


@pytest.mark.parametrize("name,target", [("ssa-torch", "libssa_tpu_torch.cli:main"),
                                         ("ssa", "libssa_tpu.cli:main")])
def test_console_scripts(name, target):
    """``ssa-torch`` runs the port's CLI beside the reference's ``ssa``."""
    scripts = _pyproject()["project"]["scripts"]
    assert scripts[name] == target
    if name == "ssa-torch":  # the port's; importing the reference's needs JAX
        module, attr = target.split(":")
        assert callable(getattr(importlib.import_module(module), attr))


def test_build_dir_of_the_checkout():
    assert cudabuild.BUILD_DIR == ROOT / "build" / "libssa_tpu_torch"
    assert cudabuild.library_path("interseq.cu", "nvcc").parent == cudabuild.BUILD_DIR


@pytest.mark.parametrize("cache", ["absolute", "unset", "relative"])
def test_build_dir_outside_a_checkout(tmp_path, monkeypatch, cache):
    """A package whose parent holds no pyproject.toml builds under
    $XDG_CACHE_HOME (absolute), else ~/.cache."""
    site = tmp_path / "site-packages"
    (site / "libssa_tpu_torch").mkdir(parents=True)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if cache == "absolute":
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        want = tmp_path / "xdg" / "libssa_tpu_torch"
    else:
        if cache == "unset":
            monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
        else:
            monkeypatch.setenv("XDG_CACHE_HOME", "relative/cache")
        want = tmp_path / "home" / ".cache" / "libssa_tpu_torch"
    assert cudabuild.build_dir(site / "libssa_tpu_torch") == want
    (site / "pyproject.toml").write_text("")  # now the root of a checkout
    assert cudabuild.build_dir(site / "libssa_tpu_torch") == site / "build" / "libssa_tpu_torch"


def test_installed_copy_builds_in_the_cache(tmp_path):
    """A copy of the package outside a checkout, imported in a fresh
    interpreter: its libraries would go to the cache, not beside it."""
    site = tmp_path / "site-packages"
    shutil.copytree(ROOT / "libssa_tpu_torch", site / "libssa_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from libssa_tpu_torch.util import cudabuild\n"
            "print(cudabuild.__file__)\n"
            "print(cudabuild.library_path('longpair.cu', 'nvcc'))\n")
    env = dict(os.environ, PYTHONPATH=str(site), XDG_CACHE_HOME=str(tmp_path / "cache"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=tmp_path, env=env, check=True)
    module, lib = proc.stdout.split()
    assert Path(module).is_relative_to(site)
    assert Path(lib).parent == tmp_path / "cache" / "libssa_tpu_torch"
    assert not (tmp_path / "cache").exists()  # nothing built
