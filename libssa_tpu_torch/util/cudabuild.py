"""Lazy builds of the port's C++ and CUDA sources, bound with ``ctypes``.

Each source under ``libssa_tpu_torch/csrc/`` compiles at first use into a
shared library with a plain C interface: the ``.cu`` kernels with ``nvcc``
(``load``), the host helpers ``leafalign.cpp`` and ``fastadb.cpp`` with
the host C++ compiler (``load_native``). The libraries go to
``build/libssa_tpu_torch/`` at the repository root when the package runs
from a checkout, else (an installed package) to
``$XDG_CACHE_HOME/libssa_tpu_torch``, by default
``~/.cache/libssa_tpu_torch`` (``build_dir``). The file name carries a
hash of the source, the compiler, the flags and, for ``-march=native``
builds, what the compiler makes of ``-march=native`` on this host, so a
changed source, flag or CPU builds anew and a stale library is never
loaded (freshness is never judged by mtime). A failed compile leaves no
temporary file behind.

A missing ``nvcc`` or a failed kernel build raises: kernels have no
fallback. A host helper that cannot be built returns None with a WARNING;
its callers then take their Python paths. Import this module only where a
library is about to load.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")
CSRC = Path(__file__).resolve().parents[1] / "csrc"


def build_dir(package: Path) -> Path:
    """Where the libraries of the package at ``package`` go: ``build/`` of
    the checkout that holds it (a tree whose root, the package's parent,
    has ``pyproject.toml``), else the user's cache directory."""
    root = package.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "libssa_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME", "")
    if not os.path.isabs(cache):  # unset, empty or relative: the spec's default
        cache = os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "libssa_tpu_torch"


BUILD_DIR = build_dir(CSRC.parent)


def nvcc_path() -> str:
    """The ``nvcc`` to build with: on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin)")


def library_path(source: str, compiler: str, flags=None, host: str = "") -> Path:
    """Where ``source``'s library lives, keyed on its content and build
    (``flags`` default: ``NVCC_FLAGS``)."""
    flags = NVCC_FLAGS if flags is None else flags
    h = hashlib.sha256()
    h.update((CSRC / source).read_bytes())
    h.update("\0".join((compiler, *flags, host)).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def _build(source: str, compiler: str, flags, host: str = "") -> Path:
    """Compile ``csrc/<source>`` once, under a file lock; returns the path."""
    out = library_path(source, compiler, flags, host)
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(out.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not out.is_file():  # a concurrent build may have finished
                tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
                try:
                    proc = subprocess.run(
                        [compiler, *flags, "-o", str(tmp), str(CSRC / source)],
                        capture_output=True, text=True, timeout=600,
                    )
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"{compiler} failed on {source}:\n{proc.stderr}"
                        )
                    os.replace(tmp, out)
                finally:
                    tmp.unlink(missing_ok=True)
    return out


@functools.cache
def load(source: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build the kernel source ``csrc/<source>`` with nvcc if needed and load it.

    ``defines`` are preprocessor macros (``"NAME"`` or ``"NAME=VALUE"``),
    passed as ``-D`` flags: each set builds its own library.
    """
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    return ctypes.CDLL(str(_build(source, nvcc_path(), flags)))


def _native_target(cxx: str) -> str:
    """The target options ``-march=native`` resolves to on this host."""
    proc = subprocess.run(
        [cxx, "-march=native", "-Q", "--help=target"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout


@functools.cache
def load_native(source: str) -> ctypes.CDLL | None:
    """Build the host helper ``csrc/<source>`` with g++ if needed and load
    it; None, with a WARNING, where it cannot be built or loaded."""
    cxx = os.environ.get("CXX", "g++")
    try:
        path = _build(source, cxx, CXX_FLAGS, _native_target(cxx))
        return ctypes.CDLL(str(path))
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        from ..constants import OutputMode
        from .logging import log

        log(OutputMode.WARNING, f"native helper {source} unavailable: {exc}")
        return None
