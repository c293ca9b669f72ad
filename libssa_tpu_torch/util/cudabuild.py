"""Lazy ``nvcc`` build of the port's CUDA sources, bound with ``ctypes``.

Each source under ``libssa_tpu_torch/csrc/`` compiles at first use into a
shared library with a plain C interface, in ``build/libssa_tpu_torch/`` at
the repository root. The file name carries a hash of the sources, the flags
and the compiler's path, so a changed source or flag builds anew and a stale
library is never loaded (freshness is never judged by mtime).

There is no fallback: a missing ``nvcc`` or a failed compile raises. Import
this module only where a kernel is about to launch.
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
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "libssa_tpu_torch"


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


def library_path(source: str, nvcc: str) -> Path:
    """Where ``source``'s library lives, keyed on its content and flags."""
    h = hashlib.sha256()
    h.update((CSRC / source).read_bytes())
    h.update("\0".join((nvcc, *NVCC_FLAGS)).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


@functools.cache
def load(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` if needed and load it."""
    nvcc = nvcc_path()
    out = library_path(source, nvcc)
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(out.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not out.is_file():  # a concurrent build may have finished
                tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
                try:
                    proc = subprocess.run(
                        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
                        capture_output=True, text=True, timeout=600,
                    )
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed on {source}:\n{proc.stderr}"
                        )
                    os.replace(tmp, out)
                finally:
                    tmp.unlink(missing_ok=True)
    return ctypes.CDLL(str(out))
