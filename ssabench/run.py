"""The benchmark's command: one run of one cell on this machine's card.

    python3 -m ssabench.run --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. It makes the cell's inputs from ``--seed``,
sets the port up and warms it up (``setup_s``), measures for ``--seconds``,
checks what the timed path produced against the plain reference, and
prints one JSON object as the last line of standard output. It fails,
printing no result, without a CUDA card, with fewer cards than the cell
asks for, or where JAX, jaxlib, flax or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "libssa_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fixed_caches(root: Path) -> None:
    """Caches of the libraries under the checkout, at fixed paths. The
    port builds its kernels into ``build/libssa_tpu_torch/`` itself."""
    cache = root / "build" / "ssabench"
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))
    os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", str(cache / "torch_kernels"))
    usable_tmpdir(cache / "tmp")


def usable_tmpdir(fallback: Path) -> None:
    """nvcc and g++ write their intermediates under ``TMPDIR``: a directory
    named there but not made yet is made; one that cannot be written is
    replaced by ``fallback``, a fixed directory of the checkout."""
    tmp = os.environ.get("TMPDIR", "")
    if not tmp:
        return
    try:
        os.makedirs(tmp, exist_ok=True)
    except OSError:
        pass
    if not (os.path.isdir(tmp) and os.access(tmp, os.W_OK | os.X_OK)):
        fallback.mkdir(parents=True, exist_ok=True)
        os.environ["TMPDIR"] = str(fallback)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    fixed_caches(root)
    import torch

    from .harness import find, load_manifest, run_cell, say

    if not torch.cuda.is_available():
        say("ssabench: no CUDA device; the benchmark runs only on a card")
        return 2
    cell = find(load_manifest(root)["workloads"], args.workload, "workload")
    if torch.cuda.device_count() < cell["chips"]:
        say(f"ssabench: {args.workload} needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        say(f"ssabench: forbidden modules loaded: {', '.join(bad)}")
        return 3
    for name, c in result["checks"].items():
        say(f"check {name} = {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
