"""K3 with its own stages cut, on Hopper: where a step's time goes.

The counterpart of ``experiments/r3_banded_bisect.py`` (its ``build`` and
``build_opt``, the banded long-pair step with stages cut out). Here the
cuts are compile-time switches of the production K3 (``csrc/longpair.cu``,
all off by default), each built into its own library:

- ``full``: the production K3, held to the plain version;
- ``no_wait``: no poll on the stripe above;
- ``no_publish``: and no fence or progress release store;
- ``no_edge``: and no stripe-edge stores;
- ``no_profile``: a constant substitution row (the JAX ``nosel``);
- ``no_shuffle``: no boundary shuffles (the JAX ``noroll``);
- ``steady``: no column guard and no first-stripe branch (``steady``);
- ``bare``: all six cuts.

Every variant but ``full`` gives a wrong score and is timed only, as the
JAX probe marks its own. Timed at 16,384^2 protein SW (the JAX probe's N)
and 100,000^2 ACGT SW, beside the production K3 in the same run, in turns.

    python -m libssa_tpu_torch.experiments.r3_banded_bisect [variants...]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import longpair, longpair_cuda
from . import _common as C

CUTS = {
    "full": (),
    "no_wait": ("K3_PROBE_NO_WAIT",),
    "no_publish": ("K3_PROBE_NO_PUBLISH",),
    "no_edge": ("K3_PROBE_NO_EDGE",),
    "no_profile": ("K3_PROBE_NO_PROFILE",),
    "no_shuffle": ("K3_PROBE_NO_SHUFFLE",),
    "steady": ("K3_PROBE_STEADY",),
    "bare": ("K3_PROBE_NO_EDGE", "K3_PROBE_NO_PROFILE", "K3_PROBE_NO_SHUFFLE",
             "K3_PROBE_STEADY"),
}
PAIRS = {  # name -> (m = n, alphabet size, matrix, gaps (Q, R))
    "16k protein": (16384, 20, "BLOSUM62", (12, 1)),
    "100k ACGT": (100_000, 4, "ACGT", (11, 1)),
}

launches = 0


def plain(q, s, matrix, Q, R, local=True, dtype=torch.int32):
    """``full``'s function: K3's plain version."""
    return longpair.longpair_score_plain(q, s, matrix, Q, R, local=local, dtype=dtype)


def stage(q, s, matrix, Q, R, variant: str = "full", local: bool = True,
          dtype=torch.int32, rows_per_thread=None):
    """``launch()`` of one K3 launch, with ``variant``'s stages cut."""
    lib = longpair_cuda._lib(CUTS[variant])

    def launch():
        global launches
        out = longpair_cuda.enqueue(lib, q, s, matrix, Q, R, local, dtype, rows_per_thread)
        launches += 1
        return out

    return launch


def pair(name: str, device, seed: int = 13):
    """A random pair of ``PAIRS[name]`` (codes, codes, padded matrix, Q, R)."""
    from .. import matrices
    from ..constants import SymType

    m, hi, mat_name, (Q, R) = PAIRS[name]
    rng = np.random.default_rng(seed)
    mat = (matrices.builtin(mat_name) if mat_name != "ACGT"
           else matrices.constant_scoring(5, -4, SymType.NUCLEOTIDE))
    q = torch.as_tensor(rng.integers(0, hi, m).astype(np.uint8)).to(device)
    s = torch.as_tensor(rng.integers(0, hi, m).astype(np.uint8)).to(device)
    return q, s, torch.as_tensor(mat.padded().astype(np.int32)).to(device), Q, R


def measure(name: str, dev, variants=tuple(CUTS), reps: int = 3) -> dict:
    """ms of each variant at pair ``name``, the production K3 first and last
    (min of ``reps`` each), and the production K3's score."""
    q, s, mat, Q, R = pair(name, dev)
    out = {}
    order = ["full", *[v for v in variants if v != "full"], "full"]
    for v in order:
        ms = C.events_ms(stage(q, s, mat, Q, R, v), reps)
        out[v] = min(out.get(v, ms), ms)
    out["score"] = int(stage(q, s, mat, Q, R, "full")())
    return out


def main(argv=None) -> int:
    dev = C.require_cuda("cuda")
    print(C.card(), flush=True)
    variants = (argv if argv is not None else sys.argv[1:]) or tuple(CUTS)
    for name in PAIRS:
        r = measure(name, dev, variants)
        m = PAIRS[name][0]
        for v in variants:
            tag = "" if v == "full" else " [timed only]"
            print(f"{name} {v:10s}: {r[v]:8.3f} ms ({m * m / r[v] / 1e6:7.2f} GCUPS-equiv)"
                  f"{tag}", flush=True)
    print(C.sample(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
