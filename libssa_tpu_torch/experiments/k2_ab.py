"""K2 and the huge-pair tracebacks of one checkout, for comparing two K2 designs.

    python libssa_tpu_torch/experiments/k2_ab.py ROOT LABEL

Imports ``libssa_tpu_torch`` and ``chip_smoke`` from the checkout at ROOT
(another commit unpacked with ``git archive``, or this one) and prints one
line, ``RESULT {json}``:

- ``k2_ms``: K2's launch alone (``ring_block_cuda.stage``, at the wrapper's
  own choice of band height and, where it has one, warps a block) at three
  shapes: (a) ``chip_smoke.py`` phase 11a's first Myers-Miller level (2
  tiles of 8,192 x 16,384, NW, BLOSUM62 11/1, phase 8a's pair, seed 88);
  (b) 11b's first SW end scan (one 100,000^2 tile, SW, seed 111, what
  ``DevicePair.sw_end`` launches over the whole pair); (c) the level of 11b's
  NW traceback with the most tiles (found by running it once with its
  levels recorded): two CUDA-event timings each, each the min of 3 after a
  warm-up, and the outputs' checksum;
- ``tracebacks``: ``align_pair(mode=ALIGNMENT)`` through
  ``SSAContext(device="cuda")`` on 11a's and 11b's pairs, SW and NW, twice
  each: wall seconds, ``aligner_device_seconds``, K2 launches and the score.

Only the port's API of the earliest design compared is used, so the
script runs unchanged on either checkout. Run two checkouts in one call on
one card, in the order A, B, B, A, so that the host's and the card's drift
falls on both.
"""
from __future__ import annotations

import json
import os
import sys
import time

SHAPES = ("a", "b", "c")


def trace_pair():
    """``chip_smoke.py`` phase 11b's pair: 100,000^2 random protein, seed 111."""
    import numpy as np

    rng = np.random.default_rng(111)
    return (rng.integers(0, 20, 100_000).astype(np.uint8),
            rng.integers(0, 20, 100_000).astype(np.uint8))


def shapes(c, dev) -> dict:
    """(DevicePair, jobs, bounds, local) at (a), (b) and (c)."""
    import numpy as np

    from libssa_tpu_torch import matrices, oracle
    from libssa_tpu_torch.ops import mm_device
    from libssa_tpu_torch.search import hirschberg

    b62 = matrices.builtin("BLOSUM62")
    padded = b62.padded().astype(np.int32)
    Q, R = oracle.gap_qr(11, 1)
    _, _, _, q8, s8, _ = c.pair_cases()[0]
    pa = mm_device.DevicePair(q8, s8, padded, Q, R, device=dev)
    ja, ta = pa.level_jobs([(0, pa.m, 0, pa.n, False, False)])
    qb, sb = trace_pair()
    pb = mm_device.DevicePair(qb, sb, padded, Q, R, device=dev)
    jb = np.array([[0, pb.m, 0, pb.n]], np.int64)
    levels = []
    divide = mm_device.DevicePair.divide_level

    def record(self, nodes):
        levels.append(list(nodes))
        return divide(self, nodes)

    mm_device.DevicePair.divide_level = record
    try:
        hirschberg.align_pair_linear(qb, sb, b62.scores, 11, 1, local=False, device=dev)
    finally:
        mm_device.DevicePair.divide_level = divide
    jc, tc = pb.level_jobs(max(levels, key=len))
    return {"a": (pa, ja, pa.bounds(ja, ta), False), "b": (pb, jb, pb.bounds(jb, None), True),
            "c": (pb, jc, pb.bounds(jc, tc), False)}


def kernel_ms(c, dev) -> dict:
    from libssa_tpu_torch import oracle
    from libssa_tpu_torch.ops import ring_block_cuda

    Q, R = oracle.gap_qr(11, 1)
    out = {}
    for key, (pair, jobs, bounds, local) in shapes(c, dev).items():
        launch = ring_block_cuda.stage(pair.q, pair.s, jobs, pair.matrix, Q, R, local,
                                       *bounds, codes_checked=True)
        times = []
        for _ in range(2):
            ms, got = c.cuda_ms(launch)
            times.append(ms)
        check = sum(int(t.long().sum()) for t in got if t is not None)
        out[key] = {"ms": times, "tiles": len(jobs), "cells": int((jobs[:, 1] * jobs[:, 3]).sum()),
                    "warps": getattr(launch, "warps", 1), "checksum": check}
    return out


def tracebacks(c) -> dict:
    from libssa_tpu_torch import alphabet
    from libssa_tpu_torch.api import SSAContext
    from libssa_tpu_torch.constants import AlignType, ComputeMode, SymType
    from libssa_tpu_torch.ops import ring_block_cuda

    ctx = SSAContext(device="cuda")
    ctx.init_score_matrix("BLOSUM62")
    ctx.init_gap_penalties(11, 1)
    _, _, _, q8, s8, _ = c.pair_cases()[0]
    res = {}
    for label, (qc, sc) in (("11a", (q8, s8)), ("11b", trace_pair())):
        q = ctx.init_sequence_fasta(alphabet.decode(qc, SymType.AMINOACID))
        subject = alphabet.decode(sc, SymType.AMINOACID)
        for at in (AlignType.SW, AlignType.NW):
            runs = []
            for _ in range(2):
                ring_block_cuda.launches = 0
                t0 = time.perf_counter()
                a = ctx.align_pair(q, subject, at, ComputeMode.ALIGNMENT)
                runs.append({"wall_s": time.perf_counter() - t0,
                             "device_s": a.stats.aligner_device_seconds,
                             "k2_launches": ring_block_cuda.launches, "score": a.score})
            res[f"{label} {at.name}"] = runs
    return res


def main(argv: list[str]) -> int:
    root = os.path.abspath(argv[0])
    sys.modules["jax"] = None
    sys.modules["libssa_tpu"] = None
    sys.path.insert(0, root)
    import torch

    import chip_smoke as c
    import libssa_tpu_torch

    if not libssa_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"imported {libssa_tpu_torch.__file__}, not the checkout at {root}")
    if not torch.cuda.is_available():
        raise SystemExit("k2_ab: CUDA is not available")
    dev = torch.device("cuda", 0)
    res = {"label": argv[1], "card": c.card_line(), "k2_ms": kernel_ms(c, dev),
           "tracebacks": tracebacks(c)}
    print("RESULT", json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
