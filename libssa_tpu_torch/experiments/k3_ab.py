"""K3 and the single-pair score path of one checkout, for comparing two K3 designs.

    python libssa_tpu_torch/experiments/k3_ab.py ROOT LABEL

Imports ``libssa_tpu_torch`` and ``chip_smoke`` from the checkout at ROOT
(another commit unpacked with ``git archive``, or this one) and prints one
line, ``RESULT {json}``:

- ``k3_ms``: K3 through ``longpair_score_cuda`` at the wrapper's own choice
  of band height and, where it has one, warps a block: ``chip_smoke.py``
  phase 8a's 16,384^2 protein pair (seed 88, BLOSUM62 11/1) in SW and NW,
  and 8b's 100,000^2 ACGT pair (5/-4, gaps 10/1, its forward strand) in SW
  in int32 and with int64 pinned, and in NW: two CUDA-event timings each,
  each the min of 3 after a warm-up (the call's host checks, one device
  sync for the code check, fall inside them), and the score;
- ``align_pair``: ``align_pair(mode=SCORE)`` through
  ``SSAContext(device="cuda")`` on 8a (SW) and 8b (SW, both strands), twice
  each: wall seconds, K3 launches and the score.

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


def kernel_ms(c, dev) -> dict:
    import numpy as np
    import torch

    from libssa_tpu_torch import matrices, oracle
    from libssa_tpu_torch.constants import SymType
    from libssa_tpu_torch.ops import longpair_cuda

    (_, _, _, qa, sa, _), (_, _, _, qb, sb, _) = c.pair_cases()
    b62 = matrices.builtin("BLOSUM62").padded().astype(np.int32)
    acgt = matrices.constant_scoring(5, -4, SymType.NUCLEOTIDE).padded().astype(np.int32)
    runs = {
        "16k SW": (qa, sa, b62, (11, 1), True, torch.int32),
        "16k NW": (qa, sa, b62, (11, 1), False, torch.int32),
        "100k SW": (qb, sb, acgt, (10, 1), True, torch.int32),
        "100k SW int64": (qb, sb, acgt, (10, 1), True, torch.int64),
        "100k NW": (qb, sb, acgt, (10, 1), False, torch.int32),
    }
    out = {}
    for key, (q, s, mat, gaps, local, dt) in runs.items():
        Q, R = oracle.gap_qr(*gaps)
        qt, st, mt = (torch.as_tensor(x).to(dev) for x in (q, s, mat))
        times = []
        for _ in range(2):
            ms, got = c.cuda_ms(lambda: longpair_cuda.longpair_score_cuda(
                qt, st, mt, Q, R, local, dt))
            times.append(ms)
        out[key] = {"ms": times, "cells": len(q) * len(s), "score": int(got)}
    return out


def align_pair(c) -> dict:
    from libssa_tpu_torch import alphabet
    from libssa_tpu_torch.api import SSAContext
    from libssa_tpu_torch.constants import AlignType, ComputeMode, Strand, SymType
    from libssa_tpu_torch.ops import longpair_cuda

    res = {}
    for label, nucleotide, symtype, q_codes, s_codes, _ in c.pair_cases():
        ctx = SSAContext(device="cuda")
        if nucleotide:
            ctx.init_symbol_translation(SymType.NUCLEOTIDE, Strand.BOTH)
            ctx.init_constant_scoring(5, -4)
            ctx.init_gap_penalties(10, 1)
        else:
            ctx.init_score_matrix("BLOSUM62")
            ctx.init_gap_penalties(11, 1)
        q = ctx.init_sequence_fasta(alphabet.decode(q_codes, symtype))
        subject = alphabet.decode(s_codes, symtype)
        runs = []
        for _ in range(2):
            longpair_cuda.launches = 0
            t0 = time.perf_counter()
            a = ctx.align_pair(q, subject, AlignType.SW, ComputeMode.SCORE)
            runs.append({"wall_s": time.perf_counter() - t0,
                         "k3_launches": longpair_cuda.launches, "score": a.score})
        res[label[:2] + " SW"] = runs
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
        raise SystemExit("k3_ab: CUDA is not available")
    dev = torch.device("cuda", 0)
    res = {"label": argv[1], "card": c.card_line(), "k3_ms": kernel_ms(c, dev),
           "align_pair": align_pair(c)}
    print("RESULT", json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
