"""The row-sweep long-pair kernel with stages cut, on Hopper.

The counterpart of ``experiments/r3_lp_bisect.py`` (its ``build``, variants
c_empty, c_noscan and c_full, at N = 16,384): one pair, SW, swept row by row
by one block of ``csrc/lp_rowsweep.cu``; each row's lazy E is a block-wide
prefix max and F stays in registers. Only ``full`` gives the SW score;
``noscan`` (no prefix max) and ``empty`` (the loop and its barriers alone)
are timed only, as the JAX probe marks them. One block is one SM; the
card runs one copy of the pair on each SM.

    python -m libssa_tpu_torch.experiments.r3_lp_bisect
"""
from __future__ import annotations

import ctypes
import functools
import sys

import numpy as np
import torch

from . import _common as C

SOURCE = "lp_rowsweep.cu"
N = 16384
VARIANTS = ("full", "noscan", "empty")  # csrc/lp_rowsweep.cu's Variant order
WIDTHS = (1024, 4096, 16384)  # subject lengths with an instantiation
NEG = -(1 << 30)

launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    from ..util import cudabuild

    lib = cudabuild.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lprs_rowsweep.argtypes = [i, p, i, p, i, p, i, i, p, i, p]
    lib.lprs_rowsweep.restype = i
    return lib


def plain(q: torch.Tensor, s: torch.Tensor, matrix: torch.Tensor, Q: int, R: int,
          variant: str = "full") -> int:
    """The kernel's function, a row at a time in int64: the SW score for
    ``full``, the no-prefix-max sweep's best for ``noscan``, 0 for ``empty``
    (as the JAX probe's c_empty returns)."""
    if variant == "empty":
        return 0
    n = s.shape[0]
    dt = torch.int64
    j = torch.arange(n, dtype=dt, device=s.device)
    sub = matrix.to(dt)[:, s.long()]  # (32, n): row q[i] is the substitution row
    h = torch.zeros(n, dtype=dt, device=s.device)
    f = torch.full((n,), NEG, dtype=dt, device=s.device)
    best = torch.zeros((), dtype=dt, device=s.device)
    neg = torch.full((1,), NEG, dtype=dt, device=s.device)
    for qi in q.tolist():
        f = torch.maximum(f - R, h - Q)
        hd = torch.cat([torch.zeros(1, dtype=dt, device=s.device), h[:-1]])
        hnof = torch.maximum(torch.maximum(hd + sub[qi], f), torch.zeros((), dtype=dt))
        if variant == "full":
            dsc = torch.cummax(hnof + j * R, 0).values - j * R
        else:
            dsc = hnof
        e = torch.cat([neg, dsc[:-1] - Q])
        h = torch.maximum(hnof, e)
        best = torch.maximum(best, h.max())
    return int(best)


def stage(q: torch.Tensor, s: torch.Tensor, matrix: torch.Tensor, Q: int, R: int,
          variant: str = "full", copies: int = 1):
    """``launch()`` of the row sweep on the card: ``copies`` blocks, each the
    whole pair; it returns each block's result, (copies,) int32."""
    dev = s.device
    if dev.type != "cuda" or q.device != dev or matrix.device != dev:
        raise ValueError("the row sweep takes CUDA tensors")
    if q.dtype != torch.uint8 or s.dtype != torch.uint8 or q.dim() != 1 or s.dim() != 1:
        raise TypeError("q and s must be 1-d uint8 codes")
    if matrix.dtype != torch.int32 or tuple(matrix.shape) != (32, 32):
        raise TypeError("matrix must be (32, 32) int32")
    if s.shape[0] not in WIDTHS:
        raise ValueError(f"subject length must be one of {WIDTHS}")
    if int(torch.maximum(q.max(), s.max())) >= 32:
        raise ValueError("codes must be < 32")
    q, s, matrix = q.contiguous(), s.contiguous(), matrix.contiguous()
    out = torch.empty(copies, dtype=torch.int32, device=dev)
    lb, code = _lib(), VARIANTS.index(variant)

    def launch():
        global launches
        with torch.cuda.device(dev):
            rc = lb.lprs_rowsweep(code, q.data_ptr(), q.shape[0], s.data_ptr(), s.shape[0],
                                  matrix.data_ptr(), int(Q), int(R), out.data_ptr(), copies,
                                  C.stream(dev))
        C.check(rc, f"row sweep {variant}")
        launches += 1
        return out

    return launch


def pair(n: int = N, seed: int = 1):
    """The JAX probe's pair: random protein codes, seed 1, BLOSUM62."""
    from .. import matrices

    rng = np.random.default_rng(seed)
    q = rng.integers(0, 20, n).astype(np.uint8)
    s = rng.integers(0, 20, n).astype(np.uint8)
    return q, s, matrices.builtin("BLOSUM62").padded().astype(np.int32)


def measure(variant: str, dev, Q: int = 11, R: int = 1) -> dict:
    """ms of one pair on one SM, and of one pair on every SM at once."""
    q, s, mat = (torch.as_tensor(a).to(dev) for a in pair())
    one = stage(q, s, mat, Q, R, variant)
    ms_one = C.events_ms(one, 3)
    score = int(one()[0])
    sms = C.sm_count(dev)
    ms_card = C.events_ms(stage(q, s, mat, Q, R, variant, copies=sms), 3)
    return {"variant": variant, "ms_one": ms_one, "gcups_one": N * N / ms_one / 1e6,
            "ms_card": ms_card, "gcups_card": sms * N * N / ms_card / 1e6, "score": score}


def main() -> int:
    dev = C.require_cuda("cuda")
    print(C.card(), flush=True)
    for v in VARIANTS:
        m = measure(v, dev)
        print(f"{v:7s}: one SM {m['ms_one']:8.2f} ms ({m['gcups_one']:6.2f} GCUPS), "
              f"all SMs {m['ms_card']:8.2f} ms ({m['gcups_card']:7.2f} GCUPS) "
              f"score={m['score']}{'' if v == 'full' else ' [timed only]'}", flush=True)
    print(C.sample(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
