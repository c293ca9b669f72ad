"""Dependent-chain op rates on Hopper: latency, one accumulator a thread.

The counterpart of ``experiments/r2_rate_probe.py`` (``chain_kernel``): one
accumulator over a (rows, 1024) tile, ``x = op(x, b)`` repeated ``reps``
times, the slope between reps 4096 and 512. Ops add, maximum and max_add
(``max(x + b, b)``) in f32, bf16 (bf16x2), int32 and int16 (int16x2); here
also max_add as one DPX ``__viaddmax_s32`` / ``__viaddmax_s16x2``, the
three-way max plain and as ``__vimax3_s32`` (``_relu``), and int8x4. Run at
one warp an SM, each thread walks its share of the tile one chain after
another, so the slope is the op's latency.

    python -m libssa_tpu_torch.experiments.r2_rate_probe
"""
from __future__ import annotations

import sys

import torch

from . import _common as C

LO, HI = 512, 4096
# (type, op, rows, cols): the JAX probe's cases, then Hopper's.
CASES = (
    ("f32", "add", 256, 1024), ("f32", "max", 256, 1024), ("f32", "max_add", 256, 1024),
    ("bf16x2", "add", 512, 1024), ("bf16x2", "max", 512, 1024),
    ("bf16x2", "max_add", 512, 1024), ("bf16x2", "max", 256, 1024),
    ("i32", "add", 256, 1024), ("i32", "max", 256, 1024),
    ("i16x2", "add", 512, 1024), ("i16x2", "add", 256, 1024),
    ("i32", "max_add", 256, 1024), ("i32", "max_add_dpx", 256, 1024),
    ("i32", "max3", 256, 1024), ("i32", "max3_dpx", 256, 1024),
    ("i32", "max3_relu", 256, 1024), ("i32", "max3_relu_dpx", 256, 1024),
    ("i16x2", "max", 512, 1024), ("i16x2", "max_add", 512, 1024),
    ("i16x2", "max_add_dpx", 512, 1024), ("i16x2", "max3", 512, 1024),
    ("i16x2", "max3_dpx", 512, 1024),
    ("i8x4", "add", 1024, 1024), ("i8x4", "max", 1024, 1024),
)
C1 = 1  # the third operand of max3: a constant

launches = 0


def _count():
    global launches
    launches += 1


def inputs(type_name: str, rows: int, cols: int, device, seed: int = 1):
    """The JAX probe's inputs: integers in [-3, 4) and b = 0, so chained adds
    stay exact and never overflow."""
    dt = C.TYPES[type_name][1]
    g = torch.Generator().manual_seed(seed)
    a = torch.randint(-3, 4, (rows, cols), generator=g).to(dt).to(device)
    return a, torch.zeros((rows, cols), dtype=dt, device=device)


def plain(a, b, op: str, reps: int) -> torch.Tensor:
    return C.plain_chain(op, a, b, reps, 1, c1=C1)


def stage(a, b, op: str, type_name: str, reps: int, latency: bool = True):
    """``launch()`` of the chain on the card: one warp an SM (``latency``) or
    one thread a word, 256 a block."""
    kw = dict(blocks=C.sm_count(a.device), threads=32) if latency else {}
    return C.stage_chain(op, type_name, a, b, reps, 1, c1=C1, count=_count, **kw)


def measure(type_name: str, op: str, rows: int, cols: int, dev, latency: bool = True) -> dict:
    a, b = inputs(type_name, rows, cols, dev)
    t_lo, t_hi = C.slope_ms(stage(a, b, op, type_name, LO, latency),
                            stage(a, b, op, type_name, HI, latency))
    per_op = (t_hi - t_lo) * 1e-3 / (HI - LO)  # s for one application over the tile
    n_words = -(-a.numel() // C.TYPES[type_name][2])
    threads = C.sm_count(dev) * 32 if latency else n_words
    chains = -(-n_words // threads)  # words a thread walks, one after another
    return {"type": type_name, "op": op, "rows": rows, "cols": cols,
            "gelem_s": rows * cols / per_op / 1e9,
            "ns_dependent": per_op * 1e9 / chains, "t_lo_ms": t_lo, "t_hi_ms": t_hi}


def main() -> int:
    dev = C.require_cuda("cuda")
    print(C.card(), flush=True)
    for ty, op, r, c in CASES:
        m = measure(ty, op, r, c, dev)
        print(f"  {ty:6s} {op:14s} ({r:4d},{c}) {m['gelem_s']:9.1f} Gelem/s  "
              f"{m['ns_dependent']:7.3f} ns a dependent op (one warp an SM)", flush=True)
    print(C.sample(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
