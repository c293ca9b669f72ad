"""Op throughput on Hopper: four independent accumulators, full occupancy.

The counterpart of ``experiments/r2_ilp_probe.py`` (``streams_kernel``):
x1..x4 = a, a + b, a, a + b, each ``x = op(x)`` per trip, the output
max(max(x1, x2), max(x3, x4)); slope between reps 1024 and 128. Ops add,
maximum and dpmix (``E = max(x - 1, x - 3); x = max(x + b, E)``: 2 sub, 1
add, 2 max) in f32 and bf16 (bf16x2); here also int32, int16x2 and
int8x4, dpmix with DPX (``__viaddmax`` twice), and the three-way max plain
and with DPX. One thread a word, 256 a block, so the card is full.

    python -m libssa_tpu_torch.experiments.r2_ilp_probe
"""
from __future__ import annotations

import sys

import torch

from . import _common as C

LO, HI = 128, 1024
CASES = (
    ("f32", "add", 256, 1024), ("bf16x2", "add", 512, 1024),
    ("f32", "max", 256, 1024), ("bf16x2", "max", 512, 1024),
    ("f32", "dpmix", 256, 1024), ("bf16x2", "dpmix", 512, 1024),
    ("f32", "max_add", 256, 1024), ("bf16x2", "max_add", 512, 1024),
    ("i32", "add", 256, 1024), ("i32", "max", 256, 1024),
    ("i32", "dpmix", 256, 1024), ("i32", "dpmix_dpx", 256, 1024),
    ("i32", "max_add", 256, 1024), ("i32", "max_add_dpx", 256, 1024),
    ("i32", "max3", 256, 1024), ("i32", "max3_dpx", 256, 1024),
    ("i32", "max3_relu", 256, 1024), ("i32", "max3_relu_dpx", 256, 1024),
    ("i16x2", "add", 512, 1024), ("i16x2", "max", 512, 1024),
    ("i16x2", "dpmix", 512, 1024), ("i16x2", "dpmix_dpx", 512, 1024),
    ("i16x2", "max_add", 512, 1024), ("i16x2", "max_add_dpx", 512, 1024),
    ("i16x2", "max3", 512, 1024), ("i16x2", "max3_dpx", 512, 1024),
    ("i8x4", "add", 1024, 1024), ("i8x4", "max", 1024, 1024),
)
C1, C2 = 1, 3  # dpmix's x - 1 and x - 3; max3's constant is C1
COPIES = 16  # tiles a launch, stacked: 16 waves of the card, so the slope is ms, not us

launches = 0


def _count():
    global launches
    launches += 1


def inputs(type_name: str, rows: int, cols: int, device):
    """The JAX probe's inputs: a = b = 0."""
    dt = C.TYPES[type_name][1]
    z = torch.zeros((rows, cols), dtype=dt, device=device)
    return z, z.clone()


def plain(a, b, op: str, reps: int) -> torch.Tensor:
    return C.plain_chain(op, a, b, reps, 4, c1=C1, c2=C2)


def stage(a, b, op: str, type_name: str, reps: int):
    return C.stage_chain(op, type_name, a, b, reps, 4, c1=C1, c2=C2, count=_count)


def measure(type_name: str, op: str, rows: int, cols: int, dev, copies: int = COPIES) -> dict:
    a, b = inputs(type_name, rows * copies, cols, dev)
    t_lo, t_hi = C.slope_ms(stage(a, b, op, type_name, LO), stage(a, b, op, type_name, HI))
    per_iter = (t_hi - t_lo) * 1e-3 / (HI - LO)  # s for 4 applications an element
    apps = a.numel() * 4 / per_iter
    return {"type": type_name, "op": op, "rows": rows, "cols": cols,
            "gapps_card": apps / 1e9, "gapps_sm": apps / 1e9 / C.sm_count(dev),
            "gops_card": apps * C.OP_COUNT[op] / 1e9, "t_lo_ms": t_lo, "t_hi_ms": t_hi}


def main() -> int:
    dev = C.require_cuda("cuda")
    print(C.card(), flush=True)
    for ty, op, r, c in CASES:
        m = measure(ty, op, r, c, dev)
        print(f"  {ty:6s} {op:14s} ({r},{c})  {m['gops_card']:9.1f} Gelem-ops/s card "
              f"({m['gapps_card']:8.1f} G applications/s, {m['gapps_sm']:6.2f} a SM)", flush=True)
    print(C.sample(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
