"""Op rates on the (256, 512) tile of the inter-sequence kernel, on Hopper.

The counterpart of ``experiments/op_rate_probe.py`` (its ``build`` and
``_kernel``): ``ITERS`` = 2048 trips of ``reps`` in {4, 8} applications of
roll0, roll1, max, add, scanpass or select to a tile, in f32 and bf16 (as
bf16x2), and roll0, roll1 and scanpass in int32 and int16x2 too; the time
of one op is the slope between reps 8 and reps 4. roll0 rolls along the
rows (lines of 256: 8 lanes of 32 registers), roll1 along the columns
(lines of 512: 16 lanes of 32 registers); a roll renames registers and
shuffles one word a lane (``csrc/probes.cu``).

    python -m libssa_tpu_torch.experiments.op_rate_probe [ops...]
"""
from __future__ import annotations

import sys

import torch

from . import _common as C

ITERS = 2048
M, B = 256, 512
COPIES = 16  # tiles a launch: 2,048 warps in f32, to fill 132 SMs
OPS = ("roll0", "roll1", "max", "add", "scanpass", "select")
FLOAT = ("f32", "bf16x2")
INTEGER = ("i32", "i16x2")  # where the op has an integer form
# op -> (probes.cu op, rolled axis of (copies, rows, cols), G, R, c1)
SPEC = {
    "roll0": ("roll", 1, 8, 32, 0),
    "roll1": ("roll", 2, 16, 32, 0),
    "max": ("maxmulc", 1, 8, 32, 0.999),
    "add": ("addc", 1, 8, 32, 0.001),
    "scanpass": ("max_roll_addc", 1, 8, 32, -1.0),
    "select": ("select", 1, 8, 32, 0.5),
}

launches = 0


def _count():
    global launches
    launches += 1


def types_of(op: str) -> tuple[str, ...]:
    return FLOAT + (INTEGER if op in ("roll0", "roll1", "scanpass") else ())


def plain(x: torch.Tensor, op: str, reps: int, iters: int = ITERS) -> torch.Tensor:
    """The probe's function on (..., rows, cols) elements of the working
    type: ``iters * reps`` applications of ``op``."""
    kop, axis, _, _, c1 = SPEC[op]
    return C.plain_tile(kop, x, iters * reps, axis - 3, c1=c1)


def stage(x: torch.Tensor, op: str, type_name: str, reps: int, iters: int = ITERS):
    """The kernel on (copies, 256, 512) elements on the card: ``launch()``."""
    kop, axis, G, R, c1 = SPEC[op]
    return C.stage_tile(kop, type_name, x, iters * reps, axis, G, R, c1=c1, count=_count)


def tile_input(type_name: str, copies: int, device, seed: int = 0) -> torch.Tensor:
    """The JAX probe's input, ``np.random.rand(m, B)`` f32, as the working type;
    integer types take small random integers instead."""
    g = torch.Generator().manual_seed(seed)
    dt = C.TYPES[type_name][1]
    if dt.is_floating_point:
        x = torch.rand((copies, M, B), generator=g).to(dt)
    else:
        x = torch.randint(-50, 50, (copies, M, B), generator=g).to(dt)
    return x.to(device)


def measure(op: str, type_name: str, dev, copies: int = COPIES) -> dict:
    """ns an op for one tile and G element-ops/s on the card, by slope."""
    x = tile_input(type_name, copies, dev)
    t4, t8 = C.slope_ms(stage(x, op, type_name, 4), stage(x, op, type_name, 8))
    per_op = (t8 - t4) * 1e-3 / (4 * ITERS)  # s for one op over all copies
    rate = copies * M * B / per_op
    return {"op": op, "type": type_name, "ns_per_op_tile": per_op * 1e9 / copies,
            "gops_card": rate / 1e9, "gops_sm": rate / 1e9 / C.sm_count(dev),
            "t4_ms": t4, "t8_ms": t8}


def main(argv=None) -> int:
    dev = C.require_cuda("cuda")
    print(C.card(), flush=True)
    for op in (argv if argv is not None else sys.argv[1:]) or OPS:
        for ty in types_of(op):
            r = measure(op, ty, dev)
            print(f"{op:9s} {ty:6s}: {r['ns_per_op_tile']:8.3f} ns/op a tile  "
                  f"{r['gops_card']:9.1f} G elem/s card  {r['gops_sm']:7.2f} a SM", flush=True)
    print(C.sample(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
