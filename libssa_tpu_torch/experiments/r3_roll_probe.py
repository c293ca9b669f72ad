"""Slope-timed costs of the long-pair kernel's building blocks, on Hopper.

The counterpart of ``experiments/r3_roll_probe.py`` (``mk``): bodies applied
to an (8, 2048) f32 tile, the slope between ``LO`` = 1024 and ``HI`` =
16,384 applications. Lane rolls (along the 2048 columns) hold a row in one
warp, 64 registers a lane, and shuffle what crosses a lane; the sublane
roll holds a column of 8 in one thread's registers. max3 is
``fmaxf(fmaxf())`` in f32 and ``__vimax3_s32`` in int32 (``max3_i32``
beside it is the plain int32 form). Probe 2 of
``experiments/r3_longpair_probe.py`` (``r3_longpair_probe.PROBES``) runs
through ``measure`` here too.

    python -m libssa_tpu_torch.experiments.r3_roll_probe
"""
from __future__ import annotations

import sys

import torch

from . import _common as C

K = 2048  # (8, 2048) f32: the long-pair row shape
LO, HI = 1024, 16384
# name -> (probes.cu op, type, rolled axis (1 rows, 2 columns) or 0, G, R, shift, c1, c2)
PROBES = {
    "add": ("addc", "f32", 0, 0, 0, 0, 1e-7, 0),
    "max3": ("max3mul", "f32", 0, 0, 0, 0, 0.99, 1.01),
    "max3_i32": ("max3add", "i32", 0, 0, 0, 0, -1, -2),
    "max3_dpx": ("max3add_dpx", "i32", 0, 0, 0, 0, -1, -2),
    "roll_lane1+max": ("max_roll_addc", "f32", 2, 32, 64, 1, -1e-6, 0),
    "roll_lane8+max": ("max_roll_addc", "f32", 2, 32, 64, 8, -1e-6, 0),
    "roll_lane512+max": ("max_roll_addc", "f32", 2, 32, 64, 512, -1e-6, 0),
    "roll_sub1+max": ("max_roll_addc", "f32", 1, 1, 8, 1, -1e-6, 0),
    "scanstep_masked": ("scan_masked", "f32", 2, 32, 64, 4, -1e-6, -1e6),
}

launches = 0


def _count():
    global launches
    launches += 1


def tile_input(type_name: str, copies: int, device, seed: int = 0) -> torch.Tensor:
    """The JAX probe's input, uniform [0, 0.5) f32 (small integers for int32)."""
    g = torch.Generator().manual_seed(seed)
    if type_name == "f32":
        x = torch.rand((copies, 8, K), generator=g, dtype=torch.float64) * 0.5
        return x.to(torch.float32).to(device)
    return torch.randint(-1000, 1000, (copies, 8, K), generator=g, dtype=torch.int32).to(device)


def plain(x: torch.Tensor, spec: tuple, apps: int) -> torch.Tensor:
    """``apps`` applications of a probe's body to (..., 8, K) elements."""
    op, _, axis, _, _, shift, c1, c2 = spec
    return C.plain_tile(op, x, apps, axis - 3 if axis else -1, shift, c1=c1, c2=c2)


def stage(x: torch.Tensor, spec: tuple, apps: int, count=_count):
    """``launch()`` of a probe's body on (copies, 8, K) elements on the card."""
    op, ty, axis, G, R, shift, c1, c2 = spec
    if axis:
        return C.stage_tile(op, ty, x, apps, axis, G, R, shift, c1=c1, c2=c2, count=count)
    flat = x.reshape(-1, K)
    launch = C.stage_chain(op, ty, flat, torch.zeros_like(flat), apps, 1, c1=c1, c2=c2,
                           count=count)
    return lambda: launch().reshape(x.shape)


def copies_for(dev) -> int:
    return 4 * C.sm_count(dev)  # 8 warps a tile for a lane roll: 32 warps an SM


def measure(name: str, dev, spec: tuple | None = None, lo: int = LO, hi: int = HI,
            count=_count) -> dict:
    """ns an application for one tile and G element-ops/s on the full card."""
    spec = spec or PROBES[name]
    copies = copies_for(dev)
    x = tile_input(spec[1], copies, dev)
    t_lo, t_hi = C.slope_ms(stage(x, spec, lo, count), stage(x, spec, hi, count))
    per = (t_hi - t_lo) * 1e-3 / (hi - lo)  # s for one application over all tiles
    rate = copies * 8 * K / per
    return {"name": name, "ns_op_tile": per * 1e9 / copies, "gops_card": rate / 1e9,
            "gops_sm": rate / 1e9 / C.sm_count(dev), "t_lo_ms": t_lo, "t_hi_ms": t_hi}


def main() -> int:
    dev = C.require_cuda("cuda")
    print(C.card(), flush=True)
    for name in PROBES:
        m = measure(name, dev)
        print(f"probe {name:18s}: {m['ns_op_tile']:8.3f} ns/op a tile, "
              f"{m['gops_card']:9.1f} G elem/s card ({m['gops_sm']:.2f} a SM)", flush=True)
    print(C.sample(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
