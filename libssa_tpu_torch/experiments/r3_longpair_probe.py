"""The long-pair design probes of round 3, on Hopper.

The counterpart of ``experiments/r3_longpair_probe.py``. Probe 2 (its
``mk``): bodies applied ``ITERS`` = 512 times to an (8, 2048) f32 tile,
timed whole as the JAX probe timed them; they run on ``r3_roll_probe``'s
kernels. Probe 1 asked whether XLA's scan row sweep clears the bar at
16,384^2 or a hand kernel is needed: here the hand row sweep
(``r3_lp_bisect``'s full variant) answers it at the same size.

    python -m libssa_tpu_torch.experiments.r3_longpair_probe
"""
from __future__ import annotations

import sys

from . import _common as C
from . import r3_lp_bisect, r3_roll_probe

ITERS = 512
# name -> r3_roll_probe's spec: (op, type, axis, G, R, shift, c1, c2)
PROBES = {
    "add": ("addc", "f32", 0, 0, 0, 0, 1.0, 0),
    "max": ("maxc", "f32", 0, 0, 0, 0, 0.5, 0),
    "roll_lane1": ("roll_addc", "f32", 2, 32, 64, 1, 1.0, 0),
    "roll_lane128": ("roll_addc", "f32", 2, 32, 64, 128, 1.0, 0),
    "roll_lane512": ("roll_addc", "f32", 2, 32, 64, 512, 1.0, 0),
    "roll_sub1": ("roll_addc", "f32", 1, 1, 8, 1, 1.0, 0),
    "scan_step": ("max_roll_addc", "f32", 2, 32, 64, 4, -4.0, 0),
}

launches = 0


def _count():
    global launches
    launches += 1


def tile_input(copies: int, device, seed: int = 0):
    """The JAX probe's input: uniform [0, 1) f32."""
    return r3_roll_probe.tile_input("f32", copies, device, seed) * 2.0


def plain(x, name: str, iters: int = ITERS):
    return r3_roll_probe.plain(x, PROBES[name], iters)


def stage(x, name: str, iters: int = ITERS):
    return r3_roll_probe.stage(x, PROBES[name], iters, _count)


def measure(name: str, dev) -> dict:
    """One launch of ITERS applications: ms, and ns an op for one tile."""
    copies = r3_roll_probe.copies_for(dev)
    ms = C.events_ms(stage(tile_input(copies, dev), name))
    return {"name": name, "ms": ms, "ns_op_tile": ms * 1e6 / ITERS / copies}


def main() -> int:
    dev = C.require_cuda("cuda")
    print(C.card(), flush=True)
    for name in PROBES:
        m = measure(name, dev)
        print(f"probe {name:14s}: {m['ns_op_tile']:8.3f} ns/op a tile "
              f"({m['ms']:.3f} ms / {ITERS})", flush=True)
    r = r3_lp_bisect.measure("full", dev)
    print(f"row sweep 16k (r3_lp_bisect full): {r['ms_one']:.3f} ms, "
          f"{r['gcups_one']:.2f} GCUPS, score {r['score']}", flush=True)
    print(C.sample(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
