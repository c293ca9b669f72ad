"""K2 with its own stages cut, on Hopper: where a step's time goes.

K2's counterpart of ``r3_banded_bisect`` (K3's stage cuts): compile-time
switches of K2 (``csrc/ring_block.cu``'s header, all off by default), each
set built into its own library:

- ``full``: K2 itself;
- ``no_fence``: no ``__threadfence`` before the writer warp's progress
  release store (still exact: the release is cumulative);
- ``no_wait``: the reader warp does not poll the group above;
- ``no_publish``: no poll, no fence and no progress release store;
- ``no_sync``: no barrier between segments, so the warps of a block drift
  apart and their shared-memory handoffs are unordered;
- ``no_profile``: every column takes symbol 0's profile entries;
- ``bare``: ``no_publish``, ``no_sync`` and ``no_profile`` at once.

Every variant but ``full`` and ``no_fence`` gives wrong outputs and is timed
only. Each is timed as its launch alone (``ring_block_cuda.stage``, min of
3 after a warm-up) at ``chip_smoke.py``'s K2 shapes (``k2_ab.shapes``): (a)
11a's first level at 4 rows a thread and 1, 4 and 8 warps a block, and (b)
11b's first SW end scan at 8 rows and 1 and 4 warps; K2 itself first and
last at each.

    python -m libssa_tpu_torch.experiments.k2_bisect [variants...]

from the repository root (it imports ``chip_smoke`` for the shapes).
"""
from __future__ import annotations

import sys

from ..ops import ring_block_cuda
from . import _common as C
from . import k2_ab

CUTS = {
    "full": (),
    "no_fence": ("K2_PROBE_NO_FENCE",),
    "no_wait": ("K2_PROBE_NO_WAIT",),
    "no_publish": ("K2_PROBE_NO_PUBLISH",),
    "no_sync": ("K2_PROBE_NO_SYNC",),
    "no_profile": ("K2_PROBE_NO_PROFILE",),
    "bare": ("K2_PROBE_NO_PUBLISH", "K2_PROBE_NO_SYNC", "K2_PROBE_NO_PROFILE"),
}
CONFIGS = {"a": ((4, 1), (4, 4), (4, 8)), "b": ((8, 1), (8, 4))}  # (rows, warps)


def measure(shapes: dict, variants=tuple(CUTS), reps: int = 3) -> dict:
    """{(shape, rows, warps): {variant: ms}}, K2 itself first and last."""
    from .. import oracle

    Q, R = oracle.gap_qr(11, 1)
    order = ["full", *[v for v in variants if v != "full"], "full"]
    out = {}
    for shape, configs in CONFIGS.items():
        pair, jobs, bounds, local = shapes[shape]
        for ch, w in configs:
            row = out.setdefault((shape, ch, w), {})
            for v in order:
                launch = ring_block_cuda.stage(pair.q, pair.s, jobs, pair.matrix, Q, R, local,
                                               *bounds, codes_checked=True,
                                               rows_per_thread=ch, warps=w, defines=CUTS[v])
                ms = C.events_ms(launch, reps)
                row[v] = min(row.get(v, ms), ms)
    return out


def main(argv=None) -> int:
    import chip_smoke

    dev = C.require_cuda("cuda")
    print(C.card(), flush=True)
    variants = (argv if argv is not None else sys.argv[1:]) or tuple(CUTS)
    res = measure(k2_ab.shapes(chip_smoke, dev), variants)
    for (shape, ch, w), row in res.items():
        print(f"({shape}) rows {ch} warps {w}: " + ", ".join(
            f"{v} {row[v]:.3f}" + ("" if v in ("full", "no_fence") else "*")
            for v in variants) + " ms (* timed only)", flush=True)
    print(C.sample(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
