"""Least times of the benchmark's DP kernels, from frozen rates.

A DP cell's least time uses the fewest element operations an exact Gotoh
cell update needs on Hopper (``chip_smoke.py``'s count): ``h = max3(diag +
s, e, f)`` is an add and a 3-way max, ``t = h - Q`` an add shared by both
gaps, ``e' = max(e - R, t)`` and ``f'`` two max-adds. That is 2 adds and 3
DPX operations for NW; SW's running maximum folds two cells into one 3-way
max, 3.5. The adds issue beside the DPX operations, so a cell takes the
larger of the two counts over their rates.

Each rate is the highest exact element rate this card showed for that
operation in any integer width the precision ladder allows (int32, int16x2,
int8x4), so no narrower rung or packed layout can read above 100%: one
H100 80GB HBM3 at a 700 W power limit, ``r2_ilp_probe`` at full occupancy,
phase 12 of ``chip_smoke.py`` (PERF.md, the probes' rates). The element rates there
count a max-add or a 3-way max as two element operations; the rates below
count one a cell.

Bytes: each input byte read once and each output byte written once, at the
data sheet's 3.35 TB/s (H100 SXM at 700 W). The least time is the larger
of the two bounds.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
# Elements a second. int16x2 is the fastest width for both (phase 12):
# add: __vadd2 32,721 G (int32 IADD3 22,169 G, int8x4 __vadd4 28,904 G);
# DPX: __viaddmax_s16x2 52,779 G element-ops = 26,390 G max-adds
# (__vimax3_s16x2 52,744 G = 26,372 G; int32 __viaddmax_s32 13,176 G).
RATES = {"add": 32.721e12, "dpx": 26.3895e12}
CELL_OPS = {"sw": (2.0, 3.5), "nw": (2.0, 3.0)}  # (adds, DPX operations)


def least_seconds(cells: int, kind: str, nbytes: int) -> float:
    """The least time for ``cells`` DP cells of ``kind`` ("sw" or "nw")
    that read and write ``nbytes``."""
    adds, dpx = CELL_OPS[kind]
    t_ops = cells * max(adds / RATES["add"], dpx / RATES["dpx"])
    return max(t_ops, nbytes / HBM_BYTES_PER_S)


def share_pct(least_s: float, device_s: float) -> float | None:
    """The least time as a percentage of the measured device time; None
    where the kernel did not run."""
    return 100.0 * least_s / device_s if device_s > 0 else None


def search_bytes(db_residues: int, query_residues: int, queries: int, k: int) -> int:
    """A search call: the database and the queries read once (a byte a
    residue), ``k`` hits (a 4-byte id and score) written a query."""
    return db_residues + query_residues + 8 * k * queries


def pair_bytes(m: int, n: int) -> int:
    """One pair's score: both sequences read once, one score written."""
    return m + n + 8
