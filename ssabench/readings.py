"""What the metric modules share: percentiles, and readings of a run."""
from __future__ import annotations

import statistics

from . import roofline

K1 = ("k1_lanes", "k1_pipe")  # csrc/interseq.cu
K2 = ("ring_block_kernel",)  # csrc/ring_block.cu
K3 = ("longpair_kernel",)  # csrc/longpair.cu


def p95(values: list[float]) -> float | None:
    """The 95th percentile (``statistics.quantiles``, inclusive method)."""
    if not values:
        return None
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def device_idle_pct(run) -> float | None:
    s = run.summary
    if s is None or s.busy_s <= 0 or s.window_s <= 0:
        return None  # no device work was traced
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def kind(run) -> str:
    return run.traffic["align_type"]


def search_roofline_pct(run) -> float | None:
    """Least time of the window's search calls over their K1 device time."""
    residues = run.mix.residues
    least = sum(
        roofline.least_seconds(w["cells"], kind(run), roofline.search_bytes(
            residues, w["query_residues"], w["queries"], run.traffic["k"]))
        for _, _, w in run.calls if w)
    return roofline.share_pct(least, run.summary.device_s(*K1))


def pair_roofline_pct(run) -> float | None:
    """Least time of the window's pairs over the kernel's device time."""
    m, n = run.traffic["query_length"], run.traffic["subject_length"]
    least = run.total("pairs") * roofline.least_seconds(m * n, kind(run), roofline.pair_bytes(m, n))
    return roofline.share_pct(least, run.summary.device_s(*K3))


def per(run, seconds: float, key: str) -> float | None:
    """``seconds`` in ms a unit of ``key``."""
    n = run.total(key)
    return 1e3 * seconds / n if n else None
