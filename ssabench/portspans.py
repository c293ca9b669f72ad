"""The port's own spans, as the per-layer readers of them see a run.

While a profiler records, the port appends each request's spans to its
``SearchStats.spans`` (``libssa_tpu_torch/util/profiling.py``): one
``SearchStats`` a window call in both mixes. A program that keeps no
spans reads as None, so that its readers report nothing there and never
raise.
"""
from __future__ import annotations

from .readings import per


def window_spans(run) -> list[list] | None:
    """The spans of each window call, or None where there are none."""
    lists = [getattr(st, "spans", None) for st in run.mix.stats]
    if not lists or any(s is None for s in lists) or not any(lists):
        return None
    return lists


def self_ms(run, names: tuple, key: str) -> float | None:
    """Self time of the spans named ``names`` over the window, in ms a unit
    of ``key``, or in ms a call where ``key`` is None."""
    lists = window_spans(run)
    if lists is None:
        return None
    from libssa_tpu_torch.util.profiling import self_seconds

    s = sum(self_seconds(sp, names) for sp in lists)
    if s <= 0:
        return None
    return per(run, s, key) if key else 1e3 * s / len(lists)


def total_ms(run, name: str, key: str) -> float | None:
    """Time in the spans named ``name`` over the window, in ms a unit of ``key``."""
    lists = window_spans(run)
    if lists is None:
        return None
    from libssa_tpu_torch.util.profiling import total_seconds

    s = sum(total_seconds(sp, name) for sp in lists)
    return per(run, s, key) if s > 0 else None
