"""Tracing hook: the counterpart of ``libssa_tpu/util/profiling.py``.

``trace(log_dir)`` records everything run inside it with ``torch.profiler``
and writes a chrome trace to ``log_dir/trace.json`` (the CLI's ``--xprof
DIR``); view it in ui.perfetto.dev or chrome://tracing.
"""
from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(log_dir: str | None):
    """A ``torch.profiler`` chrome trace of the block into ``log_dir``
    (no-op when None); the card's activity too where CUDA is available."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
