"""The benchmark's spans around the port's public entry points.

In a traced run each function below is wrapped, for the run's length, in a
``record_function`` range of the benchmark's own, so that the trace shows
which layer the host was in while the device sat idle. The port's files
are not touched.
"""
from __future__ import annotations

import contextlib
import functools
import importlib

# (module, class or None, function, span name)
TARGETS = (
    ("libssa_tpu_torch.search.manager", "SearchEngine", "search_many", "ssabench.search_many"),
    ("libssa_tpu_torch.search.aligner", None, "align_pair", "ssabench.aligner"),
    ("libssa_tpu_torch.search.hirschberg", None, "align_pair_linear", "ssabench.hirschberg"),
    ("libssa_tpu_torch.ops.longpair", None, "longpair_score", "ssabench.longpair_score"),
)


def _wrap(fn, name: str):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return spanned


@contextlib.contextmanager
def installed():
    """Wrap every target for the duration of the block, then restore it."""
    saved = []
    try:
        for mod_name, cls_name, fn_name, span in TARGETS:
            owner = importlib.import_module(mod_name)
            if cls_name is not None:
                owner = getattr(owner, cls_name)
            fn = getattr(owner, fn_name)
            saved.append((owner, fn_name, fn))
            setattr(owner, fn_name, _wrap(fn, span))
        yield
    finally:
        for owner, fn_name, fn in reversed(saved):
            setattr(owner, fn_name, fn)
