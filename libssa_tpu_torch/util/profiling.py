"""Tracing: the port's spans, and the CLI's chrome trace.

Tracing is on exactly while a ``torch.profiler`` profile is recording
(the CLI's ``--xprof``, a benchmark's traced run, a test's profiler).
``span(stats, name, **counts)`` then appends a ``Span`` to the request's
``SearchStats.spans``: its name, the index of the innermost span of the
same request still open (None for the request's root), its start and end
from ``time.time_ns()`` and the counts taken where it opened. Off, a span
is one check of the profiler's flag and records nothing.

``time.time_ns()`` is the profiler's own clock (CLOCK_REALTIME): its
events' ``start_ns()`` lie between two reads of it taken around them, and
``export_chrome_trace`` writes ``ts = (ns - baseTimeNanoseconds) / 1000``
microseconds. So ``trace()`` can put the spans into its trace beside the
profiler's host and device events. The spans are kept in memory and never
opened as ``record_function`` ranges: the profiler copies those onto the
device's timeline, where they would read as device work.

``trace(log_dir)`` records everything run inside it with ``torch.profiler``
and writes a chrome trace to ``log_dir/trace.json`` (the CLI's ``--xprof
DIR``), the spans of the requests made inside it included (category
``ssa_span``); view it in ui.perfetto.dev or chrome://tracing.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

from torch.autograd import profiler as _autograd_profiler

# The SearchStats of the requests that opened a span, one list a trace()
# block open (empty outside them).
_collecting: list[list] = []


class Span:
    """One span of a request, and the context that closes it."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "counts")

    def __init__(self, name, parent, start_ns, end_ns=None, counts=None):
        self.name, self.parent = name, parent
        self.start_ns, self.end_ns = start_ns, end_ns
        self.counts = counts or {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, parent={self.parent}, start_ns={self.start_ns}, "
                f"end_ns={self.end_ns}, counts={self.counts})")


class _Off:
    """The span of a request while tracing is off: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def innermost_open(spans: list) -> int | None:
    """Index of the innermost span of ``spans`` still open, or None.

    Spans of one request nest, so it is the last one or an ancestor of it.
    """
    i = len(spans) - 1 if spans else None
    while i is not None and spans[i].end_ns is not None:
        i = spans[i].parent
    return i


def span(stats, name: str, **counts):
    """Context for one span of the request whose ``SearchStats`` is
    ``stats`` (None: no request, nothing recorded)."""
    if stats is None or not _autograd_profiler._is_profiler_enabled:
        return _OFF
    spans = stats.spans
    if not spans:
        for requests in _collecting:
            requests.append(stats)
    rec = Span(name, innermost_open(spans), time.time_ns(), counts=counts)
    spans.append(rec)
    return rec


def adopt(spans: list, nested: list) -> None:
    """Append a nested request's ``nested`` spans to ``spans``, its roots
    under the span of ``spans`` open now (``SearchStats.merge``)."""
    base, at = len(spans), innermost_open(spans)
    spans.extend(
        Span(s.name, at if s.parent is None else base + s.parent, s.start_ns, s.end_ns,
             s.counts)
        for s in nested
    )


def _seconds(s: Span) -> float:
    return (s.end_ns - s.start_ns) / 1e9


def self_seconds(spans: list, names) -> float:
    """Summed self time of the spans named in ``names``: each one's
    duration minus the part of it that its child spans cover."""
    covered = [0.0] * len(spans)
    for s in spans:
        if s.parent is not None:
            covered[s.parent] += _seconds(s)
    return sum(_seconds(s) - covered[i] for i, s in enumerate(spans) if s.name in names)


def count(spans: list, name: str) -> int:
    return sum(s.name == name for s in spans)


def total_seconds(spans: list, name: str) -> float:
    return sum(_seconds(s) for s in spans if s.name == name)


def _add_spans(path: str, requests: list) -> None:
    """Write the spans of ``requests`` into the chrome trace at ``path`` as
    complete events on this process's host thread, on the trace's clock."""
    with open(path) as fh:
        doc = json.load(fh)
    base = doc.get("baseTimeNanoseconds", 0)
    pid, tid = os.getpid(), threading.get_native_id()
    seen = set()  # a nested request's spans are also its parent's
    for stats in requests:
        for s in stats.spans:
            key = (s.name, s.start_ns, s.end_ns)
            if s.end_ns is None or key in seen:
                continue
            seen.add(key)
            doc["traceEvents"].append({
                "ph": "X", "cat": "ssa_span", "name": s.name, "pid": pid, "tid": tid,
                "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                "args": s.counts,
            })
    with open(path, "w") as fh:
        json.dump(doc, fh)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """A ``torch.profiler`` chrome trace of the block into ``log_dir``
    (no-op when None); the card's activity too where CUDA is available,
    and the port's spans of the requests made inside the block."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    requests: list = []
    _collecting.append(requests)
    try:
        with profile(activities=acts) as prof:
            yield
    finally:
        _collecting.remove(requests)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, requests)
