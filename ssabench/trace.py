"""Sums over a ``torch.profiler`` trace of the measured window.

Only the profiler's raw events are read (``kineto_results``), as intervals
on the host's clock: device work (kernels, copies, sets), the benchmark's
own spans (``record_function`` ranges named ``ssabench.*``) and the window.
The profiler copies each annotation onto the device's timeline too; those
copies are not device work.
"""
from __future__ import annotations

from dataclasses import dataclass, field

WINDOW = "ssabench.window"


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)  # device op name -> seconds
    idle_s: dict = field(default_factory=dict)  # innermost span -> idle seconds

    def device_s(self, *names: str) -> float:
        """Seconds of the device ops whose names hold any of ``names``."""
        return sum(s for k, s in self.kernel_s.items() if any(n in k for n in names))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_s.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def union(intervals) -> list[tuple[int, int]]:
    """Merged, sorted intervals."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def innermost(window: tuple[int, int], spans) -> list[tuple[int, int, str]]:
    """The window cut into pieces, each labelled with the innermost span
    open over it (the latest opened of those open; ``WINDOW`` where none is)."""
    w0, w1 = window
    events = sorted([(a, 1, i) for i, (a, _, _) in enumerate(spans)]
                    + [(b, 0, i) for i, (_, b, _) in enumerate(spans)])
    out, open_, t = [], [], w0
    for when, opens, i in events + [(w1, 2, -1)]:
        when = min(max(when, w0), w1)
        if when > t:
            label = spans[open_[-1]][2] if open_ else WINDOW
            if out and out[-1][2] == label:
                out[-1] = (out[-1][0], when, label)
            else:
                out.append((t, when, label))
            t = when
        if opens == 1:
            open_.append(i)
        elif opens == 0 and i in open_:
            open_.remove(i)
    return out


def summarize(window: tuple[int, int], device, spans) -> Summary:
    """``window`` (start, end) ns; ``device`` and ``spans`` lists of
    (start, end, name) ns. Device time is clipped to the window; idle time
    goes to the innermost span open while the device was idle."""
    w0, w1 = window
    clipped = [(max(a, w0), min(b, w1), n) for a, b, n in device if b > w0 and a < w1]
    kernel_s: dict[str, float] = {}
    for a, b, n in clipped:
        kernel_s[n] = kernel_s.get(n, 0.0) + (b - a) / 1e9
    busy = union((a, b) for a, b, _ in clipped)
    gaps, edge = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    idle: dict[str, float] = {}
    pieces = innermost(window, sorted(spans))
    j = 0
    for a, b in gaps:  # both lists sorted and disjoint: one pass
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi, label = pieces[k]
            idle[label] = idle.get(label, 0.0) + (min(b, hi) - max(a, lo)) / 1e9
            k += 1
    return Summary(window_s=(w1 - w0) / 1e9,
                   busy_s=sum(b - a for a, b in busy) / 1e9,
                   kernel_s=kernel_s, idle_s=idle)


def from_profiler(prof) -> Summary:
    """The summary of a finished ``torch.profiler.profile``. Device events
    are the CUDA events other than the device-side copies of annotations;
    spans and the window are host-side annotations named ``ssabench.*``."""
    window, device, spans = None, [], []
    for e in prof.profiler.kineto_results.events():
        a, b, name = e.start_ns(), e.end_ns(), e.name()
        annotation = name.startswith(("ssabench.", "ProfilerStep"))
        if str(e.device_type()).endswith("CUDA"):
            if not annotation:
                device.append((a, b, name))
        elif name == WINDOW:
            window = (a, b)
        elif annotation:
            spans.append((a, b, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    return summarize(window, device, spans)
