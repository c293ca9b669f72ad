"""The linear-space aligner's host time a pair: the traced window's length
minus the device's busy time, over the pairs aligned."""
from ssabench.readings import per


def read(run):
    s = run.summary
    return per(run, s.window_s - s.busy_s, "pairs") if s.busy_s > 0 else None
