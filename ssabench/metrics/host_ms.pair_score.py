"""Long-pair routing's host time a call: wall time a call minus K3's device
time a call."""
from ssabench.readings import K3, per


def read(run):
    wall = sum(t1 - t0 for t0, t1, w in run.calls if w)
    k3 = run.summary.device_s(*K3)
    return per(run, wall - k3, "pairs") if k3 > 0 else None
