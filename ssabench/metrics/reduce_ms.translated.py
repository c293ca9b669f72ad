"""The device's time a read outside K1: the traced window's busy time
minus K1's kernels (the best frame of each entry, the record reduction's
sorts, the range flags, the copies), in ms over the reads."""
from ssabench.readings import K1, per


def read(run):
    s = run.summary
    if s is None or s.busy_s <= 0:
        return None
    k1 = s.device_s(*K1)
    return per(run, s.busy_s - k1, "queries") if k1 > 0 else None
