"""K2's device time a pair: ring_block_kernel's milliseconds in the traced
window over the pairs aligned."""
from ssabench.readings import K2, per


def read(run):
    s = run.summary.device_s(*K2)
    return per(run, s, "pairs") if s > 0 else None
