"""align_ms_per_pair: the window's length over the pairs aligned in it. The
window ends when the call running at its end returns."""
from ssabench.readings import per


def read(run):
    return per(run, run.window_s, "pairs")
