"""search_gcups: the DP cells the inputs need (query length x subject length,
summed over every completed query and subject, no padding), in billions, over
the window's length. The window ends when the call running at its end returns."""


def read(run):
    return run.total("cells") / run.window_s / 1e9 if run.window_s > 0 else None
