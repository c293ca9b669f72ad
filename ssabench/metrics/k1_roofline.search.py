"""K1's roofline share: the least time of the window's search cells
(ssabench/roofline.py) over the device time of K1's kernels."""
from ssabench.readings import search_roofline_pct


def read(run):
    return search_roofline_pct(run)
