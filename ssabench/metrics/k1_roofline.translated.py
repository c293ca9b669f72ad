"""K1's roofline share on the frame path: the least time of the window's
frame cells (each read's six frames against every entry, no padding;
ssabench/roofline.py) over the device time of K1's kernels."""
from ssabench.readings import search_roofline_pct


def read(run):
    return search_roofline_pct(run)
