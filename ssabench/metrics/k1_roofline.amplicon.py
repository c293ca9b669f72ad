"""K1's roofline share on the amplicon path: the least time of the window's
NW cells (each read's two strands against every entry, no padding; 3 DPX
operations a cell, from the traffic's align_type; ssabench/roofline.py)
over the device time of K1's kernels."""
from ssabench.readings import search_roofline_pct


def read(run):
    return search_roofline_pct(run)
