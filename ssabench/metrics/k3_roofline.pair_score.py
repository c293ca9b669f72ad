"""K3's roofline share: the least time of the window's m x n cells
(ssabench/roofline.py) over the device time of longpair_kernel."""
from ssabench.readings import pair_roofline_pct


def read(run):
    return pair_roofline_pct(run)
