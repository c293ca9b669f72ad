"""The device's idle share of the traced window: 1 - (the union of kernel,
copy and set intervals) / the window, from torch.profiler."""
from ssabench.readings import device_idle_pct


def read(run):
    return device_idle_pct(run)
