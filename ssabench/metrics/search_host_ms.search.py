"""The search manager's host time a call: self time of the port's
search.many and search.group spans, so outside its waits on the device
(device.wait), in ms over the window's calls."""
from ssabench.portspans import self_ms


def read(run):
    return self_ms(run, ("search.many", "search.group"), None)
