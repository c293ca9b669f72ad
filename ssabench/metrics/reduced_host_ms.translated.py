"""The frame path's host time a read: self time of the port's translate
and search.reduced spans, so outside its waits on the device (device.wait):
the six frames' translation, the profiles, the index uploads, K1's
launches and the reductions' enqueue, in ms over the reads."""
from ssabench.portspans import self_ms


def read(run):
    return self_ms(run, ("translate", "search.reduced"), "queries")
