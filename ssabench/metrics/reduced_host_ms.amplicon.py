"""The strand path's host time a read: self time of the port's
search.reduced spans, so outside its waits on the device (device.wait):
the two strands' profiles, the index upload, K1's launches and the
reductions' enqueue, in ms over the reads."""
from ssabench.portspans import self_ms


def read(run):
    return self_ms(run, ("search.reduced",), "queries")
