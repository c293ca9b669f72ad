"""Myers-Miller's host time a pair: self time of the port's mm.align and
mm.level spans, so outside its waits on the device (device.wait): host
levels, leaves, K2's staging and launches, in ms over the pairs."""
from ssabench.portspans import self_ms


def read(run):
    return self_ms(run, ("mm.align", "mm.level"), "pairs")
