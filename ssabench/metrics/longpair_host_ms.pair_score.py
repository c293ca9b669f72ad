"""The long-pair scorer's host time a call: self time of the port's
longpair.score spans, so outside its waits on the device (device.wait),
in ms over the pairs (one a call)."""
from ssabench.portspans import self_ms


def read(run):
    return self_ms(run, ("longpair.score",), "pairs")
