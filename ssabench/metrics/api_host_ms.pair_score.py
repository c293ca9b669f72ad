"""The API's host time a call: self time of the port's api.align_pair
spans, so outside the long-pair scorer (longpair.score), in ms over the
pairs (one a call)."""
from ssabench.portspans import self_ms


def read(run):
    return self_ms(run, ("api.align_pair",), "pairs")
