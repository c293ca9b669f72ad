"""The display rows' time a pair: the port's display spans
(Traceback.aligned_strings under api.py), in ms over the pairs."""
from ssabench.portspans import total_ms


def read(run):
    return total_ms(run, "display", "pairs")
