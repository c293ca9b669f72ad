"""The Myers-Miller leaves' time a pair: the port's mm.leaves spans (each
frontier pass's leaves: on the device one launch and one fetch, else the
host fills), in ms over the pairs. A program without the span reads None."""
from ssabench.portspans import total_ms


def read(run):
    return total_ms(run, "mm.leaves", "pairs")
