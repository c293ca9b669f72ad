"""The top hits' traceback time a read: time in the port's traceback.batch
spans (on the card the hit kernel's upload, NW launch and fetch; its unpack),
in ms over the reads. A program without the span reads None."""
from ssabench.portspans import total_ms


def read(run):
    return total_ms(run, "traceback.batch", "queries")
