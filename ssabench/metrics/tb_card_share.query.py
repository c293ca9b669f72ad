"""The share of the window's hits traced on the card, in %: the port's
traceback.batch spans (one a hit-kernel launch; ``device`` its hits solved
on the card, ``hits`` all of its hits) over those hits and the hits traced
alone (one traceback.fill span each: the linear-space path, empty
sequences). A program without traceback.batch spans reads None."""
from ssabench.portspans import window_spans


def read(run):
    lists = window_spans(run)
    if lists is None:
        return None
    batches = [s for spans in lists for s in spans if s.name == "traceback.batch"]
    if not batches:
        return None
    alone = sum(s.name == "traceback.fill" for spans in lists for s in spans)
    hits = sum(s.counts["hits"] for s in batches) + alone
    return 100.0 * sum(s.counts["device"] for s in batches) / hits
