"""The share of the window's strand sweeps that ran NW on K1's int32 lanes,
in %: the port's search.reduced spans with ``local`` 0 and ``wide`` 0 over
all of them. A program whose spans lack those counts reads None."""
from ssabench.portspans import window_spans


def read(run):
    lists = window_spans(run)
    if lists is None:
        return None
    sweeps = [s.counts for spans in lists for s in spans if s.name == "search.reduced"]
    if not sweeps or any("local" not in c or "wide" not in c for c in sweeps):
        return None
    return 100.0 * sum(c["local"] == 0 and c["wide"] == 0 for c in sweeps) / len(sweeps)
