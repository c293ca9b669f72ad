"""The host traceback's time a query: the port's SearchStats.aligner_seconds
over the window's calls, in ms over the queries."""
from ssabench.readings import per


def read(run):
    s = sum(st.aligner_seconds for st in run.mix.stats)
    return per(run, s, "queries") if s > 0 else None
