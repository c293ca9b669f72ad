"""query_p95_ms: the 95th percentile of every query's latency in the window,
as one client sees it (a call's wall time, once for each query in it)."""
from ssabench.readings import p95


def read(run):
    return p95(run.latencies_ms("queries"))
