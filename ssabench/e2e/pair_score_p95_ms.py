"""pair_score_p95_ms: the 95th percentile of every align_pair(SCORE) call's
latency in the window."""
from ssabench.readings import p95


def read(run):
    return p95(run.latencies_ms("pairs"))
