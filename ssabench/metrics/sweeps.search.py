"""K1 sweeps a call: the port's search.group spans (one sweep, device
top-k and fetch for the queries of one profile height) over the window's
calls."""
from ssabench.portspans import window_spans


def read(run):
    lists = window_spans(run)
    if lists is None:
        return None
    from libssa_tpu_torch.util.profiling import count

    n = sum(count(sp, "search.group") for sp in lists)
    return n / len(lists) if n else None
