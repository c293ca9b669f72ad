"""Traceback alignment of top-k hits (COMPUTE_ALIGNMENT stage).

The port's copy of ``libssa_tpu/search/aligner.py`` (NumPy, unchanged but
for ``align_pair``'s ``device``, which the linear-space path above
``MATRIX_CELL_LIMIT`` runs its large levels on), and ``align_batch``: the
hits of one call solved together, on a CUDA device in one launch of the hit
kernel (``ops/hit_cuda.py``) a batch.

Counterpart of the reference's ``src/algo/aligner.c`` (SURVEY.md §3.3): after
the score search picks the top-k hits, each hit is re-aligned with a full
Gotoh DP + traceback to produce the alignment path, coordinates, and display
strings. Like the reference, this stage is not vectorized across subjects —
k is tiny — but unlike the reference's scalar C loop the matrix fill here is
row-vectorized NumPy using the same exact lazy-E identity the TPU kernels
use for F (symmetric argument, see ops/interseq.py): ~100x faster than a
per-cell Python loop while remaining an implementation INDEPENDENT of both
the scalar oracle (plain per-cell loops) and the device kernels — the three
are cross-checked in tests/test_aligner.py.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..oracle import NEG, Traceback, _traceback_from, gap_qr
from ..ops import hit_cuda
from ..util.profiling import span


def fill_matrices(q, s, sub, Q: int, R: int, local: bool):
    """Full (m+1, n+1) H, E, F int64 matrices, row-vectorized.

    Row i fill: F row is elementwise from row i-1; the no-E values
    Hnof = max(diag + S, F[, 0]) are exact per cell; E is recovered with a
    prefix max over j of (Hnof + j*R) — exact because extending a gap
    through an E-derived cell never beats extending the gap directly
    (requires Q >= R, guaranteed by gap_qr).
    """
    q = np.asarray(q, dtype=np.intp)
    s = np.asarray(s, dtype=np.intp)
    sub = np.asarray(sub)
    m, n = len(q), len(s)
    # np.empty + fill: np.full with an np.int64 scalar fill value is ~500x
    # slower than a fill() memset on multi-MB arrays (measured).
    H = np.empty((m + 1, n + 1), dtype=np.int64)
    E = np.empty((m + 1, n + 1), dtype=np.int64)
    F = np.empty((m + 1, n + 1), dtype=np.int64)
    H.fill(NEG)
    E.fill(NEG)
    F.fill(NEG)
    H[0, 0] = 0
    js = np.arange(1, n + 1, dtype=np.int64)
    if local:
        H[0, 1:] = 0
        H[1:, 0] = 0
    else:
        H[0, 1:] = -(Q + (js - 1) * R)
        H[1:, 0] = -(Q + (np.arange(1, m + 1, dtype=np.int64) - 1) * R)
    jR = js * R  # offsets for the prefix-max change of variables

    S_rows = sub[q][:, s]  # (m, n) substitution scores
    for i in range(1, m + 1):
        F[i, 1:] = np.maximum(F[i - 1, 1:] - R, H[i - 1, 1:] - Q)
        hnof = np.maximum(H[i - 1, :-1] + S_rows[i - 1], F[i, 1:])
        if local:
            hnof = np.maximum(hnof, 0)
        # E[i, j] = max_{0<=k<j} H[i, k] - Q - (j-1-k) R
        #         = max(H[i, 0], max_{1<=k<j} (hnof_k + k R)) - Q - (j-1) R
        W = hnof + jR  # W[k-1] = hnof_k + k R
        C = np.maximum.accumulate(W)
        prev = np.concatenate(([NEG], C[:-1]))
        prev = np.maximum(prev, H[i, 0])  # gap opened at the row boundary
        E[i, 1:] = prev - Q - (jR - R)
        H[i, 1:] = np.maximum(hnof, E[i, 1:])
    return H, E, F


# Above this many DP cells the full-matrix fill (3 int64 matrices) would
# hold gigabytes; the linear-space Myers-Miller path takes over.
MATRIX_CELL_LIMIT = 16_000_000


def align_pair(
    q: np.ndarray,
    s: np.ndarray,
    sub: np.ndarray,
    gap_open: int,
    gap_extend: int,
    local: bool = True,
    first_residue_opens: bool = True,
    stats=None,
    device="cuda",
) -> Traceback:
    """One optimal alignment of a pair.

    Small pairs: full-matrix fill + traceback. Long pairs (> 16M cells):
    O(m+n)-memory Myers-Miller divide and conquer (search/hirschberg.py)
    — same optimal scores, locked against each other in tests; on a CUDA
    ``device`` its large levels run on K2. ``stats`` (optional
    ``SearchStats``) receives the long-pair path's device accounting
    (``aligner_dispatches`` and the rest).
    """
    q = np.asarray(q)
    s = np.asarray(s)
    m, n = len(q), len(s)
    if m * n > MATRIX_CELL_LIMIT:
        from .hirschberg import align_pair_linear

        return align_pair_linear(
            q, s, sub, gap_open, gap_extend, local, first_residue_opens,
            stats=stats, device=device,
        )
    Q, R = gap_qr(gap_open, gap_extend, first_residue_opens)
    if m == 0 or n == 0:
        if local:
            return Traceback(0, 0, 0, 0, 0, "")
        score = 0 if m == n else -(Q + (max(m, n) - 1) * R)
        return Traceback(score, 0, m, 0, n, "D" * m + "I" * n)
    H, E, F = fill_matrices(q, s, np.asarray(sub), Q, R, local)
    if local:
        i, j = np.unravel_index(int(H.argmax()), H.shape)
        i, j = int(i), int(j)
    else:
        i, j = m, n
    return _traceback_from(H, E, F, q, s, np.asarray(sub), Q, R, i, j, local=local)


def align_batch(
    pairs,
    sub: np.ndarray,
    gap_open: int,
    gap_extend: int,
    local: bool = True,
    first_residue_opens: bool = True,
    stats=None,
    device="cuda",
) -> list[Traceback]:
    """``align_pair`` of every (q, s) of ``pairs``, in their order.

    The pairs of at most ``MATRIX_CELL_LIMIT`` cells with both sequences
    non-empty are traced together: on a CUDA ``device`` by
    ``hit_cuda.hit_batch``, one upload, one launch and one fetch a run of
    ``hit_cuda.groups``, each in a ``traceback.batch`` span (counts
    ``hits``, ``cells``, ``device``: the hits solved on the card; ``local``:
    1 for SW) with its fetch in ``device.wait``; elsewhere by ``align_pair``
    hit by hit, in one such span with ``device`` 0. Every other pair runs ``align_pair`` alone
    in a ``traceback.fill`` span: the linear-space path and the empty
    sequences. ``stats`` (optional ``SearchStats``) also gets the card's
    launch-to-fetch seconds (``aligner_device_seconds``).
    """
    out: list[Traceback | None] = [None] * len(pairs)
    batch = []
    for k, (q, s) in enumerate(pairs):
        m, n = len(q), len(s)
        if m * n > MATRIX_CELL_LIMIT or m == 0 or n == 0:
            with span(stats, "traceback.fill"):
                out[k] = align_pair(q, s, sub, gap_open, gap_extend, local,
                                    first_residue_opens, stats=stats, device=device)
        else:
            batch.append(k)
    if not batch:
        return out
    dev = torch.device(device)
    if dev.type == "cuda":
        Q, R = gap_qr(gap_open, gap_extend, first_residue_opens)
        tbs = _trace_on_card([pairs[k] for k in batch], np.asarray(sub), Q, R, local, dev,
                             stats)
    else:
        cells = sum(len(pairs[k][0]) * len(pairs[k][1]) for k in batch)
        with span(stats, "traceback.batch", hits=len(batch), cells=cells, device=0,
                  local=int(local)):
            tbs = [align_pair(*pairs[k], sub, gap_open, gap_extend, local,
                              first_residue_opens) for k in batch]
    for k, tb in zip(batch, tbs):
        out[k] = tb
    return out


def _trace_on_card(pairs, sub, Q, R, local, dev, stats) -> list[Traceback]:
    """The pairs' tracebacks, one ``hit_cuda.hit_batch`` a run of ``groups``
    over one buffer of their codes."""
    seqs = [np.asarray(x, np.uint8) for pair in pairs for x in pair]
    sizes = np.array([len(x) for x in seqs], np.int64)
    starts = np.cumsum(sizes) - sizes
    hits = np.stack([starts[0::2], sizes[0::2], starts[1::2], sizes[1::2]], axis=1)
    codes = np.concatenate(seqs)
    out = []
    for lo, hi in hit_cuda.groups(hits):
        part = hits[lo:hi]
        cells = int((part[:, 1] * part[:, 3]).sum())
        with span(stats, "traceback.batch", hits=hi - lo, cells=cells, device=hi - lo,
                  local=int(local)):
            t0 = time.perf_counter()
            res = hit_cuda.hit_batch(codes, part, sub, Q, R, local, dev)
            with span(stats, "device.wait"):
                res = res.cpu()  # the one fetch
            if stats is not None:
                stats.aligner_device_seconds += time.perf_counter() - t0
            out.extend(hit_cuda.unpack(res.numpy(), part))
    return out
