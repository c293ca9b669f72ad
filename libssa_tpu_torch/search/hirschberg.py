"""Linear-space optimal alignment (Myers-Miller / Hirschberg).

The port of ``libssa_tpu/search/hirschberg.py``: the same NumPy passes,
leaf solvers, recursion and tie-breaks, so scores, coordinates and cigars
equal the JAX package's. Its device path is ``ops/mm_device.DevicePair``
(the divide levels on K2, each pass's leaves in one launch of the leaf
kernel), used on a CUDA device for pairs of at least ``DEVICE_MIN_CELLS``
cells; on the CPU the NumPy passes and the host leaf solve run, as the
reference runs there.

The full-matrix aligner (``aligner.py``) keeps O(m*n) traceback state —
right for re-aligning top-k database hits (small, bounded), impossible for
two long sequences. This module produces optimal alignments in O(m + n)
memory: the classic Myers-Miller divide-and-conquer for affine gaps
(forward and reverse passes meet at the query midpoint; the crossing
column — and whether the path crosses inside a vertical gap — splits the
problem in two).

The reference has no equivalent (its aligner fills full direction
matrices, SURVEY.md §3.3); this is the long-pair counterpart of the
wavefront/ring score paths (SURVEY.md §5 "long-context").

Internally min-cost form with gap(L) = g + h*L where g = Q - R (open
minus first extend, from ``oracle.gap_qr``'s Q) and h = R; substitution
cost = -score. Row passes are vectorized with the same lazy-E prefix
identity the matrix aligner uses.

SW wraps NW: a forward O(m+n)-memory scoring pass finds the end cell, a
reverse pass from there finds the start cell, then the bounded
subrectangle aligns globally.
"""
from __future__ import annotations

import numpy as np
import torch

from ..oracle import NEG, Traceback, gap_qr
from ..util.profiling import span

INF = int(2**60)

# Pairs with at least this many cells run on a CUDA device: the threshold
# gates (a) uploading the pair at all and (b) each recursion LEVEL (one K2
# launch and one fetch per level; a smaller level's host passes cost less
# than a launch and its boundary set-up). It decides only where a pass
# runs, never the output. Tests lower it and set DEVICE_ON_CPU to run the
# device path on K2's plain version on the CPU.
DEVICE_MIN_CELLS = 16 * 1024 * 1024
DEVICE_ON_CPU = False

# Subproblems at or below this many cells stop recursing and solve
# directly with an O(m*n) direction-matrix fill (_ops_small). The deep
# subtree below this size is tens of thousands of tiny row passes whose
# per-call overhead dominates a huge-pair traceback: the r3 attribution
# (experiments/r3_mm_profile.py) measured 53,210 _mm_pass calls = 19 s
# for only 0.22 Gcells on a 30k x 30k NW pair. Direction matrices at
# this bound cost ~3 MB — trivial next to the O(m+n) guarantee's
# purpose (the FULL matrix for 30k x 30k would be ~2.7 GB).
LEAF_CELLS = 1 << 20


def _pad32(sub):
    out = np.full((32, 32), -64, np.int64)
    A = sub.shape[0]
    out[:A, :A] = sub
    return out


def _device_ok(m, n, device):
    if m * n < DEVICE_MIN_CELLS or m < 2 or n < 2:
        return False
    return device.type == "cuda" or DEVICE_ON_CPU


def _mm_pass(q, s, cost, g, h, tb):
    """One Myers-Miller forward pass over all rows of ``q``.

    Returns ``(CC, DD)`` (n+1,) int64: best cost of aligning all of ``q``
    with ``s[:j]`` in any state / ending in a vertical-gap (delete) state.
    ``tb``: open cost for a vertical gap hugging the left/top corner
    (g normally, 0 when the subproblem continues a gap across its top
    boundary).
    """
    m, n = len(q), len(s)
    js = np.arange(1, n + 1, dtype=np.int64)
    CC = np.empty(n + 1, dtype=np.int64)
    CC[0] = 0
    CC[1:] = g + h * js
    DD = CC + g  # row-0 vertical-state seeds (open later at row 1)
    # Column-0 delete state IS the corner gap: seed with the boundary
    # cost so DD[0] evolves to tb + h*i (not tb + g + h*i).
    DD[0] = tb
    for i in range(1, m + 1):
        CC_prev = CC
        c0 = tb + h * i  # CC[i][0]: leading deletions at boundary cost
        DD = np.minimum(DD, CC_prev + g) + h
        w = cost[q[i - 1], s]  # (n,)
        cnof = np.minimum(DD[1:], CC_prev[:-1] + w)
        # E (horizontal/insert) via prefix min:
        #   E[j] = min( c0 + g + j h,  min_{1<=k<j} cnof[k] + g + (j-k) h )
        W = cnof - js * h
        Cmin = np.minimum.accumulate(W)
        prev = np.concatenate(([INF], Cmin[:-1]))
        prev = np.minimum(prev, c0)
        E = prev + g + js * h
        CC = np.empty(n + 1, dtype=np.int64)
        CC[0] = c0
        CC[1:] = np.minimum(cnof, E)
    return CC, DD


def _rev(x):
    return np.ascontiguousarray(x[::-1])


def _make_device_pair(q, s, sub, Q, R, device, stats):
    """The whole pair resident on ``device``, or None.

    Built once per ``align_pair_linear`` call when the pair is device-
    eligible (its size, a CUDA device); every SW end-cell sweep and every
    Myers-Miller divide LEVEL then runs as one K2 launch windowing into
    it. The TPU package's f32-window and bf16-entry gates have no
    counterpart: K2 is exact in int32, or int64 past its bound.
    """
    if not _device_ok(len(q), len(s), device):
        return None
    from ..ops.mm_device import DevicePair

    return DevicePair(q, s, _pad32(sub), Q, R, device=device, stats=stats)


def _ops_small(q, s, cost, g, h, tb, te):
    """Direct direction-matrix solve of one recursion leaf.

    Optimal ops under the Myers-Miller boundary contract: a vertical
    run hugging the top-left corner (down column 0) opens at ``tb``; one
    hugging the bottom-right corner (up column n) opens at ``te`` — each
    g for a fresh gap, 0 when the parent's gap crosses that boundary.
    Honoring ``te`` in the CHOICE of path (not just its cost) matters:
    after a t2 split the parent already committed to a vertical gap
    across the boundary, and an equal-cost path that does not end in
    the delete state would re-open that gap globally.

    Ties between equal-cost states are safe in any order: each
    candidate's quoted cost is an achievable global contribution for
    that candidate's path, so any argmin path is globally optimal (the
    final score is evaluated from the ops string's gap RUNS, never from
    these internal state choices).
    """
    m, n = len(q), len(s)
    js = np.arange(1, n + 1, dtype=np.int64)
    C_prev = np.empty(n + 1, np.int64)
    C_prev[0] = 0
    C_prev[1:] = g + h * js
    D_prev = C_prev + g
    D_prev[0] = tb
    Cdir = np.empty((m, n), np.uint8)  # 0 diag, 1 from D, 2 from E
    Dopen = np.empty((m, n), bool)
    Eopen = np.empty((m, n), bool)
    CcolN = np.empty(m + 1, np.int64)
    CcolN[0] = C_prev[n]
    for i in range(1, m + 1):
        D = np.minimum(D_prev, C_prev + g) + h
        Dopen[i - 1] = D[1:] == C_prev[1:] + g + h
        w = cost[q[i - 1], s]
        cand = C_prev[:-1] + w
        cnof = np.minimum(D[1:], cand)
        c0 = tb + h * i
        # Lazy-E prefix min (the _mm_pass identity; exact for g >= 0).
        W = cnof - js * h
        Cm = np.minimum.accumulate(W)
        prev = np.concatenate(([INF], Cm[:-1]))
        prev = np.minimum(prev, c0)
        E = prev + g + js * h
        C = np.empty(n + 1, np.int64)
        C[0] = c0
        C[1:] = np.minimum(cnof, E)
        Cdir[i - 1] = np.where(
            C[1:] == cand, 0, np.where(C[1:] == D[1:], 1, 2)
        ).astype(np.uint8)
        Eopen[i - 1] = E == C[:-1] + g + h
        CcolN[i] = C[n]
        C_prev, D_prev = C, D

    # te contract: a trailing delete run of length k ending at (m, n)
    # costs te + k*h (predecessor closes in C state at (m-k, n)).
    ops = []
    i, j = m, n
    if m:
        ks = np.arange(1, m + 1, dtype=np.int64)
        tails = CcolN[m - ks] + te + ks * h
        kbest = int(np.argmin(tails)) + 1
        if tails[kbest - 1] < C_prev[n]:
            ops.extend("D" * kbest)
            i -= kbest
    state = "C"
    while i > 0 and j > 0:
        if state == "C":
            d = Cdir[i - 1, j - 1]
            if d == 0:
                ops.append("M")
                i -= 1
                j -= 1
            elif d == 1:
                state = "D"
            else:
                state = "E"
        elif state == "D":
            ops.append("D")
            opened = Dopen[i - 1, j - 1]
            i -= 1
            if opened:
                state = "C"
        else:
            ops.append("I")
            opened = Eopen[i - 1, j - 1]
            j -= 1
            if opened:
                state = "C"
    ops.extend("D" * i)
    ops.extend("I" * j)
    ops.reverse()
    return ops


def _ops_m1(q, s, cost, g, h, tb, te):
    """Single-row base case: q[0] aligned to some s[j] with flanking
    horizontal gaps, or q[0] deleted inside one vertical gap (cheapest
    boundary open). Vectorized: m==1 nodes inherit the FULL subject span
    of their parent, which for megabase pairs is millions of positions —
    a per-j Python loop takes tens of seconds there. np.argmin keeps the loop's first-strict-improvement
    tie-break (first index attaining the minimum wins; ties with the
    delete-run cost keep the delete run, as the strict < did)."""
    n = len(s)
    del_cost = min(tb, te) + h + g + h * n  # delete + full insert run
    j_arr = np.arange(n, dtype=np.int64)
    gaps = np.where(j_arr > 0, g + h * j_arr, 0) + np.where(
        j_arr < n - 1, g + h * (n - 1 - j_arr), 0
    )
    c = cost[q[0], s].astype(np.int64) + gaps
    jmin = int(np.argmin(c)) if n else -1
    if n and c[jmin] < del_cost:
        return ["I"] * jmin + ["M"] + ["I"] * (n - jmin - 1)
    return ["D"] + ["I"] * n


def _ops_leaf(q, s, cost, g, h, tb, te):
    """Leaf solve: the native C++ fill when built, else ``_ops_small``.

    Identical outputs by construction (same recurrences, tie-breaks, and
    boundary contract — differential-tested); the native path exists
    because the NumPy fill's per-row interpreter overhead dominated the
    huge-pair warm traceback (experiments/r4_mm_profile.py).
    """
    from .leafnative import leaf_ops_native

    ops = leaf_ops_native(q, s, cost, g, h, tb, te)
    if ops is not None:
        return ops
    return _ops_small(q, s, cost, g, h, tb, te)


class _Node:
    """A pending Myers-Miller subproblem: q[qs:qe] vs s[ss:se] with
    boundary opens (tb, te)."""

    __slots__ = ("qs", "qe", "ss", "se", "tb", "te")

    def __init__(self, qs, qe, ss, se, tb, te):
        self.qs, self.qe, self.ss, self.se = qs, qe, ss, se
        self.tb, self.te = tb, te


def _nw_ops(q, s, cost, g, h, tb, te, dev=None, q0=0, s0=0, stats=None):
    """Myers-Miller -> ops list 'M'/'D'/'I' (D: query residue to gap,
    I: subject residue to gap).

    Breadth-first frontier instead of depth-first recursion: ALL divide
    passes of one level run as ONE device dispatch
    (``DevicePair.divide_level`` — forward+reverse rows, t1/t2 combine,
    and argmin on device; the fetch is 4 scalars per node), and
    subproblems at or below LEAF_CELLS solve directly with the
    direction-matrix fill: with ``dev``, every leaf of a pass in one
    launch on the device (``DevicePair.solve_leaves``), else one by one on
    the host (``_ops_leaf``), the same ops either way. ``q0``/``s0``: this
    rectangle's offset in the full pair (``dev`` windows are absolute).
    Levels below DEVICE_MIN_CELLS run the host NumPy passes instead —
    cheaper than a round trip. ``stats``: the request's ``SearchStats``,
    which gets an ``mm.level`` span for each level's divide passes (its
    count ``staged`` is 1 where the level ran through
    ``ops/mm_level_cuda.py``'s kernels on a card, else 0) and an
    ``mm.leaves`` span for each pass's leaves.
    """
    items = [_Node(0, len(q), 0, len(s), tb, te)]
    while True:
        pending = [
            (i, it) for i, it in enumerate(items) if isinstance(it, _Node)
        ]
        if not pending:
            break
        requests, leaves = [], []
        for i, nd in pending:
            m, n = nd.qe - nd.qs, nd.se - nd.ss
            if n == 0:
                items[i] = ["D"] * m
            elif m == 0:
                items[i] = ["I"] * n
            elif m > 1 and m * n <= LEAF_CELLS:
                leaves.append((i, nd))
            elif m == 1:
                items[i] = _ops_m1(q[nd.qs : nd.qe], s[nd.ss : nd.se], cost, g, h,
                                   nd.tb, nd.te)
            else:
                requests.append((i, nd))
        if leaves:
            cells = sum((nd.qe - nd.qs) * (nd.se - nd.ss) for _, nd in leaves)
            with span(stats, "mm.leaves", leaves=len(leaves), cells=cells):
                if dev is not None:
                    solved = dev.solve_leaves([
                        (q0 + nd.qs, nd.qe - nd.qs, s0 + nd.ss, nd.se - nd.ss, nd.tb, nd.te)
                        for _, nd in leaves
                    ])
                else:
                    solved = [
                        _ops_leaf(q[nd.qs : nd.qe], s[nd.ss : nd.se], cost, g, h,
                                  nd.tb, nd.te)
                        for _, nd in leaves
                    ]
            for (i, _), ops in zip(leaves, solved):
                items[i] = ops
        if requests:
            cells = sum((nd.qe - nd.qs) * (nd.se - nd.ss) for _, nd in requests)
            on_device = dev is not None and cells >= DEVICE_MIN_CELLS
            with span(stats, "mm.level", nodes=len(requests), cells=cells,
                      device=on_device, staged=0) as level:
                if on_device:
                    staged = dev.staged_levels
                    splits = dev.divide_level(
                        [
                            (q0 + nd.qs, q0 + nd.qe, s0 + nd.ss, s0 + nd.se,
                             nd.tb == 0, nd.te == 0)
                            for _, nd in requests
                        ]
                    )
                    if level is not None:  # 1: the level's kernels ran on the card
                        level.counts["staged"] = dev.staged_levels - staged
                else:
                    splits = []
                    for _, nd in requests:
                        mid = (nd.qe - nd.qs) // 2
                        CCf, DDf = _mm_pass(
                            q[nd.qs : nd.qs + mid], s[nd.ss : nd.se],
                            cost, g, h, nd.tb,
                        )
                        CCr, DDr = _mm_pass(
                            _rev(q[nd.qs + mid : nd.qe]),
                            _rev(s[nd.ss : nd.se]), cost, g, h, nd.te,
                        )
                        CCr, DDr = _rev(CCr), _rev(DDr)
                        t1 = CCf + CCr  # crossing at (mid, j), match/insert
                        t2 = DDf + DDr - g  # crossing inside a vertical gap
                        j1 = int(np.argmin(t1))
                        j2 = int(np.argmin(t2))
                        splits.append((j1, j2, int(t1[j1]), int(t2[j2])))
            for (i, nd), (j1, j2, v1, v2) in zip(requests, splits):
                mid = (nd.qe - nd.qs) // 2
                if v1 <= v2:
                    items[i] = [
                        _Node(nd.qs, nd.qs + mid, nd.ss, nd.ss + j1,
                              nd.tb, g),
                        _Node(nd.qs + mid, nd.qe, nd.ss + j1, nd.se,
                              g, nd.te),
                    ]
                else:
                    items[i] = [
                        _Node(nd.qs, nd.qs + mid - 1, nd.ss, nd.ss + j2,
                              nd.tb, 0),
                        ["D", "D"],
                        _Node(nd.qs + mid + 1, nd.qe, nd.ss + j2, nd.se,
                              0, nd.te),
                    ]
        flat = []
        for it in items:
            if isinstance(it, list) and it and not isinstance(it[0], str):
                flat.extend(it)  # a replaced node: [child, ops?, child]
            else:
                flat.append(it)
        items = flat
    out = []
    for it in items:
        out.extend(it)
    return out


def _score_end_sw(q, s, sub, Q, R):
    """O(m+n) SW pass -> (best score, end_i, end_j) (1-based inclusive).

    Ties break toward the smallest (i, j) — matching the matrix aligner's
    argmax over C-order.
    """
    m, n = len(q), len(s)
    js = np.arange(1, n + 1, dtype=np.int64)
    H = np.zeros(n + 1, dtype=np.int64)
    Fcol = np.full(n + 1, NEG, dtype=np.int64)
    best, bi, bj = 0, 0, 0
    for i in range(1, m + 1):
        Hprev = H
        Fcol = np.maximum(Fcol - R, Hprev - Q)
        S = sub[q[i - 1], s]
        hnof = np.maximum(np.maximum(Hprev[:-1] + S, Fcol[1:]), 0)
        W = hnof + js * R
        C = np.maximum.accumulate(W)
        prev = np.concatenate(([NEG], C[:-1]))
        E = np.maximum(prev, 0) - Q - (js - 1) * R
        H = np.concatenate(([0], np.maximum(hnof, E)))
        j = int(np.argmax(H))
        if H[j] > best:
            best, bi, bj = int(H[j]), i, j
    return best, bi, bj


def _ops_score(q, s, sub, Q, R, ops) -> int:
    """Score of an alignment path in O(m+n) (vectorized).

    Gotoh accounting: a maximal run of one gap op costs Q + (run-1)*R;
    switching between D and I opens a NEW gap (two separate gaps).
    """
    a = np.frombuffer("".join(ops).encode(), np.uint8)
    isM = a == ord("M")
    isD = a == ord("D")
    i_pos = np.cumsum(isM | isD) - 1  # query index at each step
    j_pos = np.cumsum(~isD) - 1  # subject index (M or I advance j)
    subs = int(sub[q[i_pos[isM]], s[j_pos[isM]]].sum())
    gap = ~isM
    opens = int((gap & np.concatenate([[True], a[1:] != a[:-1]])).sum())
    gap_len = int(gap.sum())
    return subs - opens * Q - (gap_len - opens) * R


def align_pair_linear(
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
    """Optimal alignment in O(m+n) memory (same scores as the oracle).

    ``device``: where ``DevicePair`` runs a pair of at least
    ``DEVICE_MIN_CELLS`` cells (K2 on CUDA); on the CPU the NumPy passes
    run. ``stats`` (a ``SearchStats``, optional): the device path's K2
    launches, levels and seconds are folded into
    ``stats.aligner_dispatches``, ``aligner_levels`` and
    ``aligner_device_seconds``, and, while tracing, it gets the
    ``mm.align`` span and a span a level (``util/profiling.py``).
    """
    Q, R = gap_qr(gap_open, gap_extend, first_residue_opens)
    q = np.asarray(q, dtype=np.intp)
    s = np.asarray(s, dtype=np.intp)
    sub = np.asarray(sub)
    m, n = len(q), len(s)
    if m == 0 or n == 0:
        if local:
            return Traceback(0, 0, 0, 0, 0, "")
        score = 0 if m == n else -(Q + (max(m, n) - 1) * R)
        return Traceback(score, 0, m, 0, n, "D" * m + "I" * n)
    g, h = Q - R, R
    cost = -sub.astype(np.int64)
    with span(stats, "mm.align"):
        dev = _make_device_pair(q, s, sub, Q, R, torch.device(device), stats)
        try:
            if local:
                if dev is not None:
                    score, ei, ej = dev.sw_end(0, m, 0, n)
                else:
                    score, ei, ej = _score_end_sw(q, s, sub, Q, R)
                if score == 0:
                    return Traceback(0, 0, 0, 0, 0, "")
                # Reverse pass over the prefix rectangle finds the start cell
                # (a window into the REVERSED planes: rev(q[:ei]) = rev-q rows
                # [m-ei, m), same for the subject).
                if dev is not None:
                    _, ri, rj = dev.sw_end(m - ei, ei, n - ej, ej, reverse=True)
                else:
                    _, ri, rj = _score_end_sw(
                        _rev(q[:ei]), _rev(s[:ej]), sub, Q, R
                    )
                si, sj = ei - ri, ej - rj  # 0-based start
                ops = _nw_ops(
                    q[si:ei], s[sj:ej], cost, g, h, g, g, dev=dev, q0=si, s0=sj,
                    stats=stats,
                )
                return Traceback(score, si, ei, sj, ej, "".join(ops))
            ops = _nw_ops(q, s, cost, g, h, g, g, dev=dev, stats=stats)
            # The optimal score is the optimal path's score: evaluate the ops
            # in O(m+n) instead of re-running a whole O(m*n) forward pass
            # (which was +33-50% wall time on every huge-pair global
            # alignment) just to read CC[n].
            return Traceback(
                _ops_score(q, s, sub, Q, R, ops), 0, m, 0, n, "".join(ops)
            )
        finally:
            if stats is not None and dev is not None:
                stats.aligner_dispatches += dev.dispatches
                stats.aligner_levels += dev.levels
                stats.aligner_device_seconds += dev.seconds
