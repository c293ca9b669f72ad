"""Device-spanning traceback of one pair: Myers-Miller divides over a mesh.

The port of ``libssa_tpu/parallel/ring_mm.py`` on ``torch.distributed``.
``parallel/ring.py`` scores a pair whose subject is sharded by columns;
``search/hirschberg.py`` with ``ops/mm_device.DevicePair`` aligns a pair
in O(m + n) memory on one device. Here the top of the Myers-Miller
recursion runs on the ring:

* ``RingPair.divide`` runs a node's forward row pass (its query's upper
  half) and reverse row pass (its lower half, reversed) in the SAME
  staircase phases (``Ring.run``), so each phase's K2 launch holds both.
  The row-``mid`` H/F rows of every shard are then collected by one
  all_gather (each shard's padded to W, indexed by its true columns), and
  t1/t2 are combined in int64 with the first argmin, exactly as
  ``DevicePair.divide_level``: the same split, so the same ops string.
* ``RingPair.sw_end`` is the SW staircase; each tile gives its (best, first
  row reaching it, that row's earliest column), and the lexicographic best
  (score desc, i asc, j asc) is taken over tiles, then ranks.
* Nodes below ``ring_min_cells`` leave the ring for ``hirschberg._nw_ops``
  with the rank's own ``DevicePair`` (on its card; None on the CPU).

Every rank walks the same recursion, makes the same ring divides in the
same order, and returns the same ``Traceback``.

``RingPair`` uploads the pair's codes, forward and reversed, and the matrix
once to every device its shards use; every divide and end-cell sweep is a
set of windows into them. The TPU package's f32/bf16 window fall-back and
its WARNING have no counterpart: K2 is exact in int32, and in int64 past
``score_bound``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..oracle import Traceback, gap_qr
from .ring import RB_DEFAULT, Pass, Ring, all_gather

# Subproblems below this many cells leave the ring and finish on the
# single-device Myers-Miller stack (hirschberg._nw_ops + DevicePair). The
# reference's break-even model (a ring divide saves about
# area * (1 - 1/(D u)) / rate over the single-device pass but pays a
# dispatch a node, where DevicePair batches a whole level into one
# launch) gives about 3e10 cells at D = 8; this card's break-even is not
# measured.
RING_MIN_CELLS = 1 << 35


def _first_min(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(first index of the minimum, the minimum) of a 1-D tensor."""
    v = t.min()
    j = torch.where(t == v, torch.arange(len(t), device=t.device), len(t)).min()
    return j, v


class RingPair(Ring):
    """One pair on the mesh for its traceback: ``divide`` and ``sw_end``
    over windows of the codes ``Ring`` uploaded.

    Counters: ``dispatches`` (``divide`` and ``sw_end`` calls, each one
    staircase and one fetch) and ``seconds`` (their wall time, the
    collectives' and the fetch's waits included).
    """

    def __init__(self, q_codes, s_codes, matrix_padded, gap_q, gap_r, mesh, RB=None):
        super().__init__(q_codes, s_codes, matrix_padded, gap_q, gap_r, mesh,
                         RB_DEFAULT if RB is None else RB)
        self.dispatches = 0
        self.seconds = 0.0

    def _rows(self, outs, W: int, nn: int) -> torch.Tensor:
        """(2 len(outs), nn) int64: H and F at each pass's last row over all
        its columns, from every rank's shards, padded to W, by one
        all_gather."""
        counts = self.mesh.rank_shards or (self.mesh.size,)
        local = torch.zeros(max(counts), 2 * len(outs), W, dtype=torch.int64,
                            device=self.device)
        for t, d in enumerate(self.shards):
            for k, out in enumerate(outs):
                if d in out.rows:
                    for r, row in enumerate(out.rows[d]):
                        local[t, 2 * k + r, :len(row)] = row.to(self.device)
        got = all_gather(local, self.mesh.group)  # (world, max(counts), 2 len(outs), W)
        rows = torch.cat([got[r, :c] for r, c in enumerate(counts)])  # (D, 2 len(outs), W)
        return rows.permute(1, 0, 2).reshape(2 * len(outs), -1)[:, :nn]

    def divide(self, qs, qe, ss, se, tbf_zero, tbr_zero):
        """Ring divide of q[qs:qe] x s[ss:se] (absolute coordinates):
        ``(j1, j2, v1, v2)``, window-local split columns and t1/t2 costs,
        the ``DevicePair.divide_level`` contract."""
        t0 = time.perf_counter()
        g, R = self.Q - self.R, self.R
        mid = (qe - qs) // 2
        mr = (qe - qs) - mid
        nn = se - ss
        tbf, tbr = 0 if tbf_zero else g, 0 if tbr_zero else g
        W = -(-nn // self.mesh.size)
        fwd, rev = self.run([Pass(qs, mid, ss, nn, tbf),
                             Pass(2 * self.m - qe, mr, 2 * self.n - se, nn, tbr)], False)
        fH, fF, rH, rF = self._rows([fwd, rev], W, nn)

        def costs(c0, row):  # CC or DD: column 0's boundary, then -row
            return torch.cat([torch.tensor([c0], device=row.device), -row])

        # t1[j] = CCf[j] + CCr[nn - j], t2[j] = DDf[j] + DDr[nn - j] - g.
        t1 = costs(tbf + R * mid, fH) + costs(tbr + R * mr, rH).flip(0)
        t2 = costs(tbf + R * mid, fF) + costs(tbr + R * mr, rF).flip(0) - g
        j1, v1 = _first_min(t1)
        j2, v2 = _first_min(t2)
        out = torch.stack([j1, j2, v1, v2]).tolist()  # the one fetch
        self.dispatches += 1
        self.seconds += time.perf_counter() - t0
        return tuple(out)

    def sw_end(self, q_end, s_end, reverse=False):
        """(best, end_i, end_j) of SW over q[:q_end] x s[:s_end] (or their
        reverses), 1-based inclusive, with the oracle's tie-break (smallest
        i, then smallest j); (0, 0, 0) when no cell scores above 0."""
        t0 = time.perf_counter()
        m, nn = int(q_end), int(s_end)
        if m == 0 or nn == 0:
            return 0, 0, 0
        p = (Pass(2 * self.m - m, m, 2 * self.n - nn, nn) if reverse
             else Pass(0, m, 0, nn))
        (out,) = self.run([p], True)
        best, i, j = self.end(out)
        self.dispatches += 1
        self.seconds += time.perf_counter() - t0
        if best <= 0:
            return 0, 0, 0
        return best, i, j


def _ring_nw_ops(rp: RingPair, dev, q, s, cost, g, h, tb, te, q0, s0, ring_min_cells):
    """Breadth-first Myers-Miller with ring divides at the top.

    ``hirschberg._nw_ops``'s node bookkeeping: nodes of at least
    ``ring_min_cells`` cells split by ``rp.divide`` (one staircase each);
    smaller nodes hand their whole subtree to ``hirschberg._nw_ops`` with
    the rank's ``DevicePair`` ``dev`` and absolute offsets. The splits equal
    ``align_pair_linear``'s, so where every ring node is also a divide
    there (``ring_min_cells`` above ``LEAF_CELLS``) the ops string is too.
    """
    from ..search.hirschberg import _Node, _nw_ops

    items = [_Node(0, len(q), 0, len(s), tb, te)]
    while True:
        pending = [(i, it) for i, it in enumerate(items) if isinstance(it, _Node)]
        if not pending:
            break
        for i, nd in pending:
            m, n = nd.qe - nd.qs, nd.se - nd.ss
            if m > 1 and n > 0 and m * n >= ring_min_cells:
                continue  # ring-sized: split below
            items[i] = _nw_ops(
                q[nd.qs:nd.qe], s[nd.ss:nd.se], cost, g, h, nd.tb, nd.te,
                dev=dev, q0=q0 + nd.qs, s0=s0 + nd.ss,
            )
        for i, nd in pending:
            if not isinstance(items[i], _Node):
                continue
            j1, j2, v1, v2 = rp.divide(
                q0 + nd.qs, q0 + nd.qe, s0 + nd.ss, s0 + nd.se, nd.tb == 0, nd.te == 0,
            )
            mid = (nd.qe - nd.qs) // 2
            if v1 <= v2:
                items[i] = [
                    _Node(nd.qs, nd.qs + mid, nd.ss, nd.ss + j1, nd.tb, g),
                    _Node(nd.qs + mid, nd.qe, nd.ss + j1, nd.se, g, nd.te),
                ]
            else:
                items[i] = [
                    _Node(nd.qs, nd.qs + mid - 1, nd.ss, nd.ss + j2, nd.tb, 0),
                    ["D", "D"],
                    _Node(nd.qs + mid + 1, nd.qe, nd.ss + j2, nd.se, 0, nd.te),
                ]
        flat = []
        for it in items:
            if isinstance(it, list) and it and not isinstance(it[0], str):
                flat.extend(it)
            else:
                flat.append(it)
        items = flat
    out = []
    for it in items:
        out.extend(it)
    return out


def ring_align_pair(
    q_codes: np.ndarray,
    s_codes: np.ndarray,
    matrix_padded: np.ndarray,
    gap_open: int,
    gap_extend: int,
    local: bool = True,
    first_residue_opens: bool = True,
    mesh=None,
    RB: int | None = None,
    ring_min_cells: int = RING_MIN_CELLS,
    stats=None,
) -> Traceback:
    """Optimal alignment of one pair with the top of its Myers-Miller
    recursion and its SW end and start sweeps on ``mesh`` (default
    ``make_db_mesh()``: every card, raising without CUDA).

    The result equals ``hirschberg.align_pair_linear``'s: score,
    coordinates and ops string. Pairs with m < 2 or n < 2, under
    ``ring_min_cells`` cells, or on a mesh of one shard go to
    ``align_pair_linear`` on the mesh's first local device. ``stats`` (a
    ``SearchStats``): the ring's ``dispatches`` and seconds and the
    hand-off ``DevicePair``'s dispatches, levels and seconds are folded
    into ``aligner_dispatches``, ``aligner_levels`` and
    ``aligner_device_seconds``.
    """
    from ..search.hirschberg import _device_ok, _ops_score, _pad32, align_pair_linear
    from .sharded import make_db_mesh

    mesh = mesh if mesh is not None else make_db_mesh()
    Q, R = gap_qr(gap_open, gap_extend, first_residue_opens)
    q = np.asarray(q_codes, np.intp)
    s = np.asarray(s_codes, np.intp)
    sub = np.asarray(matrix_padded)
    m, n = len(q), len(s)
    if m < 2 or n < 2 or mesh.size < 2 or m * n < ring_min_cells:
        return align_pair_linear(
            q, s, sub, gap_open, gap_extend, local=local,
            first_residue_opens=first_residue_opens, stats=stats,
            device=mesh.local[min(mesh.local)],
        )

    g, h = Q - R, R
    cost = -sub.astype(np.int64)
    rp = RingPair(q, s, _pad32(sub), Q, R, mesh, RB=RB)
    # The hand-off runs on this rank's first device, with the pair the ring
    # already uploaded there, where align_pair_linear would use a device.
    dev = rp.pairs[rp.device] if _device_ok(m, n, rp.device) else None
    try:
        if local:
            best, ei, ej = rp.sw_end(m, n)
            if best == 0:
                return Traceback(0, 0, 0, 0, 0, "")
            _, ri, rj = rp.sw_end(ei, ej, reverse=True)
            si, sj = ei - ri, ej - rj
            ops = _ring_nw_ops(
                rp, dev, q[si:ei], s[sj:ej], cost, g, h, g, g,
                q0=si, s0=sj, ring_min_cells=ring_min_cells,
            )
            return Traceback(best, si, ei, sj, ej, "".join(ops))
        ops = _ring_nw_ops(rp, dev, q, s, cost, g, h, g, g, q0=0, s0=0,
                           ring_min_cells=ring_min_cells)
        return Traceback(_ops_score(q, s, sub, Q, R, ops), 0, m, 0, n, "".join(ops))
    finally:
        if stats is not None:
            stats.aligner_dispatches += rp.dispatches
            stats.aligner_device_seconds += rp.seconds
            if dev is not None:  # the ring's launches bypass its counters
                stats.aligner_dispatches += dev.dispatches
                stats.aligner_levels += dev.levels
                stats.aligner_device_seconds += dev.seconds
