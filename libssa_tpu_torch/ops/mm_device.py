"""Device row passes for the linear-space Myers-Miller traceback, on K2.

The port of ``libssa_tpu/ops/mm_device.py``. ``search/hirschberg.py``
aligns arbitrarily long pairs in O(m + n) memory; its divide step needs
exactly two things per subproblem:

* the (CC, DD) min-cost rows at the split row: the NEGATED H and F rows of
  a Gotoh NW fill whose left boundary opens a vertical gap at ``tb``
  (g = Q - R for a fresh gap, 0 when a gap crosses the subproblem's
  boundary): CC[j] = -H[mid][j], DD[j] = -F[mid][j];
* the SW end cell (score, i, j) with the oracle's tie-break (smallest i,
  then smallest j).

Both are K2 tiles (``ops/ring_block.py``), one tile per pass, since K2
takes any number of rows and columns: the H/F row at the split is the
tile's bottom row, and the end cell comes from the tile's per-row maxima
and their earliest columns.

``DevicePair`` uploads the pair once per alignment: the query and subject
codes, forward and reversed, and the matrix. Every pass is then a window
into them. One recursion level runs as ONE K2 launch over the forward and
reverse pass of every node, staged by ``ops/mm_level_cuda.py``: the
level's tile table goes up in one copy, a prologue kernel writes K2's
boundaries from it, K2 runs, and a split kernel combines t1/t2 in int64
(a sum of two rows can pass the int32 bound when each row does not) and
takes their first minima (as ``np.argmin``); the host fetches 4 integers
a node in one copy. Nothing else of a level waits for the device. The
leaves of a frontier pass are one launch of the leaf kernel
(``solve_leaves``, ``ops/leaf_cuda.py``) and one fetch of their ops.

Boundary mapping (min-cost -> score form): substitution = the matrix,
penalties (Q, R); left column H[i][0] = -(tb + R*i); top row
H[0][j] = -(Q + (j-1)R); no gap state on either boundary, passed as
E = H - Q + R and F = H - Q + R (ring_block.py).

The TPU version's fixed two-level tile ladder, power-of-two grid and
node-count rounding, plane capacities with slack and f32/bf16 limits are
compilation and layout devices of the TPU; K2 needs none of them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..util.profiling import span
from . import leaf_cuda, mm_level_cuda, ring_block_cuda
from .interseq import INT32_LIMIT
from .longpair import score_bound

class DevicePair:
    """One (query, subject) pair resident on a device, for its traceback.

    Uploaded once per ``hirschberg.align_pair_linear`` call: the codes,
    forward and reversed, in one buffer each (reversed after forward), and
    the padded matrix. Every Myers-Miller level and SW end-cell sweep is one
    K2 launch over windows into them. On a CPU ``device`` the same calls run
    K2's plain version (the tests' way of holding this class against the
    JAX package).

    Counters: ``dispatches`` (K2 launches, each followed by one fetch),
    ``levels`` (``divide_level`` calls), ``staged_levels`` (those that ran
    through ``mm_level_cuda``'s kernels: on a card), ``leaf_launches``
    (``solve_leaves`` calls: one leaf-kernel launch and one fetch each) and
    ``seconds`` (wall time of those calls, the fetch's wait for the device
    included). ``stats``, the request's ``SearchStats`` where given, gets a
    ``device.wait`` span around each fetch.
    """

    def __init__(self, q_codes, s_codes, matrix_padded, gap_q, gap_r, device="cuda",
                 stats=None):
        q, s = np.asarray(q_codes), np.asarray(s_codes)
        for codes in (q, s):  # checked once here, not at every K2 launch
            if codes.size and not 0 <= int(codes.min()) <= int(codes.max()) < 32:
                raise ValueError("codes must lie in 0 .. 31")
        q, s = q.astype(np.uint8), s.astype(np.uint8)
        self.m, self.n = len(q), len(s)
        self.Q, self.R = int(gap_q), int(gap_r)
        self.device = torch.device(device)
        mat = np.asarray(matrix_padded)
        self.dtype = (torch.int32 if score_bound(self.m, self.n, mat, self.Q, self.R)
                      < INT32_LIMIT else torch.int64)
        self.q = torch.from_numpy(np.concatenate([q, q[::-1]])).to(self.device)
        self.s = torch.from_numpy(np.concatenate([s, s[::-1]])).to(self.device)
        self.matrix = torch.from_numpy(mat.astype(np.int32)).to(self.device)
        self.cost = torch.from_numpy(-mat.astype(np.int32)).to(self.device)
        self.max_cost = int(np.abs(mat).max())
        self.stats = stats
        self.dispatches = 0
        self.levels = 0
        self.staged_levels = 0
        self.leaf_launches = 0
        self.seconds = 0.0

    def _jobs(self, q_off, m, s_off, n, reverse):
        """One tile's row of K2's job list (reversed windows lie past the
        forward codes)."""
        return [q_off + (self.m if reverse else 0), m, s_off + (self.n if reverse else 0), n]

    def bounds(self, jobs: np.ndarray, tbs: np.ndarray | None):
        """K2's flat (leftH, leftE, topH, topF) for ``jobs``: NW tiles whose
        left boundary opens a vertical gap at ``tbs``, or SW tiles with zero
        boundaries (``tbs`` None); the prologue kernel on a card (kept for
        ``experiments/k2_ab.py``, which times K2 alone across checkouts)."""
        level = mm_level_cuda.stage(jobs, tbs, self.device)
        return mm_level_cuda.prologue(level, self.dtype, self.Q, self.R, tbs is None)

    def _run(self, jobs: np.ndarray, tbs: np.ndarray | None):
        """One K2 launch over ``jobs``: NW tiles whose left boundary opens a
        vertical gap at ``tbs``, or SW tiles with zero boundaries (``tbs``
        None), the boundaries written by the prologue from one upload of the
        tile table. Returns K2's outputs and the staged table."""
        level = mm_level_cuda.stage(jobs, tbs, self.device)
        out = ring_block_cuda.ring_block_cuda(
            self.q, self.s, jobs, self.matrix, self.Q, self.R, tbs is None,
            *mm_level_cuda.prologue(level, self.dtype, self.Q, self.R, tbs is None),
            codes_checked=True,
        )
        return out, level

    def level_jobs(self, nodes):
        """K2's jobs and left-boundary opens for one level: per node, the
        forward pass over q[qs:qs+mid] x s[ss:se], then the reverse pass
        over the reversed remainder (at M - qe, N - se in reversed codes)."""
        g = self.Q - self.R
        a = np.array([tuple(int(v) for v in nd) for nd in nodes], np.int64).reshape(-1, 6)
        qs, qe, ss, se = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
        mid = (qe - qs) // 2
        nn = se - ss
        jobs = np.empty((2 * len(a), 4), np.int64)
        jobs[0::2] = np.stack([qs, mid, ss, nn], 1)
        jobs[1::2] = np.stack([2 * self.m - qe, qe - qs - mid, 2 * self.n - se, nn], 1)
        tbs = np.stack([np.where(a[:, 4] != 0, 0, g), np.where(a[:, 5] != 0, 0, g)], 1)
        return jobs, tbs.reshape(-1)

    def divide_level(self, nodes):
        """All divide passes of one recursion LEVEL in one K2 launch, between
        the prologue and the split kernel (on a card; their plain versions
        on the CPU), with one fetch.

        ``nodes``: ``[(qs, qe, ss, se, tbf_is_zero, tbr_is_zero)]`` in
        absolute pair coordinates, qe - qs >= 2 and se > ss. Returns
        ``[(j1, j2, v1, v2)]``: the t1/t2 argmins and values
        ``hirschberg._nw_ops`` splits on.
        """
        t0 = time.perf_counter()
        out, level = self._run(*self.level_jobs(nodes))
        res = mm_level_cuda.split(level, out.botH, out.botF, self.Q - self.R, self.R)
        with span(self.stats, "device.wait"):
            res = mm_level_cuda.fetch(res)  # the one fetch
        self.dispatches += 1
        self.levels += 1
        self.staged_levels += int(self.device.type == "cuda")
        self.seconds += time.perf_counter() - t0
        return [tuple(r) for r in res]

    def solve_leaves(self, leaves):
        """The ops of every leaf of one frontier pass: one upload of the leaf
        table, one launch, one fetch.

        ``leaves``: ``[(q_off, m, s_off, n, tb, te)]``, windows into the
        forward codes in absolute pair coordinates, m >= 1 and n >= 1, the
        boundary opens tb and te each 0 or Q - R. Returns each leaf's ops as
        a string of 'M', 'D' and 'I', as ``hirschberg._ops_leaf`` gives them.
        """
        t0 = time.perf_counter()
        table = np.array(leaves, np.int64).reshape(-1, 6)
        out = leaf_cuda.leaf_batch_cuda(self.q, self.s, table, self.cost, self.Q - self.R,
                                        self.R, max_abs=self.max_cost)
        with span(self.stats, "device.wait"):
            out = out.cpu().numpy()  # the one fetch
        self.leaf_launches += 1
        self.seconds += time.perf_counter() - t0
        return leaf_cuda.unpack(out, table)

    def mm_pass(self, q_off, m, s_off, n, tb_is_zero, reverse=False):
        """(CC, DD) int64 rows of one window, the device counterpart of
        ``hirschberg._mm_pass`` on ``q[q_off:q_off+m]`` x ``s[s_off:s_off+n]``
        (reversed codes when ``reverse``)."""
        t0 = time.perf_counter()
        tb = 0 if tb_is_zero else self.Q - self.R
        out, _ = self._run(np.array([self._jobs(q_off, m, s_off, n, reverse)], np.int64),
                           np.array([tb]))
        c0 = tb + self.R * m
        with span(self.stats, "device.wait"):
            CC = np.concatenate([[c0], -out.botH.long().cpu().numpy()])
            DD = np.concatenate([[c0], -out.botF.long().cpu().numpy()])
        self.dispatches += 1
        self.seconds += time.perf_counter() - t0
        return CC.astype(np.int64), DD.astype(np.int64)

    def sw_end(self, q_off, m, s_off, n, reverse=False):
        """Window-local (best, end_i, end_j), 1-based inclusive, with the
        oracle tie-break (smallest i, then smallest j); (0, 0, 0) when no
        cell scores above 0."""
        t0 = time.perf_counter()
        out, _ = self._run(np.array([self._jobs(q_off, m, s_off, n, reverse)], np.int64),
                           None)
        best = out.rowmax.max()
        rows = torch.arange(m, device=self.device)
        i = torch.where(out.rowmax == best, rows, m).min().view(1)  # the first row reaching it
        j = out.rowarg.index_select(0, i).long()
        fetched = torch.cat([best.long().view(1), i, j])
        with span(self.stats, "device.wait"):
            best, i, j = fetched.cpu().tolist()  # the one fetch
        self.dispatches += 1
        self.seconds += time.perf_counter() - t0
        if best <= 0:
            return 0, 0, 0
        return best, i + 1, j + 1


def mm_pass_rows(q_codes, s_codes, matrix_padded, gap_q, gap_r, tb_is_zero, device="cuda"):
    """One-shot (CC, DD) rows through a throwaway ``DevicePair``: the test
    anchor for the windowed pass."""
    dev = DevicePair(q_codes, s_codes, matrix_padded, gap_q, gap_r, device)
    return dev.mm_pass(0, dev.m, 0, dev.n, tb_is_zero)


def sw_end_cell(q_codes, s_codes, matrix_padded, gap_q, gap_r, device="cuda"):
    """(best, end_i, end_j) 1-based inclusive, the device counterpart of
    ``hirschberg._score_end_sw`` (throwaway ``DevicePair``)."""
    dev = DevicePair(q_codes, s_codes, matrix_padded, gap_q, gap_r, device)
    return dev.sw_end(0, dev.m, 0, dev.n)
