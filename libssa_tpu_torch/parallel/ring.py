"""Device-spanning score of one pair: the subject split by columns over a mesh.

The port of ``libssa_tpu/parallel/ring.py`` on ``torch.distributed``. When
one pair outgrows a card, the subject is sharded by columns over a
``DBMesh`` (``parallel/sharded.py``) and the Gotoh boundary flows to the
right: shard d holds columns [d W, min((d + 1) W, n)), W = ceil(n / D), and
the query is cut into row blocks of ``RB`` rows. Shard d sweeps row block
rb at phase p = rb + d, a staircase of max(Rb) + D - 1 phases that every
rank derives from m, n, RB and D alone.

``Ring.run`` is that staircase, once, for a list of passes (``Pass``: query
and subject windows into the pair's code buffers, and NW's left-column
open). At phase p every tile of every pass on this process's shards of one
device goes into ONE K2 launch (``ops/ring_block_cuda.ring_block_cuda``;
K2's plain version on the CPU), since the tiles of one phase are
independent. Tiles are exact: no padding columns, the last row block is
shorter, and a shard with no columns (n <= (D - 1) W) launches nothing and
passes its left edge on unchanged.

Boundaries, built with tensor ops on the shard's device:

* shard 0's left column and row block 0's top row are the DP's own
  (``mm_level_cuda.open_edge`` for NW, zeros for SW), with no gap state
  (E = H - Q + R, F = H - Q + R, ``ops/ring_block.py``);
* a shard's bottom H/F row is its next row block's top;
* its right-edge H/E column is shard d + 1's left edge one phase later;
  the tile's corner H[i0-1][c0-1] is the last element of the left edge
  the shard took the phase before (K2's ``rightH`` has no corner; the
  reference keeps it as ``corner_state``).

Between processes the last shard of rank r sends its right edge to the
first shard of rank r + 1 once a phase (``isend``/``irecv``, so no pair
of blocking calls can deadlock); every rank makes the same exchanges the
same number of times, whatever its shards hold. Gloo carries host
tensors, NCCL the card's. Between shards of one process the edge stays a
device tensor.

``RB`` (``RB_DEFAULT`` = 2**17 rows): a K2 tile's time is about its column
count of steps plus a short fill per block of rows, nearly whatever its
row count, until its stripes fill the card: one H100 holds about 132 K2
blocks at 8 rows (1,024 rows a block) and 396 at 4 rows (512 rows a
block), 135,168-202,752 rows in flight. So a shard's phase costs about
W steps up to that height, and the staircase's (ceil(m / RB) + D - 1)
phases are fewest at the largest RB that still fits the card. The TPU
package's f32 window escape, bf16 planes, band heights, power-of-two W
and PAD columns have no counterpart here: K2 is exact in int32, and in
int64 past ``ops/longpair.score_bound``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import ring_block_cuda
from ..ops.mm_device import DevicePair
from ..ops.mm_level_cuda import open_edge

RB_DEFAULT = 1 << 17
BIG = 2**62  # above every row and column index
phases = 0  # pipeline phases run by this process; set to 0 to start a count


class Pass(NamedTuple):
    """One DP over windows of a ``Ring``'s code buffers: query rows
    [q_off, q_off + m) and subject columns [s_off, s_off + n), where offsets
    past the forward codes select the reversed ones (``DevicePair``'s
    layout), and NW's left column H[i][0] = -(tb + R i)."""

    q_off: int
    m: int
    s_off: int
    n: int
    tb: int = 0


@dataclass
class PassOut:
    """What one pass leaves on this process.

    ``rows``: each local shard's (H, F) at the window's last row; ``corner``:
    NW's H[m][n] as a (1,) tensor where this process holds the last
    non-empty shard; ``end``: SW's (3,) int64 (best, i, j), 1-based in the
    window, the lexicographic best (score desc, i asc, j asc) of this
    process's tiles, (-1, BIG, BIG) where it has none.
    """

    rows: dict = field(default_factory=dict)
    corner: torch.Tensor | None = None
    end: torch.Tensor | None = None


class _Shard:
    """One pass's state on one shard: its columns, the top boundary of its
    next row block, the left edge and corner for its next tile."""

    __slots__ = ("d", "c0", "cols", "dev", "botH", "botF", "inH", "inE", "corner")

    def __init__(self, d, c0, cols, dev):
        self.d, self.c0, self.cols, self.dev = d, c0, cols, dev
        self.botH = self.botF = self.inH = self.inE = self.corner = None


def lex_best(c: torch.Tensor) -> torch.Tensor:
    """The row of ``c`` (k, 3) = (score, i, j) with the highest score, then
    the smallest i, then the smallest j."""
    best = c[:, 0].max()
    hit = c[:, 0] == best
    i = torch.where(hit, c[:, 1], BIG).min()
    j = torch.where(hit & (c[:, 1] == i), c[:, 2], BIG).min()
    return torch.stack([best, i, j])


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order by one all_gather, on
    ``t``'s device: a gloo group gathers host tensors, an NCCL group the
    card's."""
    if group is None:
        return t[None]
    x = t if dist.get_backend(group) == dist.Backend.NCCL else t.cpu()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.stack(out).to(t.device)


def _global_rank(group, r: int) -> int:
    return r if group is dist.group.WORLD else dist.get_global_rank(group, r)


class Ring:
    """One pair on a mesh: its codes, forward and reversed, and the matrix
    on every device the mesh's local shards use (one ``DevicePair`` a
    device, uploaded once), the gap costs, ``RB`` and the DP type
    (int32 below ``score_bound``'s int32 limit, else int64)."""

    def __init__(self, q_codes, s_codes, matrix_padded, gap_q, gap_r, mesh, RB=RB_DEFAULT):
        if int(RB) < 1:
            raise ValueError(f"RB must be at least 1, got {RB}")
        self.mesh, self.RB = mesh, int(RB)
        self.Q, self.R = int(gap_q), int(gap_r)
        self.pairs: dict[torch.device, DevicePair] = {}
        for dev in mesh.local.values():
            if dev not in self.pairs:
                self.pairs[dev] = DevicePair(q_codes, s_codes, matrix_padded,
                                             self.Q, self.R, dev)
        first = next(iter(self.pairs.values()))
        self.m, self.n, self.dtype = first.m, first.n, first.dtype
        self.device = first.device
        self.shards = sorted(mesh.local)
        group = mesh.group
        rank = dist.get_rank(group) if group is not None else 0
        world = dist.get_world_size(group) if group is not None else 1
        self.prev = _global_rank(group, rank - 1) if rank > 0 else None
        self.next = _global_rank(group, rank + 1) if rank < world - 1 else None
        self.nccl = group is not None and dist.get_backend(group) == dist.Backend.NCCL

    # -- the staircase ------------------------------------------------------

    def _edge(self, st: _Shard, r0: int, rows: int, p: Pass, local: bool):
        """(leftH, leftE) of shard ``st``'s tile at query rows [r0, r0 + rows)."""
        Q, R, dt = self.Q, self.R, self.dtype
        if st.d == 0:
            i = torch.arange(r0, r0 + rows + 1, device=st.dev)
            H = (torch.zeros_like(i) if local else open_edge(p.tb, i, R)).to(dt)
            return H, H[1:] - Q + R
        H = torch.cat([st.corner, st.inH])
        st.corner = st.inH[-1:]  # the next tile's corner
        return H, st.inE

    def run(self, passes: list[Pass], local: bool) -> list[PassOut]:
        """The staircase for ``passes`` (all SW or all NW): one K2 launch a
        device a phase over every active tile of every pass. Returns one
        ``PassOut`` a pass."""
        global phases
        D, RB, Q, R, dt = self.mesh.size, self.RB, self.Q, self.R, self.dtype
        geo = []
        for p in passes:
            if p.m < 1 or p.n < 1:
                raise ValueError(f"a pass needs at least one row and one column: {p}")
            geo.append((-(-p.n // D), -(-p.m // RB)))  # W, row blocks
        n_phases = max(rb for _, rb in geo) + D - 1
        widths = [min(RB, p.m) for p in passes]  # an edge's rows at most
        outs = [PassOut() for _ in passes]
        ends = [[] for _ in passes]  # SW: each tile's (best, i, j)
        state = []
        for p, (W, _) in zip(passes, geo):
            per = {}
            for d in self.shards:
                c0 = d * W
                st = per[d] = _Shard(d, c0, max(0, min(W, p.n - c0)), self.mesh.local[d])
                j = torch.arange(c0, c0 + st.cols + 1, device=st.dev)
                top = (torch.zeros_like(j) if local else open_edge(Q - R, j, R)).to(dt)
                st.corner, st.botH = top[:1], top[1:]
                st.botF = st.botH - Q + R
            state.append(per)
        for ph in range(n_phases):
            tiles = {}  # device -> [(k, shard, rb, job, leftH, leftE)]
            forward = []  # (k, shard, rb, rightH, rightE) of the empty shards
            for k, (p, (W, Rb)) in enumerate(zip(passes, geo)):
                for d, st in state[k].items():
                    rb = ph - d
                    if not 0 <= rb < Rb:
                        continue
                    r0 = rb * RB
                    rows = min(RB, p.m - r0)
                    if st.cols == 0:  # no columns: the left edge goes on as it came
                        forward.append((k, st, rb, st.inH, st.inE))
                        continue
                    leftH, leftE = self._edge(st, r0, rows, p, local)
                    job = [p.q_off + r0, rows, p.s_off + st.c0, st.cols]
                    tiles.setdefault(st.dev, []).append((k, st, rb, job, leftH, leftE))
            done = list(forward)
            for dev, ts in tiles.items():
                pair = self.pairs[dev]
                jobs = np.array([t[3] for t in ts], np.int64)
                out = ring_block_cuda.ring_block_cuda(
                    pair.q, pair.s, jobs, pair.matrix, Q, R, local,
                    torch.cat([t[4] for t in ts]), torch.cat([t[5] for t in ts]),
                    torch.cat([t[1].botH for t in ts]), torch.cat([t[1].botF for t in ts]),
                    codes_checked=True)
                rows, cols = jobs[:, 1].tolist(), jobs[:, 3].tolist()
                parts = [out.rightH.split(rows), out.rightE.split(rows),
                         out.botH.split(cols), out.botF.split(cols)]
                if local:
                    parts += [out.rowmax.split(rows), out.rowarg.split(rows)]
                for t, (k, st, rb, job, _, _) in enumerate(ts):
                    st.botH, st.botF = parts[2][t], parts[3][t]
                    last = rb == geo[k][1] - 1
                    if last:
                        outs[k].rows[st.d] = (st.botH, st.botF)
                        if not local and st.c0 + st.cols == passes[k].n:
                            outs[k].corner = parts[0][t][-1:]
                    if local:
                        rowmax, n_rows = parts[4][t], job[1]
                        best = rowmax.max()
                        idx = torch.where(rowmax == best, torch.arange(
                            n_rows, device=dev), n_rows).min().view(1)
                        j = parts[5][t].index_select(0, idx).long()
                        ends[k].append(torch.cat([
                            best.long().view(1), idx + rb * RB + 1, j + st.c0 + 1]).to(self.device))
                    done.append((k, st, rb, parts[0][t], parts[1][t]))
            phases += 1
            if ph == n_phases - 1:
                break
            send = None
            for k, st, rb, rH, rE in done:
                right = state[k].get(st.d + 1)
                if right is not None:
                    right.inH, right.inE = rH.to(right.dev), rE.to(right.dev)
                elif st.d == self.shards[-1] and self.next is not None:
                    if send is None:
                        send = torch.zeros(2 * sum(widths), dtype=dt, device=self.device)
                    o = 2 * sum(widths[:k])
                    send[o:o + len(rH)] = rH.to(self.device)
                    send[o + widths[k]:o + widths[k] + len(rE)] = rE.to(self.device)
            self._exchange(send, ph, passes, geo, state, widths)
        if local:
            for out, tiles in zip(outs, ends):
                out.end = (lex_best(torch.stack(tiles)) if tiles else
                           torch.tensor([-1, BIG, BIG], device=self.device))
        return outs

    def _exchange(self, send, ph, passes, geo, state, widths):
        """Phase ``ph``'s edge between ranks: this rank's last shard's right
        edge to the next rank's first shard, the previous rank's into this
        rank's first; every rank but the last sends and every rank but the
        first receives, at every phase but the last."""
        if self.prev is None and self.next is None:
            return
        size, dt = 2 * sum(widths), self.dtype
        where = self.device if self.nccl else torch.device("cpu")
        works, recv = [], None
        if self.next is not None:
            if send is None:
                send = torch.zeros(size, dtype=dt, device=self.device)
            send = send.to(where)  # held until the wait below
            works.append(dist.isend(send, self.next, group=self.mesh.group))
        if self.prev is not None:
            recv = torch.empty(size, dtype=dt, device=where)
            works.append(dist.irecv(recv, self.prev, group=self.mesh.group))
        for w in works:
            w.wait()
        if recv is None:
            return
        first = self.shards[0]
        for k, (p, (_, Rb)) in enumerate(zip(passes, geo)):
            rb = ph + 1 - first
            if not 0 <= rb < Rb:
                continue
            st = state[k][first]
            rows = min(self.RB, p.m - rb * self.RB)
            o = 2 * sum(widths[:k])
            st.inH = recv[o:o + rows].to(st.dev)
            st.inE = recv[o + widths[k]:o + widths[k] + rows].to(st.dev)

    # -- the results ----------------------------------------------------------

    def end(self, out: PassOut) -> tuple[int, int, int]:
        """SW's (best, i, j) over every rank's tiles, by one all_gather."""
        best, i, j = lex_best(all_gather(out.end, self.mesh.group)).tolist()
        return best, i, j

    def corner(self, out: PassOut) -> int:
        """NW's H[m][n], from the rank that holds it, by one all_gather."""
        held = out.corner is not None
        row = torch.cat([torch.tensor([int(held)], device=self.device),
                         out.corner.long().to(self.device) if held else
                         torch.zeros(1, dtype=torch.int64, device=self.device)])
        got = all_gather(row, self.mesh.group)
        return int(got[got[:, 0] == 1][0, 1])

    def score(self, local: bool) -> int:
        """The pair's SW or NW score over the mesh."""
        (out,) = self.run([Pass(0, self.m, 0, self.n, self.Q - self.R)], local)
        return self.end(out)[0] if local else self.corner(out)


def ring_score(
    q_codes: np.ndarray,
    s_codes: np.ndarray,
    matrix_padded: np.ndarray,
    gap_open: int,
    gap_extend: int,
    local: bool = True,
    mesh=None,
    RB: int = RB_DEFAULT,
    first_residue_opens: bool = True,
) -> int:
    """Exact SW/NW score of one pair with its subject sharded over ``mesh``
    (default ``make_db_mesh()``: every card, raising without CUDA).

    ``first_residue_opens``: the Gotoh gap convention, as in
    ``init_gap_penalties``. Every rank of the mesh's group calls this with
    the same arguments and returns the same score.
    """
    from ..oracle import gap_qr
    from .sharded import make_db_mesh

    mesh = mesh if mesh is not None else make_db_mesh()
    Q, R = gap_qr(gap_open, gap_extend, first_residue_opens)
    m, n = len(q_codes), len(s_codes)
    if m == 0 or n == 0:
        if local:
            return 0
        lm = max(m, n)
        return 0 if lm == 0 else -(Q + (lm - 1) * R)
    return Ring(q_codes, s_codes, matrix_padded, Q, R, mesh, RB).score(local)
