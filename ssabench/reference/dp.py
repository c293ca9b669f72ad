"""Plain Gotoh dynamic programming in PyTorch, one query row at a time.

Each row of the query is a few whole-tensor operations over every subject
column at once. The vertical gap (E) is elementwise from the row above; the
horizontal gap (F) is a prefix maximum along the row:
``F[j] = max_{k<j} (H[k] - Q - R (j-1-k))``. H without F is exact for every
cell whose best path does not end in a horizontal gap, and a gap opened from
a cell whose own value came from a horizontal gap never beats extending that
gap (Q >= R), so the prefix maximum over the F-free values gives F exactly.

Subjects lie in buckets of equal padded width. A pad column scores
``PAD_SCORE`` against everything: it cannot raise a cell at or left of a
subject's end, and no pad cell exceeds the largest real cell of the rows
above and beside it, so the row maximum over the whole bucket is the local
score, and the global score is read at each subject's own end column.

``saturate`` gives the control: the same sweep with H and E clamped to a
narrow signed or unsigned window each row, as a saturating 8- or 16-bit
kernel without an exact rescore would compute them.
"""
from __future__ import annotations

import numpy as np
import torch

PAD_SCORE = -64
WINDOWS = {None: None, "sat8": (0, 255), "sat16": (-32768, 32767)}


def _profile_table(sub: np.ndarray, codes: torch.Tensor) -> torch.Tensor:
    """(A + 1, *codes.shape) int8: row a is the score of residue a against
    every subject column; ``codes`` holds A for pad columns."""
    a = sub.shape[0]
    table = np.full((a + 1, a + 1), PAD_SCORE, dtype=np.int8)
    table[:a, :a] = sub
    t = torch.as_tensor(table, device=codes.device)
    return t[:, codes.long()]


def _cummax(w: torch.Tensor, blocks: int) -> torch.Tensor:
    """Prefix maximum along each row; a long row as ``blocks`` pieces, each
    scanned on its own, then each piece raised to the maximum before it."""
    if blocks <= 1:
        return torch.cummax(w, dim=1).values
    nb, L = w.shape
    c = torch.cummax(w.view(nb, blocks, L // blocks), dim=2).values
    carry = torch.cummax(c[:, :, -1], dim=1).values
    torch.maximum(c[:, 1:], carry[:, :-1, None], out=c[:, 1:])
    return c.view(nb, L)


def sweep(
    qs: list,
    codes: torch.Tensor,
    lengths: torch.Tensor,
    sub: np.ndarray,
    Q: int,
    R: int,
    local: bool,
    saturate: str | None = None,
    blocks: int = 1,
    graph_rows: int = 0,
) -> torch.Tensor:
    """Scores of each query of ``qs`` (codes) against each row of ``codes``
    ``(nb, L)`` (pad code ``sub.shape[0]`` past each of ``lengths``):
    ``(len(qs), nb)`` int64, SW's best cell or NW's end cell.

    The queries run side by side, longest first: row ``i`` updates the
    queries longer than ``i`` as one block of every tensor, so the
    operations a row launches serve them all. ``blocks`` splits each row's
    prefix maximum (``L`` a multiple of it); ``graph_rows`` > 0 replays
    that many query rows at a time as one CUDA graph of the same operations
    (one query only; an even count; the first block and the last rows run
    as they are)."""
    dev = codes.device
    nb, L = codes.shape
    window = WINDOWS[saturate]
    i32 = torch.int32
    order = sorted(range(len(qs)), key=lambda b: -len(qs[b]))
    q_lens = [len(qs[b]) for b in order]
    nq, m = len(qs), (q_lens[0] if qs else 0)
    active = np.searchsorted(-np.asarray(q_lens), -np.arange(m), side="left")  # len > i
    q_rows = np.full((max(m, 1), nq), sub.shape[0], dtype=np.int64)  # row i: each query's residue
    for c, b in enumerate(order):
        q_rows[: len(qs[b]), c] = qs[b]
    table = _profile_table(sub, codes)  # (A + 1, nb, L)
    graphed = graph_rows and dev.type == "cuda" and nq == 1
    G = graph_rows if graphed else 4
    rows = torch.empty((G, nq, nb, L), dtype=torch.int8, device=dev)
    bnd = torch.zeros((G, 2), dtype=i32, device=dev)  # H[i][0], H[i][0] - Q
    h_prev = torch.zeros((nq, nb, L + 1), dtype=i32, device=dev)
    h_new = torch.empty_like(h_prev)
    if not local:
        h_prev[..., 1:] = -(Q + R * torch.arange(L, dtype=i32, device=dev))
    e = torch.full((nq, nb, L), -(2**30), dtype=i32, device=dev)
    tmp = torch.empty((nq, nb, L), dtype=i32, device=dev)
    hp = torch.empty((nq, nb, L), dtype=i32, device=dev)
    ramp = R * torch.arange(1, L + 1, dtype=i32, device=dev)  # R k, k = 1..L
    off = Q + R * torch.arange(1, L, dtype=i32, device=dev)  # Q + R (j - 1), j = 2..L
    best = torch.zeros((nq, nb), dtype=i32, device=dev)
    out = torch.zeros((nq, nb), dtype=torch.int64, device=dev)
    state = [h_prev, h_new]
    ends: dict[int, list[int]] = {}  # rows done -> the queries that end there
    for c, n in enumerate(q_lens):
        ends.setdefault(n, []).append(c)
    end_idx = lengths.long()[:, None]

    def record(done: int) -> None:
        """NW: the end cells of the queries with ``done`` rows."""
        if not local:
            for c in ends.get(done, []):
                out[c] = state[0][c].gather(1, end_idx)[:, 0]

    def row(r: int, a: int) -> None:
        h_prev, h_new = state[0][:a], state[1][:a]
        ea, ta, ha = e[:a], tmp[:a], hp[:a]
        h0, h0q = bnd[r, 0:1], bnd[r, 1:2]
        torch.sub(ea, R, out=ea)
        torch.sub(h_prev[..., 1:], Q, out=ta)
        torch.maximum(ea, ta, out=ea)
        torch.add(h_prev[..., :-1], rows[r, :a], out=ha)  # diagonal
        torch.maximum(ha, ea, out=ha)
        if local:
            ha.clamp_(min=0)
        c = _cummax((ha + ramp).view(a * nb, L), blocks).view(a, nb, L)  # H[k] + R k, k = 1..L
        if not local:
            torch.maximum(c, h0, out=c)  # the row's boundary cell, k = 0
        h_new[..., 0:1].copy_(h0.expand(a, nb, 1))
        torch.maximum(ha[..., :1], h0q, out=h_new[..., 1:2])
        torch.sub(c[..., :-1], off, out=ta[..., 1:])
        torch.maximum(ha[..., 1:], ta[..., 1:], out=h_new[..., 2:])
        if window is not None:
            h_new.clamp_(*window)
            ea.clamp_(*window)
        if local:
            torch.maximum(best[:a], h_new.amax(dim=2), out=best[:a])
        state.reverse()

    record(0)
    q_dev = torch.as_tensor(q_rows, device=dev)
    graph = None
    for i0 in range(0, m, G):
        n = min(G, m - i0)
        torch.index_select(table, 0, q_dev[i0 : i0 + n].reshape(-1),
                           out=rows[:n].view(n * nq, nb, L))
        if not local:
            b = -(Q + R * torch.arange(i0, i0 + n, dtype=i32, device=dev))
            bnd[:n, 0], bnd[:n, 1] = b, b - Q
        if graph is not None and n == G:
            graph.replay()
            continue
        for r in range(n):
            row(r, int(active[i0 + r]))
            if i0 + r + 1 < m:
                record(i0 + r + 1)
        if graphed and n == G and G % 2 == 0:
            graph = torch.cuda.CUDAGraph()  # captured, not run, after a first eager block
            with torch.cuda.graph(graph):
                for r in range(G):
                    row(r, 1)
    if m:
        record(m)
    result = best.long() if local else out
    back = torch.empty_like(result)
    back[torch.as_tensor(order, device=dev)] = result
    return back


def pair_score(q, s, sub, Q, R, local, device, saturate=None, blocks: int = 256,
               graph_rows: int = 128) -> int:
    """One pair's score: the sweep with one subject, padded to a multiple of
    ``blocks`` columns, ``graph_rows`` rows a CUDA graph on a card."""
    s = np.asarray(s, dtype=np.uint8)
    blocks = blocks if len(s) >= 64 * blocks else 1
    width = -(-len(s) // blocks) * blocks
    padded = np.full(width, sub.shape[0], dtype=np.uint8)
    padded[: len(s)] = s
    codes = torch.as_tensor(padded, device=device)[None, :]
    lengths = torch.tensor([len(s)], device=device)
    return int(sweep([q], codes, lengths, sub, Q, R, local, saturate, blocks, graph_rows)[0, 0])


def buckets(lengths: np.ndarray, widen: float = 1.05, max_cells: int = 1 << 27):
    """Subject ids grouped by length: each group's longest is at most
    ``widen`` times its shortest, and a group holds at most ``max_cells``
    padded cells."""
    order = np.argsort(lengths, kind="stable")
    out, start = [], 0
    while start < len(order):
        lo = max(int(lengths[order[start]]), 1)
        end = start + 1
        while (end < len(order) and lengths[order[end]] <= widen * lo
               and (end - start + 1) * int(lengths[order[end]]) <= max_cells):
            end += 1
        out.append(order[start:end])
        start = end
    return out


class Database:
    """A database laid out for the sweep: codes, padded, in length buckets
    on ``device``."""

    def __init__(self, codes: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
                 alphabet: int, device):
        self.n = len(lengths)
        self.groups = []
        flat = torch.as_tensor(np.append(codes, np.uint8(alphabet)), device=device)
        pad = len(codes)  # the index of the pad code appended above
        for ids in buckets(lengths):
            lens = torch.as_tensor(lengths[ids], device=device).long()
            cols = torch.arange(int(lens.max()), device=device)
            idx = torch.as_tensor(offsets[ids], device=device)[:, None] + cols
            idx = torch.where(cols < lens[:, None], idx, pad)
            self.groups.append((ids, flat[idx], lens))

    def scores(self, qs: list, sub, Q, R, local, saturate=None,
               max_cells: int = 1 << 28) -> np.ndarray:
        """(len(qs), n) int64 scores of each query of ``qs`` against every
        subject: the queries of a bucket side by side, as many as keep
        queries x padded cells under ``max_cells``."""
        out = np.zeros((len(qs), self.n), dtype=np.int64)
        order = sorted(range(len(qs)), key=lambda b: -len(qs[b]))
        for ids, block, lens in self.groups:
            step = max(1, max_cells // block.numel())
            for k in range(0, len(order), step):
                part = order[k : k + step]
                got = sweep([qs[b] for b in part], block, lens, sub, Q, R, local, saturate)
                out[np.ix_(part, ids)] = got.cpu().numpy()
        return out


def top_hits(scores: np.ndarray, k: int) -> list[tuple[int, int]]:
    """The k best (id, score): score descending, then id ascending."""
    order = np.lexsort((np.arange(len(scores)), -scores))[:k]
    return [(int(i), int(scores[i])) for i in order]
