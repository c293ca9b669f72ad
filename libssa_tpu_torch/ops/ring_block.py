"""One tile of a larger SW/NW DP with boundary input and output: K2's contract.

The port of the tile sweep of ``libssa_tpu/ops/ring_block_pallas.py``
(``banded_tile``). A tile has its top-left cell at (r0, c0) of a larger
DP, RB query rows and W subject columns. Given

* the query codes of its rows (RB,) and the subject codes of its columns
  (W,), a 32 x 32 substitution matrix and the gap costs Q (open, the first
  gap residue included) and R (extend);
* ``leftH`` (RB + 1,) = H[r0-1 .. r0+RB-1][c0-1]: element 0 is the corner;
* ``leftE`` (RB,) = E[r0 .. r0+RB-1][c0-1];
* ``topH`` and ``topF`` (W,) = H and F of row r0-1 at columns c0 .. c0+W-1;

it returns (``Tiles``):

* ``rightH`` and ``rightE`` (RB,): H and E of the tile's rows at its last
  column c0+W-1;
* ``botH`` and ``botF`` (W,): H and F of its last row;
* SW only: ``rowmax`` (RB,), each row's maximum H over the tile's columns,
  and ``rowarg`` (RB,) int32, the earliest tile column (0-based) at which
  the row reaches it. These are the TPU kernel's ``acc`` and ``track_pos``
  outputs, re-based from skewed steps to columns.

Gotoh's recurrence with E along a row, F down a column:
E[i][j] = max(E[i][j-1] - R, H[i][j-1] - Q),
F[i][j] = max(F[i-1][j] - R, H[i-1][j] - Q),
H[i][j] = max(H[i-1][j-1] + sub, E[i][j], F[i][j]) (and 0 for SW).

There is no -inf in the contract: a boundary with no gap state passes
E = H - Q + R (or F = H - Q + R), whose first update gives H - Q exactly as
-inf would, so int32 never wraps below its floor.

What the TPU kernel has and this contract drops, and why:

* the mid-cell latch (``cap_row``/``cap_col``) and the selectable bottom
  row (``bot_band``/``bot_row``). They exist because TPU tiles are padded
  to fixed RB x WC blocks, so the wanted row or cell can fall inside a
  block (``mm_device.py:201-203``). The port's tiles are exact, so the
  answer is always the last row or the bottom-right cell;
* the bf16 select tree over K symbol planes, the f32 window, the rotating
  bottom accumulator, window-aligned steps, the power-of-two grid rounding
  and the slack in the plane capacities (``mm_device.py:484-485``): all
  layouts and limits of the TPU, none of the function.

``ring_block_plain`` is the plain PyTorch version of one tile, a row sweep
like ``longpair.longpair_score_plain``; ``ring_block_batch_plain`` runs a
batch of tiles with it. A batch is flat: ``jobs`` rows are
[q_off, rows, s_off, cols], the tiles' codes are windows into two code
buffers, and their boundaries and outputs are concatenated in job order,
each tile's rows + 1 (``leftH``), rows (``leftE`` and the row outputs) or
cols (``topH``, ``topF``, ``botH``, ``botF``) long (``offsets``). The
wrapper that launches K2 (``csrc/ring_block.cu``) on such a batch of CUDA
tensors is ``ring_block_cuda.ring_block_cuda``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Tiles(NamedTuple):
    """K2's outputs, one tile's or a batch's concatenated in job order."""

    rightH: torch.Tensor  # (rows,)
    rightE: torch.Tensor  # (rows,)
    botH: torch.Tensor  # (cols,)
    botF: torch.Tensor  # (cols,)
    rowmax: torch.Tensor | None  # (rows,), SW only
    rowarg: torch.Tensor | None  # (rows,) int32, SW only


def ring_block_plain(
    q: torch.Tensor,  # (RB,) integer codes, RB >= 1
    s: torch.Tensor,  # (W,) integer codes, W >= 1
    matrix_padded: torch.Tensor,  # (32, 32) integer substitution scores
    Q: int,
    R: int,
    local: bool,
    leftH: torch.Tensor,  # (RB + 1,) corner first
    leftE: torch.Tensor,  # (RB,)
    topH: torch.Tensor,  # (W,)
    topF: torch.Tensor,  # (W,)
) -> Tiles:
    """One tile, exactly, in the boundaries' dtype (int32 or int64).

    One query row per step: F elementwise against the row above, the
    diagonal as one shift, and E by the lazy prefix identity
    E[j] = max(leftE - (j+1) R, max_{k<=j}(Hnof[k] + k R) - Q - j R)
    (columns 0-based, ``Hnof[-1]`` the left boundary), with ``torch.cummax``
    over H before E; exact since Q >= R.
    """
    dt = leftH.dtype
    if dt not in (torch.int32, torch.int64):
        raise ValueError(f"unsupported DP dtype {dt!r}")
    dev = s.device
    RB, W = q.shape[0], s.shape[0]
    if RB == 0 or W == 0:
        raise ValueError("a tile needs at least one row and one column")
    for name, t, n in (("leftH", leftH, RB + 1), ("leftE", leftE, RB),
                       ("topH", topH, W), ("topF", topF, W)):
        if t.shape != (n,) or t.dtype != dt:
            raise ValueError(f"{name}: expected ({n},) {dt}, got {tuple(t.shape)} {t.dtype}")
    prof = matrix_padded.to(device=dev, dtype=dt)[:, s.long()]  # (32, W)
    kR = torch.arange(W + 1, device=dev, dtype=dt) * R  # k R, k = 0 .. W
    H = torch.cat([leftH[:1], topH])  # row r0-1, corner first
    F = topF
    rightH = torch.empty(RB, device=dev, dtype=dt)
    rightE = torch.empty(RB, device=dev, dtype=dt)
    rowmax = torch.empty(RB, device=dev, dtype=dt) if local else None
    rowarg = torch.empty(RB, device=dev, dtype=torch.int32) if local else None
    Wv = torch.empty(W + 1, device=dev, dtype=dt)
    cols = torch.arange(W, device=dev, dtype=torch.int32)
    for i, qi in enumerate(q.tolist()):
        F = torch.maximum(F - R, H[1:] - Q)
        Hnof = torch.maximum(H[:-1] + prof[qi], F)
        if local:
            Hnof.clamp_(min=0)
        Wv[0] = leftH[i + 1]  # H[i][c0-1]
        torch.add(Hnof, kR[1:], out=Wv[1:])
        E = torch.cummax(Wv, dim=0).values[:-1] - Q - kR[:-1]
        E = torch.maximum(E, leftE[i] - kR[1:])
        H = Wv.clone()
        torch.maximum(Hnof, E, out=H[1:])
        rightH[i] = H[W]
        rightE[i] = E[W - 1]
        if local:
            best = H[1:].max()
            rowmax[i] = best
            rowarg[i] = torch.where(H[1:] == best, cols, W).min()  # earliest
    return Tiles(rightH, rightE, H[1:].clone(), F.clone(), rowmax, rowarg)


def offsets(jobs: np.ndarray) -> dict:
    """Start of each job's segment in every flat array, in elements."""
    rows, cols = jobs[:, 1], jobs[:, 3]
    starts = lambda n: np.concatenate([[0], np.cumsum(n)[:-1]]).astype(np.int64)
    return {"rows": starts(rows), "left": starts(rows + 1), "cols": starts(cols)}


def ring_block_batch_plain(q_codes, s_codes, jobs, matrix_padded, Q, R, local,
                           leftH, leftE, topH, topF) -> Tiles:
    """A flat batch of tiles, tile by tile on ``ring_block_plain``, with the
    outputs concatenated in job order."""
    off = offsets(jobs)
    out = []
    for k, (q0, rows, s0, cols) in enumerate(np.asarray(jobs).tolist()):
        lr, ll, lc = off["rows"][k], off["left"][k], off["cols"][k]
        out.append(ring_block_plain(
            q_codes[q0:q0 + rows], s_codes[s0:s0 + cols], matrix_padded, Q, R, local,
            leftH[ll:ll + rows + 1], leftE[lr:lr + rows], topH[lc:lc + cols],
            topF[lc:lc + cols],
        ))
    return Tiles(*(torch.cat(parts) if parts[0] is not None else None for parts in zip(*out)))
