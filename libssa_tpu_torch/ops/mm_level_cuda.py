"""A Myers-Miller divide level's staging around K2: one upload, two kernels.

``ops/mm_device.DevicePair`` runs each K2 launch of a pair's traceback
through this module. ``stage`` lays out the launch's tiles in one table of
``JOB_WORDS`` int64 a tile (``level_table``: offsets into the flat boundary
and output arrays, rows, cols, the left column's open) and copies it to the
device once, from pinned host memory, without waiting for the device.
``prologue`` writes K2's boundaries (``leftH``, ``leftE``, ``topH``,
``topF``) of every tile from it; ``split`` reads the bottom rows K2 wrote
for each node's forward and reverse tile (tiles 2k and 2k + 1) and gives
the node's t1/t2 first minima and values, ``(j1, j2, v1, v2)`` as int64,
the numbers ``hirschberg._nw_ops`` splits on; ``fetch`` brings them to the
host in one copy.

On CPU tensors ``prologue`` and ``split`` run the plain versions
(``prologue_plain``, ``split_plain``: PyTorch ops over the same table); on
CUDA tensors they launch ``csrc/mmlevel.cu``'s kernels or raise. Nothing
falls back.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import ring_block
from .ring_block_cuda import to_device

SOURCE = "mmlevel.cu"
JOB_WORDS = 6  # left_off, rows_off, cols_off, rows, cols, tb
BLOCK = 256  # threads a prologue block
SPLIT_BLOCK = 1024  # threads a split block (one block a node)
MAX_SPREAD = 64  # prologue blocks a tile at most
INF64 = 2**62

launches = 0  # kernel launches made by this process; set to 0 to start a count


@functools.cache
def _lib() -> ctypes.CDLL:
    from ..util import cudabuild

    lib = cudabuild.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mml_prologue.argtypes = [p, ll, i, i, ll, ll, i, p, p, p, p, p]
    lib.mml_prologue.restype = i
    lib.mml_split.argtypes = [p, ll, ll, ll, i, p, p, p, p]
    lib.mml_split.restype = i
    bind_layout(lib)
    return lib


def bind_layout(lib: ctypes.CDLL) -> None:
    """Type the layout queries of ``lib`` (the card's build or the host
    build) and raise if its table or block sizes differ from the wrapper's."""
    for name in ("mml_job_words", "mml_block", "mml_split_block"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    if (lib.mml_job_words(), lib.mml_block(), lib.mml_split_block()) != \
            (JOB_WORDS, BLOCK, SPLIT_BLOCK):
        raise RuntimeError("the level kernels' table or blocks differ from the wrapper's")


def open_edge(opens, k: torch.Tensor, R: int) -> torch.Tensor:
    """H along an NW DP's first column or first row, at index ``k``: 0 at
    k = 0, else -(opens + R k). The left column H[i][0] opens at ``tb``
    (k = i), the top row H[0][j] at Q - R (k = j)."""
    return torch.where(k == 0, 0, -(opens + R * k))


class Level(NamedTuple):
    """One K2 launch's tiles: the table on the host and on the device."""

    table: np.ndarray  # (J, JOB_WORDS) int64
    table_d: torch.Tensor  # the same, on the launch's device


def level_table(jobs: np.ndarray, tbs: np.ndarray | None) -> np.ndarray:
    """The (J, ``JOB_WORDS``) table of K2's ``jobs`` ([q_off, rows, s_off,
    cols] rows) whose left columns open at ``tbs`` (None: SW, 0)."""
    off = ring_block.offsets(jobs)
    table = np.empty((len(jobs), JOB_WORDS), np.int64)
    table[:, 0], table[:, 1], table[:, 2] = off["left"], off["rows"], off["cols"]
    table[:, 3], table[:, 4] = jobs[:, 1], jobs[:, 3]
    table[:, 5] = 0 if tbs is None else tbs
    return table


def stage(jobs: np.ndarray, tbs: np.ndarray | None, device) -> Level:
    """``level_table`` of a launch, copied to ``device`` once."""
    table = level_table(np.asarray(jobs, np.int64).reshape(-1, 4), tbs)
    return Level(table, to_device(table, torch.device(device)))


def _segments(lengths: np.ndarray, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """(segment id, index within the segment) of every element of a flat
    array of segments with ``lengths``, built on ``dev``."""
    counts = torch.as_tensor(lengths, dtype=torch.int64).to(dev)
    total = int(lengths.sum())
    seg = torch.repeat_interleave(
        torch.arange(len(lengths), device=dev), counts, output_size=total
    )
    starts = torch.cumsum(counts, 0) - counts
    return seg, torch.arange(total, device=dev) - starts[seg]


def _seg_argmin(t: torch.Tensor, seg: torch.Tensor, j: torch.Tensor, k: int):
    """(first index, minimum) of each of ``k`` segments of ``t``."""
    dev = t.device
    v = torch.full((k,), INF64, dtype=torch.int64, device=dev).scatter_reduce(
        0, seg, t, "amin")
    at = torch.where(t == v[seg], j, INF64)
    first = torch.full((k,), INF64, dtype=torch.int64, device=dev).scatter_reduce(
        0, seg, at, "amin")
    return first, v


def prologue_plain(table: np.ndarray, dtype, Q: int, R: int, local: bool, dev="cpu"):
    """K2's flat (leftH, leftE, topH, topF) of ``table``'s tiles with
    PyTorch ops on ``dev``: NW tiles whose left column opens a vertical gap
    at their tb and top row at Q - R, or SW tiles with zero boundaries; no
    gap state on either boundary."""
    rows, cols = table[:, 3], table[:, 4]
    seg, i = _segments(rows + 1, dev)  # leftH: rows 0 .. rows
    eseg, ie = _segments(rows, dev)  # leftE: rows 1 .. rows
    _, j = _segments(cols, dev)
    if local:
        leftH = torch.zeros(len(i), dtype=dtype, device=dev)
        leftE = torch.zeros(len(ie), dtype=dtype, device=dev)
        topH = torch.zeros(len(j), dtype=dtype, device=dev)
    else:
        tb = torch.as_tensor(table[:, 5]).to(dev)
        leftH = open_edge(tb[seg], i, R).to(dtype)  # H[i][0]
        leftE = open_edge(tb[eseg], ie + 1, R).to(dtype)
        topH = open_edge(Q - R, j + 1, R).to(dtype)  # H[0][j+1]
    leftE = leftE - Q + R  # no gap state on either boundary
    return leftH, leftE, topH, topH - Q + R


def split_plain(table: np.ndarray, botH: torch.Tensor, botF: torch.Tensor, g: int,
                R: int) -> torch.Tensor:
    """(nodes, 4) int64 ``(j1, j2, v1, v2)`` with PyTorch ops: for node k
    (forward tile 2k, reverse tile 2k + 1, nn columns each) the first
    minima of t1[j] = CCf[j] + CCr[nn - j] and t2[j] = DDf[j] + DDr[nn - j]
    - g, j = 0 .. nn, with CC = -botH and DD = -botF and column 0 of each
    pass at tb + R * rows."""
    dev = botH.device
    botH, botF = botH.long(), botF.long()
    fwd, rev = table[0::2], table[1::2]
    nn = fwd[:, 4]
    seg, j = _segments(nn + 1, dev)
    nn_d = torch.as_tensor(nn).to(dev)[seg]
    c0f = torch.as_tensor(fwd[:, 5] + R * fwd[:, 3]).to(dev)[seg]
    c0r = torch.as_tensor(rev[:, 5] + R * rev[:, 3]).to(dev)[seg]
    fi = (torch.as_tensor(fwd[:, 2]).to(dev)[seg] + j - 1).clamp(min=0)
    ri = (torch.as_tensor(rev[:, 2]).to(dev)[seg] + nn_d - j - 1).clamp(min=0)
    at0, atn = j == 0, j == nn_d
    t1 = torch.where(at0, c0f, -botH[fi]) + torch.where(atn, c0r, -botH[ri])
    t2 = torch.where(at0, c0f, -botF[fi]) + torch.where(atn, c0r, -botF[ri]) - g
    j1, v1 = _seg_argmin(t1, seg, j, len(fwd))
    j2, v2 = _seg_argmin(t2, seg, j, len(fwd))
    return torch.stack([j1, j2, v1, v2], 1)


def spread(table: np.ndarray) -> int:
    """Prologue blocks a tile: enough that the largest tile's boundary
    elements come to about 16 a thread, at most ``MAX_SPREAD``."""
    most = int((2 * table[:, 3] + 1 + table[:, 4]).max())
    return max(1, min(MAX_SPREAD, -(-most // (16 * BLOCK))))


def _launched(rc: int, what: str) -> None:
    global launches
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
    launches += 1


def prologue(level: Level, dtype, Q: int, R: int, local: bool):
    """K2's (leftH, leftE, topH, topF) for ``level``'s tiles in ``dtype``
    (int32 or int64), on the table's device: one launch on CUDA, the plain
    version on the CPU."""
    dev = level.table_d.device
    if dev.type == "cpu":
        return prologue_plain(level.table, dtype, Q, R, local)
    if dtype not in (torch.int32, torch.int64):
        raise ValueError(f"unsupported DP dtype {dtype!r}")
    table = level.table
    n_rows, n_cols = int(table[:, 3].sum()), int(table[:, 4].sum())
    out = (torch.empty(n_rows + len(table), dtype=dtype, device=dev),
           torch.empty(n_rows, dtype=dtype, device=dev),
           torch.empty(n_cols, dtype=dtype, device=dev),
           torch.empty(n_cols, dtype=dtype, device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().mml_prologue(level.table_d.data_ptr(), len(table), spread(table),
                                 int(local), int(Q), int(R), int(dtype == torch.int64),
                                 *(t.data_ptr() for t in out), stream)
    _launched(rc, "level prologue")
    return out


def split(level: Level, botH: torch.Tensor, botF: torch.Tensor, g: int, R: int) -> torch.Tensor:
    """(nodes, 4) int64 ``(j1, j2, v1, v2)`` of ``level``'s nodes from K2's
    bottom rows, on their device: one launch on CUDA, the plain version on
    the CPU."""
    table = level.table
    if len(table) % 2 or (table[0::2, 4] != table[1::2, 4]).any():
        raise ValueError("a node is a forward and a reverse tile of equal columns")
    dev = botH.device
    if dev.type == "cpu":
        return split_plain(table, botH, botF, g, R)
    n_cols = int(table[:, 4].sum())
    for t in (botH, botF):
        if t.dtype not in (torch.int32, torch.int64) or t.dtype != botH.dtype or \
                tuple(t.shape) != (n_cols,) or t.device != dev or not t.is_contiguous():
            raise ValueError("botH and botF: K2's contiguous bottom rows of the level")
    out = torch.empty((len(table) // 2, 4), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().mml_split(level.table_d.data_ptr(), len(table) // 2, int(g), int(R),
                              int(botH.dtype == torch.int64), botH.data_ptr(),
                              botF.data_ptr(), out.data_ptr(), stream)
    _launched(rc, "level split")
    return out


def fetch(t: torch.Tensor) -> list:
    """``t`` as nested lists on the host: from a card, one copy into pinned
    memory and one wait for the stream."""
    if t.device.type == "cpu":
        return t.tolist()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.tolist()
