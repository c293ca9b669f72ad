"""The tracebacks of a batch of hits in one launch.

``hit_batch`` aligns a batch of hits (windows into one code buffer: a
query and a subject each, at most ``aligner.MATRIX_CELL_LIMIT`` cells, both
non-empty) with one launch of ``csrc/hitbatch.cu``: each hit's full Gotoh
fill, its end cell and its walk back, with the semantics of
``aligner.align_pair``. It launches on a CUDA device or raises; the plain
version, ``aligner.align_pair`` hit by hit, is what ``aligner.align_batch``
runs on the CPU. Nothing falls back.

A launch reads one upload (the padded substitution scores, the hit table
and the codes, in one buffer) and writes one uint8 tensor: six int64 words a
hit (score, q_begin, q_end, s_begin, s_end, op count), then each hit's slot of
m + n bytes (``layout``), whose last ``count`` bytes are its ops ('M', 'D',
'I') in order; ``unpack`` reads it on the host. ``groups`` cuts a batch into
launches of at most ``DIR_BYTES_CAP`` direction bytes.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..oracle import Traceback
from .interseq_cuda import check_gaps

SOURCE = "hitbatch.cu"
HIT_WORDS = 7  # 64-bit words a hit in the kernel's table
HEADER_WORDS = 6  # int64 words a hit's result: score, q_begin, q_end, s_begin, s_end, ops
ALPHA = 32  # the kernel's padded alphabet
INT32_BOUND = 1 << 27  # int32 below it: the kernel's unopened E and F are -2**28
INT64_BOUND = 1 << 58  # the int64 kernel's are -2**60
# The direction bytes one launch may write (a byte a cell, each row padded to
# 8). One hit of at most aligner.MATRIX_CELL_LIMIT = 16M cells needs at most
# 128 MB (n = 1 pads its rows eightfold), so every hit fits alone.
DIR_BYTES_CAP = 1 << 28

launches = 0  # kernel launches made by this process; set to 0 to start a count


@functools.cache
def _lib() -> ctypes.CDLL:
    from ..util import cudabuild

    lib = cudabuild.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hb_hit_batch.argtypes = [p, p, ll, p, ll, ll, p, p, p, i, i, p]
    lib.hb_hit_batch.restype = i
    lib.hb_attrs.argtypes = [i, p]
    lib.hb_attrs.restype = i
    bind_layout(lib)
    return lib


def bind_layout(lib: ctypes.CDLL) -> None:
    """Type the layout queries of ``lib`` (the card's build or the host
    build) and raise if its hit table, header or row stride differ from
    ``layout``'s."""
    lib.hb_hit_words.argtypes = []
    lib.hb_hit_words.restype = ctypes.c_int
    lib.hb_header_words.argtypes = []
    lib.hb_header_words.restype = ctypes.c_int
    lib.hb_dir_stride.argtypes = [ctypes.c_longlong]
    lib.hb_dir_stride.restype = ctypes.c_longlong
    if (lib.hb_hit_words(), lib.hb_header_words()) != (HIT_WORDS, HEADER_WORDS):
        raise RuntimeError("the hit kernel's table layout differs from the wrapper's")
    if any(lib.hb_dir_stride(n) != dir_stride(n) for n in range(1, 65)):
        raise RuntimeError("the hit kernel's direction rows differ from the wrapper's")


def attrs(wide: bool) -> dict:
    """ptxas's registers and local bytes a thread of the int32 or int64 SW kernel."""
    out = (ctypes.c_int * 2)()
    rc = _lib().hb_attrs(int(wide), out)
    if rc != 0:
        raise RuntimeError(f"hit kernel attributes: CUDA error {rc}")
    return {"regs": out[0], "local": out[1]}


def dir_stride(n):
    """Direction bytes a row of a hit of ``n`` columns: a lane stores 8 at once."""
    return -(-n // 8) * 8


def dir_bytes(hits: np.ndarray) -> np.ndarray:
    """Direction bytes of each hit of ``hits`` ((L, 4): q_off, m, s_off, n)."""
    return hits[:, 1] * dir_stride(hits[:, 3])


def layout(hits: np.ndarray) -> dict:
    """Offsets of each hit of ``hits`` ((L, 4): q_off, m, s_off, n) in the
    launch's buffers, and their sizes: direction bytes (``dir``), carry
    elements (``carry``: H and F rows of n + 1) and the output (``out``
    bytes: L headers of six int64 words, then a slot of m + n bytes a hit
    at ``ops``)."""
    m, n = hits[:, 1], hits[:, 3]
    sizes = {"dir": dir_bytes(hits), "carry": 2 * (n + 1), "ops": m + n}
    out = {}
    for name, size in sizes.items():
        ends = np.cumsum(size)
        out[name] = ends - size
        out[f"{name}_total"] = int(ends[-1])
    out["out_total"] = 8 * HEADER_WORDS * len(hits) + out["ops_total"]
    return out


def groups(hits: np.ndarray) -> list[tuple[int, int]]:
    """``hits`` cut into launches ``[lo, hi)`` in order, each of at most
    ``DIR_BYTES_CAP`` direction bytes (a hit larger than that alone)."""
    out, lo, total = [], 0, 0
    for k, b in enumerate(dir_bytes(hits).tolist()):
        if k > lo and total + b > DIR_BYTES_CAP:
            out.append((lo, k))
            lo, total = k, 0
        total += b
    if len(hits):
        out.append((lo, len(hits)))
    return out


def value_bound(hits: np.ndarray, max_abs: int, Q: int, R: int) -> int:
    """A bound on |H|, |E| and |F| over every hit's fill: (m + n)
    (``max_abs`` + 2R) + 4Q, ``max_abs`` the largest |score|."""
    span = int((hits[:, 1] + hits[:, 3]).max())
    return span * (max_abs + 2 * R) + 4 * Q


def _check_hits(codes: np.ndarray, hits, sub: np.ndarray) -> np.ndarray:
    """``hits`` as an (L, 4) int64 array, after checking it against the
    code buffer and the matrix."""
    hits = np.asarray(hits, np.int64).reshape(-1, 4)
    if len(hits) == 0:
        raise ValueError("no hits")
    q_off, m, s_off, n = hits.T
    if (m < 1).any() or (n < 1).any():
        raise ValueError("a hit needs at least one row and one column")
    if (q_off < 0).any() or (q_off + m > len(codes)).any() or \
            (s_off < 0).any() or (s_off + n > len(codes)).any():
        raise ValueError("a hit's codes lie outside the code buffer")
    if (m + n >= 2**30).any():
        raise ValueError("a hit too large for the kernel's int32 sizes")
    if sub.ndim != 2 or sub.shape[0] != sub.shape[1] or sub.shape[0] > ALPHA:
        raise ValueError(f"sub: expected a square matrix of at most {ALPHA} symbols, "
                         f"got shape {sub.shape}")
    if len(codes) and int(codes.max()) >= sub.shape[0]:
        raise ValueError("codes must lie inside the matrix's alphabet")
    return hits


def hit_batch(
    codes: np.ndarray,  # (N,) codes of every hit's query and subject
    hits: np.ndarray,  # (L, 4) int64: q_off, m, s_off, n
    sub: np.ndarray,  # (A, A) substitution scores, A <= 32
    Q: int,  # a gap's first residue's cost
    R: int,  # each further residue's
    local: bool,
    device,
    wide: bool | None = None,
) -> torch.Tensor:
    """Every hit of ``hits`` with one launch on a CUDA ``device``; the
    output (``layout``'s ``out_total`` bytes, uint8) stays on ``device``.

    Hit k aligns ``codes[q_off:q_off+m]`` with ``codes[s_off:s_off+n]``, SW
    where ``local``, else NW. ``wide`` pins the kernel's DP type (tests,
    ``chip_smoke.py``); None takes int32 where ``value_bound`` lies below
    ``INT32_BOUND``.
    """
    Q, R = int(Q), int(R)
    codes = np.asarray(codes)
    sub = np.asarray(sub)
    hits = _check_hits(codes, hits, sub)
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the hit kernel runs on CUDA, got {dev}")
    check_gaps(Q, R)
    bound = value_bound(hits, int(np.abs(sub).max()), Q, R)
    if bound >= INT64_BOUND:
        raise ValueError("scores or gap penalties too large for the hit kernel")
    if wide is None:
        wide = bound >= INT32_BOUND
    dt = torch.int64 if wide else torch.int32
    lib = _lib()
    lay = layout(hits)
    table = np.empty((len(hits), HIT_WORDS), np.int64)
    table[:, :4] = hits
    table[:, 4], table[:, 5], table[:, 6] = lay["dir"], lay["carry"], lay["ops"]
    padded = np.zeros((ALPHA, ALPHA), np.int32)
    padded[:sub.shape[0], :sub.shape[1]] = sub
    host = np.concatenate([padded.view(np.uint8).ravel(), table.view(np.uint8).ravel(),
                           codes.astype(np.uint8)])
    buf = torch.from_numpy(host).to(dev)  # the one upload
    at_table = buf.data_ptr() + padded.nbytes
    at_codes = at_table + table.nbytes
    dirs = torch.empty(lay["dir_total"], dtype=torch.uint8, device=dev)
    carry = torch.empty(lay["carry_total"], dtype=dt, device=dev)
    out = torch.empty(lay["out_total"], dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hb_hit_batch(at_codes, at_table, len(hits), buf.data_ptr(), Q, R,
                              dirs.data_ptr(), carry.data_ptr(), out.data_ptr(), int(wide),
                              int(local), stream)
    if rc != 0:
        raise RuntimeError(f"hit kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out


def unpack(out: np.ndarray, hits: np.ndarray) -> list[Traceback]:
    """Each hit's ``Traceback`` from a launch's output fetched to the host."""
    L = len(hits)
    head = out[:8 * HEADER_WORDS * L].view(np.int64).reshape(L, HEADER_WORDS).tolist()
    ends = (8 * HEADER_WORDS * L + layout(hits)["ops"] + hits[:, 1] + hits[:, 3]).tolist()
    return [Traceback(score, qb, qe, sb, se, out[e - c:e].tobytes().decode())
            for (score, qb, qe, sb, se, c), e in zip(head, ends)]
