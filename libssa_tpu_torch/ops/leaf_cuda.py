"""The leaves of one Myers-Miller frontier pass in one launch.

``leaf_batch_cuda`` solves a batch of leaves (``search/hirschberg.py``'s
subproblems of at most ``LEAF_CELLS`` cells, windows into one pair's code
buffers) with one launch of ``csrc/leafbatch.cu``: each leaf's direction
matrix fill and its walk back, with the semantics of
``hirschberg._ops_small`` and ``csrc/leafalign.cpp``. On CPU tensors it runs
the plain version (``leaf_batch_plain``: the host leaf solve,
``hirschberg._ops_leaf``, leaf by leaf); on CUDA tensors it launches the
kernel or raises. Nothing falls back.

A launch's output is one uint8 tensor: the leaves' op counts as int32, then
each leaf's slot of m + n bytes (``layout``), whose last ``count`` bytes are
its ops ('M', 'D', 'I') in order; ``unpack`` reads it on the host.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .interseq_cuda import _check, check_gaps

SOURCE = "leafbatch.cu"
LEAF_WORDS = 9  # 64-bit words a leaf in the kernel's table
INT32_BOUND = 1 << 27  # int32 below it: the kernel's unopened E is 2**28

launches = 0  # kernel launches made by this process; set to 0 to start a count


@functools.cache
def _lib() -> ctypes.CDLL:
    from ..util import cudabuild

    lib = cudabuild.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lb_leaf_batch.argtypes = [p, p, p, ll, p, ll, ll, p, p, p, i, p]
    lib.lb_leaf_batch.restype = i
    lib.lb_attrs.argtypes = [i, p]
    lib.lb_attrs.restype = i
    bind_layout(lib)
    return lib


def bind_layout(lib: ctypes.CDLL) -> None:
    """Type the layout queries of ``lib`` (the card's build or the host
    build) and raise if its leaf table or row stride differ from ``layout``'s."""
    lib.lb_leaf_words.argtypes = []
    lib.lb_leaf_words.restype = ctypes.c_int
    lib.lb_dir_stride.argtypes = [ctypes.c_longlong]
    lib.lb_dir_stride.restype = ctypes.c_longlong
    if lib.lb_leaf_words() != LEAF_WORDS:
        raise RuntimeError("the leaf kernel's table layout differs from the wrapper's")
    if any(lib.lb_dir_stride(n) != dir_stride(n) for n in range(1, 65)):
        raise RuntimeError("the leaf kernel's direction rows differ from the wrapper's")


def attrs(wide: bool) -> dict:
    """ptxas's registers and local bytes a thread of the int32 or int64 kernel."""
    out = (ctypes.c_int * 2)()
    rc = _lib().lb_attrs(int(wide), out)
    if rc != 0:
        raise RuntimeError(f"leaf kernel attributes: CUDA error {rc}")
    return {"regs": out[0], "local": out[1]}


def dir_stride(n):
    """Direction bytes a row of a leaf of ``n`` columns: a lane stores 8 at once."""
    return -(-n // 8) * 8


def layout(leaves: np.ndarray) -> dict:
    """Offsets of each leaf of ``leaves`` ((L, 6): q_off, m, s_off, n, tb,
    te) in the launch's buffers, and their sizes: direction bytes (``dir``),
    carry elements (``carry``: C and D rows of n + 1, C's column n of m + 1)
    and the output (``out``: L int32 counts, then a slot of m + n bytes a
    leaf at ``ops``)."""
    m, n = leaves[:, 1], leaves[:, 3]
    sizes = {"dir": m * dir_stride(n), "carry": 2 * (n + 1) + m + 1, "ops": m + n}
    out = {}
    for name, size in sizes.items():
        ends = np.cumsum(size)
        out[name] = ends - size
        out[f"{name}_total"] = int(ends[-1])
    out["out_total"] = 4 * len(leaves) + out["ops_total"]
    return out


def needs_int64(leaves: np.ndarray, max_abs: int, g: int, h: int) -> bool:
    """Whether a value of some leaf's fill, walk or tail scan could pass the
    int32 kernel's range: every C, D, E and tail cost lies within (m + n)
    (``max_abs`` + 2h) + 4 (g + h) of 0, ``max_abs`` the largest |cost|."""
    span = int((leaves[:, 1] + leaves[:, 3]).max())
    return span * (max_abs + 2 * h) + 4 * (g + h) >= INT32_BOUND


def _check_leaves(q_codes, s_codes, leaves, cost, g, h) -> np.ndarray:
    """``leaves`` as an (L, 6) int64 array, after checking it against the
    code buffers."""
    leaves = np.asarray(leaves, np.int64).reshape(-1, 6)
    if len(leaves) == 0:
        raise ValueError("no leaves")
    q_off, m, s_off, n, tb, te = leaves.T
    if (m < 1).any() or (n < 1).any():
        raise ValueError("a leaf needs at least one row and one column")
    if (q_off < 0).any() or (q_off + m > q_codes.shape[0]).any() or \
            (s_off < 0).any() or (s_off + n > s_codes.shape[0]).any():
        raise ValueError("a leaf's codes lie outside the code buffers")
    if ((tb != 0) & (tb != g)).any() or ((te != 0) & (te != g)).any():
        raise ValueError("a leaf's boundary opens must be 0 or g")
    if tuple(cost.shape) != (32, 32):
        raise ValueError(f"cost: expected shape (32, 32), got {tuple(cost.shape)}")
    return leaves


def leaf_batch_plain(q_codes, s_codes, leaves, cost, g, h) -> torch.Tensor:
    """The plain version on CPU tensors: each leaf through the host leaf
    solve (``hirschberg._ops_leaf``), written in the kernel's layout."""
    from ..search.hirschberg import _ops_leaf

    q, s = q_codes.numpy().astype(np.intp), s_codes.numpy().astype(np.intp)
    c = cost.numpy().astype(np.int64)
    lay = layout(leaves)
    out = np.zeros(lay["out_total"], np.uint8)
    counts = out[:4 * len(leaves)].view(np.int32)
    base = 4 * len(leaves)
    for k, (qo, m, so, n, tb, te) in enumerate(leaves.tolist()):
        ops = "".join(_ops_leaf(q[qo:qo + m], s[so:so + n], c, g, h, tb, te)).encode()
        end = base + int(lay["ops"][k]) + m + n
        out[end - len(ops):end] = np.frombuffer(ops, np.uint8)
        counts[k] = len(ops)
    return torch.from_numpy(out)


def leaf_batch_cuda(
    q_codes: torch.Tensor,  # (Lq,) uint8 codes, < 32
    s_codes: torch.Tensor,  # (Ls,) uint8 codes, < 32
    leaves: np.ndarray,  # (L, 6) int64: q_off, m, s_off, n, tb, te
    cost: torch.Tensor,  # (32, 32) int32 substitution costs (-score)
    g: int,  # gap open beyond the first extend (Q - R)
    h: int,  # gap extend (R)
    max_abs: int | None = None,
    wide: bool | None = None,
) -> torch.Tensor:
    """Every leaf of ``leaves`` with one launch; the output (``layout``'s
    ``out_total`` bytes) stays on the device.

    Leaf k aligns ``q_codes[q_off:q_off+m]`` with ``s_codes[s_off:s_off+n]``
    under the boundary opens tb and te (each 0 or g). The codes are taken
    as checked (``DevicePair`` checks its buffers once before the upload).
    ``max_abs``, the largest |cost| where the caller knows it, spares a read
    of ``cost`` that waits for the device. ``wide`` pins the kernel's DP
    type (tests, ``chip_smoke.py``); None takes int32 unless ``needs_int64``.
    """
    g, h = int(g), int(h)
    leaves = _check_leaves(q_codes, s_codes, leaves, cost, g, h)
    if s_codes.device.type == "cpu":
        return leaf_batch_plain(q_codes, s_codes, leaves, cost, g, h)
    dev = s_codes.device
    if dev.type != "cuda":
        raise ValueError(f"the leaf kernel takes CUDA or CPU tensors, got {dev}")
    check_gaps(g + h, h)
    _check("q_codes", q_codes, torch.uint8, tuple(q_codes.shape), dev)
    _check("s_codes", s_codes, torch.uint8, tuple(s_codes.shape), dev)
    _check("cost", cost, torch.int32, (32, 32), dev)
    if (leaves[:, 1] + leaves[:, 3] >= 2**30).any():
        raise ValueError("a leaf too large for the kernel's int32 op counts")
    if wide is None:
        if max_abs is None:
            max_abs = int(cost.abs().max())
        wide = needs_int64(leaves, max_abs, g, h)
    dt = torch.int64 if wide else torch.int32
    lib = _lib()
    lay = layout(leaves)
    table = np.empty((len(leaves), LEAF_WORDS), np.int64)
    table[:, :6] = leaves
    table[:, 6], table[:, 7], table[:, 8] = lay["dir"], lay["carry"], lay["ops"]
    table_d = torch.from_numpy(table).to(dev)
    dirs = torch.empty(lay["dir_total"], dtype=torch.uint8, device=dev)
    carry = torch.empty(lay["carry_total"], dtype=dt, device=dev)
    out = torch.empty(lay["out_total"], dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lb_leaf_batch(q_codes.data_ptr(), s_codes.data_ptr(), table_d.data_ptr(),
                               len(leaves), cost.data_ptr(), g, h, dirs.data_ptr(),
                               carry.data_ptr(), out.data_ptr(), int(wide), stream)
    if rc != 0:
        raise RuntimeError(f"leaf kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out


def unpack(out: np.ndarray, leaves: np.ndarray) -> list[str]:
    """Each leaf's ops from a launch's output fetched to the host."""
    lay = layout(leaves)
    L = len(leaves)
    counts = out[:4 * L].view(np.int32)
    ends = 4 * L + lay["ops"] + leaves[:, 1] + leaves[:, 3]
    return [out[e - c:e].tobytes().decode() for e, c in zip(ends.tolist(), counts.tolist())]
