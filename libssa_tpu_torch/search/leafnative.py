"""ctypes bridge to the native Myers-Miller leaf solver.

``csrc/leafalign.cpp`` (a copy of the reference's ``native/leafalign.cpp``)
runs the leaf direction-matrix Gotoh fill + traceback at C speed: the
Python fill (``hirschberg._ops_small``) pays about 60 us of interpreter
overhead per DP row, and the leaf row total equals the query length
whatever the leaf sizing, so it dominates a huge-pair traceback. The
Python fill remains the fallback and the differential oracle; this path is
a throughput optimization, never a correctness dependency (identical
recurrences, tie-breaks, and (tb, te) boundary contract).

Build: at first use, by the host C++ compiler, through
``util/cudabuild.load_native`` into ``build/libssa_tpu_torch/`` (keyed on
the source, the flags and the host CPU).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np


@functools.cache
def _find_lib():
    from ..util.cudabuild import load_native

    lib = load_native("leafalign.cpp")
    if lib is not None:
        lib.leaf_ops.restype = ctypes.c_int64
        lib.leaf_ops.argtypes = [
            ctypes.POINTER(ctypes.c_int64),  # cost (A, A)
            ctypes.c_int32,                  # A
            ctypes.POINTER(ctypes.c_int32),  # q
            ctypes.c_int64,                  # m
            ctypes.POINTER(ctypes.c_int32),  # s
            ctypes.c_int64,                  # n
            ctypes.c_int64,                  # g
            ctypes.c_int64,                  # h
            ctypes.c_int64,                  # tb
            ctypes.c_int64,                  # te
            ctypes.POINTER(ctypes.c_uint8),  # ops out (m + n)
        ]
    return lib


def native_available() -> bool:
    return _find_lib() is not None


def leaf_ops_native(q, s, cost, g, h, tb, te):
    """Optimal ops list for one leaf, or None when the lib is absent.

    Arguments mirror ``hirschberg._ops_small`` (min-cost form); the
    returned list is identical to its output by construction (same
    recurrences and tie-breaks, differential-tested).
    """
    lib = _find_lib()
    if lib is None:
        return None
    q32 = np.ascontiguousarray(q, np.int32)
    s32 = np.ascontiguousarray(s, np.int32)
    cost64 = np.ascontiguousarray(cost, np.int64)
    m, n = len(q32), len(s32)
    out = np.empty(m + n, np.uint8)
    got = lib.leaf_ops(
        cost64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(cost64.shape[0]),
        q32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(m),
        s32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(n),
        ctypes.c_int64(int(g)),
        ctypes.c_int64(int(h)),
        ctypes.c_int64(int(tb)),
        ctypes.c_int64(int(te)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if got < 0:
        return None
    return list(out[:got].tobytes().decode())
