"""K3's wrapper: the counterpart of ``libssa_tpu/ops/longpair_pallas.py``.

``longpair_score_cuda`` scores one whole pair with one K3 launch
(``csrc/longpair.cu``). On CPU tensors it runs the plain PyTorch version
(``longpair.longpair_score_plain``); on CUDA tensors it launches K3 or
raises. Nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import longpair
from .interseq_cuda import _check

SOURCE = "longpair.cu"
WARP = 32  # bands (threads) per stripe
BAND_ROWS = (4, 8)  # rows per thread with an instantiation in K3

launches = 0  # K3 launches made by this process; set to 0 to start a count


@functools.cache
def _lib() -> ctypes.CDLL:
    from ..util import cudabuild

    lib = cudabuild.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.k3_longpair.argtypes = [p, ll, p, i, p, ll, ll, i, i, i, i, p, p, p, p, p, p]
    lib.k3_longpair.restype = i
    lib.k3_ring_slots.argtypes = []
    lib.k3_ring_slots.restype = i
    return lib


def band_rows(m: int, sms: int) -> int:
    """Rows per thread: 8 once that still makes a stripe for every other
    SM, else 4.

    Measured on one H100 80GB HBM3 at 700 W (PERF.md): 4 rows was fastest
    at m = 16k, 8 rows at 64k and 100k, and at 4k the two were within 6%;
    2 rows was never the fastest.
    """
    return 8 if -(-m // (WARP * 8)) >= sms // 2 else 4


def longpair_score_cuda(
    q: torch.Tensor,  # (m,) uint8 query codes, < 32
    s: torch.Tensor,  # (n,) uint8 subject codes, < 32
    matrix_padded: torch.Tensor,  # (32, 32) int32
    Q: int,
    R: int,
    local: bool = True,
    dtype: torch.dtype = torch.int32,
    rows_per_thread: int | None = None,
) -> torch.Tensor:
    """Exact SW/NW score of one pair as a 0-dim ``dtype`` tensor.

    ``rows_per_thread`` pins K3's band height (one of ``BAND_ROWS``);
    None picks it by ``band_rows``. The result stays on the device.
    """
    global launches
    dev = s.device
    if dev.type == "cpu":
        return longpair.longpair_score_plain(
            q, s, matrix_padded, Q, R, local=local, dtype=dtype
        )
    if dev.type != "cuda":
        raise ValueError(f"K3 takes CUDA or CPU tensors, got {dev}")
    if dtype not in (torch.int32, torch.int64):
        raise ValueError(f"unsupported DP dtype {dtype!r}")
    if q.dim() != 1 or s.dim() != 1:
        raise ValueError("q and s must be 1-d")
    m, n = q.shape[0], s.shape[0]
    if m == 0 or n == 0:
        raise ValueError("use longpair_score for empty inputs")
    if n >= 2**31 - WARP:
        raise ValueError(f"subject too long for K3 ({n})")
    _check("q", q, torch.uint8, (m,), dev)
    _check("s", s, torch.uint8, (n,), dev)
    _check("matrix_padded", matrix_padded, torch.int32, (32, 32), dev)
    if int(torch.maximum(q.max(), s.max())) >= 32:
        raise ValueError("codes must be < 32")
    Q, R = int(Q), int(R)
    if rows_per_thread is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rows_per_thread = band_rows(m, sms)
    if rows_per_thread not in BAND_ROWS:
        raise ValueError(f"rows_per_thread must be one of {BAND_ROWS}")
    stripes = -(-m // (WARP * rows_per_thread))
    if stripes >= 2**31:
        raise ValueError(f"query too long for K3 ({m})")
    lib = _lib()
    bufs = torch.empty((2, lib.k3_ring_slots(), n), dtype=dtype, device=dev)
    counters = torch.zeros(stripes + 1, dtype=torch.int32, device=dev)  # ticket, progress
    result = torch.zeros(1, dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.k3_longpair(
            q.data_ptr(), m, s.data_ptr(), n, matrix_padded.data_ptr(), Q, R,
            int(local), int(dtype == torch.int64), rows_per_thread, stripes,
            bufs[0].data_ptr(), bufs[1].data_ptr(), counters[1:].data_ptr(),
            counters[0:1].data_ptr(), result.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {rc}")
    launches += 1
    return result[0]
