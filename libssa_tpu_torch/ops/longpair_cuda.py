"""K3's wrapper: the counterpart of ``libssa_tpu/ops/longpair_pallas.py``.

``longpair_score_cuda`` scores one whole pair with one K3 launch
(``csrc/longpair.cu``). On CPU tensors it runs the plain PyTorch version
(``longpair.longpair_score_plain``); on CUDA tensors it launches K3 or
raises. Nothing falls back.

K3 runs W stripes of 32 x ``rows_per_thread`` query rows a block (a group),
plus a reader and a writer warp for the edge between groups:
``band_rows`` picks the rows a thread, ``choose_warps`` the stripes a block.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..util.profiling import span
from . import longpair
from .interseq_cuda import _check, check_gaps

SOURCE = "longpair.cu"
WARP = 32  # bands (threads) per stripe
BAND_ROWS = (4, 8)  # rows per thread with an instantiation in K3
MAX_WARPS = 8  # stripes (compute warps) a K3 block
EDGE = 128  # columns of a shared ring of a K3 block
MAX_SMEM = 232448  # dynamic shared bytes a block may have
# Room above n for the block's clock (n + 31 + 40 x (W - 1) steps) in int32.
MAX_SUBJECT = 2**31 - 4096

launches = 0  # K3 launches made by this process; set to 0 to start a count


@functools.cache
def _lib(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """K3's library; ``defines`` switch on the stage cuts of a timing probe
    (``csrc/longpair.cu``'s header), and the default is the production K3."""
    from ..util import cudabuild

    lib = cudabuild.load(SOURCE, defines)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.k3_longpair.argtypes = [p, ll, p, i, p, ll, ll, i, i, i, ll, i, p, p, p, p, p, p]
    lib.k3_longpair.restype = i
    lib.k3_attrs.argtypes = [i, i, i, i, p]
    lib.k3_attrs.restype = i
    bind_layout(lib)
    return lib


def bind_layout(lib: ctypes.CDLL) -> None:
    """Type K3's layout queries in ``lib`` (the card's build or the host
    build) and raise if its shared memory differs from the wrapper's."""
    i = ctypes.c_int
    lib.k3_ring_slots.argtypes = []
    lib.k3_ring_slots.restype = i
    lib.k3_smem_bytes.argtypes = [i, i, i]
    lib.k3_smem_bytes.restype = ctypes.c_longlong
    if any(lib.k3_smem_bytes(w, ch, wide) != smem_bytes(w, ch, 8 if wide else 4)
           for w in range(1, MAX_WARPS + 1) for ch in BAND_ROWS for wide in (0, 1)):
        raise RuntimeError("K3's shared memory layout differs from the wrapper's")


def smem_bytes(warps: int, ch: int, itemsize: int) -> int:
    """Dynamic shared bytes of a K3 block: each compute warp's profile (ch x
    32 symbols x 32 lanes of int32), then one ring a compute warp and one
    for the writer warp (H and F, ``EDGE`` columns each)."""
    return warps * ch * 32 * WARP * 4 + (warps + 1) * 2 * EDGE * itemsize


def fits(warps: int, ch: int, itemsize: int) -> bool:
    """Whether K3 takes ``warps`` stripes a block at ``ch`` rows a thread."""
    return 1 <= warps <= MAX_WARPS and smem_bytes(warps, ch, itemsize) <= MAX_SMEM


def band_rows(m: int, sms: int) -> int:
    """Rows per thread for a query of ``m`` rows on a card of ``sms`` SMs: 4.

    Measured on one H100 80GB HBM3 at 700 W by ``chip_smoke.py`` phase 8's
    sweep (PERF.md §6): 4 rows beat 8 at every warps count a block at
    m = 16,384 and at m = 100,000, in int32 (14.8-15.0 ms against 16.1-16.2
    at 100k, 4 warps) and in int64 (41.9-42.0 against 57.2-57.6). 8 rows
    also hold fewer rows on the card at once (a block of 4 warps at 8 rows
    fits once an SM, at 4 rows three times), so no longer query favours
    them.
    """
    del m, sms
    return 4


def choose_warps(m: int, ch: int, sms: int) -> int:
    """Stripes (compute warps) a K3 block for a query of ``m`` rows at
    ``ch`` rows a thread, on a card of ``sms`` SMs: 4, or one a stripe for a
    query of fewer.

    Measured on one H100 80GB HBM3 at 700 W by ``chip_smoke.py`` phase 8's
    sweep over 1, 2, 3, 4, 6 and 8 (PERF.md §6), two runs: at 4
    rows a thread 4 was the fastest or within 2% of 3 at m = 16,384
    (2.31-2.45 ms; 8 took 2.57-2.67) and within 4% of 6 at m = 100,000
    (14.8-15.0 ms; 2 took 16.3). More warps lengthen the block's clock and
    fit fewer blocks an SM; fewer put more group edges, each about 200
    steps of fill, on the chain.
    """
    del sms
    return min(4, -(-m // (WARP * ch)))


def attrs(local: bool, wide: bool, ch: int, warps: int) -> dict:
    """ptxas's registers and local bytes a thread of one K3 instantiation,
    its resident blocks an SM at ``warps`` and its dynamic shared bytes."""
    out = (ctypes.c_int * 4)()
    rc = _lib().k3_attrs(int(local), int(wide), int(ch), int(warps), out)
    if rc != 0:
        raise RuntimeError(f"K3 attributes at ch={ch}, warps={warps}: error {rc}")
    return {"regs": out[0], "local": out[1], "blocks_an_sm": out[2], "smem": out[3]}


def longpair_score_cuda(
    q: torch.Tensor,  # (m,) uint8 query codes, < 32
    s: torch.Tensor,  # (n,) uint8 subject codes, < 32
    matrix_padded: torch.Tensor,  # (32, 32) int32
    Q: int,
    R: int,
    local: bool = True,
    dtype: torch.dtype = torch.int32,
    rows_per_thread: int | None = None,
    warps: int | None = None,
    stats=None,
) -> torch.Tensor:
    """Exact SW/NW score of one pair as a 0-dim ``dtype`` tensor.

    ``rows_per_thread`` pins K3's band height (one of ``BAND_ROWS``);
    None picks it by ``band_rows``. ``warps`` pins the stripes a block
    (tests, ``chip_smoke.py``); None takes ``choose_warps``. The result
    stays on the device. ``stats``: the request's ``SearchStats``, which
    gets a ``device.wait`` span around the codes' check.
    """
    global launches
    if s.device.type == "cpu":
        return longpair.longpair_score_plain(
            q, s, matrix_padded, Q, R, local=local, dtype=dtype
        )
    result = enqueue(_lib(), q, s, matrix_padded, Q, R, local, dtype, rows_per_thread,
                     warps=warps, stats=stats)
    launches += 1
    return result


def enqueue(
    lib: ctypes.CDLL,
    q: torch.Tensor,
    s: torch.Tensor,
    matrix_padded: torch.Tensor,
    Q: int,
    R: int,
    local: bool,
    dtype: torch.dtype,
    rows_per_thread: int | None,
    warps: int | None = None,
    stats=None,
) -> torch.Tensor:
    """Check the CUDA inputs and launch ``lib``'s K3 once (no count):
    ``longpair_score_cuda``'s launch, shared with the stage-cut probes."""
    dev = s.device
    if dev.type != "cuda":
        raise ValueError(f"K3 takes CUDA or CPU tensors, got {dev}")
    Q, R = int(Q), int(R)
    check_gaps(Q, R)
    if dtype not in (torch.int32, torch.int64):
        raise ValueError(f"unsupported DP dtype {dtype!r}")
    if q.dim() != 1 or s.dim() != 1:
        raise ValueError("q and s must be 1-d")
    m, n = q.shape[0], s.shape[0]
    if m == 0 or n == 0:
        raise ValueError("use longpair_score for empty inputs")
    if n >= MAX_SUBJECT:
        raise ValueError(f"subject too long for K3 ({n})")
    _check("q", q, torch.uint8, (m,), dev)
    _check("s", s, torch.uint8, (n,), dev)
    _check("matrix_padded", matrix_padded, torch.int32, (32, 32), dev)
    with span(stats, "device.wait"):
        top = int(torch.maximum(q.max(), s.max()))
    if top >= 32:
        raise ValueError("codes must be < 32")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if rows_per_thread is None:
        rows_per_thread = band_rows(m, sms)
    if rows_per_thread not in BAND_ROWS:
        raise ValueError(f"rows_per_thread must be one of {BAND_ROWS}")
    if warps is None:
        warps = choose_warps(m, rows_per_thread, sms)
    itemsize = 8 if dtype == torch.int64 else 4
    if not fits(int(warps), rows_per_thread, itemsize):
        raise ValueError(f"K3 takes 1 .. {MAX_WARPS} warps a block within {MAX_SMEM} shared "
                         f"bytes, not {warps} at {rows_per_thread} rows a thread")
    warps = int(warps)
    stripes = -(-m // (WARP * rows_per_thread))
    groups = -(-stripes // warps)
    if groups >= 2**31:
        raise ValueError(f"query too long for K3 ({m})")
    bufs = torch.empty((2, lib.k3_ring_slots(), n), dtype=dtype, device=dev)
    counters = torch.zeros(groups + 1, dtype=torch.int32, device=dev)  # ticket, progress
    result = torch.zeros(1, dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.k3_longpair(
            q.data_ptr(), m, s.data_ptr(), n, matrix_padded.data_ptr(), Q, R,
            int(local), int(dtype == torch.int64), rows_per_thread, stripes, warps,
            bufs[0].data_ptr(), bufs[1].data_ptr(), counters[1:].data_ptr(),
            counters[0:1].data_ptr(), result.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {rc}")
    return result[0]
