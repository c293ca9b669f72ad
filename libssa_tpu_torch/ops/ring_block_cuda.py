"""K2's wrapper: the counterpart of ``libssa_tpu/ops/ring_block_pallas.py``.

``ring_block_cuda`` runs a flat batch of tiles (``ring_block.py`` has the
contract and the layout) with one K2 launch (``csrc/ring_block.cu``). On
CPU tensors it runs the plain PyTorch version
(``ring_block.ring_block_batch_plain``) tile by tile; on CUDA tensors it
launches K2 or raises. Nothing falls back. ``stage`` splits a launch into
its host staging and the launch itself.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable

import numpy as np
import torch

from . import ring_block
from .interseq_cuda import _check

SOURCE = "ring_block.cu"
WARP = 32  # bands (threads) per stripe
BAND_ROWS = (4, 8)  # rows per thread with an instantiation in K2
JOB_WORDS = 16  # 64-bit words per job in K2's table

launches = 0  # K2 launches made by this process; set to 0 to start a count


@functools.cache
def _lib() -> ctypes.CDLL:
    from ..util import cudabuild

    lib = cudabuild.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.k2_ring_block.argtypes = [p, p, i, p, ll, ll, i, i, i, p, p, p]
    lib.k2_ring_block.restype = i
    lib.k2_ring_slots.argtypes = []
    lib.k2_ring_slots.restype = i
    lib.k2_job_words.argtypes = []
    lib.k2_job_words.restype = i
    if lib.k2_job_words() != JOB_WORDS:
        raise RuntimeError("K2's job table layout differs from the wrapper's")
    return lib


def job_table(jobs: np.ndarray, ch: int, q_addr: int, s_addr: int, addr: dict,
              itemsize: int, ring: int) -> tuple[np.ndarray, np.ndarray]:
    """K2's (J, JOB_WORDS) int64 job table and (stripes,) int32 ticket map.

    ``addr`` holds the base address of each flat array (``leftH`` .. ``ring``;
    ``rowmax``/``rowarg`` 0 for NW); ``jobs`` rows are
    [q_off, rows, s_off, cols] in elements of the code buffers at
    ``q_addr``/``s_addr``. A tile's ring slots are 2 * ``ring`` * cols
    elements.
    """
    J = len(jobs)
    q_off, rows, s_off, cols = (jobs[:, k].astype(np.int64) for k in range(4))
    off = ring_block.offsets(jobs)
    stripes = -(-rows // (WARP * ch))
    first = np.concatenate([[0], np.cumsum(stripes)[:-1]]).astype(np.int64)
    ring_off = 2 * ring * off["cols"]
    t = np.zeros((J, JOB_WORDS), np.int64)
    t[:, 0] = q_addr + q_off
    t[:, 1] = s_addr + s_off
    for k, (name, seg) in enumerate((
            ("leftH", "left"), ("leftE", "rows"), ("topH", "cols"), ("topF", "cols"),
            ("rightH", "rows"), ("rightE", "rows"), ("botH", "cols"), ("botF", "cols"),
            ("rowmax", "rows"))):
        t[:, 2 + k] = addr[name] + itemsize * off[seg] if addr[name] else 0
    t[:, 11] = addr["rowarg"] + 4 * off["rows"] if addr["rowarg"] else 0
    t[:, 12] = addr["ring"] + itemsize * ring_off
    t[:, 13] = rows
    t[:, 14] = cols
    t[:, 15] = first
    return t, np.repeat(np.arange(J, dtype=np.int32), stripes)


def ring_block_cuda(
    q_codes: torch.Tensor,  # (Lq,) uint8 codes, < 32
    s_codes: torch.Tensor,  # (Ls,) uint8 codes, < 32
    jobs: np.ndarray,  # (J, 4) int64: q_off, rows, s_off, cols
    matrix_padded: torch.Tensor,  # (32, 32) int32
    Q: int,
    R: int,
    local: bool,
    leftH: torch.Tensor,  # (sum(rows + 1),) int32 or int64
    leftE: torch.Tensor,  # (sum(rows),)
    topH: torch.Tensor,  # (sum(cols),)
    topF: torch.Tensor,  # (sum(cols),)
    rows_per_thread: int | None = None,
    codes_checked: bool = False,
) -> ring_block.Tiles:
    """Every tile of ``jobs`` with one K2 launch; outputs stay on the device.

    The DP type is ``leftH``'s. ``rows_per_thread`` pins K2's band height
    (one of ``BAND_ROWS``); None takes 8 rows once 8-row stripes give
    every other SM one, else 4 (K3's rule, ``longpair_cuda.band_rows``,
    over all the launch's tiles). ``codes_checked`` skips the check that
    every code is below 32 (a reduction and a wait for the device), for a
    caller that checked its code buffers once before the upload.
    """
    if s_codes.device.type == "cpu":
        jobs = _check_tiles(q_codes, s_codes, jobs, leftH, leftE, topH, topF)
        return ring_block.ring_block_batch_plain(q_codes, s_codes, jobs, matrix_padded, Q,
                                                 R, local, leftH, leftE, topH, topF)
    return stage(q_codes, s_codes, jobs, matrix_padded, Q, R, local, leftH, leftE, topH,
                 topF, rows_per_thread, codes_checked)()


def _check_tiles(q_codes, s_codes, jobs, leftH, leftE, topH, topF) -> np.ndarray:
    """``jobs`` as a (J, 4) int64 array, after checking it and the
    boundary arrays against each other."""
    jobs = np.asarray(jobs, np.int64).reshape(-1, 4)
    dev = s_codes.device
    if len(jobs) == 0:
        raise ValueError("no tiles")
    if (jobs[:, 1] < 1).any() or (jobs[:, 3] < 1).any():
        raise ValueError("a tile needs at least one row and one column")
    if (jobs[:, 0] < 0).any() or (jobs[:, 0] + jobs[:, 1] > q_codes.shape[0]).any() or \
            (jobs[:, 2] < 0).any() or (jobs[:, 2] + jobs[:, 3] > s_codes.shape[0]).any():
        raise ValueError("a tile's codes lie outside the code buffers")
    dt = leftH.dtype
    if dt not in (torch.int32, torch.int64):
        raise ValueError(f"unsupported DP dtype {dt!r}")
    n_rows, n_cols = int(jobs[:, 1].sum()), int(jobs[:, 3].sum())
    sizes = {"leftH": n_rows + len(jobs), "leftE": n_rows, "topH": n_cols, "topF": n_cols}
    for name, t in zip(sizes, (leftH, leftE, topH, topF)):
        _check(name, t, dt, (sizes[name],), dev)
    return jobs


def stage(q_codes, s_codes, jobs, matrix_padded, Q, R, local, leftH, leftE, topH, topF,
          rows_per_thread=None, codes_checked=False) -> Callable[[], ring_block.Tiles]:
    """One K2 launch made ready on CUDA tensors (``ring_block_cuda``'s
    arguments): the job table and ticket map copied to the device, the
    outputs and the stripe-edge scratch allocated. Returns the launch:
    each call resets the tickets, launches K2 once on the current stream
    and returns the same output tensors. Timing the launch alone times
    K2 without the host's staging."""
    jobs = _check_tiles(q_codes, s_codes, jobs, leftH, leftE, topH, topF)
    dev, dt = s_codes.device, leftH.dtype
    if dev.type != "cuda":
        raise ValueError(f"K2 takes CUDA or CPU tensors, got {dev}")
    _check("q_codes", q_codes, torch.uint8, tuple(q_codes.shape), dev)
    _check("s_codes", s_codes, torch.uint8, tuple(s_codes.shape), dev)
    _check("matrix_padded", matrix_padded, torch.int32, (32, 32), dev)
    if (jobs[:, 3] >= 2**31 - WARP).any():
        raise ValueError("a tile too wide for K2")
    if not codes_checked and int(torch.maximum(q_codes.max(), s_codes.max())) >= 32:
        raise ValueError("codes must be < 32")
    if rows_per_thread is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        stripes8 = int((-(-jobs[:, 1] // (WARP * 8))).sum())
        rows_per_thread = 8 if stripes8 >= sms // 2 else 4
    if rows_per_thread not in BAND_ROWS:
        raise ValueError(f"rows_per_thread must be one of {BAND_ROWS}")
    lib = _lib()
    ring = lib.k2_ring_slots()
    n_rows, n_cols = int(jobs[:, 1].sum()), int(jobs[:, 3].sum())
    out = ring_block.Tiles(
        torch.empty(n_rows, dtype=dt, device=dev), torch.empty(n_rows, dtype=dt, device=dev),
        torch.empty(n_cols, dtype=dt, device=dev), torch.empty(n_cols, dtype=dt, device=dev),
        torch.empty(n_rows, dtype=dt, device=dev) if local else None,
        torch.empty(n_rows, dtype=torch.int32, device=dev) if local else None,
    )
    scratch = torch.empty(2 * ring * n_cols, dtype=dt, device=dev)
    addr = {name: (t.data_ptr() if t is not None else 0) for name, t in zip(
        ("leftH", "leftE", "topH", "topF", *out._fields), (leftH, leftE, topH, topF, *out))}
    addr["ring"] = scratch.data_ptr()
    table, stripe_job = job_table(jobs, rows_per_thread, q_codes.data_ptr(),
                                  s_codes.data_ptr(), addr, leftH.element_size(), ring)
    if len(stripe_job) >= 2**31:
        raise ValueError("too many stripes for one K2 launch")
    table_d = torch.from_numpy(table).to(dev)
    stripe_job_d = torch.from_numpy(stripe_job).to(dev)
    counters = torch.empty(len(stripe_job) + 1, dtype=torch.int32, device=dev)  # ticket, progress

    def launch() -> ring_block.Tiles:
        global launches
        counters.zero_()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.k2_ring_block(
                table_d.data_ptr(), stripe_job_d.data_ptr(), len(stripe_job),
                matrix_padded.data_ptr(), int(Q), int(R), int(local), int(dt == torch.int64),
                rows_per_thread, counters[1:].data_ptr(), counters[0:1].data_ptr(), stream,
            )
        if rc != 0:
            raise RuntimeError(f"K2 launch failed: CUDA error {rc}")
        launches += 1
        return out

    # The table points into the scratch, so the launch holds it. Dropping the
    # launch (table, ticket map, scratch) is safe: the caching allocator hands
    # their blocks out again only to work ordered after it on the stream.
    launch.scratch = scratch
    return launch
