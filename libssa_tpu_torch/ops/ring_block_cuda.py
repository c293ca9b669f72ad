"""K2's wrapper: the counterpart of ``libssa_tpu/ops/ring_block_pallas.py``.

``ring_block_cuda`` runs a flat batch of tiles (``ring_block.py`` has the
contract and the layout) with one K2 launch (``csrc/ring_block.cu``). On
CPU tensors it runs the plain PyTorch version
(``ring_block.ring_block_batch_plain``) tile by tile; on CUDA tensors it
launches K2 or raises. Nothing falls back. ``stage`` splits a launch into
its host staging and the launch itself; ``to_device`` is its upload, one
copy from pinned host memory that does not wait for the device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable

import numpy as np
import torch

from . import ring_block
from .interseq_cuda import _check, check_gaps

SOURCE = "ring_block.cu"
WARP = 32  # bands (threads) per stripe
BAND_ROWS = (4, 8)  # rows per thread with an instantiation in K2
JOB_WORDS = 16  # 64-bit words per job in K2's table
MAX_WARPS = 8  # stripes (compute warps) a K2 block
EDGE = 128  # columns of a shared ring of a K2 block
MAX_SMEM = 232448  # dynamic shared bytes a block may have
SM_SMEM = 233472  # shared bytes of an SM, 1 KB of it reserved for each block

launches = 0  # K2 launches made by this process; set to 0 to start a count


@functools.cache
def _lib(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """K2's library; ``defines`` switch on the stage cuts of a timing probe
    (``csrc/ring_block.cu``'s header), and the default is K2 itself."""
    from ..util import cudabuild

    lib = cudabuild.load(SOURCE, defines)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.k2_ring_block.argtypes = [p, p, i, i, p, ll, ll, i, i, i, p, p, p]
    lib.k2_ring_block.restype = i
    lib.k2_attrs.argtypes = [i, i, i, i, p]
    lib.k2_attrs.restype = i
    bind_layout(lib)
    return lib


def bind_layout(lib: ctypes.CDLL) -> None:
    """Type K2's layout queries in ``lib`` (the card's build or the host
    build) and raise if the job table or shared memory differ from the
    wrapper's."""
    i = ctypes.c_int
    lib.k2_ring_slots.argtypes = []
    lib.k2_ring_slots.restype = i
    lib.k2_job_words.argtypes = []
    lib.k2_job_words.restype = i
    lib.k2_smem_bytes.argtypes = [i, i, i]
    lib.k2_smem_bytes.restype = ctypes.c_longlong
    if lib.k2_job_words() != JOB_WORDS:
        raise RuntimeError("K2's job table layout differs from the wrapper's")
    if any(lib.k2_smem_bytes(w, ch, wide) != smem_bytes(w, ch, 8 if wide else 4)
           for w in range(1, MAX_WARPS + 1) for ch in BAND_ROWS for wide in (0, 1)):
        raise RuntimeError("K2's shared memory layout differs from the wrapper's")


def smem_bytes(warps: int, ch: int, itemsize: int) -> int:
    """Dynamic shared bytes of a K2 block: each compute warp's profile (ch x
    32 symbols x 32 lanes of int32), then one ring a compute warp (H and F,
    ``EDGE`` columns each)."""
    return warps * ch * 32 * WARP * 4 + warps * 2 * EDGE * itemsize


def choose_warps(jobs: np.ndarray, ch: int, sms: int, itemsize: int = 4) -> int:
    """Stripes (compute warps) a K2 block for a launch over ``jobs`` (rows
    [q_off, rows, s_off, cols]) at ``ch`` rows a thread, on a card of
    ``sms`` SMs.

    4, else 2, else 1: the largest that leaves at most a quarter of the
    launch's compute warps without a stripe and whose groups all fit on
    the card at once (``resident_blocks`` an SM), if any does; else the
    largest that passes the first test alone. Measured on one H100 by
    ``chip_smoke.py`` phase 10 (PERF.md §6): at the band height the wrapper
    picks, 4 was the fastest or within 5% of the fastest at 11a's first
    level, 11b's SW end scan and 11b NW's widest level; 8 lost 11% at the
    first, and 2 lost 27-46% at 8 rows.
    """
    stripes = -(-np.asarray(jobs, np.int64).reshape(-1, 4)[:, 1] // (WARP * ch))
    few_idle = []
    for w in (4, 2):
        groups = -(-stripes // w)
        if 4 * int((groups * w - stripes).sum()) <= int(groups.sum()) * w:
            if int(groups.sum()) <= resident_blocks(w, ch, itemsize) * sms:
                return w
            few_idle.append(w)
    return few_idle[0] if few_idle else 1


def resident_blocks(warps: int, ch: int, itemsize: int) -> int:
    """K2 blocks an SM holds at once as its shared memory allows (at most
    32). Registers may allow fewer: ``attrs`` reads the card's own count."""
    return min(32, SM_SMEM // (smem_bytes(warps, ch, itemsize) + 1024))


def attrs(local: bool, wide: bool, ch: int, warps: int) -> dict:
    """ptxas's registers and local bytes a thread of one K2 instantiation,
    its resident blocks an SM at ``warps`` and its dynamic shared bytes."""
    out = (ctypes.c_int * 4)()
    rc = _lib().k2_attrs(int(local), int(wide), int(ch), int(warps), out)
    if rc != 0:
        raise RuntimeError(f"K2 attributes at ch={ch}, warps={warps}: error {rc}")
    return {"regs": out[0], "local": out[1], "blocks_an_sm": out[2], "smem": out[3]}


def job_table(jobs: np.ndarray, ch: int, warps: int, q_addr: int, s_addr: int,
              addr: dict, itemsize: int, ring: int) -> tuple[np.ndarray, np.ndarray]:
    """K2's (J, JOB_WORDS) int64 job table and (groups,) int32 ticket map:
    a tile's stripes of 32 * ``ch`` rows go in groups of ``warps``, one
    block and one ticket each.

    ``addr`` holds the base address of each flat array (``leftH`` .. ``ring``;
    ``rowmax``/``rowarg`` 0 for NW); ``jobs`` rows are
    [q_off, rows, s_off, cols] in elements of the code buffers at
    ``q_addr``/``s_addr``. A tile's ring slots are 2 * ``ring`` * cols
    elements.
    """
    J = len(jobs)
    q_off, rows, s_off, cols = (jobs[:, k].astype(np.int64) for k in range(4))
    off = ring_block.offsets(jobs)
    groups = -(-rows // (WARP * ch * warps))
    first = np.concatenate([[0], np.cumsum(groups)[:-1]]).astype(np.int64)
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
    return t, np.repeat(np.arange(J, dtype=np.int32), groups)


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
    warps: int | None = None,
) -> ring_block.Tiles:
    """Every tile of ``jobs`` with one K2 launch; outputs stay on the device.

    The DP type is ``leftH``'s. ``rows_per_thread`` pins K2's band height
    (one of ``BAND_ROWS``); None takes 8 rows once 8-row stripes over all
    the launch's tiles give every other SM one, else 4. ``codes_checked``
    skips the check that every code is below 32 (a reduction and a wait for
    the device), for a caller that checked its code buffers once before the
    upload.
    ``warps`` pins the stripes a block (tests, ``chip_smoke.py``); None
    takes ``choose_warps``.
    """
    if s_codes.device.type == "cpu":
        jobs = _check_tiles(q_codes, s_codes, jobs, leftH, leftE, topH, topF)
        return ring_block.ring_block_batch_plain(q_codes, s_codes, jobs, matrix_padded, Q,
                                                 R, local, leftH, leftE, topH, topF)
    return stage(q_codes, s_codes, jobs, matrix_padded, Q, R, local, leftH, leftE, topH,
                 topF, rows_per_thread, codes_checked, warps)()


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


def to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``arr`` on ``dev``: on a card one copy from pinned host memory that
    does not wait for the device (the caching host allocator keeps the
    pinned block until the copy is done); on the CPU ``arr`` itself."""
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type == "cpu":
        return host
    return host.pin_memory().to(dev, non_blocking=True)


def stage(q_codes, s_codes, jobs, matrix_padded, Q, R, local, leftH, leftE, topH, topF,
          rows_per_thread=None, codes_checked=False, warps=None,
          defines=()) -> Callable[[], ring_block.Tiles]:
    """One K2 launch made ready on CUDA tensors (``ring_block_cuda``'s
    arguments): the job table and ticket map copied to the device in one
    ``to_device`` copy, the outputs and the stripe-edge scratch allocated.
    Returns the launch: each call resets the tickets, launches K2 once on
    the current stream and returns the same output tensors. Timing the
    launch alone times K2 without the host's staging. ``defines`` builds a timing probe's
    stage cuts in (``_lib``)."""
    jobs = _check_tiles(q_codes, s_codes, jobs, leftH, leftE, topH, topF)
    dev, dt = s_codes.device, leftH.dtype
    if dev.type != "cuda":
        raise ValueError(f"K2 takes CUDA or CPU tensors, got {dev}")
    Q, R = int(Q), int(R)
    check_gaps(Q, R)
    _check("q_codes", q_codes, torch.uint8, tuple(q_codes.shape), dev)
    _check("s_codes", s_codes, torch.uint8, tuple(s_codes.shape), dev)
    _check("matrix_padded", matrix_padded, torch.int32, (32, 32), dev)
    if (jobs[:, 3] >= 2**31 - WARP).any():
        raise ValueError("a tile too wide for K2")
    if not codes_checked and int(torch.maximum(q_codes.max(), s_codes.max())) >= 32:
        raise ValueError("codes must be < 32")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if rows_per_thread is None:
        stripes8 = int((-(-jobs[:, 1] // (WARP * 8))).sum())
        rows_per_thread = 8 if stripes8 >= sms // 2 else 4
    if rows_per_thread not in BAND_ROWS:
        raise ValueError(f"rows_per_thread must be one of {BAND_ROWS}")
    if warps is None:
        warps = choose_warps(jobs, rows_per_thread, sms, leftH.element_size())
    if not 1 <= warps <= MAX_WARPS or \
            smem_bytes(warps, rows_per_thread, leftH.element_size()) > MAX_SMEM:
        raise ValueError(f"K2 takes 1 .. {MAX_WARPS} warps a block within {MAX_SMEM} "
                         f"shared bytes, not {warps} at {rows_per_thread} rows a thread")
    lib = _lib(tuple(defines))
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
    table, group_job = job_table(jobs, rows_per_thread, warps, q_codes.data_ptr(),
                                 s_codes.data_ptr(), addr, leftH.element_size(), ring)
    if len(group_job) >= 2**31:
        raise ValueError("too many stripes for one K2 launch")
    staged = to_device(np.concatenate([table.view(np.uint8).ravel(), group_job.view(np.uint8)]),
                       dev)  # the job table, then the ticket map: one copy
    table_d, group_job_d = staged[:table.nbytes].view(torch.int64), \
        staged[table.nbytes:].view(torch.int32)
    counters = torch.empty(len(group_job) + 1, dtype=torch.int32, device=dev)  # ticket, progress

    def launch() -> ring_block.Tiles:
        global launches
        counters.zero_()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.k2_ring_block(
                table_d.data_ptr(), group_job_d.data_ptr(), len(group_job), warps,
                matrix_padded.data_ptr(), Q, R, int(local), int(dt == torch.int64),
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
    launch.warps, launch.rows_per_thread = warps, rows_per_thread
    return launch
