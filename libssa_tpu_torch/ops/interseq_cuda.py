"""K1's wrapper: the counterpart of ``libssa_tpu/ops/interseq_pallas.py``.

``interseq_pairs_cuda`` scores every (query, chunk) pair of one stack group
with one K1 launch (``csrc/interseq.cu``), or a few where the inter-strip
scratch would pass ``SCRATCH_BUDGET``. On CPU tensors it runs the plain
PyTorch version (``interseq.interseq_pairs``); on CUDA tensors it launches K1
or raises. Nothing falls back.

``choose_warps`` picks K1's layout from the launch's shape: one thread a
lane over every strip (Part A, 128-lane blocks) where the launch already
fills the card, else W warps down the query a 32-lane block (Part B).

K1 computes in int32 unless ``dtype`` is "int64" or the a-priori bound on
|H| reaches 2**31 - 1 (``interseq.compute_dtype``: int32 is exact wherever
the reference's f32 was, but would wrap past 2**31 where f32 saturated);
then it runs its int64 instantiation and the outputs are int64.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import interseq

SOURCE = "interseq.cu"
SCRATCH_BUDGET = 1 << 30  # bytes of strip-edge scratch per engine
MAX_PAIRS_PER_LAUNCH = 65535  # the grid's y limit
MAX_WARPS = 16  # Part B's most warps down the query (the source's MAX_WARPS)
# Resident warps an SM at K1's 128 registers a thread: 65,536 / (128 x 32).
WARPS_AN_SM = 16
# Part A (128-lane blocks, 4 an SM) counts as filled from 3.5 blocks an SM
# (on one H100, Part A won at 512 blocks, 8 warps at 448: chip_smoke.py
# phase 6's sweep).
FILLED_BLOCKS_AN_SM = 3.5
# Part B's warps: the query's strips in one pass, up to 8 (on one H100, 8
# beat 2 and 4 from one to six chunks of 8,192 lanes, 16 lost past one wave
# of blocks: chip_smoke.py phase 6's sweep); 16 where 8 leaves the card
# under half full.
PASS_WARPS = 8

launches = 0  # K1 launches made by this process; set to 0 to start a count


@functools.cache
def _lib() -> ctypes.CDLL:
    from ..util import cudabuild

    lib = cudabuild.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.k1_interseq.argtypes = [
        p, i, p, p, i, i, p, p, p, i, ll, ll, i, i, i, i, p, p, p, p, p,
    ]
    lib.k1_interseq.restype = i
    lib.k1_strip_rows.argtypes = [i]
    lib.k1_strip_rows.restype = i
    lib.k1_attrs.argtypes = [i, i, i, i, p]
    lib.k1_attrs.restype = i
    if lib.k1_max_warps() != MAX_WARPS:
        raise RuntimeError("csrc/interseq.cu's MAX_WARPS differs from the wrapper's")
    return lib


def choose_warps(B: int, P: int, strips: int, sms: int) -> int:
    """Warps down the query for a launch of P pairs of B lanes whose query
    takes ``strips`` strips, on a card of ``sms`` SMs.

    1 (Part A) where its 128-lane blocks already put ``FILLED_BLOCKS_AN_SM``
    on every SM, or the query is one strip. Otherwise Part B with one warp a
    strip, at most ``PASS_WARPS``, or at most ``MAX_WARPS`` where
    ``PASS_WARPS`` would leave the card under half its resident warps; then
    spread evenly over the passes down the query, so that no pass leaves
    warps idle that another fills.
    """
    if strips <= 1 or -(-B // 128) * P >= FILLED_BLOCKS_AN_SM * sms:
        return 1
    w = min(strips, PASS_WARPS)
    if strips > w and -(-B // 32) * P * w * 2 < WARPS_AN_SM * sms:
        w = min(strips, MAX_WARPS)
    passes = -(-strips // w)
    return -(-strips // passes)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def attrs(local: bool, track: bool, wide: bool, warps: int) -> dict:
    """ptxas's registers and local bytes a thread of one instantiation, its
    resident blocks an SM at ``warps`` and its dynamic shared bytes."""
    out = (ctypes.c_int * 4)()
    rc = _lib().k1_attrs(int(local), int(track), int(wide), int(warps), out)
    if rc != 0:
        raise RuntimeError(f"K1 attributes at warps={warps}: CUDA error {rc}")
    return {"regs": out[0], "local": out[1], "blocks_an_sm": out[2], "smem": out[3]}


def check_gaps(Q: int, R: int) -> None:
    """Raise unless Q >= R >= 0: the kernels' lazy F (K1, K2, K3) is exact
    only there. Their CUDA branches call it before any launch; the plain
    versions, which match the reference at Q < R too, do not."""
    if R < 0 or Q < R:
        raise ValueError(f"the kernels are exact only for Q >= R >= 0 (Q={Q}, R={R})")


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def interseq_pairs_cuda(
    profiles: torch.Tensor,  # (n_queries, m, 32) int32
    codes: torch.Tensor,  # (g, n_pad, B) int8
    lengths: torch.Tensor,  # (g, B) int32
    iq: torch.Tensor,  # (P,) int32 query of each pair
    ic: torch.Tensor,  # (P,) int32 chunk of each pair
    m_reals: torch.Tensor,  # (n_queries,) int32, 1 <= m_real <= m
    gap_q,
    gap_r,
    local: bool = True,
    track_range: bool = False,
    dtype="int32",
    max_abs: int | None = None,
    scratch: torch.Tensor | None = None,
    warps: int | None = None,
):
    """``(scores, hi, lo)``, each (P, B), for every pair of a stack group.

    ``max_abs`` bounds |profile entry| (read from ``profiles`` when None,
    which costs a device sync). ``scratch`` is a uint8 buffer on the card
    for the strip-edge rows, reused across calls; when None or too small
    for one pair, the call allocates its own. ``warps`` pins K1's warps
    down the query (1 .. ``MAX_WARPS``; tests and ``chip_smoke.py``); None
    takes ``choose_warps``.
    """
    global launches
    dev = profiles.device
    if dev.type == "cpu":
        return interseq.interseq_pairs(
            profiles, codes, lengths, iq, ic, m_reals, gap_q, gap_r,
            local=local, track_range=track_range, dtype=dtype, max_abs=max_abs,
        )
    if dev.type != "cuda":
        raise ValueError(f"K1 takes CUDA or CPU tensors, got {dev}")
    if profiles.dim() != 3 or codes.dim() != 3:
        raise ValueError("profiles and codes must be 3-d")
    nq, m = profiles.shape[0], profiles.shape[1]
    g, n_pad, B = codes.shape
    P = iq.shape[0]
    _check("profiles", profiles, torch.int32, (nq, m, 32), dev)
    _check("codes", codes, torch.int8, (g, n_pad, B), dev)
    _check("lengths", lengths, torch.int32, (g, B), dev)
    _check("iq", iq, torch.int32, (P,), dev)
    _check("ic", ic, torch.int32, (P,), dev)
    _check("m_reals", m_reals, torch.int32, (nq,), dev)
    if m == 0:
        raise ValueError("profiles need at least one row")
    if warps is not None and not 1 <= int(warps) <= MAX_WARPS:
        raise ValueError(f"warps must lie in 1..{MAX_WARPS}, got {warps}")
    Q, R = int(gap_q), int(gap_r)
    check_gaps(Q, R)
    if max_abs is None:
        max_abs = interseq._max_abs(profiles)
    out_t = interseq.compute_dtype(dtype, max_abs, m, n_pad, Q, R)
    wide = out_t == torch.int64
    scores = torch.empty((P, B), dtype=out_t, device=dev)
    hi = torch.empty_like(scores)
    lo = torch.empty_like(scores)
    if P == 0 or B == 0:
        return scores, hi, lo
    lib = _lib()
    S = lib.k1_strip_rows(int(wide))
    if warps is None:
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        warps = choose_warps(B, P, -(-m // S), _sm_count(index))
    warps = int(warps)
    step = min(P, MAX_PAIRS_PER_LAUNCH)
    scratch_ptr = None
    if m > S * warps:  # rows cross a strip edge outside one block's warps
        per_pair = 2 * n_pad * B * scores.element_size()
        if scratch is not None:
            _check("scratch", scratch, torch.uint8, (scratch.numel(),), dev)
        if scratch is None or scratch.numel() < per_pair:
            scratch = torch.empty(
                min(P, max(1, SCRATCH_BUDGET // per_pair)) * per_pair,
                dtype=torch.uint8, device=dev,
            )
        step = min(step, scratch.numel() // per_pair)
        scratch_ptr = scratch.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for p0 in range(0, P, step):
            p1 = min(P, p0 + step)
            rc = lib.k1_interseq(
                profiles.data_ptr(), m, codes.data_ptr(), lengths.data_ptr(),
                n_pad, B, iq[p0:p1].data_ptr(), ic[p0:p1].data_ptr(),
                m_reals.data_ptr(), p1 - p0, Q, R, int(local),
                int(track_range), int(wide), warps, scores[p0:p1].data_ptr(),
                hi[p0:p1].data_ptr(), lo[p0:p1].data_ptr(), scratch_ptr,
                stream,
            )
            if rc != 0:
                raise RuntimeError(f"K1 launch failed: CUDA error {rc}")
            launches += 1
    return scores, hi, lo


def interseq_scores_cuda(
    profile: torch.Tensor,  # (m, 32) int32
    subjects_T: torch.Tensor,  # (n_pad, B) int8
    lengths: torch.Tensor,  # (B,) int32
    gap_q,
    gap_r,
    local: bool = True,
    use_matmul: bool = True,
    track_range: bool = False,
    dtype="int32",
    m_real: int | None = None,
    warps: int | None = None,
):
    """Drop-in for ``interseq.interseq_scores``: one query, one K1 launch
    (``warps`` as ``interseq_pairs_cuda``'s)."""
    if profile.device.type == "cpu":
        return interseq.interseq_scores(
            profile, subjects_T, lengths, gap_q, gap_r, local=local,
            use_matmul=use_matmul, track_range=track_range, dtype=dtype,
            m_real=m_real,
        )
    m = profile.shape[0]
    mr = m if m_real is None else int(m_real)
    if not 1 <= mr <= m:
        raise ValueError(f"m_real {mr} out of range for profile rows {m}")
    dev = profile.device
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    s, hi, lo = interseq_pairs_cuda(
        profile[None], subjects_T[None], lengths[None], zero, zero,
        torch.tensor([mr], dtype=torch.int32, device=dev), gap_q, gap_r,
        local=local, track_range=track_range, dtype=dtype, warps=warps,
    )
    return s[0], hi[0], lo[0]
