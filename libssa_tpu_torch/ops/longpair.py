"""Single enormous-pair SW/NW scoring: routing, plain version and bounds.

The port of ``libssa_tpu/ops/longpair.py``. ``longpair_score`` is the
1-vs-1 score of one (possibly genome-scale) pair: on CUDA tensors it runs
K3 (``csrc/longpair.cu`` through ``longpair_cuda``), on the CPU the plain
PyTorch row sweep ``longpair_score_plain``. Both compute exactly in int32,
or in int64 where ``score_bound`` reaches 2**31 - 1.

The TPU routing is not ported: there is no f32 window, no bf16 limit on
matrix entries, and no switch to a tiled kernel for tall queries, because
K3 keeps its per-row state in registers and has no cap on m or n.
"""
from __future__ import annotations

import numpy as np
import torch

from ..util.profiling import span
from .interseq import INT32_LIMIT


def real_max_abs(matrix: np.ndarray) -> tuple[int, bool]:
    """(max |substitution score| over REAL symbols, had_pad_rows).

    Accepts the raw score table OR a kernel-padded one (``Matrix.padded``
    fills unused rows/cols with -64): uniform pad rows are stripped so the
    fill value doesn't masquerade as a real score.
    """
    matrix = np.asarray(matrix)
    fill = matrix[-1, -1]
    real_rows = ~np.all(matrix == fill, axis=1)
    padded = bool(real_rows.any() and not real_rows.all())
    if padded:
        a = int(np.nonzero(real_rows)[0].max()) + 1
        matrix = matrix[:a, :a]
    return int(np.abs(matrix).max()), padded


def score_bound(m: int, n: int, matrix: np.ndarray, Q: int, R: int) -> int:
    """A-priori bound on |H| anywhere in the DP (f32-window precheck).

    The -64 pad fill is stripped from the max. Pad CELLS do participate in
    the padded sweeps' DP, but a pad run only adds ``64 * run`` magnitude
    and runs are bounded by the sweeps' pad multiples (<= 256 rows + 512
    cols); a flat slack covers them.
    """
    mx, padded = real_max_abs(matrix)
    pad_slack = 64 * 1024 if padded else 0  # > 64 * max pad run, any kernel
    return min(m, n) * mx + Q + max(m, n) * R + pad_slack


def subject_profile(s_codes: np.ndarray, matrix_padded: np.ndarray) -> np.ndarray:
    """(A, n) substitution profile of the SUBJECT: P[a, j] = sub(a, s[j])."""
    return np.asarray(matrix_padded)[:, np.asarray(s_codes, np.intp)]


def longpair_score_plain(
    q: torch.Tensor,  # (m,) integer codes, m >= 1
    s: torch.Tensor,  # (n,) integer codes, n >= 1
    matrix_padded: torch.Tensor,  # (32, 32) integer substitution scores
    Q: int,
    R: int,
    local: bool = True,
    dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    """Exact SW/NW score of one pair as a 0-dim ``dtype`` tensor.

    The row sweep of the reference's ``_row_sweep``: one query row per
    step, F elementwise against the previous row, the diagonal as one
    shift, and the within-row E by the lazy prefix identity
    E[j] = max_{k<j}(Hnof[k] + k R) - Q - (j - 1) R, with ``torch.cummax``
    over ``Hnof`` (H before E; exact since Q >= R) and the column-0
    boundary as k = 0. Nothing is padded. Each row costs about a dozen
    tensor ops on (n,) vectors, wherever the tensors lie.
    """
    if dtype not in (torch.int32, torch.int64):
        raise ValueError(f"unsupported DP dtype {dtype!r}")
    dev = s.device
    m, n = q.shape[0], s.shape[0]
    if m == 0 or n == 0:
        raise ValueError("use longpair_score for empty inputs")
    prof = matrix_padded.to(device=dev, dtype=dtype)[:, s.long()]  # (32, n)
    kR = torch.arange(n + 1, device=dev, dtype=dtype) * R
    if local:
        H = torch.zeros(n + 1, device=dev, dtype=dtype)
    else:
        H = torch.cat([torch.zeros(1, device=dev, dtype=dtype), -(Q + kR[:-1])])
    F = H[1:] - Q + R  # so that row 1's F is H[0][j] - Q exactly
    W = torch.empty(n + 1, device=dev, dtype=dtype)
    best = torch.zeros(n, device=dev, dtype=dtype)
    for i, qi in enumerate(q.tolist()):
        F = torch.maximum(F - R, H[1:] - Q)
        Hnof = torch.maximum(H[:-1] + prof[qi], F)
        if local:
            Hnof.clamp_(min=0)
        W[0] = 0 if local else -(Q + i * R)  # H[i+1][0]
        torch.add(Hnof, kR[1:], out=W[1:])
        E = torch.cummax(W, dim=0).values[:-1] - Q - kR[:-1]
        H = W.clone()
        torch.maximum(Hnof, E, out=H[1:])
        if local:
            torch.maximum(best, H[1:], out=best)
    return best.max() if local else H[n]


def longpair_score(
    q_codes: np.ndarray,
    s_codes: np.ndarray,
    matrix_padded: np.ndarray,
    gap_open: int,
    gap_extend: int,
    local: bool = True,
    first_residue_opens: bool = True,
    kernel: str = "auto",
    device="cuda",
    stats=None,
) -> int:
    """Host convenience: exact SW/NW score of one (possibly huge) pair.

    ``kernel``: "auto"/"cuda" runs K3's wrapper, which launches K3 on a
    CUDA ``device`` (or raises) and runs the plain version on the CPU;
    "plain" runs the plain version on ``device``. Empty inputs are
    answered on the host. ``stats``: the request's ``SearchStats``, which
    gets the ``longpair.score`` span and its waits on the device.
    """
    from ..oracle import gap_qr

    with span(stats, "longpair.score"):
        Q, R = gap_qr(gap_open, gap_extend, first_residue_opens)
        m, n = len(q_codes), len(s_codes)
        if m == 0 or n == 0:
            if local:
                return 0
            lm = max(m, n)
            return 0 if lm == 0 else -(Q + (lm - 1) * R)

        if kernel not in ("auto", "cuda", "plain"):
            raise ValueError(f"unknown kernel {kernel!r} (auto | cuda | plain)")
        dt = (torch.int32 if score_bound(m, n, matrix_padded, Q, R) < INT32_LIMIT
              else torch.int64)
        dev = torch.device(device)
        q = torch.as_tensor(np.asarray(q_codes, np.uint8)).to(dev)
        s = torch.as_tensor(np.asarray(s_codes, np.uint8)).to(dev)
        mat = torch.as_tensor(np.asarray(matrix_padded, np.int32)).to(dev)
        if kernel == "plain":
            result = longpair_score_plain(q, s, mat, Q, R, local=local, dtype=dt)
        else:
            from .longpair_cuda import longpair_score_cuda

            result = longpair_score_cuda(q, s, mat, Q, R, local=local, dtype=dt,
                                         stats=stats)
        with span(stats, "device.wait"):
            return int(result)
