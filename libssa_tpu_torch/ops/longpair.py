"""Score bounds shared by the search paths (NumPy, no device work).

The long-pair scorer itself (``libssa_tpu/ops/longpair.py``'s
``longpair_score`` and its kernels) has not been ported yet; these two
helpers are what the search engine needs from that module.
"""
from __future__ import annotations

import numpy as np


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
