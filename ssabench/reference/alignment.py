"""Re-scoring a reported alignment from its edit path, in NumPy.

The path is a string of M (a query residue against a subject residue), D (a
query residue against a gap) and I (a subject residue against a gap), one
letter a column, or the same in run lengths ("12M3D"). A run of L gap
columns of one kind costs Q + R (L - 1).
"""
from __future__ import annotations

import re

import numpy as np

_RUN = re.compile(r"(\d*)([MID])")


def expand(cigar: str) -> np.ndarray | None:
    """The path as one byte a column, or None if it is malformed."""
    if not cigar:
        return np.zeros(0, dtype=np.uint8)
    if not any(ch.isdigit() for ch in cigar):
        if set(cigar) - set("MID"):
            return None
        return np.frombuffer(cigar.encode(), dtype=np.uint8)
    runs = _RUN.findall(cigar)
    if "".join(n + op for n, op in runs) != cigar:
        return None
    return np.frombuffer("".join(op * int(n or 1) for n, op in runs).encode(), dtype=np.uint8)


def rescore(q, s, sub, Q: int, R: int, q_begin: int, q_end: int, s_begin: int,
            s_end: int, cigar: str, local: bool) -> int | None:
    """The path's score, or None where it does not consume exactly
    ``q[q_begin:q_end]`` and ``s[s_begin:s_end]`` (for a global alignment,
    all of both)."""
    ops = expand(cigar)
    if ops is None:
        return None
    q, s = np.asarray(q), np.asarray(s)
    if not local and (q_begin, q_end, s_begin, s_end) != (0, len(q), 0, len(s)):
        return None
    if not (0 <= q_begin <= q_end <= len(q) and 0 <= s_begin <= s_end <= len(s)):
        return None
    m_col, d_col, i_col = ops == ord("M"), ops == ord("D"), ops == ord("I")
    if int((m_col | d_col).sum()) != q_end - q_begin or int((m_col | i_col).sum()) != s_end - s_begin:
        return None
    qi = q_begin + np.cumsum(m_col | d_col) - 1
    sj = s_begin + np.cumsum(m_col | i_col) - 1
    score = int(np.asarray(sub, dtype=np.int64)[q[qi[m_col]], s[sj[m_col]]].sum())
    for gap in (d_col, i_col):
        opens = int((gap & ~np.concatenate(([False], gap[:-1]))).sum())
        score -= opens * (Q - R) + int(gap.sum()) * R
    return score
