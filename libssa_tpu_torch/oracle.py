"""Scalar Gotoh affine-gap alignment oracle (NumPy, int64).

This is the engine's independent correctness anchor (SURVEY.md §4: the
reference tests its SIMD kernels against its 64-bit scalar path; we replicate
that oracle pattern with a pure-NumPy implementation that every TPU kernel is
tested against bit-exactly). It also serves as the terminal "64-bit" rung of
the adaptive-precision ladder semantics: int64 cannot overflow for any
realistic sequence.

Gap model
---------
A gap of length L costs ``gap_open + L * gap_extend`` (BLAST-style: the open
penalty is charged once at gap creation, every gapped residue including the
first also pays the extension penalty). In the Gotoh recurrences this means
Q = gap_open + gap_extend is subtracted when opening and R = gap_extend when
extending (SURVEY.md Appendix A; the appendix notes both conventions exist in
the SWIPE/SWARM family — this module exposes the raw (Q, R) form so either
convention is reachable: libssa-style "open includes first extension" is
Q = open, R = extend, available via ``first_residue_opens=False``).

Recurrences (Appendix A):
    E[i][j] = max(E[i][j-1] - R, H[i][j-1] - Q)     # gap in query
    F[i][j] = max(F[i-1][j] - R, H[i-1][j] - Q)     # gap in subject
    H[i][j] = max(H[i-1][j-1] + sub(q[i], s[j]), E[i][j], F[i][j])
    SW: additionally H >= 0; score = max cell.  NW: score = H[m][n].
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NEG = np.int64(-(2**62))  # effective -infinity, safe from int64 underflow


def gap_qr(gap_open: int, gap_extend: int, first_residue_opens: bool = True) -> tuple[int, int]:
    """Map a (gap_open, gap_extend) pair to Gotoh (Q, R) penalties."""
    if gap_open < 0 or gap_extend < 0:
        raise ValueError("gap penalties are magnitudes and must be >= 0")
    q = gap_open + gap_extend if first_residue_opens else gap_open
    if q < gap_extend:
        raise ValueError("gap open cost must be >= gap extend cost")
    return q, gap_extend


def _dp_matrices(
    q: np.ndarray, s: np.ndarray, sub: np.ndarray, Q: int, R: int, local: bool
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full H, E, F matrices, shape (m+1, n+1). Row/col 0 are boundaries."""
    m, n = len(q), len(s)
    H = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    E = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    F = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    H[0, 0] = 0
    for j in range(1, n + 1):
        H[0, j] = 0 if local else -(Q + (j - 1) * R)
    for i in range(1, m + 1):
        H[i, 0] = 0 if local else -(Q + (i - 1) * R)
    subq = sub[np.asarray(q, dtype=np.intp)]  # (m, A) row view per query pos
    for i in range(1, m + 1):
        row = subq[i - 1]
        for j in range(1, n + 1):
            E[i, j] = max(E[i, j - 1] - R, H[i, j - 1] - Q)
            F[i, j] = max(F[i - 1, j] - R, H[i - 1, j] - Q)
            h = max(H[i - 1, j - 1] + row[s[j - 1]], E[i, j], F[i, j])
            H[i, j] = max(h, 0) if local else h
    return H, E, F


def sw_score(q, s, sub, gap_open: int, gap_extend: int, first_residue_opens=True) -> int:
    """Smith-Waterman local alignment score (empty alignment scores 0)."""
    Q, R = gap_qr(gap_open, gap_extend, first_residue_opens)
    if len(q) == 0 or len(s) == 0:
        return 0
    H, _, _ = _dp_matrices(q, s, np.asarray(sub), Q, R, local=True)
    return int(H.max())


def nw_score(q, s, sub, gap_open: int, gap_extend: int, first_residue_opens=True) -> int:
    """Needleman-Wunsch global alignment score."""
    Q, R = gap_qr(gap_open, gap_extend, first_residue_opens)
    m, n = len(q), len(s)
    if m == 0 and n == 0:
        return 0
    if m == 0 or n == 0:
        return -(Q + (max(m, n) - 1) * R)
    H, _, _ = _dp_matrices(q, s, np.asarray(sub), Q, R, local=False)
    return int(H[m, n])


# ---------------------------------------------------------------------------
# Traceback (COMPUTE_ALIGNMENT parity — SURVEY.md §3.3)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Traceback:
    """One optimal alignment with coordinates and an edit path.

    ``cigar`` uses M (match/mismatch), I (insertion: subject residue vs gap
    in query), D (deletion: query residue vs gap in subject). Coordinates are
    0-based half-open ranges into query/subject.
    """

    score: int
    q_begin: int
    q_end: int
    s_begin: int
    s_end: int
    cigar: str

    def aligned_strings(self, q: np.ndarray, s: np.ndarray, decode_fn) -> tuple[str, str, str]:
        """Render (query_row, midline, subject_row) for display.

        ``decode_fn`` maps a code array to one ASCII character a code. It is
        called once a row, on the aligned span of each sequence; the letters
        are scattered into the columns that consume a residue (``M`` and
        ``D`` for the query, ``M`` and ``I`` for the subject), with ``-`` in
        the rest. The midline is ``|`` where an ``M`` column pairs equal
        letters and a space elsewhere.
        """
        if not self.cigar:
            return "", "", ""
        ops = np.frombuffer(self.cigar.encode("ascii"), np.uint8)
        top = _display_row(
            decode_fn(q[self.q_begin : self.q_end]),
            (ops == ord("M")) | (ops == ord("D")), "query",
        )
        bot = _display_row(
            decode_fn(s[self.s_begin : self.s_end]), ops != ord("D"), "subject"
        )
        mid = np.full(len(ops), ord(" "), np.uint8)
        mid[(ops == ord("M")) & (top == bot)] = ord("|")
        return tuple(row.tobytes().decode("ascii") for row in (top, mid, bot))


def _display_row(letters: str, takes: np.ndarray, name: str) -> np.ndarray:
    """One display row as bytes: ``letters`` in the ``takes`` columns, ``-`` elsewhere."""
    got = np.frombuffer(letters.encode("ascii"), np.uint8)
    need = int(np.count_nonzero(takes))
    if len(got) != need:
        raise ValueError(
            f"the {name} span decodes to {len(got)} letters, but the cigar "
            f"consumes {need}"
        )
    row = np.full(len(takes), ord("-"), np.uint8)
    row[takes] = got
    return row


def _traceback_from(
    H, E, F, q, s, sub, Q: int, R: int, i: int, j: int, local: bool
) -> Traceback:
    """Walk back from cell (i, j). Deterministic tie-break: M > D > I
    (diagonal preferred, then gap-in-subject), matching a fixed canonical
    path so results are reproducible across backends."""
    ops: list[str] = []
    score = int(H[i, j])
    state = "H"
    while i > 0 or j > 0:
        if state == "H":
            h = H[i, j]
            if local and h == 0:
                break
            if i > 0 and j > 0 and h == H[i - 1, j - 1] + sub[q[i - 1], s[j - 1]]:
                ops.append("M")
                i -= 1
                j -= 1
            elif i > 0 and h == F[i, j]:
                state = "F"
            elif j > 0 and h == E[i, j]:
                state = "E"
            elif not local and j == 0:
                ops.append("D")
                i -= 1
            elif not local and i == 0:
                ops.append("I")
                j -= 1
            else:  # pragma: no cover - would indicate a DP bug
                raise AssertionError("traceback dead end")
        elif state == "F":  # gap in subject, consuming query rows
            ops.append("D")
            came_open = F[i, j] == H[i - 1, j] - Q  # prefer closing on ties
            i -= 1
            state = "H" if came_open else "F"
        else:  # state == "E": gap in query, consuming subject cols
            ops.append("I")
            came_open = E[i, j] == H[i, j - 1] - Q
            j -= 1
            state = "H" if came_open else "E"
    return Traceback(
        score=score,
        q_begin=i,
        q_end=i + sum(1 for o in ops if o in "MD"),
        s_begin=j,
        s_end=j + sum(1 for o in ops if o in "MI"),
        cigar="".join(reversed(ops)),
    )


def sw_align(q, s, sub, gap_open: int, gap_extend: int, first_residue_opens=True) -> Traceback:
    """Smith-Waterman with traceback of one optimal local alignment."""
    Q, R = gap_qr(gap_open, gap_extend, first_residue_opens)
    q = np.asarray(q)
    s = np.asarray(s)
    sub = np.asarray(sub)
    if len(q) == 0 or len(s) == 0:
        return Traceback(0, 0, 0, 0, 0, "")
    H, E, F = _dp_matrices(q, s, sub, Q, R, local=True)
    i, j = np.unravel_index(int(H.argmax()), H.shape)
    return _traceback_from(H, E, F, q, s, sub, Q, R, int(i), int(j), local=True)


def nw_align(q, s, sub, gap_open: int, gap_extend: int, first_residue_opens=True) -> Traceback:
    """Needleman-Wunsch with traceback of one optimal global alignment."""
    Q, R = gap_qr(gap_open, gap_extend, first_residue_opens)
    q = np.asarray(q)
    s = np.asarray(s)
    sub = np.asarray(sub)
    m, n = len(q), len(s)
    if m == 0 or n == 0:
        score = 0 if m == n else -(Q + (max(m, n) - 1) * R)
        return Traceback(score, 0, m, 0, n, "D" * m + "I" * n)
    H, E, F = _dp_matrices(q, s, sub, Q, R, local=False)
    return _traceback_from(H, E, F, q, s, sub, Q, R, m, n, local=False)


def score_matrix_scores(q, db_seqs, sub, gap_open, gap_extend, local=True) -> np.ndarray:
    """Score one query against a list of subjects (oracle database sweep)."""
    fn = sw_score if local else nw_score
    return np.array(
        [fn(q, s, sub, gap_open, gap_extend) for s in db_seqs], dtype=np.int64
    )
