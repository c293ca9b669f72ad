"""Frozen scoring tables of the configurations: alphabets and matrices.

Codes are indexes into the letters below, the NCBI matrix order for amino
acids and ACGT for nucleotides. The benchmark makes its inputs as codes and
hands the same codes (or their letters) to the port and to the reference.
"""
from __future__ import annotations

import numpy as np

AA_LETTERS = "ARNDCQEGHILKMFPSTWYV"
NT_LETTERS = "ACGT"

# BLOSUM62 over the 20 standard amino acids (Henikoff and Henikoff 1992,
# NCBI's text), frozen here.
_BLOSUM62 = """
   A  R  N  D  C  Q  E  G  H  I  L  K  M  F  P  S  T  W  Y  V
A  4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0
R -1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3
N -2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3
D -2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3
C  0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1
Q -1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2
E -1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2
G  0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3
H -2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3
I -1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3
L -1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1
K -1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2
M -1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1
F -2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1
P -1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2
S  1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2
T  0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0
W -3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3
Y -2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1
V  0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4
"""


def _parse(text: str) -> np.ndarray:
    rows = [line.split() for line in text.strip().splitlines()]
    cols = rows[0]
    out = np.array([[int(v) for v in r[1:]] for r in rows[1:]], dtype=np.int32)
    if cols != [r[0] for r in rows[1:]] or "".join(cols) != AA_LETTERS:
        raise ValueError("BLOSUM62 text out of order")
    return out


MATRICES = {"BLOSUM62": _parse(_BLOSUM62)}


def substitution(scoring: dict) -> np.ndarray:
    """The (A, A) int32 table of a configuration's ``scoring`` entry:
    ``{"matrix": "BLOSUM62"}`` or ``{"match": 10, "mismatch": -8}`` over
    ACGT."""
    if "matrix" in scoring:
        return MATRICES[scoring["matrix"]].copy()
    a = len(NT_LETTERS)
    out = np.full((a, a), scoring["mismatch"], dtype=np.int32)
    np.fill_diagonal(out, scoring["match"])
    return out


def letters(symtype: str) -> str:
    return AA_LETTERS if symtype == "aminoacid" else NT_LETTERS


def decode(codes: np.ndarray, symtype: str) -> str:
    table = np.frombuffer(letters(symtype).encode(), dtype=np.uint8)
    return table[np.asarray(codes, dtype=np.intp)].tobytes().decode()


def gap_qr(gap_open: int, gap_extend: int, first_residue_opens: bool) -> tuple[int, int]:
    """(Q, R): a gap of length L costs Q + R (L - 1)."""
    return (gap_open + gap_extend if first_residue_opens else gap_open), gap_extend
