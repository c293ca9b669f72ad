"""Translated search in plain NumPy: six reading frames and their best.

A read is nucleotide codes over ``READ_LETTERS`` (ACGT and N). Its six
frames are, in this order, ``+0 +1 +2`` (the read from its first, second
and third base) and ``-0 -1 -2`` (the same of its reverse complement), each
translated by NCBI genetic code 1 with the trailing partial codon dropped;
a codon that holds an N reads as X, and an empty frame is left out.
Protein codes index ``PROTEIN_LETTERS``, NCBI's matrix order, whose first 20
are ``scoring.AA_LETTERS``, so database codes need no change.

An entry's score is the best of the read's frames against it, the first
listed frame winning ties; the frames are scored side by side by
``dp.Database.scores``.
"""
from __future__ import annotations

import numpy as np

READ_LETTERS = "ACGTN"
N = READ_LETTERS.index("N")
PROTEIN_LETTERS = "ARNDCQEGHILKMFPSTWYVBZX*"
X = PROTEIN_LETTERS.index("X")
LABELS = ("+0", "+1", "+2", "-0", "-1", "-2")

# NCBI genetic code 1, the standard code, codon by codon.
CODE_1 = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": "*", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}

# BLOSUM62 with B, Z, X and * (NCBI's text), frozen here.
_BLOSUM62 = """
   A  R  N  D  C  Q  E  G  H  I  L  K  M  F  P  S  T  W  Y  V  B  Z  X  *
A  4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0 -4
R -1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1 -4
N -2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1 -4
D -2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1 -4
C  0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2 -4
Q -1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1 -4
E -1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
G  0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -4
H -2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1 -4
I -1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1 -4
L -1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1 -4
K -1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1 -4
M -1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1 -4
F -2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1 -4
P -1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2 -4
S  1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0 -4
T  0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0 -4
W -3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2 -4
Y -2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1 -4
V  0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1 -4
B -2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1 -4
Z -1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
X  0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1 -4
* -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4  1
"""


def _parse(text: str) -> np.ndarray:
    rows = [line.split() for line in text.strip().splitlines()]
    cols = rows[0]
    if cols != [r[0] for r in rows[1:]] or "".join(cols) != PROTEIN_LETTERS:
        raise ValueError("BLOSUM62 text out of order")
    return np.array([[int(v) for v in r[1:]] for r in rows[1:]], dtype=np.int32)


BLOSUM62 = _parse(_BLOSUM62)
# Codon index 16 a + 4 b + c over ACGT codes -> protein code.
_TABLE = np.array([PROTEIN_LETTERS.index(CODE_1[a + b + c])
                   for a in "ACGT" for b in "ACGT" for c in "ACGT"], dtype=np.uint8)
_COMPLEMENT = np.array([READ_LETTERS.index(c) for c in "TGCAN"], dtype=np.uint8)


def substitution() -> np.ndarray:
    """The (24, 24) int32 BLOSUM62 over ``PROTEIN_LETTERS``."""
    return BLOSUM62.copy()


def reverse_complement(read: np.ndarray) -> np.ndarray:
    return _COMPLEMENT[np.asarray(read, dtype=np.intp)][::-1].copy()


def translate(nt: np.ndarray) -> np.ndarray:
    """Protein codes of ``nt`` read from its first base, whole codons only."""
    n = len(nt) // 3
    tri = np.asarray(nt[: 3 * n], dtype=np.int64).reshape(n, 3)
    out = _TABLE[np.minimum(tri, 3) @ np.array([16, 4, 1])]
    out[(tri == N).any(axis=1)] = X
    return out


def frames(read: np.ndarray) -> list[tuple[str, np.ndarray]]:
    """The read's non-empty frames as (label, protein codes), in ``LABELS``'s order."""
    rc = reverse_complement(read)
    out = [(f"+{f}", translate(read[f:])) for f in range(3)]
    out += [(f"-{f}", translate(rc[f:])) for f in range(3)]
    return [(label, aa) for label, aa in out if len(aa)]


def best_frames(scores: np.ndarray, labels: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """Each entry's best score over the frames' rows of ``scores`` (F, n),
    and the label of the first frame that reaches it."""
    first = np.argmax(scores, axis=0)  # the first of the maxima
    return scores.max(axis=0), np.asarray(labels)[first]
