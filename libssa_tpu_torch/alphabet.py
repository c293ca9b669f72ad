"""Symbol translation: ASCII sequences -> internal integer codes.

TPU-native counterpart of the reference's ``src/util/util_sequence.c``
(SURVEY.md §2 "Symbol translation"; reference mount empty — behavior follows
the documented capabilities: map ASCII to internal codes for the nucleotide /
amino-acid alphabets, reverse-complement for REVERSE/BOTH strand search, and
genetic-code translation for translated search modes).

Internal code spaces
--------------------
* Amino acids: 24 codes in NCBI substitution-matrix order
  ``ARNDCQEGHILKMFPSTWYVBZX*`` (A=0 ... *=23). Unknown letters (including
  U=selenocysteine, O=pyrrolysine, J) map to X.
* Nucleotides: 15 IUPAC codes ``ACGTRYSWKMBDHVN`` (A=0 ... N=14); U maps to
  T, unknown letters map to N.

All translation is table-driven NumPy (vectorized ``np.take`` over uint8
views) so multi-megabyte databases translate at memory bandwidth.
"""
from __future__ import annotations

import numpy as np

from .constants import AA_ALPHABET, NT_ALPHABET, SymType

# ---------------------------------------------------------------------------
# Code tables
# ---------------------------------------------------------------------------

AA_CODES = {c: i for i, c in enumerate(AA_ALPHABET)}
NT_CODES = {c: i for i, c in enumerate(NT_ALPHABET)}
AA_X = AA_CODES["X"]
NT_N = NT_CODES["N"]


def _build_ascii_table(codes: dict, default: int, extra: dict) -> np.ndarray:
    table = np.full(256, default, dtype=np.uint8)
    for ch, code in codes.items():
        table[ord(ch)] = code
        table[ord(ch.lower())] = code
    for ch, code in extra.items():
        table[ord(ch)] = code
        table[ord(ch.lower())] = code
    return table


# U (Sec) and O (Pyl) and J (I/L) have no column in the classic NCBI matrices:
# map to X like BLAST does for unknowns.
_AA_TABLE = _build_ascii_table(AA_CODES, AA_X, {"U": AA_X, "O": AA_X, "J": AA_X})
_NT_TABLE = _build_ascii_table(NT_CODES, NT_N, {"U": NT_CODES["T"]})

# IUPAC complement in code space: A<->T, C<->G, R<->Y, S<->S, W<->W, K<->M,
# B<->V, D<->H, N<->N.
_NT_COMPLEMENT = np.array(
    [
        NT_CODES[c]
        for c in ["T", "G", "C", "A", "Y", "R", "S", "W", "M", "K", "V", "H", "D", "B", "N"]
    ],
    dtype=np.uint8,
)

# ---------------------------------------------------------------------------
# Translation
# ---------------------------------------------------------------------------


def encode(seq: str | bytes, symtype: SymType) -> np.ndarray:
    """ASCII sequence -> internal uint8 codes (whitespace/digits stripped)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    raw = np.frombuffer(seq, dtype=np.uint8)
    # Strip anything that is not a letter or '*' (FASTA bodies may contain
    # whitespace, digits, or '-' gaps; the reference strips these on read).
    letter = ((raw >= 65) & (raw <= 90)) | ((raw >= 97) & (raw <= 122)) | (raw == ord("*"))
    raw = raw[letter]
    table = _AA_TABLE if symtype is SymType.AMINOACID else _NT_TABLE
    return table[raw]


def decode(codes: np.ndarray, symtype: SymType) -> str:
    alpha = AA_ALPHABET if symtype is SymType.AMINOACID else NT_ALPHABET
    lut = np.frombuffer(alpha.encode(), dtype=np.uint8)
    return np.take(lut, codes).tobytes().decode("ascii")


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement a nucleotide code sequence (REVERSE/BOTH strands)."""
    return _NT_COMPLEMENT[codes][::-1].copy()


# ---------------------------------------------------------------------------
# Genetic-code translation (translated search modes)
# ---------------------------------------------------------------------------
# NCBI translation tables, given as the 64-codon amino-acid string in TTT,
# TTC, TTA, TTG, CTT, ... order (base order T, C, A, G — the NCBI standard).

_T1 = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"


def _variant(diffs: dict[str, str]) -> str:
    """Table 1 with codon -> amino-acid substitutions (codon in TCAG order)."""
    t = list(_T1)
    for codon, aa in diffs.items():
        i = _TCAG.index(codon[0]) * 16 + _TCAG.index(codon[1]) * 4 + _TCAG.index(codon[2])
        t[i] = aa
    return "".join(t)


_TCAG = "TCAG"
# The established NCBI translation tables, each expressed as its diffs
# from the standard code (safer than transcribing 64-char strings).
_NCBI_TABLES = {
    1: _T1,  # standard
    2: _variant({"AGA": "*", "AGG": "*", "ATA": "M", "TGA": "W"}),  # vertebrate mito
    3: _variant({"ATA": "M", "CTT": "T", "CTC": "T", "CTA": "T", "CTG": "T", "TGA": "W"}),  # yeast mito
    4: _variant({"TGA": "W"}),  # mold/protozoan/coelenterate mito
    5: _variant({"AGA": "S", "AGG": "S", "ATA": "M", "TGA": "W"}),  # invertebrate mito
    6: _variant({"TAA": "Q", "TAG": "Q"}),  # ciliate/dasycladacean
    9: _variant({"AAA": "N", "AGA": "S", "AGG": "S", "TGA": "W"}),  # echinoderm/flatworm mito
    10: _variant({"TGA": "C"}),  # euplotid
    11: _T1,  # bacterial/archaeal/plastid
    12: _variant({"CTG": "S"}),  # alternative yeast
    13: _variant({"AGA": "G", "AGG": "G", "ATA": "M", "TGA": "W"}),  # ascidian mito
    14: _variant({"AAA": "N", "AGA": "S", "AGG": "S", "TAA": "Y", "TGA": "W"}),  # alt flatworm mito
    16: _variant({"TAG": "L"}),  # chlorophycean mito
    21: _variant({"AAA": "N", "AGA": "S", "AGG": "S", "ATA": "M", "TGA": "W"}),  # trematode mito
    22: _variant({"TCA": "*", "TAG": "L"}),  # Scenedesmus mito
    23: _variant({"TTA": "*"}),  # Thraustochytrium mito
    24: _variant({"AGA": "S", "AGG": "K", "TGA": "W"}),  # Pterobranchia mito
    25: _variant({"TGA": "G"}),  # SR1/Gracilibacteria
}

_TCAG = "TCAG"
_NT_TO_TCAG = np.full(16, -1, dtype=np.int8)
for _i, _b in enumerate(_TCAG):
    _NT_TO_TCAG[NT_CODES[_b]] = _i


def genetic_code_table(gencode: int = 1) -> np.ndarray:
    """64-entry codon -> amino-acid-code table for an NCBI genetic code."""
    if gencode not in _NCBI_TABLES:
        raise ValueError(f"unsupported genetic code {gencode}; have {sorted(_NCBI_TABLES)}")
    aa = _NCBI_TABLES[gencode]
    return np.array([AA_CODES[c] for c in aa], dtype=np.uint8)


def translate(codes: np.ndarray, gencode: int = 1) -> np.ndarray:
    """Translate nucleotide codes (frame 0) into amino-acid codes.

    Codons containing ambiguity codes translate to X, matching the
    reference's handling of ambiguous bases in translated searches.
    """
    table = genetic_code_table(gencode)
    n = len(codes) // 3
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    tri = codes[: n * 3].reshape(n, 3)
    idx = _NT_TO_TCAG[tri]
    ambiguous = (idx < 0).any(axis=1)
    codons = np.where(ambiguous, 0, idx[:, 0] * 16 + idx[:, 1] * 4 + idx[:, 2])
    out = table[codons]
    out[ambiguous] = AA_X
    return out


def _segment_within(counts: np.ndarray, dtype=np.int64) -> np.ndarray:
    """Concatenated per-segment ``arange`` (0..c_i-1 for each count c_i).

    ``dtype`` lets large-DB callers use int32 indices — on hosts with slow
    first-touch page faults (util/hostmem.py) halving index bytes halves
    the dominant cost of the whole expansion.
    """
    counts = np.asarray(counts, dtype)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype)
    starts = np.cumsum(counts, dtype=dtype) - counts
    return np.arange(total, dtype=dtype) - np.repeat(starts, counts)


def translate_packed_six_frames(
    codes: np.ndarray,  # flat concatenated nucleotide codes
    offsets: np.ndarray,  # (R,) record start offsets
    lengths: np.ndarray,  # (R,) record lengths
    gencode: int = 1,
):
    """Six-frame translation of an entire packed nucleotide DB, vectorized.

    The per-record Python loop in round 1's ``api._search_db`` cost minutes
    at Swiss-Prot scale (VERDICT r1 missing #4); this runs a handful of
    whole-array NumPy passes instead. Entry order matches the reference's
    record-major convention: for each record, frames ``+0 +1 +2 -0 -1 -2``
    (empty frames skipped) — identical to the old loop, so hit ordering and
    tie-breaks are unchanged (locked by tests/test_api.py translated tests).

    Returns ``(aa_flat, entry_lengths, orig_ids, frame_idx)`` where
    ``frame_idx`` indexes ``("+0","+1","+2","-0","-1","-2")``.
    """
    table = genetic_code_table(gencode)
    # int32 indices when the EXPANDED six-frame array fits: the final
    # gather indexes F, whose length is ~2x len(codes) (six frames of
    # ~len/3 aa each), so the gate must cover 2*len(codes), not
    # len(codes) — otherwise DBs between ~2**30 and ~2**31 nt wrap
    # silently. On hosts with slow first-touch page faults
    # (util/hostmem.py) the expansion cost is dominated by index-array
    # bytes, so int32 halves it when safe.
    idt = np.int32 if 2 * len(codes) + 4 < 2**31 else np.int64
    offsets = np.asarray(offsets, idt)
    lengths = np.asarray(lengths, idt)
    R = len(lengths)
    tcag = _NT_TO_TCAG[codes]

    # Flat reverse-complement per record: complement, then reverse within
    # each record (index trick: o_i + L_i - 1 - j).
    comp = _NT_COMPLEMENT[codes]
    if len(codes):
        within = _segment_within(lengths, idt)
        rev_idx = np.repeat(offsets + lengths - 1, lengths)
        np.subtract(rev_idx, within, out=rev_idx)
        rc_tcag = _NT_TO_TCAG[comp[rev_idx]]
        del within, rev_idx, comp
    else:
        rc_tcag = tcag

    combo_flat = []
    combo_off = np.zeros((6, R), dtype=np.int64)
    K = np.zeros((6, R), dtype=np.int64)
    base = 0
    combo_bases = np.zeros(6, dtype=np.int64)
    for c in range(6):
        f = c % 3
        src = tcag if c < 3 else rc_tcag
        k = np.maximum(lengths - f, 0) // 3
        K[c] = k
        combo_off[c] = np.cumsum(k) - k
        combo_bases[c] = base
        pos = _segment_within(k, idt)
        np.multiply(pos, 3, out=pos)
        pos += np.repeat(offsets + f, k)
        i0 = src[pos]
        pos += 1
        i1 = src[pos]
        pos += 1
        i2 = src[pos]
        del pos
        amb = (i0 < 0) | (i1 < 0) | (i2 < 0)
        codons = i0.astype(np.int16)
        np.multiply(codons, 16, out=codons)
        codons += i1.astype(np.int16) * 4
        codons += i2
        codons[amb] = 0
        aa = table[codons]
        aa[amb] = AA_X
        del i0, i1, i2, codons, amb
        combo_flat.append(aa)
        base += len(aa)
    F = np.concatenate(combo_flat) if combo_flat else np.zeros(0, np.uint8)

    # Record-major entry assembly: (record, combo) pairs with K > 0, combos
    # in-order per record.
    k_rm = K.T.reshape(-1)  # (R*6,) record-major
    keep = k_rm > 0
    entry_k = k_rm[keep]
    rec_of_entry = np.repeat(np.arange(R, dtype=np.int64), 6)[keep]
    combo_of_entry = np.tile(np.arange(6, dtype=np.int64), R)[keep]
    src_start = (
        combo_bases[combo_of_entry]
        + combo_off[combo_of_entry, rec_of_entry]
    )
    gather = _segment_within(entry_k, idt)
    gather += np.repeat(src_start.astype(idt), entry_k)
    aa_flat = F[gather]
    return (
        aa_flat,
        entry_k.astype(np.int32),
        rec_of_entry.astype(np.int32),
        combo_of_entry.astype(np.int8),
    )


def six_frames(codes: np.ndarray, gencode: int = 1) -> list[np.ndarray]:
    """All six translated reading frames (3 forward, 3 reverse-complement)."""
    rc = reverse_complement(codes)
    return [translate(codes[f:], gencode) for f in range(3)] + [
        translate(rc[f:], gencode) for f in range(3)
    ]
