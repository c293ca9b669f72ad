"""Public enums and constants for the TPU-native sequence-alignment engine.

Mirrors the configuration surface of the reference library (libssa's
``libssa.h`` — see SURVEY.md Appendix B; the reference mount was empty at
survey time, so the exact C enum values are our own; the *semantics* follow
the documented libssa API: symbol type, strand selection, bit-width policy,
and score-only vs full-alignment compute modes).
"""
from __future__ import annotations

import enum


class SymType(enum.Enum):
    """Input sequence alphabet (reference: ``init_symbol_translation`` arg 1)."""

    NUCLEOTIDE = "nucleotide"
    AMINOACID = "aminoacid"


class Strand(enum.IntFlag):
    """Which strands of a nucleotide query to search.

    Reference: libssa's FORWARD/REVERSE/BOTH strand flags
    (``init_symbol_translation`` arg 2).
    """

    FORWARD = 1
    REVERSE = 2
    BOTH = 3


class BitWidth(enum.IntEnum):
    """Starting rung of the adaptive-precision ladder.

    The reference exposes 8/16/64-bit kernel entry points and automatically
    rescores overflowed subjects at the next width (SURVEY.md §2 P4). On TPU
    the fundamental VPU word is 32 bits, so our kernels compute exact int32
    scores and *emulate* the narrow-width overflow semantics by flagging any
    subject whose score (or intermediate score range) exceeds the width's
    representable limit; flagged subjects are re-scored at the next rung,
    preserving the reference pipeline's observable behavior (final scores are
    bit-identical either way). EXACT skips the ladder entirely — one exact
    pass (the fastest choice on TPU, and the default). BIT64 runs the TRUE
    64-bit device lane (r4): the whole sweep in s64 arithmetic — the slow
    correctness lane, like the reference's scalar 64-bit path (its first
    TPU compile takes minutes; see docs/PERF_NOTES.md "int64 lane").
    Every escape ladder terminates in that int64 rung, so even scores
    beyond int32 come back exact.
    """

    BIT8 = 8
    BIT16 = 16
    BIT64 = 64
    EXACT = 32  # TPU-native: single exact pass, no ladder.


# Score limits for ladder emulation. A width-w saturating kernel in the
# SWIPE lineage can represent scores up to its unsigned/signed max; a lane
# reaching the max is flagged for rescore (SURVEY.md Appendix A).
SCORE_LIMIT_8 = 255
SCORE_LIMIT_16 = 32767


class ComputeMode(enum.Enum):
    """Score-only search vs full alignment with traceback.

    Reference: COMPUTE_SCORE / COMPUTE_ALIGNMENT (SURVEY.md §3.2/§3.3).
    """

    SCORE = "score"
    ALIGNMENT = "alignment"


class AlignType(enum.Enum):
    """Local (Smith-Waterman) vs global (Needleman-Wunsch) alignment."""

    SW = "smith-waterman"
    NW = "needleman-wunsch"


class OutputMode(enum.IntEnum):
    """Logging verbosity (reference: ``set_output_mode``)."""

    SILENT = 0
    WARNING = 1
    INFO = 2


# Alphabet sizes, padded for the TPU kernels (profile matmul uses a
# lane-friendly padded alphabet dimension).
AA_ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX*"  # NCBI substitution-matrix order
NT_ALPHABET = "ACGTRYSWKMBDHVN"  # IUPAC; U maps to T
PADDED_ALPHABET = 32  # kernel-side padded alphabet dimension
