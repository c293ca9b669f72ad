"""The benchmark's plain translation (``ssabench/reference/translate.py``)
against the JAX package's and the port's: every codon of code 1, N, the
three offsets of both strands, reads whose length is no multiple of 3, the
reverse complement and the frozen BLOSUM62; then a small translated
``align_many`` of the port on the CPU against the reference's top 10."""
import numpy as np
import pytest
import torch

from libssa_tpu import alphabet as jax_alphabet
from libssa_tpu import constants as jax_constants
from libssa_tpu import matrices as jax_matrices
from libssa_tpu_torch import alphabet, api, matrices
from libssa_tpu_torch.constants import AlignType, BitWidth, ComputeMode, Strand, SymType
from libssa_tpu_torch.io.db import SequenceDB
from ssabench.reference import dp, scoring, translate

torch.set_num_threads(1)

CODONS = [a + b + c for a in "ACGT" for b in "ACGT" for c in "ACGT"]


SYNONYMS = {aa: [c for c in CODONS if translate.CODE_1[c] == aa] for aa in scoring.AA_LETTERS}


def ref_codes(seq: str) -> np.ndarray:
    return np.array([translate.READ_LETTERS.index(c) for c in seq], dtype=np.uint8)


def ref_letters(codes) -> str:
    return "".join(translate.PROTEIN_LETTERS[int(c)] for c in codes)


def port_letters(seq: str, gencode: int = 1) -> str:
    codes = alphabet.translate(alphabet.encode(seq, SymType.NUCLEOTIDE), gencode)
    return alphabet.decode(codes, SymType.AMINOACID)


def jax_letters(seq: str) -> str:
    nt = jax_constants.SymType.NUCLEOTIDE
    codes = jax_alphabet.translate(jax_alphabet.encode(seq, nt))
    return jax_alphabet.decode(codes, jax_constants.SymType.AMINOACID)


@pytest.mark.parametrize("codon", CODONS)
def test_every_codon_of_code_1(codon):
    want = translate.CODE_1[codon]
    assert ref_letters(translate.translate(ref_codes(codon))) == want
    assert port_letters(codon) == jax_letters(codon) == want


@pytest.mark.parametrize("at", range(3))
def test_a_codon_with_an_n_reads_as_x(at):
    for codon in ("ATG", "TAA", "GGC"):
        seq = codon[:at] + "N" + codon[at + 1:]
        assert ref_letters(translate.translate(ref_codes(seq))) == "X"
        assert port_letters(seq) == jax_letters(seq) == "X"


def test_reverse_complement():
    seq = "ACGTNNAACCGGTTACGTTGCA"
    ref = "".join(translate.READ_LETTERS[c]
                  for c in translate.reverse_complement(ref_codes(seq)))
    port = alphabet.decode(alphabet.reverse_complement(
        alphabet.encode(seq, SymType.NUCLEOTIDE)), SymType.NUCLEOTIDE)
    jnt = jax_constants.SymType.NUCLEOTIDE
    jax = jax_alphabet.decode(jax_alphabet.reverse_complement(
        jax_alphabet.encode(seq, jnt)), jnt)
    assert ref == port == jax == "TGCAACGTAACCGGTTNNACGT"


def contexts():
    """The port's and the JAX package's contexts, set up for blastx."""
    from libssa_tpu import api as jax_api

    port = api.SSAContext("cpu")
    port.init_symbol_translation(SymType.NUCLEOTIDE, Strand.BOTH, q_gencode=1, d_gencode=1,
                                 db_symtype=SymType.AMINOACID)
    port.init_score_matrix("BLOSUM62")
    ref = jax_api.SSAContext()
    ref.init_symbol_translation(jax_constants.SymType.NUCLEOTIDE, jax_constants.Strand.BOTH,
                                q_gencode=1, d_gencode=1,
                                db_symtype=jax_constants.SymType.AMINOACID)
    ref.init_score_matrix("BLOSUM62")
    return port, ref


@pytest.mark.parametrize("length", [3, 4, 5, 6, 7, 8, 31, 32, 33, 100])
def test_six_frames_at_every_offset(length):
    """Labels and letters of every frame, in order, with Ns and a length of
    each residue modulo 3 (frames shorter than a codon are left out)."""
    port, ref = contexts()
    rng = np.random.default_rng(length)
    for _ in range(4):
        seq = "".join(rng.choice(list("ACGTACGTACGTN"), length))
        want = [(label, ref_letters(aa)) for label, aa in translate.frames(ref_codes(seq))]
        got = [(label, alphabet.decode(aa, SymType.AMINOACID))
               for label, aa in port._search_sequences(port.init_sequence_fasta(seq))]
        jax = [(label, jax_alphabet.decode(aa, jax_constants.SymType.AMINOACID))
               for label, aa in ref._search_sequences(ref.init_sequence_fasta(seq))]
        assert got == jax == want
        assert [label for label, _ in want] == [
            lab for lab in translate.LABELS if int(lab[1]) + 3 <= length]


def test_frozen_blosum62_equals_the_packages():
    assert (translate.substitution() == matrices.builtin("BLOSUM62").scores).all()
    assert (translate.substitution() == np.asarray(jax_matrices.builtin("BLOSUM62").scores)).all()
    # the 20 standard letters as the protein cells' table has them
    assert (translate.substitution()[:20, :20] == scoring.MATRICES["BLOSUM62"]).all()


def test_translated_align_many_equals_the_reference():
    """Hits, scores and frame labels of ``align_many`` (SW, SCORE, BIT8,
    k = 10) against the reference's top 10 of each read's best frames."""
    rng = np.random.default_rng(2026)
    lengths = rng.integers(30, 70, 60)
    offsets = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    codes = rng.integers(0, 20, int(lengths.sum())).astype(np.uint8)
    port, _ = contexts()
    port.init_gap_penalties(11, 1, first_residue_opens=True)
    port.db = SequenceDB(codes, offsets, lengths, [f"e{i}" for i in range(60)],
                         SymType.AMINOACID)
    reads = []
    for j in range(6):  # homologs of entries on both strands, at each offset, and noise
        e = codes[offsets[j]: offsets[j] + lengths[j]]
        syn = [SYNONYMS[scoring.AA_LETTERS[a]] for a in e]
        nt = "".join(s[rng.integers(0, len(s))] for s in syn)
        nt = "ACG"[: j % 3] + nt + "TTNA"[: j % 4]
        if j % 2:
            nt = "".join(translate.READ_LETTERS[c]
                         for c in translate.reverse_complement(ref_codes(nt)))
        reads.append(nt)
    reads.append("".join(rng.choice(list("ACGT"), 101)))
    got = port.align_many([port.init_sequence_fasta(r) for r in reads], k=10,
                          mode=ComputeMode.SCORE, align_type=AlignType.SW,
                          bit_width=BitWidth.BIT8)
    db = dp.Database(codes, offsets, lengths, 24, "cpu")
    Q, R = scoring.gap_qr(11, 1, True)
    for j, (read, hl) in enumerate(zip(reads, got)):
        fr = translate.frames(ref_codes(read))
        scores = db.scores([aa for _, aa in fr], translate.substitution(), Q, R, True)
        best, label = translate.best_frames(scores, [lab for lab, _ in fr])
        want = [(i, s, label[i]) for i, s in dp.top_hits(best, 10)]
        assert [(h.seq_id, h.score, h.strand) for h in hl.hits] == want
        if j < 6:  # the homolog's entry first, in the frame it was written in
            assert want[0][:1] == (j,) and want[0][2] == ("-" if j % 2 else "+") + str(j % 3)
