"""The port's own copies of the JAX package's framework-neutral modules.

The port imports nothing of ``libssa_tpu``; it keeps copies of the modules
it needs (constants, alphabets, matrices, the oracle, FASTA and the packed
database, profiles, host top-k, the aligners, the CLI's output). Each copy
must give its original's results on the same inputs: every builtin matrix,
encoding and translation, oracle scores and alignments, the packing of
``tests/testdata``, profiles and top-k. Tolerance: exact equality.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from libssa_tpu import alphabet as j_alphabet
from libssa_tpu import cli as j_cli
from libssa_tpu import constants as j_constants
from libssa_tpu import matrices as j_matrices
from libssa_tpu import oracle as j_oracle
from libssa_tpu.io import db as j_db
from libssa_tpu.io import fasta as j_fasta
from libssa_tpu.ops import scoring as j_scoring
from libssa_tpu.ops import topk as j_topk
from libssa_tpu.search import aligner as j_aligner
from libssa_tpu_torch import alphabet, cli, constants, matrices, oracle
from libssa_tpu_torch.io import db, fasta
from libssa_tpu_torch.ops import scoring, topk
from libssa_tpu_torch.search import aligner

TESTDATA = Path(__file__).parent / "testdata"


def _ref(member):
    return getattr(j_constants, type(member).__name__)[member.name]


def test_constants_match():
    for name in ("SymType", "Strand", "BitWidth", "ComputeMode", "AlignType", "OutputMode"):
        mine, theirs = getattr(constants, name), getattr(j_constants, name)
        assert mine is not theirs  # the port's own class
        assert [(m.name, m.value) for m in mine] == [(m.name, m.value) for m in theirs]
    for name in ("AA_ALPHABET", "NT_ALPHABET", "PADDED_ALPHABET", "SCORE_LIMIT_8",
                 "SCORE_LIMIT_16"):
        assert getattr(constants, name) == getattr(j_constants, name)


@pytest.mark.parametrize("name", matrices.BUILTIN_NAMES)
def test_builtin_matrices_match(name):
    mine, theirs = matrices.builtin(name), j_matrices.builtin(name)
    assert matrices.BUILTIN_NAMES == j_matrices.BUILTIN_NAMES
    assert mine.symtype.name == theirs.symtype.name
    np.testing.assert_array_equal(mine.scores, theirs.scores)
    np.testing.assert_array_equal(mine.padded(), theirs.padded())


def test_constant_scoring_and_matrix_files_match(tmp_path):
    for st in constants.SymType:
        np.testing.assert_array_equal(
            matrices.constant_scoring(5, -4, st).padded(),
            j_matrices.constant_scoring(5, -4, _ref(st)).padded())
    path = tmp_path / "m.txt"
    path.write_text("   A  C\nA  3 -2\nC -2  4\n")
    np.testing.assert_array_equal(matrices.from_file(str(path)).scores,
                                  j_matrices.from_file(str(path)).scores)
    for bad in ("BLOSUM999",):
        with pytest.raises(ValueError):
            matrices.builtin(bad)


def test_alphabet_matches():
    rng = np.random.default_rng(1)
    aa = "".join(rng.choice(list("ARNDCQEGHILKMFPSTWYVBZXUOJ*acdx"), 300))
    nt = "".join(rng.choice(list("ACGTUNRYacgtn"), 301))
    for seq, st in ((aa, constants.SymType.AMINOACID), (nt, constants.SymType.NUCLEOTIDE)):
        codes = alphabet.encode(seq, st)
        np.testing.assert_array_equal(codes, j_alphabet.encode(seq, _ref(st)))
        assert alphabet.decode(codes, st) == j_alphabet.decode(codes, _ref(st))
    codes = alphabet.encode(nt, constants.SymType.NUCLEOTIDE)
    np.testing.assert_array_equal(alphabet.reverse_complement(codes),
                                  j_alphabet.reverse_complement(codes))
    for gencode in (1, 2, 11):
        np.testing.assert_array_equal(alphabet.translate(codes, gencode),
                                      j_alphabet.translate(codes, gencode))
        for a, b in zip(alphabet.six_frames(codes, gencode),
                        j_alphabet.six_frames(codes, gencode)):
            np.testing.assert_array_equal(a, b)


def test_oracle_matches():
    rng = np.random.default_rng(2)
    sub = matrices.builtin("BLOSUM62").scores
    for _ in range(6):
        q = rng.integers(0, 20, int(rng.integers(1, 60))).astype(np.uint8)
        s = rng.integers(0, 20, int(rng.integers(1, 60))).astype(np.uint8)
        for fro in (True, False):
            assert oracle.gap_qr(10, 1, fro) == j_oracle.gap_qr(10, 1, fro)
            for fn in ("sw_score", "nw_score"):
                assert getattr(oracle, fn)(q, s, sub, 10, 1, fro) == getattr(j_oracle, fn)(
                    q, s, sub, 10, 1, fro)
            for fn in ("sw_align", "nw_align"):
                a, b = getattr(oracle, fn)(q, s, sub, 10, 1, fro), getattr(j_oracle, fn)(
                    q, s, sub, 10, 1, fro)
                assert (a.score, a.q_begin, a.q_end, a.s_begin, a.s_end, a.cigar) == (
                    b.score, b.q_begin, b.q_end, b.s_begin, b.s_end, b.cigar)
            # The full-matrix aligner below MATRIX_CELL_LIMIT.
            for local in (True, False):
                a = aligner.align_pair(q, s, sub, 10, 1, local, fro)
                b = j_aligner.align_pair(q, s, sub, 10, 1, local, fro)
                assert (a.score, a.cigar, a.q_begin, a.s_begin) == (
                    b.score, b.cigar, b.q_begin, b.s_begin)
    assert aligner.MATRIX_CELL_LIMIT == j_aligner.MATRIX_CELL_LIMIT


AA, NT = constants.SymType.AMINOACID, constants.SymType.NUCLEOTIDE
# The human and chimpanzee mitochondrial genomes' lengths, and a count of
# paired columns that gives their NW alignment 16,632 columns in all.
MITO_M, MITO_N, MITO_MATCHED = 16569, 16554, 16491


def _decoders(st, folded):
    """Each package's own ``alphabet.decode``; ``folded`` first maps every
    code past the standard residues (B, Z, X, * or the IUPAC ambiguity
    codes) to X or N, so that two different codes decode to one letter."""
    first, to = (20, alphabet.AA_X) if st is AA else (4, alphabet.NT_N)
    fold = (lambda c: np.where(c >= first, to, c)) if folded else (lambda c: c)
    return (lambda c: alphabet.decode(fold(c), st),
            lambda c: j_alphabet.decode(fold(c), _ref(st)))


def _planted_pair(rng, top):
    """A query and a subject that share a mutated core with one indel between
    random flanks, so that a local alignment begins inside both."""
    core = rng.integers(0, top, 40)
    mutated = np.where(rng.random(40) < 0.15, rng.integers(0, top, 40), core)
    mutated = np.concatenate([mutated[:12], mutated[14:25], rng.integers(0, top, 2), mutated[25:]])
    flank = lambda: rng.integers(0, top, int(rng.integers(8, 16)))
    q = np.concatenate([flank(), core, flank()]).astype(np.uint8)
    s = np.concatenate([flank(), mutated, flank()]).astype(np.uint8)
    return q, s


def _mito_cigar(rng):
    """A drawn NW cigar at the mitochondrial pair's lengths: 16,632 columns."""
    ops = np.array(list("M" * MITO_MATCHED + "D" * (MITO_M - MITO_MATCHED)
                        + "I" * (MITO_N - MITO_MATCHED)))
    return "".join(rng.permutation(ops))


def _display_case(name):
    """(symtype, query, subject, the port's Traceback, the reference's
    Traceback, whether codes are folded) of one display case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    kind, _, alpha = name.partition("-")
    st = AA if alpha == "aa" else NT
    top = len(constants.AA_ALPHABET if st is AA else constants.NT_ALPHABET)
    if kind in ("sw", "nw"):
        q, s = _planted_pair(rng, top)
        sub = (matrices.builtin("BLOSUM62") if st is AA
               else matrices.constant_scoring(5, -4, NT)).scores
        fn = f"{kind}_align"
        mine, theirs = getattr(oracle, fn)(q, s, sub, 10, 1), getattr(j_oracle, fn)(q, s, sub, 10, 1)
        if kind == "sw":
            assert mine.q_begin > 0 and mine.s_begin > 0
        return st, q, s, mine, theirs, False
    if kind == "mito":
        q = rng.integers(0, top, MITO_M).astype(np.uint8)
        s = rng.integers(0, top, MITO_N).astype(np.uint8)
        fields = (0, 0, MITO_M, 0, MITO_N, _mito_cigar(rng))
    elif kind == "folded":
        # M columns that pair two different codes of one folded letter.
        q, s = ([0, 20, 21, 22, 23, 4, 20], [0, 22, 23, 20, 21, 9, 3]) if st is AA else (
            [0, 4, 5, 14, 13, 2, 6], [0, 14, 7, 8, 9, 1, 3])
        q, s = np.array(q, np.uint8), np.array(s, np.uint8)
        fields = (0, 0, 7, 0, 7, "MMMMMDMI")
    else:
        q = rng.integers(0, top, 20).astype(np.uint8)
        s = rng.integers(0, top, 20).astype(np.uint8)
        fields = {"empty": (0, 3, 3, 5, 5, ""), "alld": (-20, 2, 12, 3, 3, "D" * 10),
                  "alli": (-20, 4, 4, 1, 11, "I" * 10)}[kind]
    return st, q, s, oracle.Traceback(*fields), j_oracle.Traceback(*fields), kind == "folded"


@pytest.mark.parametrize("name", ["sw-aa", "sw-nt", "nw-aa", "nw-nt", "empty-aa", "alld-aa",
                                  "alli-nt", "folded-aa", "folded-nt", "mito-nt"])
def test_aligned_strings_match_reference(name):
    """The display rows equal the JAX package's on the same Traceback fields
    and codes, each decoded with its own package's ``alphabet.decode``."""
    st, q, s, mine, theirs, folded = _display_case(name)
    assert (mine.score, mine.q_begin, mine.q_end, mine.s_begin, mine.s_end, mine.cigar) == (
        theirs.score, theirs.q_begin, theirs.q_end, theirs.s_begin, theirs.s_end, theirs.cigar)
    dec, j_dec = _decoders(st, folded)
    rows = mine.aligned_strings(q, s, dec)
    assert rows == theirs.aligned_strings(q, s, j_dec)
    assert all(type(r) is str and len(r) == len(mine.cigar) for r in rows)
    if folded:
        assert rows[1] == "|||||   "
        assert mine.aligned_strings(q, s, _decoders(st, False)[0])[1] == "|       "


@pytest.mark.parametrize("columns", [0, 1, 10, MITO_M + MITO_N - MITO_MATCHED])
def test_aligned_strings_decodes_once_a_row(columns):
    """``decode_fn`` runs at most once a row, whatever the alignment's length."""
    rng = np.random.default_rng(columns)
    cigar = _mito_cigar(rng)[:columns]
    m, n = sum(op != "I" for op in cigar), sum(op != "D" for op in cigar)
    q = rng.integers(0, 15, m + 2).astype(np.uint8)
    s = rng.integers(0, 15, n + 1).astype(np.uint8)
    calls = []

    def counting(codes):
        calls.append(len(codes))
        return alphabet.decode(codes, NT)

    tb = oracle.Traceback(0, 2, 2 + m, 1, 1 + n, cigar)
    rows = tb.aligned_strings(q, s, counting)
    assert len(calls) <= 2
    assert rows == j_oracle.Traceback(0, 2, 2 + m, 1, 1 + n, cigar).aligned_strings(
        q, s, lambda c: j_alphabet.decode(c, j_constants.SymType.NUCLEOTIDE))


def test_aligned_strings_rejects_span_the_cigar_does_not_cover():
    q = np.zeros(10, np.uint8)
    dec = lambda c: alphabet.decode(c, NT)
    with pytest.raises(ValueError, match="query span"):
        oracle.Traceback(0, 0, 5, 0, 4, "MMMDI").aligned_strings(q, q, dec)
    with pytest.raises(ValueError, match="subject span"):
        oracle.Traceback(0, 0, 4, 0, 5, "MMMDI").aligned_strings(q, q, dec)


@pytest.mark.parametrize("name,symtype", [("proteins.fas", "AMINOACID"),
                                          ("nucleotides.fas", "NUCLEOTIDE")])
def test_sequence_db_packing_matches(tmp_path, name, symtype):
    path = str(shutil.copy(TESTDATA / name, tmp_path / name))
    st = constants.SymType[symtype]
    mine = db.SequenceDB.from_fasta(path, st, use_cache=False)
    theirs = j_db.SequenceDB.from_fasta(path, _ref(st), use_cache=False)
    for field in ("codes", "offsets", "lengths"):
        np.testing.assert_array_equal(getattr(mine, field), getattr(theirs, field))
    assert mine.headers == theirs.headers
    assert db.PAD_CODE == j_db.PAD_CODE
    for (c1, l1, i1), (c2, l2, i2) in zip(mine.grouped_stacks(8, 16),
                                          theirs.grouped_stacks(8, 16)):
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(np.stack(i1), np.stack(i2))
    assert list(fasta.iter_fasta(path)) == list(j_fasta.iter_fasta(path))
    if st is constants.SymType.NUCLEOTIDE:
        t1, ids1, frames1 = mine.translated(1, use_cache=False)
        t2, ids2, frames2 = theirs.translated(1, use_cache=False)
        np.testing.assert_array_equal(t1.codes, t2.codes)
        np.testing.assert_array_equal(ids1, ids2)
        assert list(frames1) == list(frames2)


def test_profiles_and_topk_match():
    rng = np.random.default_rng(3)
    padded = matrices.builtin("BLOSUM62").padded()
    q = rng.integers(0, 20, 37).astype(np.uint8)
    np.testing.assert_array_equal(scoring.make_profile(q, padded),
                                  j_scoring.make_profile(q, padded))
    for rows in (None, 64):
        kw = {} if rows is None else {"rows": rows}
        np.testing.assert_array_equal(scoring.make_padded_profile(q, padded, **kw),
                                      j_scoring.make_padded_profile(q, padded, **kw))
    scores = rng.integers(-5, 40, 200).astype(np.int64)
    scores[10:20] = 39  # ties: id ascending
    ids = rng.permutation(200).astype(np.int32)
    for k in (0, 1, 7, 300):
        for a, b in zip(topk.host_topk(scores, ids, k), j_topk.host_topk(scores, ids, k)):
            np.testing.assert_array_equal(a, b)


def test_cli_output_helpers_match(tmp_path, capsys):
    """The CLI's ``info`` and hit formats, copied from the reference CLI."""
    path = str(shutil.copy(TESTDATA / "proteins.fas", tmp_path / "p.fas"))
    assert cli.main(["info", "--db", path]) == 0
    mine = json.loads(capsys.readouterr().out)
    assert j_cli.main(["info", "--db", path]) == 0
    assert mine == json.loads(capsys.readouterr().out)
    assert cli._symtype("nt") is constants.SymType.NUCLEOTIDE
    assert cli._symtype("aa") is constants.SymType.AMINOACID


def test_native_build_keys_on_host_and_leaves_no_temp_files(tmp_path, monkeypatch):
    """The port's native helpers build through ``cudabuild.load_native``:
    the library's name carries the host CPU's target options (a library
    built for another CPU is never loaded), and a failed compile returns
    None and leaves no temporary file behind."""
    from libssa_tpu_torch.util import cudabuild

    a = cudabuild.library_path("leafalign.cpp", "g++", cudabuild.CXX_FLAGS, "host-a")
    assert a != cudabuild.library_path("leafalign.cpp", "g++", cudabuild.CXX_FLAGS, "host-b")
    assert a.name.startswith("leafalign-") and a.parent == cudabuild.BUILD_DIR
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "broken_helper.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(cudabuild, "CSRC", tmp_path / "src")
    monkeypatch.setattr(cudabuild, "BUILD_DIR", tmp_path / "build")
    assert cudabuild.load_native("broken_helper.cpp") is None
    assert not [p for p in (tmp_path / "build").iterdir() if ".tmp." in p.name]
