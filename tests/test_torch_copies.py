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
