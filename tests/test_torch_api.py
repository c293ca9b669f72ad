"""``libssa_tpu_torch.api`` against ``libssa_tpu.api`` on the test fixtures.

Both contexts get the same configuration and queries; hit lists must be
equal field by field (ids, scores, strands and frames, coordinates,
cigars, aligned rows), and so must the search statistics. Each package
gets its own enums (the port's are its own classes): the tests name the
port's, and ``_ref`` gives the JAX package's member of the same name.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from libssa_tpu import api as jax_api
from libssa_tpu import cli as jax_cli
from libssa_tpu import constants as jax_constants
from libssa_tpu.search import aligner as jax_aligner
from libssa_tpu.search import hirschberg as jax_hirschberg
from libssa_tpu_torch import api, cli
from libssa_tpu_torch.constants import AlignType, BitWidth, ComputeMode, Strand, SymType
from libssa_tpu_torch.search import aligner, hirschberg

torch.set_num_threads(1)

TESTDATA = Path(__file__).parent / "testdata"


def _ref(member):
    """The JAX package's enum member of the same name (None stays None)."""
    if member is None:
        return None
    return getattr(jax_constants, type(member).__name__)[member.name]


def _fixture(tmp_path, name):
    """A private copy, so packed-DB caches never race other test workers."""
    dst = tmp_path / name
    shutil.copy(TESTDATA / name, dst)
    return str(dst)


def _contexts(tmp_path, db="proteins.fas", symtype=SymType.AMINOACID,
              strands=Strand.FORWARD, db_symtype=None, constant=None,
              gaps=(10, 1), chunk=16):
    db_path = _fixture(tmp_path, db)
    out = []
    for ctx, enum in ((jax_api.SSAContext(), _ref), (api.SSAContext(device="cpu"), None)):
        enum = enum or (lambda e: e)
        ctx.init_symbol_translation(enum(symtype), enum(strands), 1, 1,
                                    db_symtype=enum(db_symtype))
        if constant:
            ctx.init_constant_scoring(*constant)
        else:
            ctx.init_score_matrix("BLOSUM62")
        ctx.init_gap_penalties(*gaps)
        ctx.init_db_fasta(db_path)
        ctx.set_chunk_size(chunk)
        out.append(ctx)
    return out


def _hits(hl):
    return [
        (h.seq_id, h.header, h.score, h.align_type.name, h.strand, h.db_frame,
         h.q_begin, h.q_end, h.s_begin, h.s_end, h.cigar, h.aligned)
        for h in hl
    ]


def _stats(st):
    return (st.cells, st.subjects, st.rescored, st.notes, st.aligner_cells)


def _same(port_hl, ref_hl):
    assert _hits(port_hl) == _hits(ref_hl)
    assert _stats(port_hl.stats) == _stats(ref_hl.stats)
    assert len(port_hl) > 0


@pytest.mark.parametrize("mode", [ComputeMode.SCORE, ComputeMode.ALIGNMENT],
                         ids=["score", "alignment"])
@pytest.mark.parametrize("bw", [BitWidth.EXACT, BitWidth.BIT8, BitWidth.BIT16],
                         ids=lambda b: b.name)
@pytest.mark.parametrize("algo", ["sw", "nw"])
def test_protein_search_matches(tmp_path, algo, bw, mode):
    ref, port = _contexts(tmp_path)
    qfile = _fixture(tmp_path, "query_prot.fas")
    q_ref, q_port = ref.init_sequence_fasta(qfile), port.init_sequence_fasta(qfile)
    fn = "sw_align" if algo == "sw" else "nw_align"
    want = getattr(ref, fn)(q_ref, 10, _ref(bw), _ref(mode))
    got = getattr(port, fn)(q_port, 10, bw, mode)
    _same(got, want)
    if mode is ComputeMode.ALIGNMENT:
        assert all(h.cigar for h in got)


@pytest.mark.parametrize("mode", [ComputeMode.SCORE, ComputeMode.ALIGNMENT],
                         ids=["score", "alignment"])
def test_align_many_matches(tmp_path, mode):
    ref, port = _contexts(tmp_path)
    qfile = _fixture(tmp_path, "proteins.fas")
    q_ref = ref.init_sequences_fasta(qfile)[:5]
    q_port = port.init_sequences_fasta(qfile)[:5]
    for algo in (AlignType.SW, AlignType.NW):
        want = ref.align_many(q_ref, 6, _ref(mode), _ref(algo), _ref(BitWidth.BIT8))
        got = port.align_many(q_port, 6, mode, algo, BitWidth.BIT8)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            _same(g, w)


def test_nucleotide_both_strands_matches(tmp_path):
    ref, port = _contexts(
        tmp_path, db="nucleotides.fas", symtype=SymType.NUCLEOTIDE,
        strands=Strand.BOTH, constant=(5, -4), gaps=(10, 2),
    )
    qfile = _fixture(tmp_path, "query_nt.fas")
    q_ref, q_port = ref.init_sequence_fasta(qfile), port.init_sequence_fasta(qfile)
    assert len(q_port.sequences) == 2
    for mode in (ComputeMode.SCORE, ComputeMode.ALIGNMENT):
        _same(port.sw_align(q_port, 8, mode=mode), ref.sw_align(q_ref, 8, mode=_ref(mode)))
        _same(port.nw_align(q_port, 8, mode=mode), ref.nw_align(q_ref, 8, mode=_ref(mode)))
    strands = {h.strand for h in port.sw_align(q_port, 8)}
    assert strands <= {"+", "-"}


def test_translated_query_matches(tmp_path):
    """blastx-style: nucleotide query frames against the protein fixture."""
    ref, port = _contexts(
        tmp_path, symtype=SymType.NUCLEOTIDE, strands=Strand.BOTH,
        db_symtype=SymType.AMINOACID,
    )
    qfile = _fixture(tmp_path, "query_nt.fas")
    q_ref, q_port = ref.init_sequence_fasta(qfile), port.init_sequence_fasta(qfile)
    for bw in (BitWidth.EXACT, BitWidth.BIT8):
        _same(port.sw_align(q_port, 6, bw, ComputeMode.ALIGNMENT),
              ref.sw_align(q_ref, 6, _ref(bw), _ref(ComputeMode.ALIGNMENT)))


def test_translated_db_matches(tmp_path):
    """tblastn-style: protein query against the nucleotide fixture's frames."""
    ref, port = _contexts(
        tmp_path, db="nucleotides.fas", symtype=SymType.AMINOACID,
        db_symtype=SymType.NUCLEOTIDE,
    )
    qfile = _fixture(tmp_path, "query_prot.fas")
    q_ref, q_port = ref.init_sequence_fasta(qfile), port.init_sequence_fasta(qfile)
    for algo in ("sw_align", "nw_align"):
        got = getattr(port, algo)(q_port, 6, mode=ComputeMode.ALIGNMENT)
        _same(got, getattr(ref, algo)(q_ref, 6, mode=_ref(ComputeMode.ALIGNMENT)))
        assert all(h.db_frame for h in got)


def test_align_pair_matches(tmp_path):
    ref, port = _contexts(tmp_path)
    q_ref = ref.init_sequence_fasta("MKVLAAGIVGWKQTERNDCFYHH")
    q_port = port.init_sequence_fasta("MKVLAAGIVGWKQTERNDCFYHH")
    for at in (AlignType.NW, AlignType.SW):
        a = port.align_pair(q_port, "AAGIVGWKQTE", at)
        b = ref.align_pair(q_ref, "AAGIVGWKQTE", _ref(at))
        assert _hits([a]) == _hits([b])
        assert a.stats.aligner_cells == b.stats.aligner_cells


@pytest.mark.parametrize("algo", [AlignType.SW, AlignType.NW], ids=["sw", "nw"])
def test_align_pair_score_matches(tmp_path, algo):
    """SCORE mode: score, strand and stats, protein and both nucleotide strands."""
    ref, port = _contexts(tmp_path)
    q_ref = ref.init_sequence_fasta("MKVLAAGIVGWKQTERNDCFYHH")
    q_port = port.init_sequence_fasta("MKVLAAGIVGWKQTERNDCFYHH")
    runs = [(port, q_port, ref, q_ref, "AAGIVGWKQTEWWKVLAAG")]
    ref, port = _contexts(
        tmp_path, db="nucleotides.fas", symtype=SymType.NUCLEOTIDE,
        strands=Strand.BOTH, constant=(5, -4), gaps=(10, 2),
    )
    qfile = _fixture(tmp_path, "query_nt.fas")
    q_ref, q_port = ref.init_sequence_fasta(qfile), port.init_sequence_fasta(qfile)
    assert len(q_port.sequences) == 2
    subject = "ACGTTGCAAGGCTTACGATCGGATCCAGGT"
    runs.append((port, q_port, ref, q_ref, subject))
    for port, q_port, ref, q_ref, subject in runs:
        a = port.align_pair(q_port, subject, algo, ComputeMode.SCORE)
        b = ref.align_pair(q_ref, subject, _ref(algo), _ref(ComputeMode.SCORE))
        assert _hits([a]) == _hits([b])
        assert a.cigar is None
        st_a, st_b = a.stats, b.stats
        assert (st_a.cells, st_a.dispatches, st_a.fetches) == (
            st_b.cells, st_b.dispatches, st_b.fetches)
        assert st_a.cells == len(subject) * sum(len(c) for _, c in q_port.sequences)


def test_set_device_count_sharded_api(tmp_path):
    """set_device_count(2) on a "cpu" context: SW, NW and translated hits
    equal the JAX package's mesh context's and the port's single-device
    context's; more devices than are visible raise RuntimeError."""
    import os

    from libssa_tpu_torch.parallel.sharded import ShardedSearchEngine

    def run(**kw):
        ref, port = _contexts(tmp_path, **kw)
        single = _contexts(tmp_path, **kw)[1]
        ref.set_device_count(2)
        port.set_device_count(2)
        return ref, port, single

    qfile = _fixture(tmp_path, "query_prot.fas")
    ref, port, single = run()
    qs = [c.init_sequence_fasta(qfile) for c in (ref, port, single)]
    for fn, bw in (("sw_align", BitWidth.EXACT), ("nw_align", BitWidth.EXACT),
                   ("sw_align", BitWidth.BIT8)):
        want = getattr(ref, fn)(qs[0], 5, _ref(bw), _ref(ComputeMode.ALIGNMENT))
        got = getattr(port, fn)(qs[1], 5, bw, ComputeMode.ALIGNMENT)
        _same(got, want)
        _same(got, getattr(single, fn)(qs[2], 5, bw, ComputeMode.ALIGNMENT))
    assert isinstance(port._engine, ShardedSearchEngine) and port._engine.n_devices == 2

    # Translated: a nucleotide query, both strands, against the protein DB.
    ref, port, single = run(symtype=SymType.NUCLEOTIDE, strands=Strand.BOTH,
                            db_symtype=SymType.AMINOACID)
    seq = "ATGGCTGCTTGGAAACAAACCGAAATG"
    hits = [c.sw_align(c.init_sequence_fasta(seq), 4, *args) for c, args in (
        (ref, (_ref(BitWidth.EXACT), _ref(ComputeMode.SCORE))),
        (port, (BitWidth.EXACT, ComputeMode.SCORE)),
        (single, (BitWidth.EXACT, ComputeMode.SCORE)))]
    _same(hits[1], hits[0])
    _same(hits[1], hits[2])

    q = port.init_sequence_fasta(seq)
    port.set_device_count(0)  # every device: the CPU counts once a core
    _same(port.sw_align(q, 4), hits[2])
    assert port._engine.n_devices == (os.cpu_count() or 1)
    port.set_device_count((os.cpu_count() or 1) + 1)
    with pytest.raises(RuntimeError, match="devices visible"):
        port.sw_align(q, 4)
    port.set_device_count(1)
    assert not isinstance(port._get_engine(), ShardedSearchEngine)


@pytest.fixture
def linear_space(monkeypatch):
    """Both packages' tracebacks above a lowered MATRIX_CELL_LIMIT, with a
    small common LEAF_CELLS so the recursion has levels; the port's levels
    run on DevicePair (K2's plain version on the CPU)."""
    for mod in (aligner, jax_aligner):
        monkeypatch.setattr(mod, "MATRIX_CELL_LIMIT", 100)
    for mod in (hirschberg, jax_hirschberg):
        monkeypatch.setattr(mod, "LEAF_CELLS", 256)
    monkeypatch.setattr(hirschberg, "DEVICE_ON_CPU", True)
    monkeypatch.setattr(hirschberg, "DEVICE_MIN_CELLS", 1024)


@pytest.mark.parametrize("algo", [AlignType.SW, AlignType.NW], ids=["sw", "nw"])
def test_align_pair_linear_space_matches(tmp_path, linear_space, algo):
    """ALIGNMENT-mode align_pair above the full-matrix limit: the
    linear-space aligner, equal to the JAX package's (score, coordinates,
    cigar, aligned rows)."""
    ref, port = _contexts(tmp_path)
    seq = "MKVLAAGIVGWKQTERNDCFYHHWWKVLAAGSTPQRNDE" * 3
    q_ref, q_port = ref.init_sequence_fasta(seq), port.init_sequence_fasta(seq)
    subject = "AAGIVGWKQTEWWKVLAAGPPPRNDCFYHAAGIVGWKQTERNDCF" * 2
    a = port.align_pair(q_port, subject, algo)
    b = ref.align_pair(q_ref, subject, _ref(algo))
    assert _hits([a]) == _hits([b]) and a.cigar
    assert a.stats.aligner_cells == b.stats.aligner_cells
    assert a.stats.aligner_dispatches > 0  # DevicePair ran


def test_search_hit_traceback_linear_space_matches(tmp_path, linear_space):
    """Search hits' tracebacks above the full-matrix limit (_fill_traceback)."""
    ref, port = _contexts(tmp_path)
    qfile = _fixture(tmp_path, "query_prot.fas")
    q_ref, q_port = ref.init_sequence_fasta(qfile), port.init_sequence_fasta(qfile)
    for fn in ("sw_align", "nw_align"):
        got = getattr(port, fn)(q_port, 4, BitWidth.EXACT, ComputeMode.ALIGNMENT)
        _same(got, getattr(ref, fn)(q_ref, 4, _ref(BitWidth.EXACT), _ref(ComputeMode.ALIGNMENT)))
        assert all(h.cigar for h in got)
        assert got.stats.aligner_dispatches > 0


def test_foreign_enums_raise_type_error(tmp_path):
    """A JAX-package enum is not the port's: refused, never misrouted."""
    _, port = _contexts(tmp_path)
    q = port.init_sequence_fasta("MKVLAAGWKQTE")
    with pytest.raises(TypeError, match="align_type"):
        port.align_pair(q, "MKVIGAGW", _ref(AlignType.SW))
    with pytest.raises(TypeError, match="mode"):
        port.align_pair(q, "MKVIGAGW", AlignType.SW, _ref(ComputeMode.SCORE))
    with pytest.raises(TypeError, match="mode"):
        port.sw_align(q, 3, BitWidth.EXACT, _ref(ComputeMode.ALIGNMENT))
    with pytest.raises(TypeError, match="align_type"):
        port.align_many([q], 3, ComputeMode.SCORE, _ref(AlignType.NW))
    with pytest.raises(TypeError, match="symtype"):
        port.init_symbol_translation(_ref(SymType.NUCLEOTIDE))


def test_device_must_be_explicit():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.SSAContext()
    assert api.SSAContext(device="cpu").device.type == "cpu"


def test_module_level_api(tmp_path):
    api.init_device("cpu")
    try:
        api.init_score_matrix("BLOSUM62")
        api.init_gap_penalties(10, 1)
        api.init_db_fasta(_fixture(tmp_path, "proteins.fas"))
        q = api.init_sequence_fasta(_fixture(tmp_path, "query_prot.fas"))
        hits = api.sw_align(q, 3, BitWidth.EXACT, ComputeMode.ALIGNMENT)
        assert len(hits) == 3 and hits[0].cigar
        assert api.default_context().device.type == "cpu"
        api.ssa_exit()
        assert api.default_context().db is None
    finally:
        api._default = None


def _cli_json(main, argv, capsys):
    assert main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    out.pop("seconds")
    return out


@pytest.mark.parametrize("extra", [[], ["--algo", "nw", "--bit-width", "8", "--align"],
                                   ["--all-queries"], ["--devices", "2", "--align"],
                                   ["--devices", "2", "--all-queries"]],
                         ids=["sw", "nw-bit8-align", "all-queries", "devices2",
                              "devices2-all-queries"])
def test_cli_search_matches(tmp_path, capsys, extra):
    db = _fixture(tmp_path, "proteins.fas")
    query = _fixture(tmp_path, "query_prot.fas")
    base = ["search", "--db", db, "--query", query, "-k", "5", "--json", *extra]
    want = _cli_json(jax_cli.main, base + ["--platform", "cpu"], capsys)
    got = _cli_json(cli.main, base + ["--device", "cpu"], capsys)
    assert got == want


def test_cli_info_pair_and_errors(tmp_path, capsys):
    db = _fixture(tmp_path, "proteins.fas")
    assert cli.main(["info", "--db", db]) == 0
    info = json.loads(capsys.readouterr().out)
    assert jax_cli.main(["info", "--db", db]) == 0
    assert info == json.loads(capsys.readouterr().out)
    assert cli.main(["pair", "--query", "MKVLAAGW", "--subject", "MKVIGAGW",
                     "--device", "cpu"]) == 0
    assert "score=" in capsys.readouterr().out
    assert cli.main(["pair", "--query", "MKVLAAGW", "--subject", "MKVIGAGW",
                     "--device", "cpu", "--score-only"]) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(["pair", "--query", "MKVLAAGW", "--subject", "MKVIGAGW",
                         "--platform", "cpu", "--score-only"]) == 0
    assert got == capsys.readouterr().out and "score=" in got
    if not torch.cuda.is_available():
        assert cli.main(["search", "--db", db, "--query", "MKVLAAGW"]) == 2
        assert "CUDA is not available" in capsys.readouterr().err


def test_cli_xprof_writes_trace(tmp_path, capsys):
    db = _fixture(tmp_path, "proteins.fas")
    out = tmp_path / "trace"
    assert cli.main(["search", "--db", db, "--query", "MKVLAAGWKQTE", "-k", "2",
                     "--device", "cpu", "--xprof", str(out)]) == 0
    assert (out / "trace.json").stat().st_size > 0
    assert np.isfinite(len(capsys.readouterr().out))
