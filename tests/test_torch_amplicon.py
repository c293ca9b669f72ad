"""Global search of both strands of nucleotide reads against a nucleotide
database (the amplicon_v4 cell's path: ``align_many`` -> ``_align`` ->
``SearchEngine.search_reduced`` with two strand profiles and no record map,
then the NW tracebacks), held on the CPU against the benchmark's plain
reference (``ssabench/reference``): hit ids and scores in order, the strand
label (``+`` wins ties), and each alignment re-scored on its strand,
spanning both sequences whole. Seeded random ACGT databases with planted
identical entries, reads whose scores are negative against every entry,
reads equal to their own reverse complement, and the ``local`` and ``wide``
counts of the ``search.reduced`` and ``traceback.batch`` spans."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from libssa_tpu_torch import api
from libssa_tpu_torch.constants import AlignType, BitWidth, ComputeMode, Strand, SymType
from libssa_tpu_torch.io.db import SequenceDB
from ssabench.reference import alignment, dp, scoring, translate

torch.set_num_threads(1)

MATCH, MISMATCH, GAP_OPEN, GAP_EXTEND = 2, -4, 20, 2  # VSEARCH's, as the cell's
SUB = scoring.substitution({"match": MATCH, "mismatch": MISMATCH})
Q, R = scoring.gap_qr(GAP_OPEN, GAP_EXTEND, True)
K = 6


def context(seqs, dtype="float32", strands=Strand.BOTH):
    c = api.SSAContext("cpu")
    c.init_symbol_translation(SymType.NUCLEOTIDE, strands)
    c.init_constant_scoring(MATCH, MISMATCH)
    c.init_gap_penalties(GAP_OPEN, GAP_EXTEND, first_residue_opens=True)
    c.set_chunk_size(16)  # several stack groups
    c.params.dtype = dtype
    c.db = SequenceDB.from_sequences([f"e{i}" for i in range(len(seqs))], seqs,
                                     SymType.NUCLEOTIDE)
    return c


def draw_db(seed, n=60, lo=40, hi=90):
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.uint8) for _ in range(n)]
    return rng, seqs


def mutate(rng, s, rate):
    out = s.copy()
    hit = rng.random(len(out)) < rate
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return out


def letters(codes):
    return scoring.decode(codes, "nucleotide")


def reference(seqs, read, local=False):
    """(best score of each entry over the read's strands, its first best
    strand, the two strands' scores, the strands' codes)."""
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    offsets = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    db = dp.Database(np.concatenate(seqs), offsets, lengths, len(SUB), "cpu")
    both = [read, translate.reverse_complement(read)]
    scores = db.scores(both, SUB, Q, R, local)
    best, label = translate.best_frames(scores, ["+", "-"])
    return best, label, scores, both


def search(c, reads, mode, align_type=AlignType.NW):
    qs = [c.init_sequence_fasta(letters(r), header=f"r{j}") for j, r in enumerate(reads)]
    return c.align_many(qs, k=K, mode=mode, align_type=align_type, bit_width=BitWidth.EXACT)


def assert_like_reference(seqs, reads, lists, mode, local=False):
    for read, hl in zip(reads, lists):
        best, label, scores, both = reference(seqs, read, local)
        assert [(h.seq_id, h.score) for h in hl] == dp.top_hits(best, K)
        assert [h.strand for h in hl] == [label[h.seq_id] for h in hl]
        for h in hl:
            if mode is ComputeMode.SCORE:
                assert h.cigar is None
                continue
            si = "+-".index(h.strand)
            got = alignment.rescore(both[si], seqs[h.seq_id], SUB, Q, R, h.q_begin, h.q_end,
                                    h.s_begin, h.s_end, h.cigar, local)
            assert got == h.score == scores[si][h.seq_id]
            if not local:  # the whole read against the whole entry
                assert (h.q_begin, h.q_end, h.s_begin, h.s_end) == (0, len(read), 0,
                                                                    len(seqs[h.seq_id]))


MODES = [ComputeMode.SCORE, ComputeMode.ALIGNMENT]


@pytest.mark.parametrize("mode", MODES, ids=["score", "alignment"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_homolog_reads_on_both_strands(seed, mode):
    """Reads made from entries, half of them reverse-complemented, with
    two identical copies of each source planted: ties ordered by id."""
    rng, seqs = draw_db(seed)
    reads = []
    for j, src in enumerate(rng.choice(len(seqs) - 2, 4, replace=False)):
        seqs[-1 - (j % 2)] = seqs[src].copy()  # an identical entry
        read = mutate(rng, seqs[src], 0.05)
        reads.append(translate.reverse_complement(read) if j % 2 else read)
    lists = search(context(seqs), reads, mode)
    assert_like_reference(seqs, reads, lists, mode)
    for j, hl in enumerate(lists):
        assert hl[0].strand == "+-"[j % 2]


@pytest.mark.parametrize("mode", MODES, ids=["score", "alignment"])
def test_identical_entries_are_ordered_by_id(mode):
    rng, seqs = draw_db(11)
    src = seqs[5]
    for i in (9, 20, 33, 47):
        seqs[i] = src.copy()
    reads = [src.copy(), translate.reverse_complement(src)]
    lists = search(context(seqs), reads, mode)
    assert_like_reference(seqs, reads, lists, mode)
    for hl, strand in zip(lists, "+-"):
        assert [h.seq_id for h in hl[:5]] == [5, 9, 20, 33, 47]
        assert {h.score for h in hl[:5]} == {MATCH * len(src)}
        assert {h.strand for h in hl[:5]} == {strand}
        if mode is ComputeMode.ALIGNMENT:  # each hit spans its whole subject
            assert all(h.cigar == "M" * len(src) for h in hl[:5])


@pytest.mark.parametrize("mode", MODES, ids=["score", "alignment"])
def test_negative_scores_against_every_entry(mode):
    """Unrelated reads, longer than every entry: each entry's NW score on
    both strands is negative, through the strand key's floor division."""
    rng, seqs = draw_db(12, lo=30, hi=60)
    reads = [rng.integers(0, 4, 110).astype(np.uint8) for _ in range(3)]
    best, *_ = reference(seqs, reads[0])
    assert (best < 0).all()
    lists = search(context(seqs), reads, mode)
    assert_like_reference(seqs, reads, lists, mode)
    assert all(h.score < 0 for hl in lists for h in hl)


@pytest.mark.parametrize("mode", MODES, ids=["score", "alignment"])
def test_equal_strands_take_the_plus_label(mode):
    """A read equal to its own reverse complement scores the same on both
    strands against every entry: every hit is labelled ``+``."""
    rng, seqs = draw_db(13)
    half = seqs[3][:30]
    read = np.concatenate((half, translate.reverse_complement(half)))
    assert (translate.reverse_complement(read) == read).all()
    seqs[7] = read.copy()
    lists = search(context(seqs), [read], mode)
    assert_like_reference(seqs, [read], lists, mode)
    assert [h.strand for h in lists[0]] == ["+"] * K and lists[0][0].seq_id == 7


def test_local_search_of_both_strands_matches():
    """The same path under SW, for the ``local`` count's other value."""
    rng, seqs = draw_db(14)
    reads = [mutate(rng, seqs[2], 0.1), translate.reverse_complement(mutate(rng, seqs[8], 0.1))]
    lists = search(context(seqs), reads, ComputeMode.ALIGNMENT, AlignType.SW)
    assert_like_reference(seqs, reads, lists, ComputeMode.ALIGNMENT, local=True)


def traced_counts(c, reads, mode, align_type):
    with profile(activities=[ProfilerActivity.CPU]):
        lists = search(c, reads, mode, align_type)
    spans = [s for hl in lists for s in hl.stats.spans]
    return ([s.counts for s in spans if s.name == "search.reduced"],
            [s.counts for s in spans if s.name == "traceback.batch"])


@pytest.mark.parametrize("align_type,dtype,local,wide", [
    (AlignType.NW, "float32", 0, 0), (AlignType.SW, "float32", 1, 0),
    (AlignType.NW, "int64", 0, 1)], ids=["nw", "sw", "nw-int64"])
def test_span_counts_local_and_wide(align_type, dtype, local, wide):
    """One ``search.reduced`` a read, counting ``local`` (1 for SW) and
    ``wide`` (1 where K1 computed in int64); one ``traceback.batch`` a read
    with ``local``."""
    rng, seqs = draw_db(15)
    reads = [mutate(rng, seqs[1], 0.05), mutate(rng, seqs[4], 0.05)]
    reduced, batches = traced_counts(context(seqs, dtype), reads, ComputeMode.ALIGNMENT,
                                     align_type)
    assert len(reduced) == len(batches) == len(reads)
    for c in reduced:
        assert c["frames"] == 2 and c["local"] == local and c["wide"] == wide
    for c in batches:
        assert c["local"] == local and c["hits"] == K and c["device"] == 0


def test_one_strand_records_no_fan_out():
    """A forward-only nucleotide search takes the plain path: no
    ``search.reduced`` span; the traceback's span still counts ``local``."""
    rng, seqs = draw_db(16)
    reads = [mutate(rng, seqs[1], 0.05)]
    reduced, batches = traced_counts(context(seqs, strands=Strand.FORWARD), reads,
                                     ComputeMode.ALIGNMENT, AlignType.NW)
    assert reduced == [] and [c["local"] for c in batches] == [0]
