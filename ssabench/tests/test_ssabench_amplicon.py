"""The amplicon_v4 cell on the CPU: a tiny root of its own (1,200 entries of
about 120 bases, calls of 8 reads) runs correct through the harness, its
inputs follow the seed and the traffic file, the full-size layout holds
every family and the warm-up covers every profile height, and each fault
of the strand path turns ``correct`` false."""
import json
import time

import numpy as np
import pytest

from ssabench import harness
from ssabench.mixes import amplicon_search
from ssabench.reference import alignment, scoring
from ssabench.tests import tiny
from ssabench.tests.tiny_amplicon import CELL, CONFIG, make_root

SEED = 2**31 + 4111
# Reads with many indels, so that some top hits' alignments end in a gap
# and the free end gaps fault shows in them.
GAPPY = {"indel_rate": 0.03, "indel_mean": 2.0}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny_amplicon"))


@pytest.fixture(scope="module")
def gappy_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny_amplicon_gappy"), reads=GAPPY)


def run(root, trace=False, control=False):
    return harness.run_cell(root, CELL, SEED, 0.3, trace, "cpu", time.perf_counter(), control)


def mix(root, seed):
    cfg = json.loads((root / CONFIG).read_text())
    traffic = json.loads((root / f"ssabench/traffic/{CELL}.json").read_text())
    return amplicon_search.Mix(cfg, traffic, seed, "cpu")


def test_sound_run_is_correct_and_the_control_is_not(root):
    r = run(root, control=True)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"] == {"hit_mismatches": {"value": 0, "limit": 0},
                           "strand_mismatches": {"value": 0, "limit": 0},
                           "alignment_errors": {"value": 0, "limit": 0}}
    assert set(r["metrics"]) == {"search_gcups", "setup_s"}
    # 8 bits hold no negative score: the saturated reference misses hits
    assert r["control"]["hit_mismatches"]["value"] > 0


def test_traced_run_reads_the_strand_path(root):
    r = run(root, trace=True)
    assert r["correct"]
    m = r["metrics"]
    assert m["nw_int32_share.amplicon"]["value"] == 100.0
    assert m["reduced_host_ms.amplicon"]["value"] > 0
    assert m["aligner_ms.amplicon"]["value"] > 0
    # the device's readers find nothing on the CPU
    assert not any(k.startswith(("device_idle", "k1_")) for k in m)


def test_same_inputs_for_the_same_seed(root):
    a, b, c = mix(root, SEED), mix(root, SEED), mix(root, SEED + 1)
    assert (a.codes == b.codes).all() and all((x == y).all() for x, y in zip(a.reads, b.reads))
    assert not all((x == y).all() for x, y in zip(a.reads, c.reads))
    # another seed: other bases and places, the same lengths, novel and reversed reads
    assert [len(r) for r in a.reads] == [len(r) for r in c.reads]
    assert (a.novel == c.novel).all() and (a.reverse == c.reverse).all()
    assert [list(a.lengths[f]) for f in a.families] == [list(c.lengths[f]) for f in c.families]


def test_reads_and_families_follow_the_traffic_file(root):
    m = mix(root, SEED)
    fam = m.traffic["reads"]["family"]
    members = np.concatenate([f[1:] for f in m.families])
    assert len(set(members)) == len(members) and not set(members) & set(m.sources)
    near = []
    for j, f in enumerate(m.families):
        src = m.entry(f[0])
        assert len(m.reads[j]) == len(src)
        assert all(len(m.entry(i)) == len(src) for i in f)
        same = [bool((m.entry(i) == src).all()) for i in f[1:]]
        assert same[: fam["identical"]] == [True] * fam["identical"]
        near += [float((m.entry(i) != src).mean()) for i in f[1 + fam["identical"]:]]
    # substitutions at 1-3%, a quarter of them to the same base
    assert 0.005 < np.mean(near) < fam["near_max_rate"] and max(near) < 0.08
    # a reversed read is closer to its source's reverse complement
    from ssabench.reference import translate

    for j in np.nonzero(~m.novel)[0][:12]:
        src = m.entry(m.sources[j])
        fwd = (m.reads[j] == src).mean()
        rev = (translate.reverse_complement(m.reads[j]) == src).mean()
        assert (rev > fwd) == bool(m.reverse[j])


def test_full_size_layout_holds_every_family_and_both_heights():
    """At the cell's own sizes every family finds its members of its
    source's length, and the warm-up call holds both profile heights (256
    and 288 rows), so nothing new is shaped inside the window."""
    cfg = tiny.load("ssabench/configs/silva138_v4_vsearch.json")
    traffic = tiny.load("ssabench/traffic/amplicon_v4.json")
    lay = amplicon_search.layout(cfg, traffic)
    canon = lay["canon"]
    assert 129_000_000 < int(canon.sum()) < 129_100_000
    fam = traffic["reads"]["family"]
    assert all(len(m) == fam["identical"] + fam["near"] and (canon[m] == canon[s]).all()
               for s, m in zip(lay["sources"], lay["members"]))
    per, pool = traffic["queries_per_call"], traffic["pool_calls"]
    rows = [32 * -(-int(x) // 32) for x in canon[lay["sources"]]]
    assert set(rows[pool * per:]) == set(rows[:pool * per]) == {256, 288}


def trim_ends(hit):
    """The hit as a program that charges no end gaps reports it: its
    alignment without the gaps at either end, scored without them. Returns
    whether anything changed."""
    ops = alignment.expand(hit.cigar).tobytes().decode()
    core = ops.strip("DI")
    if core == ops:
        return False
    lead = ops[: len(ops) - len(ops.lstrip("DI"))]
    trail = ops[len(lead) + len(core):]
    hit.q_begin += lead.count("D")
    hit.s_begin += lead.count("I")
    hit.q_end -= trail.count("D")
    hit.s_end -= trail.count("I")
    hit.cigar = core
    return True


@pytest.fixture
def faults(monkeypatch):
    from libssa_tpu_torch import api
    from libssa_tpu_torch.constants import AlignType, Strand

    init = api.SSAContext.init_symbol_translation
    changed = []

    def one_strand():
        monkeypatch.setattr(api.SSAContext, "init_symbol_translation",
                            lambda self, symtype, strands, **kw: init(self, symtype,
                                                                      Strand.FORWARD, **kw))

    def local():
        many = api.SSAContext.align_many
        monkeypatch.setattr(api.SSAContext, "align_many", lambda self, qs, **kw: many(
            self, qs, **dict(kw, align_type=AlignType.SW)))

    def patch_hits(change):
        orig = api.SSAContext._align

        def patched(self, query, *a, **k):
            out = orig(self, query, *a, **k)
            change(out.hits, dict(query.sequences), self.db)
            return out
        monkeypatch.setattr(api.SSAContext, "_align", patched)

    def strands_swapped():
        def swap(hits, *_):
            for h in hits:
                h.strand = "-" if h.strand == "+" else "+"
        patch_hits(swap)

    def score_altered():
        def alter(hits, *_):
            hits[-1].score += 1
        patch_hits(alter)

    def free_end_gaps():
        def free(hits, seqs, db):
            cfg = tiny.load("ssabench/configs/silva138_v4_vsearch.json")
            sub = scoring.substitution(cfg["scoring"])
            Q, R = scoring.gap_qr(cfg["gap_open"], cfg["gap_extend"], cfg["first_residue_opens"])
            for h in hits:
                if trim_ends(h):
                    changed.append(h.seq_id)
                    h.score = alignment.rescore(seqs[h.strand], db.sequence(h.seq_id), sub, Q,
                                                R, h.q_begin, h.q_end, h.s_begin, h.s_end,
                                                h.cigar, True)
        patch_hits(free)

    def cut_short():
        def cut(hits, *_):
            for h in hits:
                last = h.cigar[-1]
                h.cigar = h.cigar[:-1]
                h.q_end -= last in "MD"
                h.s_end -= last in "MI"
        patch_hits(cut)

    return {"one_strand": one_strand, "local": local, "strands_swapped": strands_swapped,
            "score_altered": score_altered, "free_end_gaps": free_end_gaps,
            "cut_short": cut_short}, changed


@pytest.mark.parametrize("fault,numbers", [
    ("one_strand", ("hit_mismatches",)), ("local", ("hit_mismatches", "alignment_errors")),
    ("strands_swapped", ("strand_mismatches", "alignment_errors")),
    ("score_altered", ("hit_mismatches",)),
    ("free_end_gaps", ("hit_mismatches", "alignment_errors")),
    ("cut_short", ("alignment_errors",))])
def test_fault_turns_correct_false(gappy_root, faults, fault, numbers):
    table, changed = faults
    table[fault]()
    r = run(gappy_root)
    assert not r["correct"] and r["failed"] == 0
    for number in numbers:
        assert r["checks"][number]["value"] > 0, r["checks"]
    if fault == "free_end_gaps":
        assert changed  # some top hits' alignments did end in a gap


def test_gappy_sound_run_is_correct(gappy_root):
    assert run(gappy_root)["correct"]
