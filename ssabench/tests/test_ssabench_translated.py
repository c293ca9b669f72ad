"""The translated_search cell on the CPU: a tiny root of its own (100
entries of about 120 residues, reads of 90-150 bases, 2 calls) runs
correct through the harness, its inputs follow the seed and the traffic
file, and each fault of the frame path turns ``correct`` false."""
import json
import time

import numpy as np
import pytest

from ssabench import harness
from ssabench.mixes import translated_search
from ssabench.reference import translate
from ssabench.tests import tiny
from ssabench.tests.tiny_translated import CELL, CONFIG, make_root

SEED = 2**31 + 2027


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny_translated"))


def run(root, trace=False, control=False):
    return harness.run_cell(root, CELL, SEED, 0.3, trace, "cpu", time.perf_counter(), control)


def mix(root, seed):
    cfg = json.loads((root / CONFIG).read_text())
    traffic = json.loads((root / f"ssabench/traffic/{CELL}.json").read_text())
    return translated_search.Mix(cfg, traffic, seed, "cpu")


def test_sound_run_is_correct(root):
    r = run(root)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"] == {"hit_mismatches": {"value": 0, "limit": 0},
                           "frame_mismatches": {"value": 0, "limit": 0}}
    assert set(r["metrics"]) == {"search_gcups", "setup_s"}


def test_traced_run_reads_the_frame_path(root):
    r = run(root, trace=True)
    assert r["correct"]
    # the port's spans are read; the device's readers find nothing on the CPU
    assert r["metrics"]["reduced_host_ms.translated"]["value"] > 0
    assert not any(k.startswith(("device_idle", "k1_", "reduce_ms")) for k in r["metrics"])


def test_same_inputs_for_the_same_seed(root):
    a, b, c = mix(root, SEED), mix(root, SEED), mix(root, SEED + 1)
    assert (a.codes == b.codes).all() and all((x == y).all() for x, y in zip(a.reads, b.reads))
    assert not all((x == y).all() for x, y in zip(a.reads, c.reads))
    # another seed: other bases, the same lengths, entries, strands and offsets
    assert [len(r) for r in a.reads] == [len(r) for r in c.reads]
    hom = a.homolog
    assert (hom == c.homolog).all() and (a.reverse == c.reverse).all()
    # the same entries, at other places of the database
    assert (a.lengths[a.sources[hom]] == c.lengths[c.sources[hom]]).all()
    assert (a.offset == c.offset).all()


def test_reads_have_their_drawn_lengths_strands_and_offsets(root):
    m = mix(root, SEED)
    tr = m.traffic["reads"]
    assert [len(r) for r in m.reads] == list(m.read_lengths)
    assert set(m.read_lengths) <= set(range(tr["trimmed_min"], tr["full_length"] + 1))
    hom = m.homolog
    assert {(bool(s), int(o)) for s, o in zip(m.reverse[hom], m.offset[hom])} == {
        (s, o) for s in (False, True) for o in range(3)}
    assert 0 < (~hom).sum() < hom.sum()
    # a homolog scores best in its own frame: the strand and offset it was given
    for j in np.nonzero(hom)[0][:12]:
        frames = dict(translate.frames(m.reads[j]))
        own = ("-" if m.reverse[j] else "+") + str(int(m.offset[j]))
        entry = m.entry(m.sources[j])
        shared = {lab: len(set(map(tuple, np.lib.stride_tricks.sliding_window_view(aa, 3)))
                            & set(map(tuple, np.lib.stride_tricks.sliding_window_view(entry, 3))))
                  for lab, aa in frames.items()}
        assert max(shared, key=shared.get) == own


def test_warm_up_covers_every_profile_height(root):
    m = mix(root, SEED)
    height = [-(-max(len(aa) for _, aa in translate.frames(r)) // 32) for r in m.reads]
    per, pool = m.per, m.traffic["pool_calls"]
    assert set(height[pool * per:]) == set(height[:pool * per])


def test_full_size_warm_up_covers_every_profile_height():
    """At the cell's own read lengths the warm-up call holds both heights (64
    and 96 rows), so nothing new is built inside the window."""
    traffic = tiny.load("ssabench/traffic/translated_search.json")
    tr, per, pool = traffic["reads"], traffic["queries_per_call"], traffic["pool_calls"]
    fixed = np.random.default_rng([tr["source_seed"]])
    n = (pool + 1) * per
    full = fixed.random(n) < tr["full_share"]
    lengths = np.where(full, tr["full_length"],
                       fixed.integers(tr["trimmed_min"], tr["trimmed_max"] + 1, n))
    rows = [32 * -(-(int(L) // 3) // 32) for L in lengths]
    assert set(rows[pool * per:]) == set(rows[:pool * per]) == {64, 96}


@pytest.fixture
def faults(monkeypatch):
    from libssa_tpu_torch import api
    from libssa_tpu_torch.constants import Strand

    init = api.SSAContext.init_symbol_translation

    def forward_only():
        monkeypatch.setattr(api.SSAContext, "init_symbol_translation",
                            lambda self, symtype, strands, **kw: init(self, symtype,
                                                                      Strand.FORWARD, **kw))

    def code_2():
        monkeypatch.setattr(api.SSAContext, "init_symbol_translation",
                            lambda self, *a, **kw: init(self, *a, **dict(kw, q_gencode=2)))

    def patch_hits(change):
        orig = api.SSAContext._align

        def changed(self, *a, **k):
            out = orig(self, *a, **k)
            change(out.hits)
            return out
        monkeypatch.setattr(api.SSAContext, "_align", changed)

    def frame_moved():
        def move(hits):
            for h in hits:
                h.strand = translate.LABELS[(translate.LABELS.index(h.strand) + 1) % 6]
        patch_hits(move)

    def score_altered():
        def alter(hits):
            hits[-1].score += 1
        patch_hits(alter)

    return {"forward_only": forward_only, "code_2": code_2, "frame_moved": frame_moved,
            "score_altered": score_altered}


@pytest.mark.parametrize("fault,number", [
    ("forward_only", "hit_mismatches"), ("code_2", "hit_mismatches"),
    ("frame_moved", "frame_mismatches"), ("score_altered", "hit_mismatches")])
def test_fault_turns_correct_false(root, faults, fault, number):
    faults[fault]()
    r = run(root)
    assert not r["correct"] and r["failed"] == 0
    assert r["checks"][number]["value"] > 0, r["checks"]
