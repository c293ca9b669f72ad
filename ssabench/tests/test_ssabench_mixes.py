"""Each mix is deterministic in its seed, and every seed sends the same sizes."""
import numpy as np
import pytest

from ssabench import gen
from ssabench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


def mix(root, cell, seed):
    import importlib
    import json

    from ssabench.harness import find, load_manifest

    m = load_manifest(root)
    w = find(m["workloads"], cell, "workload")
    cfg = json.loads((root / find(m["configs"], w["config"], "config")["file"]).read_text())
    traffic = json.loads((root / "ssabench" / "traffic" / f"{cell}.json").read_text())
    return importlib.import_module(f"ssabench.mixes.{traffic['kind']}").Mix(cfg, traffic, seed, "cpu")


@pytest.mark.parametrize("cell", ["tiny_batch", "tiny_single"])
def test_db_search_inputs(root, cell):
    a, b, c = (mix(root, cell, s) for s in (2**31 + 11, 2**31 + 11, 2**33 + 5))
    assert (a.codes == b.codes).all() and (a.lengths == b.lengths).all()
    assert all((x == y).all() for x, y in zip(a.queries, b.queries))
    # another seed: other residues and order, the same sizes and query lengths
    assert not (a.codes[:200] == c.codes[:200]).all()
    assert sorted(a.lengths) == sorted(c.lengths)
    assert [len(q) for q in a.queries] == [len(q) for q in c.queries]
    assert a.requests(1) == c.requests(1)


@pytest.mark.parametrize("cell", ["tiny_score", "tiny_align"])
def test_pair_inputs(root, cell):
    a, b, c = (mix(root, cell, s) for s in (7, 7, 8))
    assert (a.q == b.q).all() and (a.s == b.s).all() and a.subject == b.subject
    assert not (a.q == c.q).all()
    assert (len(a.q), len(a.s)) == (len(c.q), len(c.s)) == (
        a.traffic["query_length"], a.traffic["subject_length"])


def test_check_samples_every_part_of_a_batch(root):
    """One query from each run of a call's positions, so a fault in any part
    of a batch (half of it left out) meets the check in every run."""
    m = mix(root, "tiny_batch", 2**31)
    for seed in range(2**31, 2**31 + 20):
        m.seed = seed  # the sample's draw, on the same inputs
        done = [j for c in (0, 1) for j in m.requests(c)]
        pick = m.sample(done)
        runs = np.array_split(np.arange(m.per), m.traffic["check_queries"])
        assert [j % m.per in r for j, r in zip(pick, runs)] == [True] * len(runs)
        assert set(pick) <= set(done)
    m1 = mix(root, "tiny_single", 5)
    assert len(set(m1.sample(list(range(10))))) == m1.traffic["check_queries"]


def test_a_layout_seed_fixes_where_the_gaps_fall():
    """With one ``layout``, every seed's homolog keeps the same source
    residues at the same places; only the drawn residues differ."""
    src = (4 + np.arange(3000) % 200).astype(np.uint8)  # marks: no drawn residue is >= 4
    outs = [gen.evolve(gen.rng(s), src, 2950, 0.1, 0.01, 3.0, np.ones(4), gen.rng(77))
            for s in (1, 2)]
    kept = [np.flatnonzero(o >= 4) for o in outs]
    assert (kept[0] == kept[1]).all() and (outs[0][kept[0]] == outs[1][kept[1]]).all()
    assert not (outs[0] == outs[1]).all()
    free = [gen.evolve(gen.rng(s), src, 2950, 0.1, 0.01, 3.0, np.ones(4)) for s in (1, 2)]
    assert not np.array_equal(np.flatnonzero(free[0] >= 4), np.flatnonzero(free[1] >= 4))


def test_lognormal_lengths_mean():
    lens = gen.lognormal_lengths(gen.rng(1), 200_000, 361, 0.55, 10, 35213)
    assert abs(lens.mean() - 361) < 3 and lens.min() >= 10


@pytest.mark.parametrize("target", [500, 600, 420])
def test_evolve_gives_exact_length_and_identity(target):
    g = gen.rng(2**40 + 3)
    src = gen.residues(g, 500, np.ones(4))
    out = gen.evolve(g, src, target, 0.1, 0.01, 2.0, np.ones(4))
    assert len(out) == target and out.dtype == np.uint8 and out.max() < 4


def test_residues_follow_the_composition():
    w = np.array([1, 2, 3, 4], dtype=float)
    r = gen.residues(gen.rng(9), 400_000, w)
    assert np.allclose(np.bincount(r, minlength=4) / len(r), w / w.sum(), atol=3e-3)


def test_large_seeds_are_accepted():
    assert gen.rng(2**31 + 17).integers(0, 10) == gen.rng(2**31 + 17).integers(0, 10)
    gen.rng(-5, 2**70)


def test_family_fills_the_top_hits(root):
    from ssabench.reference import dp, scoring

    m = mix(root, "tiny_single", 2**32 + 9)
    sub = scoring.substitution({"matrix": "BLOSUM62"})
    db = dp.Database(m.codes, m.offsets, m.lengths, 20, "cpu")
    for j, scores in enumerate(db.scores(m.queries[:3], sub, 12, 1, True)):
        top = dp.top_hits(scores, 10)
        assert {i for i, _ in top} == set(m.families[j].tolist())
        assert len(m.families[j]) == 10
