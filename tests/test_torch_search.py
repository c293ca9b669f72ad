"""The port's sweeps and SearchEngine against the JAX package, on the CPU.

Same database, same queries, both packages: hit lists (order and
tie-breaks included), flags, and the search statistics must be equal.
Databases hold duplicated sequences on purpose so that scores tie.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libssa_tpu import matrices
from libssa_tpu.constants import BitWidth as JaxBitWidth
from libssa_tpu.constants import SymType
from libssa_tpu.io.db import SequenceDB
from libssa_tpu.ops.scoring import make_padded_profile
from libssa_tpu.search import kernels as jax_kernels
from libssa_tpu.search import manager as jax_manager
from libssa_tpu_torch import matrices as port_matrices
from libssa_tpu_torch.constants import BitWidth
from libssa_tpu_torch.convert import db_from_reference, engine_from_reference, stacks_to_device
from libssa_tpu_torch.search import kernels, manager

torch.set_num_threads(1)

B62 = matrices.builtin("BLOSUM62")
PADDED = B62.padded()


def _db(n=30, seed=0, minlen=5, maxlen=70, dup_every=4):
    """Random proteins; every ``dup_every``-th one repeats an earlier one."""
    rng = np.random.default_rng(seed)
    seqs = []
    for i in range(n):
        if dup_every and i % dup_every == dup_every - 1:
            seqs.append(seqs[int(rng.integers(0, i))].copy())
        else:
            seqs.append(
                rng.integers(0, 20, int(rng.integers(minlen, maxlen))).astype(np.uint8)
            )
    db = SequenceDB.from_sequences([f"s{i}" for i in range(n)], seqs, SymType.AMINOACID)
    return db, seqs


@pytest.fixture(scope="module")
def small_db():
    return _db()


@pytest.fixture(scope="module")
def homolog_db():
    """Long near-copies: self-hits leave the 8-bit window."""
    return _db(24, seed=3, minlen=70, maxlen=90, dup_every=3)


def _jax_stacks(grouped, with_ids=False):
    out = []
    for c, l, sids in grouped:
        t = (jnp.asarray(c, jnp.int8), jnp.asarray(l, jnp.int32))
        out.append(t + (jnp.asarray(np.stack(sids), jnp.int32),) if with_ids else t)
    return tuple(out)


def _sweeps(local, eff_limit=255, nlimit=None, dtype="float32"):
    """The reference's five sweeps (a tuple) and the port's (named)."""
    j = jax_kernels.stage_sweep("scan", 11, 1, local, False, dtype, eff_limit, nlimit)
    t = kernels.stage_sweep("auto", 11, 1, local, dtype, eff_limit, nlimit)
    return j, t


def _queries(seqs, rng, n=3):
    return [seqs[1], rng.integers(0, 20, 17).astype(np.uint8), seqs[6]][:n]


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_sweep_and_sweep_multi_match(small_db, local):
    db, seqs = small_db
    grouped = db.grouped_stacks(8, 16)
    jst = _jax_stacks(grouped)
    tst = tuple((c, l) for c, l, _ in stacks_to_device(grouped, "cpu"))
    (jsweep, jmulti, *_), port = _sweeps(local, eff_limit=60)
    q = seqs[2]
    prof = make_padded_profile(q, PADDED)
    js, jf = jsweep(jnp.asarray(prof), jst, jnp.int32(len(q)))
    got = port.scores(torch.as_tensor(prof), tst, len(q))
    np.testing.assert_array_equal(got.scores, np.asarray(js))
    np.testing.assert_array_equal(got.flags, np.asarray(jf))
    assert got.flags.any() and not got.flags.all()

    qs = _queries(seqs, np.random.default_rng(1), 2)
    profs = np.stack([make_padded_profile(x, PADDED, rows=64) for x in qs])
    mrs = [len(x) for x in qs]
    jpairs = []
    for jc, jl in jst:
        nc = jc.shape[0]
        iq = np.repeat(np.arange(2, dtype=np.int32), nc)
        ic = np.tile(np.arange(nc, dtype=np.int32), 2)
        jpairs.append((jc, jl, jnp.asarray(iq), jnp.asarray(ic)))
    js, jf = jmulti(jnp.asarray(profs), tuple(jpairs), jnp.asarray(mrs, jnp.int32))
    got = port.scores_many(torch.as_tensor(profs), kernels.pairs(tst, 2), mrs)
    np.testing.assert_array_equal(got.scores, np.asarray(js))
    np.testing.assert_array_equal(got.flags, np.asarray(jf))


def _pair_stacks(grouped, nq, jax_side):
    """Every (query, chunk) pair: the reference's staged here, the port's by
    ``kernels.pairs``."""
    if not jax_side:
        return kernels.pairs(stacks_to_device(grouped, "cpu"), nq)
    out = []
    for c, l, sids in grouped:
        nc = c.shape[0]
        iq = np.repeat(np.arange(nq, dtype=np.int32), nc)
        ic = np.tile(np.arange(nc, dtype=np.int32), nq)
        ids = np.stack(sids).astype(np.int32)
        out.append((jnp.asarray(c, jnp.int8), jnp.asarray(l), jnp.asarray(ids),
                    jnp.asarray(iq), jnp.asarray(ic)))
    return tuple(out)


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_sweep_multi_topk_matches(small_db, local):
    """(query, score desc, id asc), duplicates tying; narrow-window counts."""
    db, seqs = small_db
    grouped = db.grouped_stacks(8, 16)
    qs = _queries(seqs, np.random.default_rng(2))
    profs = np.stack([make_padded_profile(x, PADDED, rows=64) for x in qs])
    mrs = [len(x) for x in qs]
    (*_, jtopk, _, _), port = _sweeps(local, eff_limit=2**24 - 1, nlimit=255)
    want = jtopk(jnp.asarray(profs), _pair_stacks(grouped, 3, True),
                 jnp.asarray(mrs, jnp.int32), 12, 3)
    got = port.topk_many(torch.as_tensor(profs), _pair_stacks(grouped, 3, False), mrs, 12)
    np.testing.assert_array_equal(got.scores, np.asarray(want[0]))
    np.testing.assert_array_equal(got.ids, np.asarray(want[1]))
    assert got.overflow == bool(want[2]) and got.n_flagged == int(want[3])
    assert any(len(set(r)) < len(r) for r in got.scores), "no tie was exercised"


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_sweep_ladder_topk_matches(homolog_db, local):
    db, seqs = homolog_db
    grouped = db.grouped_stacks(8, 16)
    q = seqs[4]
    prof = make_padded_profile(q, PADDED)
    (jsweep, *_, jladder), port = _sweeps(local, eff_limit=255)
    jout, js, ji = jladder(jnp.asarray(prof), _jax_stacks(grouped, True), jnp.int32(len(q)), 9)
    got = port.ladder(torch.as_tensor(prof), stacks_to_device(grouped, "cpu"), len(q), 9)
    jout = np.asarray(jout).astype(np.int64)
    np.testing.assert_array_equal(got.scores, jout[:9])
    np.testing.assert_array_equal(got.ids, jout[9:18])
    # The reference's packed flags, and its plain sweep's flags on real lanes.
    np.testing.assert_array_equal(got.lane_flags,
                                  kernels.unpack_flags(jout[18:] & 0xFFFFFFFF, len(js)))
    _, jf = jsweep(jnp.asarray(prof), _jax_stacks(grouped), jnp.int32(len(q)))
    np.testing.assert_array_equal(got.lane_flags, np.asarray(jf) & (np.asarray(ji) < 2**31 - 1))
    assert got.lane_flags.any()
    np.testing.assert_array_equal(got.lane_scores.numpy(), np.asarray(js))


def _same_reduced(got, want):
    """The port's named ``reduced`` against the reference's tuple."""
    for g, w in zip((got.scores, got.records, got.entries, got.frames), want[:4]):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got.overflow == bool(want[4]) and got.n_flagged == int(want[5])


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_sweep_reduced_matches(small_db, local):
    """First frame on ties, lowest entry per record, (score desc, record asc)."""
    db, seqs = small_db
    grouped = db.grouped_stacks(8, 16)
    frames = [seqs[1], seqs[1], seqs[6][:20], seqs[3]]  # frames 0 and 1 tie
    profs = np.stack([make_padded_profile(f, PADDED, rows=64) for f in frames])
    mrs = [len(f) for f in frames]
    group_of = (np.arange(len(db)) // 2).astype(np.int32)  # two entries a record
    (*_, jred, _), port = _sweeps(local, eff_limit=2**24 - 1, nlimit=255)
    want = jred(jnp.asarray(profs), _pair_stacks(grouped, 4, True),
                jnp.asarray(mrs, jnp.int32), jnp.asarray(group_of), 8, 4)
    got = port.reduced(torch.as_tensor(profs), _pair_stacks(grouped, 4, False), mrs,
                       torch.as_tensor(group_of), 8)
    _same_reduced(got, want)


def test_best_kernel_choices():
    from libssa_tpu_torch.ops import interseq, interseq_cuda

    assert kernels.best_kernel() is interseq_cuda.interseq_pairs_cuda
    assert kernels.best_kernel("cuda") is interseq_cuda.interseq_pairs_cuda
    assert kernels.best_kernel("plain") is interseq.interseq_pairs
    with pytest.raises(ValueError):
        kernels.best_kernel("pallas")


def test_rungs_match():
    for bw in BitWidth:
        for dt in ("float32", "int32", "int64"):
            assert manager._rungs(bw, dt) == jax_manager._rungs(JaxBitWidth(bw), dt)


def _stats_key(st):
    return (st.cells, st.subjects, st.rescored, st.notes, st.dispatches, st.fetches)


def _pair(db, params=None, gaps=(10, 1)):
    ref = jax_manager.SearchEngine(
        db, B62, *gaps, params or jax_manager.SearchParams(batch_size=8)
    )
    return ref, engine_from_reference(ref, "cpu")


def _same_hits(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == want[1].dtype


@pytest.mark.parametrize(
    "bw", [BitWidth.EXACT, BitWidth.BIT8, BitWidth.BIT16, BitWidth.BIT64],
    ids=lambda b: b.name,
)
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_engine_search_matches(homolog_db, local, bw):
    db, seqs = homolog_db
    ref, eng = _pair(db)
    rescored = {}
    for q in (seqs[4], seqs[7][:33]):
        s_ref, s_eng = jax_manager.SearchStats(), manager.SearchStats()
        want = ref.search(q, 6, local, JaxBitWidth(bw), s_ref)
        got = eng.search(q, 6, local, bw, s_eng)
        _same_hits(got, want)
        assert _stats_key(s_eng) == _stats_key(s_ref)
        rescored.update(s_eng.rescored)
    if bw == BitWidth.BIT8 and local:
        assert rescored, "the homolog self-hit must leave the 8-bit window"


@pytest.mark.parametrize("bw", [BitWidth.BIT8, BitWidth.BIT64], ids=lambda b: b.name)
def test_engine_score_all_ladder_matches(homolog_db, bw):
    db, seqs = homolog_db
    ref, eng = _pair(db)
    s_ref, s_eng = jax_manager.SearchStats(), manager.SearchStats()
    want = ref.score_all(seqs[4], True, JaxBitWidth(bw), s_ref)
    got = eng.score_all(seqs[4], True, bw, s_eng)
    np.testing.assert_array_equal(got, want)
    assert _stats_key(s_eng) == _stats_key(s_ref)


@pytest.mark.parametrize("bw", [BitWidth.EXACT, BitWidth.BIT8, BitWidth.BIT16],
                         ids=lambda b: b.name)
def test_engine_search_many_matches(homolog_db, bw):
    """Mixed query heights (one sweep per height group), pair rung stats."""
    db, seqs = homolog_db
    ref, eng = _pair(db)
    qs = [seqs[4], seqs[2][:30], seqs[10], seqs[5][:12]]
    for local in (True, False):
        s_ref, s_eng = jax_manager.SearchStats(), manager.SearchStats()
        want = ref.search_many(qs, 5, local, s_ref, JaxBitWidth(bw))
        got = eng.search_many(qs, 5, local, s_eng, bw)
        for g, w in zip(got, want):
            _same_hits(g, w)
        assert _stats_key(s_eng) == _stats_key(s_ref)


def test_engine_search_reduced_matches(homolog_db):
    db, seqs = homolog_db
    ref, eng = _pair(db)
    frames = [seqs[4][:40], seqs[4][:40], seqs[8]]
    group_of = (np.arange(len(db)) // 3).astype(np.int32)
    for bw in (BitWidth.EXACT, BitWidth.BIT8, BitWidth.BIT64):
        s_ref, s_eng = jax_manager.SearchStats(), manager.SearchStats()
        want = ref.search_reduced(frames, group_of, 5, True, s_ref, JaxBitWidth(bw))
        got = eng.search_reduced(frames, group_of, 5, True, s_eng, bw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert _stats_key(s_eng) == _stats_key(s_ref)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_engine_pinned_dtypes_match(small_db, dtype):
    db, seqs = small_db
    ref, eng = _pair(db, jax_manager.SearchParams(batch_size=8, dtype=dtype))
    for bw in (BitWidth.EXACT, BitWidth.BIT16):
        for local in (True, False):
            s_ref, s_eng = jax_manager.SearchStats(), manager.SearchStats()
            _same_hits(eng.search(seqs[5], 7, local, bw, s_eng),
                       ref.search(seqs[5], 7, local, JaxBitWidth(bw), s_ref))
            assert _stats_key(s_eng) == _stats_key(s_ref)


def test_engine_forced_f32_window_escapes(homolog_db, monkeypatch):
    """A tiny f32 window: the exact fallbacks run in both packages alike."""
    monkeypatch.setattr(jax_manager, "F32_WINDOW", 90)
    monkeypatch.setattr(manager, "F32_WINDOW", 90)
    db, seqs = homolog_db
    ref, eng = _pair(db)
    q = seqs[4]
    for local in (True, False):
        s_ref, s_eng = jax_manager.SearchStats(), manager.SearchStats()
        exact = ref.search(q, 6, local, JaxBitWidth.EXACT, s_ref)
        _same_hits(eng.search(q, 6, local, BitWidth.EXACT, s_eng), exact)
        assert _stats_key(s_eng) == _stats_key(s_ref)
        assert s_eng.dispatches > 1  # the full-matrix fallback ran
        s_ref, s_eng = jax_manager.SearchStats(), manager.SearchStats()
        assert eng.search_reduced([q, q[:50]], None, 5, local, s_eng) is None
        assert ref.search_reduced([q, q[:50]], None, 5, local, s_ref) is None
        assert _stats_key(s_eng) == _stats_key(s_ref)
        # The narrow rungs' rescue rescores subsets of subsets; the JAX
        # package maps those ids wrongly (ROADMAP Queue 3), so the port is
        # held against the exact hit list here.
        for bw in (BitWidth.BIT8, BitWidth.BIT16):
            st = manager.SearchStats()
            _same_hits(eng.search(q, 6, local, bw, st), exact)
            assert "limit>90" in st.rescored
    s_ref, s_eng = jax_manager.SearchStats(), manager.SearchStats()
    np.testing.assert_array_equal(eng.score_all(q, True, BitWidth.EXACT, s_eng),
                                  ref.score_all(q, True, JaxBitWidth.EXACT, s_ref))
    assert _stats_key(s_eng) == _stats_key(s_ref)
    assert "limit>90" in s_eng.rescored


def test_engine_prepare_and_stack_cache(small_db):
    db, seqs = small_db
    _, eng = _pair(db)
    eng.prepare(query_length=20, k=4)
    assert len(eng._device_stacks) == 1
    first = eng._device_stacks[(8, 64)]
    eng.search(seqs[0], 4)
    assert eng._device_stacks[(8, 64)] is first  # uploaded once
    eng.params.batch_size = 16
    eng.search(seqs[0], 4)
    assert set(eng._device_stacks) == {(8, 64), (16, 64)}


def test_engine_device_is_explicit(small_db):
    db, _ = small_db
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    db, b62 = db_from_reference(db), port_matrices.builtin("BLOSUM62")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        manager.SearchEngine(db, b62, 10, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        manager.SearchEngine(db, b62, 10, 1, device="meta")
    assert manager.SearchEngine(db, b62, 10, 1, device="cpu").device.type == "cpu"


def test_stacks_to_device_layout(small_db):
    db, _ = small_db
    grouped = db.grouped_stacks(8, 16)
    for (c, l, sids), (tc, tl, ti) in zip(grouped, stacks_to_device(grouped, "cpu")):
        assert tc.dtype == torch.int8 and tl.dtype == torch.int32 and ti.dtype == torch.int32
        np.testing.assert_array_equal(tc.numpy(), c)
        np.testing.assert_array_equal(ti.numpy(), np.stack(sids))
        assert tc.shape == c.shape and tl.shape == l.shape


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_sweep_reduced_identity_records(small_db, local):
    """``group_of=None`` (each entry its own record) gives what the identity
    map gives, in the reference and in the port; frames tie on every entry."""
    db, seqs = small_db
    grouped = db.grouped_stacks(8, 16)
    frames = [seqs[2], seqs[2], seqs[2], seqs[5][:30], seqs[2], seqs[0]]
    profs = np.stack([make_padded_profile(f, PADDED, rows=96) for f in frames])
    mrs = [len(f) for f in frames]
    ident = np.arange(len(db), dtype=np.int32)
    (*_, jred, _), port = _sweeps(local, eff_limit=2**24 - 1, nlimit=255)
    want = jred(jnp.asarray(profs), _pair_stacks(grouped, 6, True),
                jnp.asarray(mrs, jnp.int32), jnp.asarray(ident), 10, 6)
    got = port.reduced(torch.as_tensor(profs), _pair_stacks(grouped, 6, False), mrs, None, 10)
    _same_reduced(got, want)
    assert set(got.frames.tolist()) <= {0, 3, 5}  # the first of the tied frames
