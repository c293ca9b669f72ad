"""``libssa_tpu_torch.parallel.sharded`` against the JAX package's sharded
engine and the port's single-device engine, on the CPU.

Each test mirrors one of ``tests/test_sharded.py``'s, with its parameters:
the same seeded numpy inputs go through three engines, the port's
``ShardedSearchEngine`` with D shards on the CPU, the reference's on the
8-device virtual CPU mesh (``tests/conftest.py``) and the port's
``SearchEngine``; scores, ids and order must be equal (tolerance 0: the
scores are integers). The dispatch counts are the port's own: one shard
sweep and one fetch a shard a call.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from libssa_tpu import matrices as j_matrices
from libssa_tpu.constants import BitWidth as JBitWidth
from libssa_tpu.constants import SymType as JSymType
from libssa_tpu.io.db import SequenceDB as JSequenceDB
from libssa_tpu.parallel import sharded as j_sharded
from libssa_tpu.search import manager as j_manager
from libssa_tpu_torch import matrices
from libssa_tpu_torch.constants import BitWidth, SymType
from libssa_tpu_torch.io.db import SequenceDB
from libssa_tpu_torch.parallel.sharded import ShardedSearchEngine, make_db_mesh
from libssa_tpu_torch.search import manager
from libssa_tpu_torch.search.manager import SearchEngine, SearchParams, SearchStats

torch.set_num_threads(1)

B62 = matrices.builtin("BLOSUM62")
J_B62 = j_matrices.builtin("BLOSUM62")
BIT_WIDTHS = (BitWidth.EXACT, BitWidth.BIT8, BitWidth.BIT16, BitWidth.BIT64)


def _seqs(n, seed=0, minlen=4, maxlen=60):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 20, int(rng.integers(minlen, maxlen))).astype(np.uint8)
            for _ in range(n)]


def _nt_seqs(rng, n, lo=12, hi=120):
    return [rng.integers(0, 4, int(x)).astype(np.uint8) for x in rng.integers(lo, hi, size=n)]


class Trio:
    """The port's sharded engine, the reference's and the port's single-device
    engine over one database."""

    def __init__(self, seqs, D, batch_size=16, symtype="AMINOACID", translated=False,
                 scoring=(B62, J_B62), gaps=(10, 1), dtype="float32"):
        headers = [f"s{i}" for i in range(len(seqs))]
        db = SequenceDB.from_sequences(headers, seqs, SymType[symtype])
        jdb = JSequenceDB.from_sequences(headers, seqs, JSymType[symtype])
        self.orig = None
        if translated:
            (db, self.orig, _), (jdb, jorig, _) = db.translated(1), jdb.translated(1)
            np.testing.assert_array_equal(self.orig, jorig)
        self.db = db
        self.params = SearchParams(batch_size=batch_size, dtype=dtype)
        mat, jmat = scoring
        self.port = ShardedSearchEngine(db, mat, *gaps, make_db_mesh(devices=["cpu"] * D),
                                        self.params)
        self.ref = j_sharded.ShardedSearchEngine(
            jdb, jmat, *gaps, j_sharded.make_db_mesh(D),
            j_manager.SearchParams(batch_size=batch_size, dtype=dtype))
        self.single = SearchEngine(db, mat, *gaps, SearchParams(batch_size=batch_size,
                                                                dtype=dtype), device="cpu")

    def run(self, method, *args, bit_width=None, stats=None, **kw):
        """``method`` on all three; the port's sharded result first."""
        jkw = dict(kw)
        if bit_width is not None:
            kw["bit_width"] = bit_width
            jkw["bit_width"] = JBitWidth[bit_width.name]
        return (getattr(self.port, method)(*args, **kw, stats=stats),
                getattr(self.ref, method)(*args, **jkw),
                getattr(self.single, method)(*args, **kw))


def _same(got, *wants):
    """Equal hit lists: ``(scores, ids)``, ``(s, rec, entry, frame)`` or a list of them."""
    for want in wants:
        assert (got is None) == (want is None)
        if got is None:
            continue
        if isinstance(got, list):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _same(g, w)
            continue
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_sharded_matches_single_device(n_devices, local):
    """search in every bit width: EXACT, the BIT8/BIT16 ladder, the BIT64 lane."""
    trio = Trio(_seqs(50, seed=1), n_devices)
    q = np.random.default_rng(2).integers(0, 20, 21).astype(np.uint8)
    for bw in BIT_WIDTHS:
        got, ref, single = trio.run("search", q, k=9, local=local, bit_width=bw)
        _same(got, ref, single)
        assert len(got[0]) == 9
    assert trio.port.requeued_chunks == 0


def test_sharded_ladder_with_overflow():
    """BIT8 start: the overflowing self-hit is rescued and still ranks 1."""
    seqs = _seqs(30, seed=3, minlen=70, maxlen=90)
    trio = Trio(seqs, 4, batch_size=8)
    st = SearchStats()
    got, ref, single = trio.run("search", seqs[4].copy(), k=5, local=True,
                                bit_width=BitWidth.BIT8, stats=st)
    _same(got, ref, single)
    assert got[1][0] == 4 and got[0][0] > 255
    assert st.rescored.get("limit>255", 0) >= 1


def test_sharded_ladder_elides_redundant_rescore():
    """Window flags alone do not rescore while the f32 window holds; a
    genuine window risk runs the real rescue, with the same hits."""
    seqs = _seqs(30, seed=3, minlen=70, maxlen=90)
    q = seqs[4].copy()
    for local in (True, False):
        trio = Trio(seqs, 4, batch_size=8)
        calls = []
        orig = trio.db.subset
        trio.db.subset = lambda ids: (calls.append(len(ids)), orig(ids))[1]
        stats = SearchStats()
        try:
            got = trio.port.search(q, k=5, local=local, bit_width=BitWidth.BIT8, stats=stats)
        finally:
            trio.db.subset = orig
        want = trio.single.search(q, k=5, local=local, bit_width=BitWidth.BIT8)
        _same(got, want, trio.ref.search(q, k=5, local=local, bit_width=JBitWidth.BIT8))
        assert stats.rescored, "rung stats must still record the flags"
        assert not calls, f"local={local}: the rescore ran ({calls})"

    trio = Trio(seqs, 4, batch_size=8)
    trio.port._fallback._window_risk = lambda m: True
    stats = SearchStats()
    got = trio.port.search(q, k=5, local=True, bit_width=BitWidth.BIT8, stats=stats)
    _same(got, trio.single.search(q, k=5, local=True, bit_width=BitWidth.BIT8))
    assert stats.cells > len(q) * trio.db.total_residues  # the rescue's cells


def test_uneven_shard_sizes():
    """13 subjects on 8 shards: padding lanes must not leak."""
    trio = Trio(_seqs(13, seed=5), 8, batch_size=8)
    q = np.random.default_rng(6).integers(0, 20, 15).astype(np.uint8)
    got, ref, single = trio.run("search", q, k=13, local=True)
    _same(got, ref, single)
    assert (got[1] >= 0).all() and (got[1] < 13).all() and len(got[1]) == 13


def test_dryrun_search_half():
    """The search half of ``__graft_entry__.dryrun_multichip`` over 8 shards:
    search_many and search_reduced equal the single-device engine, and the
    BIT64 sweep equals EXACT's scores with no re-queue."""
    rng = np.random.default_rng(1)
    seqs = [rng.integers(0, 20, int(rng.integers(6, 40))).astype(np.uint8) for _ in range(24)]
    trio = Trio(seqs, 8, batch_size=8)
    queries = [rng.integers(0, 20, int(n)).astype(np.uint8) for n in (12, 37)]
    _same(*trio.run("search_many", queries, k=4, local=True))
    tr = Trio([rng.integers(0, 4, int(rng.integers(9, 60))).astype(np.uint8) for _ in range(14)],
              8, batch_size=8, symtype="NUCLEOTIDE", translated=True)
    frames = [rng.integers(0, 20, int(x)).astype(np.uint8) for x in (8, 13)]
    got, ref, single = tr.run("search_reduced", frames, tr.orig, 4, True)
    assert got is not None
    _same(got, ref, single)
    got64 = trio.port.search(queries[0], 4, True, bit_width=BitWidth.BIT64)
    _same(got64, trio.single.search(queries[0], 4, True))
    assert trio.port.requeued_chunks == 0


def test_fault_injection_requeues_chunk():
    """A failing plan step is re-queued on the single-device engine; the
    hits are unchanged (in every bit width) and one step is counted."""
    seqs = _seqs(40, seed=8)
    q = np.random.default_rng(9).integers(0, 20, 18).astype(np.uint8)
    for bw in BIT_WIDTHS:
        trio = Trio(seqs, 4)
        s_ok = trio.port.search(q, k=8, local=True, bit_width=bw)

        def boom(step_idx):
            if step_idx == 0:
                raise RuntimeError("injected device failure")

        trio.port.fault_injector = boom
        trio.ref.fault_injector = boom
        got, ref, single = trio.run("search", q, k=8, local=True, bit_width=bw)
        assert trio.port.requeued_chunks == 1 == trio.ref.requeued_chunks
        _same(got, s_ok, ref, single)


def test_k_exceeds_per_device_lanes():
    """k above a step's lanes (8 < 10): the shard lists are min(k, lanes) wide."""
    trio = Trio(_seqs(81, seed=11), 1, batch_size=8)
    q = np.random.default_rng(12).integers(0, 20, 30).astype(np.uint8)
    _same(*trio.run("search", q, k=10, local=True))


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_sharded_search_many_matches_single_device(n_devices, local):
    """Mixed query heights (32 and 64 rows)."""
    trio = Trio(_seqs(60, seed=11), n_devices)
    rng = np.random.default_rng(12)
    queries = [rng.integers(0, 20, int(n)).astype(np.uint8) for n in (21, 30, 40, 33)]
    got, ref, single = trio.run("search_many", queries, k=7, local=local)
    _same(got, ref, single)
    assert [len(s) for s, _ in got] == [7] * 4


def test_sharded_search_many_k_exceeds_db():
    trio = Trio(_seqs(5, seed=13), 4, batch_size=8)
    rng = np.random.default_rng(14)
    queries = [rng.integers(0, 20, 15).astype(np.uint8) for _ in range(2)]
    got, ref, single = trio.run("search_many", queries, k=20, local=True)
    _same(got, ref, single)
    assert [len(s) for s, _ in got] == [5, 5]


def test_sharded_search_reduced_matches_single_device():
    """Translated frame-fanout search at 1, 2 and 8 shards; identity grouping at 4."""
    rng = np.random.default_rng(23)
    nt = _nt_seqs(rng, 25)
    frames = [rng.integers(0, 20, int(n)).astype(np.uint8) for n in (14, 21)]
    for D in (1, 2, 8):
        trio = Trio(nt, D, symtype="NUCLEOTIDE", translated=True)
        got, ref, single = trio.run("search_reduced", frames, trio.orig, 6, True)
        assert got is not None
        _same(got, ref, single)
    trio = Trio(nt, 4, symtype="NUCLEOTIDE", translated=True)
    got, ref, single = trio.run("search_reduced", frames, None, 6, True)
    assert got is not None
    _same(got, ref, single)


def test_params_mutation_invalidates_plan():
    """Mutating engine.params in place rebuilds the plan, which stays the
    reference's: every shard's chunk equals its rows of the reference's step."""
    trio = Trio(_seqs(40, seed=21), 4)
    q = np.random.default_rng(22).integers(0, 20, 18).astype(np.uint8)
    s1 = trio.port.search(q, k=8, local=True)
    assert trio.port._plan_key == (16, 64)
    for bs in (8, 16):
        trio.port.params.batch_size = bs  # in-place mutation
        trio.ref.params.batch_size = bs
        _same(trio.port.search(q, k=8, local=True), s1)
        assert trio.port._plan_key == (bs, 64)
        plan, want = trio.port._chunk_plan(), trio.ref._chunk_plan()
        assert len(plan) == len(want)
        B = max(8, min(bs // 4, 1024))
        for (n_pad, chunks), (codes, lens, ids) in zip(plan, want):
            assert codes.shape[1] == n_pad
            for d in range(4):
                rows = slice(d * B, (d + 1) * B)
                if d in chunks:
                    c, lt, it = chunks[d]
                    np.testing.assert_array_equal(c.T, codes[rows])
                    np.testing.assert_array_equal(lt, lens[rows])
                    np.testing.assert_array_equal(it, ids[rows])
                else:
                    assert (ids[rows] == -1).all()


def _boom(idx):
    if idx == 0:
        raise RuntimeError("injected device failure")


def test_fault_injection_requeues_search_many():
    trio = Trio(_seqs(50, seed=31), 4)
    rng = np.random.default_rng(32)
    queries = [rng.integers(0, 20, int(n)).astype(np.uint8) for n in (20, 35)]
    want = trio.port.search_many(queries, k=8, local=True)
    trio.port.fault_injector = trio.ref.fault_injector = _boom
    got, ref, single = trio.run("search_many", queries, k=8, local=True)
    assert trio.port.requeued_chunks > 0
    assert trio.port.requeued_chunks == trio.ref.requeued_chunks
    _same(got, want, ref, single)


@pytest.mark.parametrize("records", ["translated", "identity"])
def test_fault_injection_requeues_search_reduced(records):
    rng = np.random.default_rng(41)
    nt = _nt_seqs(rng, 25)
    frames = [rng.integers(0, 20, int(n)).astype(np.uint8) for n in (14, 21)]
    trio = Trio(nt, 4, symtype="NUCLEOTIDE", translated=True)
    group_of = trio.orig if records == "translated" else None
    want = trio.port.search_reduced(frames, group_of, 6, True)
    trio.port.fault_injector = trio.ref.fault_injector = _boom
    got, ref, single = trio.run("search_reduced", frames, group_of, 6, True)
    assert trio.port.requeued_chunks > 0
    assert trio.port.requeued_chunks == trio.ref.requeued_chunks
    assert got is not None
    _same(got, want, ref, single)


def test_sharded_reduced_overflow_fallback(monkeypatch):
    """A forced f32-window escape: None from the sharded engine, as from the
    single-device one; the exact int32 path then gives the untouched hits."""
    rng = np.random.default_rng(51)
    trio = Trio(_nt_seqs(rng, 15, 20, 90), 4, symtype="NUCLEOTIDE", translated=True)
    frames = [rng.integers(0, 20, int(n)).astype(np.uint8) for n in (14, 21)]
    want = trio.single.search_reduced(frames, trio.orig, 6, True)
    monkeypatch.setattr(manager, "F32_WINDOW", 1)
    monkeypatch.setattr(j_manager, "F32_WINDOW", 1)
    got, ref, single = trio.run("search_reduced", frames, trio.orig, 6, True)
    assert got is None and ref is None and single is None
    exact = SearchEngine(trio.db, B62, 10, 1, SearchParams(batch_size=16, dtype="int32"),
                         device="cpu").search_reduced(frames, trio.orig, 6, True)
    _same(exact, want)


def test_sharded_reduced_overflow_warning(monkeypatch, capsys):
    rng = np.random.default_rng(52)
    trio = Trio(_seqs(12, seed=52), 4)
    frames = [rng.integers(0, 20, int(n)).astype(np.uint8) for n in (14, 21)]
    monkeypatch.setattr(manager, "F32_WINDOW", 1)
    assert trio.port.search_reduced(frames, None, 5, True) is None
    err = capsys.readouterr().err
    assert "sharded search_reduced" in err and "SINGLE-device" in err


def test_sharded_many_overflow_warning(monkeypatch, capsys):
    rng = np.random.default_rng(53)
    trio = Trio(_seqs(12, seed=53), 4)
    queries = [rng.integers(0, 20, 18).astype(np.uint8) for _ in range(2)]
    want = trio.single.search_many(queries, 5, True)
    monkeypatch.setattr(manager, "F32_WINDOW", 1)
    got = trio.port.search_many(queries, 5, True)
    err = capsys.readouterr().err
    assert "sharded search_many" in err and "SINGLE-device" in err
    _same(got, want)


def test_sharded_dispatch_counts():
    """The port's own counts: one sweep and one fetch a shard a call (a
    query height in search_many), whatever the number of width groups."""
    trio = Trio(_seqs(60, seed=9, minlen=4, maxlen=200), 4)
    eng = trio.port
    assert len(eng._device_groups()) >= 2, "the DB must span several widths"
    rng = np.random.default_rng(10)
    q = rng.integers(0, 20, 24).astype(np.uint8)
    st = SearchStats()
    _same(eng.search(q, 5, stats=st), trio.ref.search(q, 5))
    assert (st.dispatches, st.fetches) == (4, 4)
    q2 = rng.integers(0, 20, 40).astype(np.uint8)  # another 32-row height
    st = SearchStats()
    _same(eng.search_many([q, q2], 5, stats=st), trio.ref.search_many([q, q2], 5))
    assert (st.dispatches, st.fetches) == (8, 8)
    st = SearchStats()
    _same(eng.search_reduced([q, q[:20]], None, 5, stats=st),
          trio.ref.search_reduced([q, q[:20]], None, 5))
    assert (st.dispatches, st.fetches) == (4, 4)


def test_sharded_search_many_records_its_waits():
    """Under a profiler each shard sweep records its waits on the device: one
    a width group's index upload and one for its fetch."""
    trio = Trio(_seqs(60, seed=9, minlen=4, maxlen=200), 4)
    rng = np.random.default_rng(10)
    queries = [rng.integers(0, 20, n).astype(np.uint8) for n in (24, 40)]  # two heights
    st = SearchStats()
    with profile(activities=[ProfilerActivity.CPU]):
        got = trio.port.search_many(queries, 5, stats=st)
    _same(got, trio.single.search_many(queries, 5))
    groups = [len(s) for s in trio.port._stacks().values() if s]
    assert len(groups) == 4 and st.dispatches == 2 * len(groups)
    assert [s.name for s in st.spans] == ["device.wait"] * (2 * sum(g + 1 for g in groups))


def test_sharded_fanout_rung_stats():
    """Narrow widths record the rung statistics of the single-device engine
    (and of the reference's sharded one); the hits equal EXACT's."""
    rng = np.random.default_rng(11)
    q = rng.integers(0, 20, 70).astype(np.uint8)
    trio = Trio(_seqs(30, seed=11) + [q.copy()], 4)
    for bw in (BitWidth.BIT8, BitWidth.BIT16):
        st_m = SearchStats()
        got, ref, single = trio.run("search_many", [q], 6, True, bit_width=bw, stats=st_m)
        _same(got, ref, single, trio.port.search_many([q], 6, True))
        st_s, st_r = SearchStats(), j_manager.SearchStats()
        trio.single.search_many([q], 6, True, st_s, bw)
        trio.ref.search_many([q], 6, True, st_r, JBitWidth[bw.name])
        assert st_m.rescored == st_s.rescored == st_r.rescored
        assert (st_m.cells, st_m.subjects) == (st_s.cells, st_s.subjects)

        st_m, st_s = SearchStats(), SearchStats()
        got = trio.port.search_reduced([q], None, 6, True, st_m, bw)
        _same(got, trio.single.search_reduced([q], None, 6, True, st_s, bw))
        assert st_m.rescored == st_s.rescored
        assert (st_m.cells, st_m.subjects) == (st_s.cells, st_s.subjects)
    st8 = SearchStats()
    trio.port.search_many([q], 6, True, st8, BitWidth.BIT8)
    assert st8.rescored.get("limit>255/pairs", 0) >= 1
    st16 = SearchStats()
    trio.port.search_many([q], 6, True, st16, BitWidth.BIT16)
    assert not st16.rescored


def test_sharded_k_beyond_candidates():
    """k past the candidates: exactly len(db) real hits, no sentinel."""
    trio = Trio(_seqs(5, seed=60), 4)
    q = np.random.default_rng(61).integers(0, 20, 18).astype(np.uint8)
    got, ref, single = trio.run("search", q, k=12, local=True)
    _same(got, ref, single)
    assert len(got[0]) == 5 and (got[1] < 5).all() and (got[1] >= 0).all()


def test_search_stats_equal_single_device():
    """cells, subjects and rescored of search equal the single-device
    engine's in every bit width."""
    seqs = _seqs(30, seed=3, minlen=70, maxlen=90)
    trio = Trio(seqs, 4, batch_size=8)
    for local in (True, False):
        for bw in BIT_WIDTHS:
            st_m, st_s = SearchStats(), SearchStats()
            _same(trio.port.search(seqs[4], 5, local, bw, st_m),
                  trio.single.search(seqs[4], 5, local, bw, st_s))
            assert (st_m.cells, st_m.subjects, st_m.rescored) == (
                st_s.cells, st_s.subjects, st_s.rescored), (local, bw)


def _beyond_int32(seed):
    """Nucleotides under a 2**28 match score, with a subject equal to the
    query, so the best scores pass int32."""
    rng = np.random.default_rng(seed)
    hot = np.tile(np.arange(4, dtype=np.uint8), 5)
    seqs = [rng.integers(0, 4, int(n)).astype(np.uint8) for n in rng.integers(5, 60, 7)]
    scoring = (matrices.constant_scoring(2**28, -4, SymType.NUCLEOTIDE),
               j_matrices.constant_scoring(2**28, -4, JSymType.NUCLEOTIDE))
    return seqs + [hot], hot.copy(), scoring


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_sharded_bit64_beyond_int32(dtype, local):
    """BIT64 sweeps in int64 end to end: scores past int32 survive the
    shards' device top-k and the gather, equal to the oracle's, with no
    window flags and no re-queue."""
    from libssa_tpu_torch import oracle
    from libssa_tpu_torch.ops.topk import host_topk

    seqs, q, scoring = _beyond_int32(22)
    fn = oracle.sw_score if local else oracle.nw_score
    want = np.asarray([fn(q, s, scoring[0].scores, 10, 2) for s in seqs], np.int64)
    assert want.max() > 2**31
    trio = Trio(seqs, 4, batch_size=8, symtype="NUCLEOTIDE", scoring=scoring, gaps=(10, 2),
                dtype=dtype)
    st = SearchStats()
    got, ref, single = trio.run("search", q, 3, local=local, bit_width=BitWidth.BIT64, stats=st)
    _same(got, host_topk(want, np.arange(len(seqs), dtype=np.int32), 3), ref, single)
    assert trio.port.requeued_chunks == 0 and not st.rescored
    assert (st.dispatches, st.fetches) == (4, 4)


def test_sharded_bit64_requeue_stays_int64():
    """A faulted step re-queues on the single-device int64 lane: scores past
    int32 stay exact through the re-queue's merge."""
    seqs, q, scoring = _beyond_int32(23)
    trio = Trio(seqs, 4, batch_size=8, symtype="NUCLEOTIDE", scoring=scoring, gaps=(10, 2))
    trio.port.fault_injector = trio.ref.fault_injector = _boom
    got, ref, single = trio.run("search", q, 3, local=True, bit_width=BitWidth.BIT64)
    _same(got, ref, single)
    assert got[0][0] > 2**31 and trio.port.requeued_chunks == 1 == trio.ref.requeued_chunks


def test_mesh_layout():
    """Shards are numbered in order on the given devices; n takes the first n."""
    mesh = make_db_mesh(3, devices=["cpu"] * 5)
    assert mesh.size == 3 and sorted(mesh.local) == [0, 1, 2] and mesh.group is None
    assert all(d.type == "cpu" for d in mesh.local.values())
    with pytest.raises(ValueError):
        make_db_mesh(6, devices=["cpu"] * 5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_db_mesh()
