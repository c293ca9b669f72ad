"""K1, K3, K2, the search engine, the linear-space traceback, the level,
leaf and hit kernels, the probes' kernels and K1's variants on an NVIDIA GPU,
against the plain version and the CPU.

Every test here needs a card: it is marked ``cuda`` and skips without one.
The file imports neither JAX nor the JAX package, so it also runs where
they are not installed; on a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``tests/conftest.py`` configures JAX for the rest of the suite.)
Tolerance: exact equality: the DP values are integers, and the probes'
f32 and bf16 ops round exactly as their plain versions do.
"""
import numpy as np
import pytest
import test_torch_hitbatch as hit_tests
import torch
from torch.profiler import ProfilerActivity, profile

from libssa_tpu_torch import alphabet, api, matrices, oracle
from libssa_tpu_torch.constants import BitWidth, ComputeMode, SymType
from libssa_tpu_torch.experiments import _interseq_variants as IV
from libssa_tpu_torch.io.db import PAD_CODE, SequenceDB
from libssa_tpu_torch.ops import (
    hit_cuda,
    interseq,
    interseq_cuda,
    leaf_cuda,
    longpair,
    mm_level_cuda,
    longpair_cuda,
    ring_block,
    ring_block_cuda,
)
from libssa_tpu_torch.ops.mm_device import DevicePair
from libssa_tpu_torch.ops.scoring import make_padded_profile
from libssa_tpu_torch.search import aligner, hirschberg
from libssa_tpu_torch.search.manager import SearchEngine, SearchParams, SearchStats

B62 = matrices.builtin("BLOSUM62")
PADDED = B62.padded()

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1, K2 and K3 have no CPU mode)")
    return torch.device("cuda", 0)


def _pairs(rng, m, nq=3, g=2, n_pad=36, B=21, P=7):
    """A stack group with ragged, padded and length-0 lanes, and P pairs."""
    profs = np.stack([
        make_padded_profile(rng.integers(0, 20, m).astype(np.uint8), PADDED)
        for _ in range(nq)
    ]).astype(np.int32)
    m_reals = rng.integers(1, m + 1, nq).astype(np.int32)
    lengths = rng.integers(0, n_pad + 1, (g, B)).astype(np.int32)
    lengths[:, :2] = 0
    codes = rng.integers(0, 20, (g, n_pad, B)).astype(np.int8)
    codes[np.arange(n_pad)[None, :, None] >= lengths[:, None, :]] = PAD_CODE
    iq = rng.integers(0, nq, P).astype(np.int32)
    ic = rng.integers(0, g, P).astype(np.int32)
    return profs, codes, lengths, iq, ic, m_reals


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_k1_matches_plain(dev, local, dtype):
    rng = np.random.default_rng(31)
    for m in (1, 33, 300):
        t = [torch.as_tensor(a).to(dev) for a in _pairs(rng, m)]
        for track in (True, False):
            before = interseq_cuda.launches
            got = interseq_cuda.interseq_pairs_cuda(
                *t, 12, 1, local=local, track_range=track, dtype=dtype
            )
            torch.cuda.synchronize()
            assert interseq_cuda.launches == before + 1
            want = interseq.interseq_pairs(
                *t, 12, 1, local=local, track_range=track, dtype=dtype
            )
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("warps", [1, 2, 4, 8, 16])
def test_k1_pipeline_matches_plain(dev, warps, dtype):
    """Each warps count: SW/NW x track_range, m across the last strip's
    guard, the pipeline's edges and the wrap, 4-byte (B = 64) and byte (B =
    70) code slices, one launch each."""
    rng = np.random.default_rng(300 + warps)
    for m, B in ((1, 64), (31, 70), (33, 64), (70, 70), (300, 64), (300, 70)):
        t = [torch.as_tensor(a).to(dev) for a in _pairs(rng, m, B=B)]
        for local in (True, False):
            for track in (True, False):
                kw = dict(local=local, track_range=track, dtype=dtype)
                before = interseq_cuda.launches
                got = interseq_cuda.interseq_pairs_cuda(*t, 12, 1, warps=warps, **kw)
                torch.cuda.synchronize()
                assert interseq_cuda.launches == before + 1
                want = interseq.interseq_pairs(*t, 12, 1, **kw)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and torch.equal(g, w), (m, B, kw)


def test_k1_attrs_within_budget(dev):
    """At most 128 registers and no local memory in the int32 builds; Part
    A holds four blocks an SM."""
    for local in (True, False):
        for track in (True, False):
            for warps in (1, 8, 16):
                a = interseq_cuda.attrs(local, track, False, warps)
                assert a["regs"] <= 128 and a["local"] == 0, (local, track, warps, a)
                if warps == 1:
                    assert a["blocks_an_sm"] >= 4


@pytest.mark.parametrize("warps", [1, 2])
def test_k1_splits_pairs_to_fit_scratch(dev, warps):
    """A scratch for two pairs: seven pairs take four launches, same result
    (m = 70 crosses a strip edge in Part A and the wrap at two warps)."""
    rng = np.random.default_rng(5)
    t = [torch.as_tensor(a).to(dev) for a in _pairs(rng, 70, n_pad=40, B=130)]
    per_pair = 2 * 40 * 130 * 4  # H and F rows, int32
    scratch = torch.empty(2 * per_pair, dtype=torch.uint8, device=dev)
    before = interseq_cuda.launches
    got = interseq_cuda.interseq_pairs_cuda(*t, 11, 1, track_range=True, scratch=scratch,
                                            warps=warps)
    torch.cuda.synchronize()
    assert interseq_cuda.launches == before + 4
    want = interseq.interseq_pairs(*t, 11, 1, track_range=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k1_wrapper_rejects_what_it_cannot_take(dev):
    rng = np.random.default_rng(6)
    t = [torch.as_tensor(a).to(dev) for a in _pairs(rng, 8)]
    bad_type = list(t)
    bad_type[1] = t[1].to(torch.int32)
    with pytest.raises(TypeError, match="codes"):
        interseq_cuda.interseq_pairs_cuda(*bad_type, 11, 1)
    strided = list(t)
    strided[1] = t[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        interseq_cuda.interseq_pairs_cuda(*strided, 11, 1)
    mixed = list(t)
    mixed[2] = t[2].cpu()
    with pytest.raises(ValueError, match="device"):
        interseq_cuda.interseq_pairs_cuda(*mixed, 11, 1)
    with pytest.raises(ValueError, match="warps"):
        interseq_cuda.interseq_pairs_cuda(*t, 11, 1, warps=17)


def test_engine_on_card_equals_cpu(dev):
    """Every search path: hit lists and stats on the card equal the CPU's."""
    rng = np.random.default_rng(8)
    seqs = [rng.integers(0, 20, int(rng.integers(20, 120))).astype(np.uint8)
            for _ in range(300)]
    seqs[7] = seqs[3].copy()  # a tie
    db = SequenceDB.from_sequences([f"s{i}" for i in range(300)], seqs, SymType.AMINOACID)
    engines = [SearchEngine(db, B62, 10, 1, SearchParams(batch_size=64), device=d)
               for d in (dev, "cpu")]
    queries = [seqs[3][:90], rng.integers(0, 20, 40).astype(np.uint8)]

    def run(eng):
        out = []
        for local in (True, False):
            for bw in (BitWidth.EXACT, BitWidth.BIT8, BitWidth.BIT64):
                st = SearchStats()
                out.append((eng.search(queries[0], 8, local, bw, st),
                            st.cells, st.rescored))
            st = SearchStats()
            out.append((eng.search_many(queries, 6, local, st, BitWidth.BIT16),
                        st.cells, st.rescored))
            st = SearchStats()
            out.append((eng.search_reduced(queries, None, 5, local, st),
                        st.cells, st.rescored))
        return out

    got, want = run(engines[0]), run(engines[1])
    for (g, gc, gr), (w, wc, wr) in zip(got, want):
        np.testing.assert_equal(g, w)
        assert (gc, gr) == (wc, wr)


def test_sharded_on_card_equals_single_device(dev):
    """Two shards on the card: every search path's hit lists and stats equal
    the single-device engine's on the card; each shard sweep launches K1 once
    a width group it holds, and nothing is re-queued."""
    from libssa_tpu_torch.parallel.sharded import ShardedSearchEngine, make_db_mesh

    rng = np.random.default_rng(9)
    seqs = [rng.integers(0, 20, int(rng.integers(20, 400))).astype(np.uint8)
            for _ in range(301)]
    seqs[8] = seqs[3].copy()  # a tie across the shards
    db = SequenceDB.from_sequences([f"s{i}" for i in range(301)], seqs, SymType.AMINOACID)
    params = SearchParams(batch_size=64)
    single = SearchEngine(db, B62, 10, 1, params, device=dev)
    sharded = ShardedSearchEngine(db, B62, 10, 1, make_db_mesh(devices=[dev, dev]), params)
    queries = [seqs[3][:90], rng.integers(0, 20, 40).astype(np.uint8)]
    width_groups = sum(len(g[2]) for g in sharded._device_groups())
    for local in (True, False):
        for bw in (BitWidth.EXACT, BitWidth.BIT8, BitWidth.BIT64):
            st_m, st_s = SearchStats(), SearchStats()
            before = interseq_cuda.launches
            got = sharded.search(queries[0], 8, local, bw, st_m)
            assert interseq_cuda.launches - before == width_groups
            np.testing.assert_equal(got, single.search(queries[0], 8, local, bw, st_s))
            assert (st_m.cells, st_m.rescored) == (st_s.cells, st_s.rescored)
        st_m, st_s = SearchStats(), SearchStats()
        np.testing.assert_equal(sharded.search_many(queries, 6, local, st_m, BitWidth.BIT16),
                                single.search_many(queries, 6, local, st_s, BitWidth.BIT16))
        assert (st_m.cells, st_m.rescored) == (st_s.cells, st_s.rescored)
        np.testing.assert_equal(sharded.search_reduced(queries, None, 5, local),
                                single.search_reduced(queries, None, 5, local))
    assert sharded.requeued_chunks == 0


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_ring_on_card_equals_k3_and_align_pair_linear(dev, local, monkeypatch):
    """The ring on 2 shards of the card: ring_score equals K3's score, one
    K2 launch a staircase phase, and ring_align_pair (ring divides at the
    top, the hand-off's levels on the card's DevicePair) equals
    align_pair_linear on the card, ops string included."""
    from libssa_tpu_torch.parallel import ring
    from libssa_tpu_torch.parallel.ring_mm import ring_align_pair
    from libssa_tpu_torch.parallel.sharded import make_db_mesh

    monkeypatch.setattr(hirschberg, "DEVICE_MIN_CELLS", 1 << 16)
    monkeypatch.setattr(hirschberg, "LEAF_CELLS", 1 << 14)

    rng = np.random.default_rng(81 + local)
    q = rng.integers(0, 20, 3000).astype(np.uint8)
    s = rng.integers(0, 20, 2500).astype(np.uint8)
    s[300:1800] = q[700:2200]
    mesh = make_db_mesh(devices=[dev, dev])
    want = longpair.longpair_score(q, s, PADDED, 11, 1, local, device=dev)
    for RB in (1000, ring.RB_DEFAULT):
        before, ring.phases = ring_block_cuda.launches, 0
        assert ring.ring_score(q, s, PADDED, 11, 1, local, mesh, RB) == want
        assert ring_block_cuda.launches - before == ring.phases == -(-3000 // RB) + 1
    st = SearchStats()
    got = ring_align_pair(q, s, PADDED, 11, 1, local, mesh=mesh, RB=1000,
                          ring_min_cells=1 << 19, stats=st)
    assert got == hirschberg.align_pair_linear(q, s, PADDED, 11, 1, local, device=dev)
    assert got.score == want and st.aligner_levels > 0
    assert st.aligner_dispatches >= st.aligner_levels + 3


K3_WARPS = (None, 1, 2, 3, 4, 8)  # None: the wrapper's choice


@pytest.mark.parametrize("ch", longpair_cuda.BAND_ROWS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_k3_matches_plain(dev, local, dtype, ch):
    """Stripe edges crossed inside a block and between blocks, m not a
    multiple of a stripe, fewer stripes than warps, m or n = 1, n < 8: at
    every stripes-a-block count that fits; one past the shared memory is
    refused."""
    rng = np.random.default_rng(41 + ch)
    mat = torch.as_tensor(PADDED.astype(np.int32)).to(dev)
    itemsize = torch.empty(0, dtype=dtype).element_size()
    for m, n in ((1, 1), (1, 90), (90, 1), (31, 33), (600, 5), (1000, 70), (70, 1000),
                 (2100, 517), (5000, 300)):
        q = torch.as_tensor(rng.integers(0, 20, m).astype(np.uint8)).to(dev)
        s = torch.as_tensor(rng.integers(0, 20, n).astype(np.uint8)).to(dev)
        want = longpair.longpair_score_plain(q, s, mat, 12, 1, local, dtype)
        for warps in K3_WARPS:
            before = longpair_cuda.launches
            if warps is not None and not longpair_cuda.fits(warps, ch, itemsize):
                with pytest.raises(ValueError, match="warps"):
                    longpair_cuda.longpair_score_cuda(q, s, mat, 12, 1, local, dtype,
                                                      rows_per_thread=ch, warps=warps)
                assert longpair_cuda.launches == before
                continue
            got = longpair_cuda.longpair_score_cuda(
                q, s, mat, 12, 1, local, dtype, rows_per_thread=ch, warps=warps
            )
            torch.cuda.synchronize()
            assert longpair_cuda.launches == before + 1
            assert got.dtype == want.dtype and torch.equal(got, want), (m, n, warps)


def test_k3_wrapper_rejects_what_it_cannot_take(dev):
    mat = torch.as_tensor(PADDED.astype(np.int32)).to(dev)
    q = torch.zeros(40, dtype=torch.uint8, device=dev)
    with pytest.raises(TypeError, match="q"):
        longpair_cuda.longpair_score_cuda(q.to(torch.int32), q, mat, 12, 1)
    with pytest.raises(ValueError, match="device"):
        longpair_cuda.longpair_score_cuda(q.cpu(), q, mat, 12, 1)
    with pytest.raises(ValueError, match="codes"):
        longpair_cuda.longpair_score_cuda(q + 32, q, mat, 12, 1)
    with pytest.raises(ValueError, match="rows_per_thread"):
        longpair_cuda.longpair_score_cuda(q, q, mat, 12, 1, rows_per_thread=3)
    for warps in (0, 9):
        with pytest.raises(ValueError, match="warps"):
            longpair_cuda.longpair_score_cuda(q, q, mat, 12, 1, warps=warps)
    with pytest.raises(ValueError, match="warps"):
        longpair_cuda.longpair_score_cuda(q, q, mat, 12, 1, rows_per_thread=8, warps=8)


def test_k3_attrs_at_every_fitting_warps(dev):
    """ptxas's registers and the residency of every instantiation."""
    for wide in (False, True):
        for ch in longpair_cuda.BAND_ROWS:
            for w in range(1, longpair_cuda.MAX_WARPS + 1):
                if not longpair_cuda.fits(w, ch, 8 if wide else 4):
                    continue
                a = longpair_cuda.attrs(True, wide, ch, w)
                assert a["blocks_an_sm"] >= 1 and a["smem"] == longpair_cuda.smem_bytes(
                    w, ch, 8 if wide else 4)


def test_wrappers_refuse_q_below_r_on_card(dev):
    """K1's, K2's and K3's CUDA branches raise at Q < R or R < 0 before any
    launch."""
    rng = np.random.default_rng(5)
    mat = torch.as_tensor(PADDED.astype(np.int32)).to(dev)
    q = torch.as_tensor(np.array([13, 5, 15], np.uint8)).to(dev)
    s = torch.as_tensor(np.array([6, 13], np.uint8)).to(dev)
    prof = torch.as_tensor(make_padded_profile(q.cpu().numpy(), PADDED).astype(np.int32)).to(dev)
    codes = s.to(torch.int8)[:, None].contiguous()
    lens = torch.tensor([2], dtype=torch.int32, device=dev)
    b = [torch.as_tensor(rng.integers(-30, 0, k).astype(np.int32)).to(dev) for k in (4, 3, 2, 2)]
    for Q, R in ((1, 2), (4, -1)):
        counts = (interseq_cuda.launches, ring_block_cuda.launches, longpair_cuda.launches)
        with pytest.raises(ValueError, match="Q >= R >= 0"):
            interseq_cuda.interseq_scores_cuda(prof, codes, lens, Q, R, local=False)
        with pytest.raises(ValueError, match="Q >= R >= 0"):
            interseq.pair_scores_batch(prof, s[None], lens, Q, R, local=False)
        with pytest.raises(ValueError, match="Q >= R >= 0"):
            ring_block_cuda.ring_block_cuda(q, s, [[0, 3, 0, 2]], mat, Q, R, False, *b)
        with pytest.raises(ValueError, match="Q >= R >= 0"):
            longpair_cuda.longpair_score_cuda(q, s, mat, Q, R, False)
        assert counts == (interseq_cuda.launches, ring_block_cuda.launches,
                          longpair_cuda.launches)


def test_pair_scores_batch_on_card_equals_cpu(dev):
    rng = np.random.default_rng(13)
    prof = make_padded_profile(rng.integers(0, 20, 50).astype(np.uint8), PADDED)
    subjects = rng.integers(0, 20, (300, 64)).astype(np.uint8)
    lengths = rng.integers(0, 65, 300).astype(np.int32)
    for local in (True, False):
        args = [torch.as_tensor(a) for a in (prof, subjects, lengths)]
        want = interseq.pair_scores_batch(*args, 12, 1, local=local, m_real=50)
        before = interseq_cuda.launches
        got = interseq.pair_scores_batch(
            *[a.to(dev) for a in args], 12, 1, local=local, m_real=50
        )
        assert interseq_cuda.launches == before + 1
        assert torch.equal(got.cpu(), want)


def _tiles(rng, dev, local, dtype, n_jobs=6):
    """Mixed tiles of one random pair with consistent random boundaries:
    leftE/topF one gap below leftH/topH, as a real DP's never exceed them."""
    q = torch.as_tensor(rng.integers(0, 20, 900).astype(np.uint8)).to(dev)
    s = torch.as_tensor(rng.integers(0, 20, 700).astype(np.uint8)).to(dev)
    jobs = []
    for _ in range(n_jobs):
        RB, W = int(rng.choice([1, 31, 33, 257, 600])), int(rng.choice([1, 32, 45, 300]))
        jobs.append([int(rng.integers(0, 900 - RB + 1)), RB, int(rng.integers(0, 700 - W + 1)), W])
    jobs = np.array(jobs, np.int64)
    n_rows, n_cols = int(jobs[:, 1].sum()), int(jobs[:, 3].sum())
    lo = 0 if local else -500
    h = lambda k: torch.as_tensor(rng.integers(lo, 300, k)).to(dtype).to(dev)
    leftH, topH = h(n_rows + len(jobs)), h(n_cols)
    gap = lambda k: torch.as_tensor(rng.integers(11, 40, k)).to(dtype).to(dev)
    leftE = h(n_rows) - gap(n_rows)
    return q, s, jobs, leftH, leftE, topH, topH - gap(n_cols)


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
@pytest.mark.parametrize("ch", ring_block_cuda.BAND_ROWS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_k2_matches_plain(dev, local, dtype, ch, warps):
    """One launch of mixed tiles (RB or W = 1, stripe edges crossed inside
    a block and between blocks) at ``warps`` stripes a block; a block past
    the shared memory is refused."""
    rng = np.random.default_rng(61 + ch + local)
    mat = torch.as_tensor(PADDED.astype(np.int32)).to(dev)
    q, s, jobs, *bounds = _tiles(rng, dev, local, dtype)
    before = ring_block_cuda.launches
    if ring_block_cuda.smem_bytes(warps, ch, bounds[0].element_size()) > \
            ring_block_cuda.MAX_SMEM:
        with pytest.raises(ValueError, match="warps"):
            ring_block_cuda.ring_block_cuda(q, s, jobs, mat, 12, 1, local, *bounds,
                                            rows_per_thread=ch, warps=warps)
        assert ring_block_cuda.launches == before
        return
    got = ring_block_cuda.ring_block_cuda(q, s, jobs, mat, 12, 1, local, *bounds,
                                          rows_per_thread=ch, warps=warps)
    torch.cuda.synchronize()
    assert ring_block_cuda.launches == before + 1
    want = ring_block_cuda.ring_block_cuda(q.cpu(), s.cpu(), jobs, mat.cpu(), 12, 1, local,
                                           *(b.cpu() for b in bounds))
    for name, g, w in zip(ring_block.Tiles._fields, got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w), name


def test_k2_staged_launch_repeats(dev):
    """``stage`` then its launch, twice: each call is one K2 launch and gives
    the one-call wrapper's outputs; codes_checked skips only the code check."""
    rng = np.random.default_rng(67)
    mat = torch.as_tensor(PADDED.astype(np.int32)).to(dev)
    q, s, jobs, *bounds = _tiles(rng, dev, True, torch.int32)
    want = ring_block_cuda.ring_block_cuda(q, s, jobs, mat, 12, 1, True, *bounds)
    launch = ring_block_cuda.stage(q, s, jobs, mat, 12, 1, True, *bounds, codes_checked=True)
    before = ring_block_cuda.launches
    for k in (1, 2):
        got = launch()
        torch.cuda.synchronize()
        assert ring_block_cuda.launches == before + k
        for name, g, w in zip(ring_block.Tiles._fields, got, want):
            assert torch.equal(g, w), name


def test_k2_wrapper_rejects_what_it_cannot_take(dev):
    mat = torch.as_tensor(PADDED.astype(np.int32)).to(dev)
    q = torch.zeros(40, dtype=torch.uint8, device=dev)
    b = [torch.zeros(k, dtype=torch.int32, device=dev) for k in (41, 40, 40, 40)]
    jobs = [[0, 40, 0, 40]]
    with pytest.raises(TypeError, match="q_codes"):
        ring_block_cuda.ring_block_cuda(q.int(), q, jobs, mat, 12, 1, True, *b)
    with pytest.raises(ValueError, match="device"):
        ring_block_cuda.ring_block_cuda(q, q, jobs, mat, 12, 1, True, b[0].cpu(), *b[1:])
    with pytest.raises(ValueError, match="codes"):
        ring_block_cuda.ring_block_cuda(q + 32, q, jobs, mat, 12, 1, True, *b)
    with pytest.raises(ValueError, match="rows_per_thread"):
        ring_block_cuda.ring_block_cuda(q, q, jobs, mat, 12, 1, True, *b, rows_per_thread=2)


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_device_pair_on_card_equals_cpu(dev, local, monkeypatch):
    """Divide levels and end cells on K2 equal DevicePair on the plain
    version, and the traceback (its levels on K2) equals the CPU's NumPy
    passes."""
    monkeypatch.setattr(hirschberg, "DEVICE_MIN_CELLS", 1 << 16)
    monkeypatch.setattr(hirschberg, "LEAF_CELLS", 1 << 14)
    rng = np.random.default_rng(71 + local)
    q = rng.integers(0, 20, 1500).astype(np.uint8)
    s = rng.integers(0, 20, 1300).astype(np.uint8)
    s[200:900] = q[300:1000]
    Q, R = oracle.gap_qr(11, 1)
    pairs = [DevicePair(q, s, PADDED, Q, R, device=d) for d in (dev, "cpu")]
    nodes = [(0, 1500, 0, 1300, False, False), (10, 700, 5, 640, True, False),
             (700, 1499, 640, 1290, False, True)]
    assert pairs[0].divide_level(nodes) == pairs[1].divide_level(nodes)
    assert pairs[0].sw_end(0, 1500, 0, 1300) == pairs[1].sw_end(0, 1500, 0, 1300)
    assert pairs[0].sw_end(3, 900, 7, 800, True) == pairs[1].sw_end(3, 900, 7, 800, True)
    st = SearchStats()
    got = hirschberg.align_pair_linear(q, s, B62.scores, 10, 1, local, stats=st, device=dev)
    want = hirschberg.align_pair_linear(q, s, B62.scores, 10, 1, local, device="cpu")
    assert st.aligner_levels > 0
    assert (got.score, got.q_begin, got.s_begin, got.cigar) == (
        want.score, want.q_begin, want.s_begin, want.cigar)


def _leaf_batch(rng, n_leaves, g, hi, edge_cases):
    """Code buffers and drawn leaves of m = 2 .. 1024 rows and at most
    LEAF_CELLS cells; ``edge_cases`` adds a leaf of exactly LEAF_CELLS
    (1024 x 1024) and one of m = 2 across 4,000 columns."""
    q = rng.integers(0, hi, 5000).astype(np.uint8)
    s = rng.integers(0, hi, 5000).astype(np.uint8)
    shapes = []
    for _ in range(n_leaves):
        m = int(rng.integers(2, 1025))
        shapes.append((m, int(rng.integers(1, min(hirschberg.LEAF_CELLS // m, 4000) + 1))))
    if edge_cases:
        shapes += [(1024, hirschberg.LEAF_CELLS // 1024), (2, 4000)]
    return q, s, np.array([(int(rng.integers(0, 5001 - m)), m, int(rng.integers(0, 5001 - n)),
                            n, g * int(rng.integers(2)), g * int(rng.integers(2)))
                           for m, n in shapes], np.int64)


@pytest.mark.parametrize("wide", [None, False, True], ids=["choice", "int32", "int64"])
def test_leaf_kernel_matches_leafalign(dev, wide):
    """The leaf kernel against the plain version (the host leaf solve,
    csrc/leafalign.cpp, leaf by leaf): drawn batches with a leaf of exactly
    LEAF_CELLS and one of m = 2, and a batch of one leaf; one launch each."""
    rng = np.random.default_rng(91)
    for mat, hi, (go, ge) in ((PADDED, 20, (11, 1)),
                              (matrices.constant_scoring(10, -8).padded(), 4, (20, 1))):
        Q, R = oracle.gap_qr(go, ge)
        cost = torch.as_tensor(-mat.astype(np.int32))
        for n_leaves, edges in ((30, True), (1, False)):
            q, s, leaves = _leaf_batch(rng, n_leaves, Q - R, hi, edges)
            want = leaf_cuda.leaf_batch_cuda(torch.as_tensor(q), torch.as_tensor(s), leaves,
                                             cost, Q - R, R)
            before = leaf_cuda.launches
            got = leaf_cuda.leaf_batch_cuda(torch.as_tensor(q).to(dev),
                                            torch.as_tensor(s).to(dev), leaves, cost.to(dev),
                                            Q - R, R, wide=wide)
            torch.cuda.synchronize()
            assert leaf_cuda.launches == before + 1
            assert leaf_cuda.unpack(got.cpu().numpy(), leaves) == \
                leaf_cuda.unpack(want.numpy(), leaves)


def test_leaf_wrapper_rejects_what_it_cannot_take(dev):
    q = torch.zeros(40, dtype=torch.uint8, device=dev)
    cost = torch.zeros(32, 32, dtype=torch.int32, device=dev)
    leaves = [(0, 10, 0, 10, 10, 10)]
    with pytest.raises(TypeError, match="q_codes"):
        leaf_cuda.leaf_batch_cuda(q.int(), q, leaves, cost, 10, 1)
    with pytest.raises(TypeError, match="cost"):
        leaf_cuda.leaf_batch_cuda(q, q, leaves, cost.long(), 10, 1)
    with pytest.raises(ValueError, match="device"):
        leaf_cuda.leaf_batch_cuda(q, q, leaves, cost.cpu(), 10, 1)
    with pytest.raises(ValueError, match="outside"):
        leaf_cuda.leaf_batch_cuda(q, q, [(35, 10, 0, 10, 10, 10)], cost, 10, 1)
    with pytest.raises(ValueError, match="Q >= R"):
        leaf_cuda.leaf_batch_cuda(q, q, [(0, 10, 0, 10, 0, 0)], cost, -1, 1)


def test_mito_shape_leaves_on_card_equal_host(dev, monkeypatch):
    """mito_align's pair shape (16,569 x 16,554 ACGT homologs, +10/-8, gaps
    20/1), NW on the card: the ops string with each pass's leaves in one
    launch is byte for byte the one with the leaves solved on the host."""
    rng = np.random.default_rng(16569)
    q = rng.integers(0, 4, 16569).astype(np.uint8)
    keep = rng.random(16569) >= 0.002  # deletions
    s = np.where(rng.random(16569) < 0.09, rng.integers(0, 4, 16569), q)[keep]
    s = np.concatenate([s, rng.integers(0, 4, 16554)])[:16554].astype(np.uint8)
    sub = matrices.constant_scoring(10, -8).padded()
    kw = dict(local=False, first_residue_opens=False, device=dev)
    before = leaf_cuda.launches
    st = SearchStats()
    got = hirschberg.align_pair_linear(q, s, sub, 20, 1, stats=st, **kw)
    assert leaf_cuda.launches > before and st.aligner_levels >= 5
    plain = leaf_cuda.leaf_batch_cuda

    def on_host(q_codes, s_codes, leaves, cost, g, h, **_):
        return plain(q_codes.cpu(), s_codes.cpu(), leaves, cost.cpu(), g, h).to(dev)

    monkeypatch.setattr(leaf_cuda, "leaf_batch_cuda", on_host)
    before = leaf_cuda.launches
    want = hirschberg.align_pair_linear(q, s, sub, 20, 1, **kw)
    assert leaf_cuda.launches == before
    assert (got.score, got.cigar) == (want.score, want.cigar)


def _homolog_pair(seed, m, n, sub_rate=0.09, del_rate=0.002):
    """ACGT codes of m and a homolog of n, as ``test_mito_shape_leaves_on_card_equal_host``
    draws them."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, m).astype(np.uint8)
    keep = rng.random(m) >= del_rate
    s = np.where(rng.random(m) < sub_rate, rng.integers(0, 4, m), q)[keep]
    return q, np.concatenate([s, rng.integers(0, 4, n)])[:n].astype(np.uint8)


def _recorded_levels(dev, q, s, local, monkeypatch):
    """The (DevicePair, nodes) of every divide level of one traceback on
    the card (``mito_align``'s scoring: +10/-8, gaps 20/1)."""
    seen = []
    divide = DevicePair.divide_level

    def recorded(self, nodes):
        seen.append((self, list(nodes)))
        return divide(self, nodes)

    monkeypatch.setattr(DevicePair, "divide_level", recorded)
    sub = matrices.constant_scoring(10, -8).padded()
    hirschberg.align_pair_linear(q, s, sub, 20, 1, local=local, first_residue_opens=False,
                                 device=dev)
    monkeypatch.setattr(DevicePair, "divide_level", divide)
    return seen


@pytest.mark.parametrize("shape", ["mito_align", "viral_align"])
def test_level_kernels_at_benchmark_levels_equal_plain(dev, shape, monkeypatch):
    """The prologue's boundaries and the split's (j1, j2, v1, v2) on the
    card equal their plain versions at every level of mito_align's pair
    shape (16,569 x 16,554 NW) and at the widest level of viral_align's
    (162,114 x 171,823 SW), from the same K2 outputs."""
    if shape == "mito_align":
        q, s = _homolog_pair(16569, 16569, 16554)
        levels = _recorded_levels(dev, q, s, False, monkeypatch)
        assert len(levels) >= 5
    else:
        q, s = _homolog_pair(162114, 162114, 171823, 0.13, 0.004)
        levels = _recorded_levels(dev, q, s, True, monkeypatch)
        levels = [max(levels, key=lambda x: len(x[1]))]
    for pair, nodes in levels:
        jobs, tbs = pair.level_jobs(nodes)
        level = mm_level_cuda.stage(jobs, tbs, dev)
        got = mm_level_cuda.prologue(level, pair.dtype, pair.Q, pair.R, False)
        want = mm_level_cuda.prologue_plain(level.table, pair.dtype, pair.Q, pair.R, False)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
        out = ring_block_cuda.ring_block_cuda(pair.q, pair.s, jobs, pair.matrix, pair.Q,
                                              pair.R, False, *got, codes_checked=True)
        res = mm_level_cuda.split(level, out.botH, out.botF, pair.Q - pair.R, pair.R)
        plain = mm_level_cuda.split_plain(level.table, out.botH.cpu(), out.botF.cpu(),
                                          pair.Q - pair.R, pair.R)
        assert torch.equal(res.cpu(), plain), (shape, len(nodes))
        assert res.cpu().tolist() == [list(r) for r in pair.divide_level(nodes)]


def test_divide_level_waits_once_on_card(dev):
    """A divide level on the card synchronises once, at its fetch: the
    uploads are copies from pinned memory that do not wait, and the
    prologue, K2 and the split queue behind them."""
    import warnings

    q, s = _homolog_pair(7, 6000, 5800)
    pair = DevicePair(q, s, matrices.constant_scoring(10, -8).padded(), 21, 1, device=dev)
    nodes = [(0, 6000, 0, 5800, False, False)]
    want = pair.divide_level(nodes)  # builds and loads the kernels
    torch.cuda.synchronize()
    before = mm_level_cuda.launches
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = pair.divide_level(nodes)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    assert got == want and mm_level_cuda.launches == before + 2
    assert pair.staged_levels == 2


def test_traceback_levels_staged_on_card(dev, monkeypatch):
    """Every device level of a traced traceback on the card is staged: its
    mm.level span counts ``staged`` 1, two level-kernel launches each, and
    no span opens under it but its one device.wait; the alignment equals
    the CPU's host passes'."""
    monkeypatch.setattr(hirschberg, "DEVICE_MIN_CELLS", 1 << 16)
    monkeypatch.setattr(hirschberg, "LEAF_CELLS", 1 << 14)
    q, s = _homolog_pair(11, 1500, 1300)
    sub = matrices.constant_scoring(10, -8).padded()
    st = SearchStats()
    before = mm_level_cuda.launches
    with profile(activities=[ProfilerActivity.CPU]):
        got = hirschberg.align_pair_linear(q, s, sub, 20, 1, local=False, stats=st,
                                           first_residue_opens=False, device=dev)
    levels = [i for i, x in enumerate(st.spans) if x.name == "mm.level"]
    on_card = [i for i in levels if st.spans[i].counts["device"]]
    assert on_card and all(st.spans[i].counts["staged"] == 1 for i in on_card)
    assert mm_level_cuda.launches - before == 2 * len(on_card)
    for i in on_card:
        kids = [x.name for x in st.spans if x.parent == i]
        assert kids == ["device.wait"]
    want = hirschberg.align_pair_linear(q, s, sub, 20, 1, local=False,
                                        first_residue_opens=False, device="cpu")
    assert (got.score, got.cigar) == (want.score, want.cigar)


def _plain_hits(codes, hits, sub, Q, R, local):
    """The hit kernel's plain version: aligner.align_pair hit by hit at
    Gotoh's (Q, R)."""
    return [aligner.align_pair(codes[qo:qo + m], codes[so:so + n], sub, Q, R, local,
                               first_residue_opens=False, device="cpu")
            for qo, m, so, n in hits.tolist()]


def _card_hits(stats) -> int:
    """The hits a traced request solved on the card: its traceback.batch
    spans' ``device`` counts."""
    return sum(s.counts["device"] for s in stats.spans if s.name == "traceback.batch")


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_hit_kernel_matches_plain(dev, local, wide):
    """The hit kernel against its plain version (aligner.align_pair hit by
    hit, on the CPU) on batches of hits at stripe and chunk edges, BLOSUM62 and a
    4-letter matrix full of ties, Q > R and Q = R; one launch a batch."""
    rng = np.random.default_rng([local, wide])
    ties = np.where(np.eye(4, dtype=bool), 2, -1)
    shapes = [(1, 1), (1, 65), (65, 1), (31, 33), (32, 32), (33, 64), (64, 65), (400, 389),
              (361, 361), (97, 410)]
    for sub in (B62.scores, ties):
        codes, hits = hit_tests.draw_batch(rng, sub.shape[0], shapes)
        for Q, R in ((12, 1), (2, 2)):
            want = _plain_hits(codes, hits, sub, Q, R, local)
            before = hit_cuda.launches
            got = hit_cuda.hit_batch(codes, hits, sub, Q, R, local, dev, wide=wide)
            torch.cuda.synchronize()
            assert hit_cuda.launches == before + 1 and got.device == dev
            assert hit_cuda.unpack(got.cpu().numpy(), hits) == want


def test_hit_kernel_at_sprot_single_shapes(dev):
    """Ten homolog hits of 767 x 767 (sprot_single's long queries) in one
    launch, SW, equal to the plain version; attributes within a warp's
    budget."""
    rng = np.random.default_rng(767)
    codes, hits = hit_tests.draw_batch(rng, 20, [(767, 767)] * 10)
    want = _plain_hits(codes, hits, B62.scores, 12, 1, True)
    got = hit_cuda.hit_batch(codes, hits, B62.scores, 12, 1, True, dev)
    assert hit_cuda.unpack(got.cpu().numpy(), hits) == want
    assert all(tb.score > 0 and len(tb.cigar) > 500 for tb in want)
    for wide in (False, True):
        assert hit_cuda.attrs(wide)["local"] == 0


def test_hit_wrapper_rejects_what_it_cannot_take(dev):
    codes = np.zeros(40, np.uint8)
    with pytest.raises(ValueError, match="outside"):
        hit_cuda.hit_batch(codes, [(35, 10, 0, 10)], B62.scores, 12, 1, True, dev)
    with pytest.raises(ValueError, match="Q >= R"):
        hit_cuda.hit_batch(codes, [(0, 10, 0, 10)], B62.scores, 1, 2, True, dev)
    with pytest.raises(ValueError, match="too large"):
        hit_cuda.hit_batch(codes, [(0, 10, 0, 10)], B62.scores, 2**57, 1, True, dev)


def _alignment_fields(lists):
    return [[(h.seq_id, h.score, h.strand, h.q_begin, h.q_end, h.s_begin, h.s_end, h.cigar,
              h.aligned) for h in hl] for hl in lists]


def test_alignment_mode_on_card_equals_cpu(dev):
    """sw_align, nw_align and align_many in ALIGNMENT mode on the card equal
    the CPU's hit for hit; each call's hits are one hit-kernel launch (the
    two strands of a nucleotide query too), counted on the card."""
    rng = np.random.default_rng(9)
    seqs = [rng.integers(0, 20, int(rng.integers(30, 400))).astype(np.uint8)
            for _ in range(200)]
    db = SequenceDB.from_sequences([f"s{i}" for i in range(200)], seqs, SymType.AMINOACID)
    ctxs = []
    for d in (dev, "cpu"):
        c = api.SSAContext(d)
        c.init_score_matrix("BLOSUM62")
        c.init_gap_penalties(11, 1)
        c.db = db
        ctxs.append(c)
    texts = [alphabet.decode(np.where(rng.random(len(seqs[k])) < 0.3,
                                      rng.integers(0, 20, len(seqs[k])), seqs[k]),
                             SymType.AMINOACID) for k in (4, 9, 17)]

    def run(c):
        qs = [c.init_sequence_fasta(t) for t in texts]
        return [c.sw_align(qs[0], 10, BitWidth.EXACT, ComputeMode.ALIGNMENT),
                c.nw_align(qs[1], 5, BitWidth.EXACT, ComputeMode.ALIGNMENT),
                *c.align_many(qs, 10, ComputeMode.ALIGNMENT)]

    before = hit_cuda.launches
    with profile(activities=[ProfilerActivity.CPU]):
        got = run(ctxs[0])
    assert hit_cuda.launches == before + 3
    assert _alignment_fields(got) == _alignment_fields(run(ctxs[1]))
    assert _card_hits(got[0].stats) == 10 and _card_hits(got[2].stats) == 30
    with profile(activities=[ProfilerActivity.CPU]):
        pair = [c.align_pair(c.init_sequence_fasta(texts[2]), alphabet.decode(
            seqs[17], SymType.AMINOACID)) for c in ctxs]
    assert _alignment_fields([pair[:1]]) == _alignment_fields([pair[1:]])
    assert _card_hits(pair[0].stats) == 1 and _card_hits(pair[1].stats) == 0


def test_hits_past_the_cell_limit_take_the_linear_path_on_card(dev, monkeypatch):
    """A batch with a hit past MATRIX_CELL_LIMIT: that hit runs Myers-Miller
    (K2 on the card), the rest one hit-kernel launch; all equal align_pair."""
    monkeypatch.setattr(aligner, "MATRIX_CELL_LIMIT", 200_000)
    monkeypatch.setattr(hirschberg, "DEVICE_MIN_CELLS", 1024)
    rng = np.random.default_rng(10)
    codes, hits = hit_tests.draw_batch(rng, 20, [(300, 280), (600, 500), (120, 130)])
    pairs = [(codes[qo:qo + m], codes[so:so + n]) for qo, m, so, n in hits.tolist()]
    st = SearchStats()
    before = hit_cuda.launches
    with profile(activities=[ProfilerActivity.CPU]):
        got = aligner.align_batch(pairs, B62.scores, 11, 1, True, stats=st, device=dev)
    assert hit_cuda.launches == before + 1 and _card_hits(st) == 2
    assert st.aligner_dispatches > 0  # the 600 x 500 hit on K2's levels
    assert got == [aligner.align_pair(q, s, B62.scores, 11, 1, True, device="cpu")
                   for q, s in pairs]


# -- the probes (libssa_tpu_torch/experiments/) ------------------------------------


@pytest.mark.parametrize("type_name", ["f32", "bf16x2", "i32", "i16x2", "i8x4", "u8x4"])
def test_probe_chain_matches_plain(dev, type_name):
    """chain_kernel, one and four accumulators, every op of r2_dtype's part A
    and the rate probes' DPX ops, against the plain version."""
    from libssa_tpu_torch.experiments import _common as C
    from libssa_tpu_torch.experiments import r2_dtype_probe, r2_ilp_probe

    a, b = r2_dtype_probe.inputs_a(type_name, dev)
    for name in r2_dtype_probe.ops_of(type_name):
        if r2_dtype_probe.OPS.get(name, ("", 0))[1]:
            continue  # the rolls: test_probe_tile_matches_plain
        got = r2_dtype_probe.stage(name, type_name, a, b, 3)()
        assert torch.equal(got, r2_dtype_probe.plain(name, a, b, 3)), name
    for ty, op, _, _ in r2_ilp_probe.CASES:
        if ty == type_name:
            got = C.stage_chain(op, ty, a, b, 4, 4, c1=1, c2=3)()
            assert torch.equal(got, C.plain_chain(op, a, b, 4, 4, c1=1, c2=3)), op


def test_probe_tile_matches_plain(dev):
    """tile_kernel at every instantiated layout: op_rate's, r2_dtype's rolls,
    r3_roll's and r3_longpair's."""
    from libssa_tpu_torch.experiments import (
        op_rate_probe, r2_dtype_probe, r3_longpair_probe, r3_roll_probe)

    for op in op_rate_probe.OPS:
        for ty in op_rate_probe.types_of(op):
            x = op_rate_probe.tile_input(ty, 2, dev)
            got = op_rate_probe.stage(x, op, ty, 4, iters=2)()
            assert torch.equal(got, op_rate_probe.plain(x, op, 4, iters=2)), (op, ty)
    for ty in r2_dtype_probe.TYPES:
        a, b = r2_dtype_probe.inputs_a(ty, dev)
        for name in ("roll1", "roll2", "max_roll"):
            got = r2_dtype_probe.stage(name, ty, a, b, 5)()
            assert torch.equal(got, r2_dtype_probe.plain(name, a, b, 5)), (name, ty)
        a, b = r2_dtype_probe.inputs_b(ty, dev)
        got = r2_dtype_probe.stage("max_roll", ty, a, b, 3)()
        assert torch.equal(got, r2_dtype_probe.plain("max_roll", a, b, 3)), ty
    for spec in [*r3_roll_probe.PROBES.values(), *r3_longpair_probe.PROBES.values()]:
        x = r3_roll_probe.tile_input(spec[1], 2, dev)
        got = r3_roll_probe.stage(x, spec, 9, None)()
        assert torch.equal(got, r3_roll_probe.plain(x, spec, 9)), spec


@pytest.mark.parametrize("variant", ["single", "tuple3", "with1b", "slice78", "subroll",
                                     "laneroll1b", "iota_t"])
def test_probe_carry_matches_plain(dev, variant):
    from libssa_tpu_torch.experiments import r3_carry_probe

    x = r3_carry_probe.tile_input(2, dev)
    before = r3_carry_probe.launches
    got = r3_carry_probe.stage(x, variant, 2100)()
    assert r3_carry_probe.launches == before + 1
    assert torch.equal(got, r3_carry_probe.plain(x, variant, 2100))


@pytest.mark.parametrize("variant", ["full", "noscan", "empty"])
def test_row_sweep_matches_plain(dev, variant):
    """Every column width with an instantiation; full equals K3's score."""
    from libssa_tpu_torch.experiments import r3_lp_bisect

    q, s, mat = (torch.as_tensor(a).to(dev) for a in r3_lp_bisect.pair(16384))
    for n in r3_lp_bisect.WIDTHS:
        m = min(n, 700)
        got = r3_lp_bisect.stage(q[:m], s[:n], mat, 11, 1, variant, copies=3)()
        want = r3_lp_bisect.plain(q[:m], s[:n], mat, 11, 1, variant)
        assert got.tolist() == [want] * 3, n
        if variant == "full":
            k3 = longpair_cuda.longpair_score_cuda(q[:m], s[:n], mat, 11, 1)
            assert int(k3) == want


def test_k3_stage_cuts_build_and_terminate(dev):
    """Each stage-cut build runs to its end without a fault at every
    stripes-a-block count that fits; the default (``full``) is the
    production K3 and equals the plain version."""
    from libssa_tpu_torch.experiments import r3_banded_bisect

    q, s, mat, Q, R = r3_banded_bisect.pair("16k protein", dev)
    q, s = q[:2500], s[:1900]
    want = int(r3_banded_bisect.plain(q, s, mat, Q, R))
    for v in r3_banded_bisect.CUTS:
        for ch in longpair_cuda.BAND_ROWS:
            for warps in (1, 2, 4, 8):
                if not longpair_cuda.fits(warps, ch, 4):
                    continue
                out = r3_banded_bisect.stage(q, s, mat, Q, R, v, rows_per_thread=ch,
                                             warps=warps)()
                torch.cuda.synchronize()
                if v == "full":
                    assert int(out) == want, (ch, warps)


# -- K1's lazy-F variants (csrc/interseq_variants.cu) ------------------------------


@pytest.mark.parametrize("idx", range(len(IV.INSTANCES)))
def test_k1_variant_matches_plain_and_k1(dev, idx):
    """Every instantiation equals its plain version (scores, hi, lo) on
    random shapes with ragged, padded and length-0 lanes; the exact ones
    equal the production K1's scores."""
    v = IV.INSTANCES[idx][1]
    rng = np.random.default_rng(100 + idx)
    for m in (1, 40, 70, 100):
        n, nb = int(rng.integers(1, 60)), int(rng.integers(1, 700))
        prof = make_padded_profile(rng.integers(0, 20, m).astype(np.uint8), PADDED)
        codes = rng.integers(0, 20, (n, nb)).astype(np.int8)
        lens = rng.integers(0, n + 1, nb).astype(np.int32)
        lens[:1] = 0
        codes[np.arange(n)[:, None] >= lens[None, :]] = PAD_CODE
        t = [torch.as_tensor(a).to(dev) for a in (prof.astype(np.int32), codes, lens)]
        Q, R = int(rng.integers(1, 13)), 1
        got = IV.stage(*t, Q, R, v)()
        want = IV.plain(*t, Q, R, v)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (m, n, nb)
        if v.exact:
            k1 = interseq_cuda.interseq_scores_cuda(*t, Q, R)[0]
            assert torch.equal(got[0], k1), (m, n, nb)
