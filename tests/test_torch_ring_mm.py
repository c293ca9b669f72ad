"""``libssa_tpu_torch.parallel.ring_mm`` against the JAX package's, on the CPU.

Each case mirrors one of ``tests/test_ring_mm.py``'s: the same seeded numpy
pair goes through the reference's ``RingPair``/``ring_align_pair`` on the
8-device virtual CPU mesh (``tests/conftest.py``; its banded tile in
interpret mode, RB = 32), the port's on a mesh of D CPU shards (K2's plain
version), the host Myers-Miller passes and the port's ``align_pair_linear``.
Tolerance: exact equality of splits, end cells, scores, coordinates and ops
strings. Both packages' ``LEAF_CELLS`` are lowered to 512 where whole
alignments are compared, so every node the ring divides is divided by
``align_pair_linear`` too (the reference's ``test_ring_align_bit_identical``).
"""
import numpy as np
import pytest
import torch

from libssa_tpu.parallel import ring_mm as j_ring_mm
from libssa_tpu.parallel.sharded import make_db_mesh as j_mesh
from libssa_tpu.search import hirschberg as jhb
from libssa_tpu.search.manager import SearchStats as JSearchStats
from libssa_tpu_torch import matrices, oracle
from libssa_tpu_torch.ops import ring_block
from libssa_tpu_torch.parallel import ring
from libssa_tpu_torch.parallel.ring_mm import RingPair, ring_align_pair
from libssa_tpu_torch.parallel.sharded import make_db_mesh
from libssa_tpu_torch.search import hirschberg as hb
from libssa_tpu_torch.search.manager import SearchStats

torch.set_num_threads(1)

B62 = matrices.builtin("BLOSUM62")


def _pair(m, n, seed, hi=20):
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, m).astype(np.uint8), rng.integers(0, hi, n).astype(np.uint8)


def _mesh(D):
    return make_db_mesh(devices=["cpu"] * D)


def _host_divide(q, s, qs, qe, ss, se, f0, r0, Q, R):
    g = Q - R
    cost = -B62.padded().astype(np.int64)
    mid = (qe - qs) // 2
    CCf, DDf = hb._mm_pass(q[qs:qs + mid], s[ss:se], cost, g, R, 0 if f0 else g)
    CCr, DDr = hb._mm_pass(q[qs + mid:qe][::-1].copy(), s[ss:se][::-1].copy(), cost, g, R,
                           0 if r0 else g)
    t1 = CCf + CCr[::-1]
    t2 = DDf + DDr[::-1] - g
    return int(np.argmin(t1)), int(np.argmin(t2)), int(t1.min()), int(t2.min())


@pytest.fixture(scope="module")
def divide_pairs():
    q, s = _pair(200, 333, 0)
    Q, R = oracle.gap_qr(11, 1, True)
    port = {D: RingPair(q, s, B62.padded(), Q, R, _mesh(D), RB=32) for D in (3, 8)}
    jax = j_ring_mm.RingPair(q, s, B62.padded(), Q, R, j_mesh(), RB=32, interpret=True)
    return q, s, Q, R, port, jax


@pytest.fixture
def leaf512(monkeypatch):
    monkeypatch.setattr(hb, "LEAF_CELLS", 512)
    monkeypatch.setattr(jhb, "LEAF_CELLS", 512)


@pytest.mark.parametrize("win", [
    (0, 200, 0, 333, False, False),  # whole pair, fresh gaps
    (10, 150, 5, 200, True, False),  # tb crosses the boundary
    (50, 52, 100, 333, False, True),  # minimal height, te crosses
    (0, 64, 0, 8, False, False),  # narrow subject (one shard wide)
    (3, 199, 330, 333, True, True),
])
def test_ring_divide_matches_jax(divide_pairs, win):
    q, s, Q, R, port, jax = divide_pairs
    want = _host_divide(q, s, *win, Q, R)
    assert jax.divide(*win) == want
    for rp in port.values():
        before = rp.dispatches
        assert rp.divide(*win) == want
        assert rp.dispatches == before + 1


def test_ring_sw_end_matches_jax():
    """The end cell, then the reverse prefix sweep (the start cell); the
    gaps of the alignments below, so the reference compiles its sweep once."""
    q, s = _pair(150, 400, 7)
    Q, R = oracle.gap_qr(11, 1, True)
    jax = j_ring_mm.RingPair(q, s, B62.padded(), Q, R, j_mesh(), RB=32, interpret=True)
    want = hb._score_end_sw(q, s, B62.padded(), Q, R)
    _, ei, ej = want
    want_r = hb._score_end_sw(q[:ei][::-1].copy(), s[:ej][::-1].copy(), B62.padded(), Q, R)
    assert jax.sw_end(len(q), len(s)) == want
    assert jax.sw_end(ei, ej, reverse=True) == want_r
    for D in (2, 8):
        rp = RingPair(q, s, B62.padded(), Q, R, _mesh(D), RB=32)
        assert rp.sw_end(len(q), len(s)) == want
        assert rp.sw_end(ei, ej, reverse=True) == want_r
        assert rp.dispatches == 2


def _three(q, s, mat, go, ge, local, D=8, ring_min_cells=4096, **kw):
    """(port ring, JAX ring, port align_pair_linear) of one pair."""
    got = ring_align_pair(q, s, mat.padded(), go, ge, local=local, mesh=_mesh(D), RB=32,
                          ring_min_cells=ring_min_cells, **kw)
    want = j_ring_mm.ring_align_pair(q, s, mat.padded(), go, ge, local=local, mesh=j_mesh(),
                                     RB=32, ring_min_cells=ring_min_cells, interpret=True,
                                     **kw)
    linear = hb.align_pair_linear(q, s, mat.padded(), go, ge, local=local, device="cpu", **kw)
    return got, want, linear


def _same(got, want):
    return (got.score, got.q_begin, got.q_end, got.s_begin, got.s_end, got.cigar) == (
        want.score, want.q_begin, want.q_end, want.s_begin, want.s_end, want.cigar)


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_ring_align_matches_jax(leaf512, local):
    q, s = _pair(200, 333, 1)
    got, want, linear = _three(q, s, B62, 11, 1, local)
    assert _same(got, want) and got == linear


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_ring_align_shard_counts(leaf512, D):
    """The second shape of the reference's tests at every mesh size: equal
    to align_pair_linear (D = 1 is its fall-back)."""
    q, s = _pair(97, 510, 2)
    for local in (True, False):
        got = ring_align_pair(q, s, B62.padded(), 11, 1, local=local, mesh=_mesh(D), RB=32,
                              ring_min_cells=4096)
        assert got == hb.align_pair_linear(q, s, B62.padded(), 11, 1, local=local,
                                           device="cpu")


def test_ring_align_gap_convention(leaf512):
    """first_residue_opens=False against the reference; both conventions
    against align_pair_linear."""
    q, s = _pair(120, 300, 3)
    got, want, linear = _three(q, s, B62, 6, 2, True, first_residue_opens=False)
    assert _same(got, want) and got == linear
    got = ring_align_pair(q, s, B62.padded(), 6, 2, mesh=_mesh(8), RB=32, ring_min_cells=4096)
    assert got == hb.align_pair_linear(q, s, B62.padded(), 6, 2, device="cpu")


def test_ring_align_nucleotide(leaf512):
    """ACGT codes (the reference's small-K plane tree)."""
    mat = matrices.constant_scoring(5, -4)
    q, s = _pair(100, 257, 4, hi=4)
    got, want, linear = _three(q, s, mat, 10, 2, True, ring_min_cells=2048)
    assert _same(got, want) and got == linear


def test_ring_align_large_entries(leaf512):
    """|entry| > 256: the reference escapes to its single-device path; the
    port stays on the ring, and the alignment is the same."""
    mat = matrices.constant_scoring(500, -400)
    q, s = _pair(64, 128, 6, hi=4)
    got, want, linear = _three(q, s, mat, 300, 100, True, ring_min_cells=1024)
    assert _same(got, want) and got == linear
    stats = SearchStats()
    ring_align_pair(q, s, mat.padded(), 300, 100, mesh=_mesh(8), RB=32, ring_min_cells=1024,
                    stats=stats)
    assert stats.aligner_dispatches >= 3  # two end-cell sweeps and a divide


def test_ring_align_small_pair_passthrough():
    """Pairs below ring_min_cells go straight to align_pair_linear."""
    q, s = _pair(20, 30, 8)
    stats = SearchStats()
    got = ring_align_pair(q, s, B62.padded(), 11, 1, local=True, mesh=_mesh(8), stats=stats)
    want = j_ring_mm.ring_align_pair(q, s, B62.padded(), 11, 1, local=True, mesh=j_mesh(),
                                     interpret=True)
    assert _same(got, want)
    assert got == hb.align_pair_linear(q, s, B62.padded(), 11, 1, local=True, device="cpu")
    assert stats.aligner_dispatches == 0


def test_ring_align_stats_dispatches(leaf512):
    """Every divide and end-cell sweep is counted, as the reference counts
    them (test_ring_align_matches_jax's pair, so the reference's
    compilations are reused)."""
    q, s = _pair(200, 333, 1)
    stats, jstats = SearchStats(), JSearchStats()
    got = ring_align_pair(q, s, B62.padded(), 11, 1, local=False, mesh=_mesh(8), RB=32,
                          ring_min_cells=4096, stats=stats)
    want = j_ring_mm.ring_align_pair(q, s, B62.padded(), 11, 1, local=False, mesh=j_mesh(),
                                     RB=32, ring_min_cells=4096, interpret=True, stats=jstats)
    assert _same(got, want)
    assert got == hb.align_pair_linear(q, s, B62.padded(), 11, 1, local=False, device="cpu")
    assert stats.aligner_dispatches == jstats.aligner_dispatches >= 1
    assert stats.aligner_levels == 0  # no hand-off DevicePair on the CPU


def test_ring_align_hand_off_device_pair(leaf512, monkeypatch):
    """Below ring_min_cells the recursion hands off to hirschberg._nw_ops
    with the rank's DevicePair (forced onto K2's plain version here): its
    launches and levels are folded into the stats."""
    monkeypatch.setattr(hb, "DEVICE_ON_CPU", True)
    monkeypatch.setattr(hb, "DEVICE_MIN_CELLS", 2048)
    q, s = _pair(200, 333, 1)
    s[40:180] = q[30:170]  # SW's block: about 140 x 140 cells
    for local in (True, False):
        stats = SearchStats()
        got = ring_align_pair(q, s, B62.padded(), 11, 1, local=local, mesh=_mesh(4), RB=32,
                              ring_min_cells=16_000, stats=stats)
        assert got == hb.align_pair_linear(q, s, B62.padded(), 11, 1, local=local,
                                           device="cpu")
        assert stats.aligner_levels > 0
        assert stats.aligner_dispatches > stats.aligner_levels


def test_ring_divide_one_k2_batch_a_phase(monkeypatch):
    """A divide's forward and reverse passes share the staircase's phases:
    ONE K2 batch a phase holds both passes' tiles."""
    calls = []
    plain = ring_block.ring_block_batch_plain

    def counted(q, s, jobs, *args):
        calls.append(np.asarray(jobs).copy())
        return plain(q, s, jobs, *args)

    monkeypatch.setattr(ring_block, "ring_block_batch_plain", counted)
    q, s = _pair(90, 120, 9)
    Q, R = oracle.gap_qr(11, 1, True)
    D, RB = 3, 16
    rp = RingPair(q, s, B62.padded(), Q, R, _mesh(D), RB=RB)
    ring.phases = 0
    assert rp.divide(0, 90, 0, 120, False, False) == _host_divide(q, s, 0, 90, 0, 120, False,
                                                                  False, Q, R)
    Rb = -(-45 // RB)  # mid = mr = 45 rows
    assert len(calls) == ring.phases == Rb + D - 1
    assert [len(j) for j in calls] == [
        2 * sum(0 <= p - d < Rb for d in range(D)) for p in range(Rb + D - 1)]
    # Forward tiles read the forward codes, reverse tiles the reversed ones.
    assert all((j[:, 0] < 90).sum() == (j[:, 0] >= 90).sum() for j in calls)


def test_ring_align_defaults_to_the_card():
    """mesh=None takes every card, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    q, s = _pair(10, 10, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ring_align_pair(q, s, B62.padded(), 11, 1)
