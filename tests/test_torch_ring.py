"""``libssa_tpu_torch.parallel.ring`` against the JAX package's ring, on the CPU.

Each case mirrors one of ``tests/test_ring.py``'s: the same seeded numpy
pair goes through the reference's ``ring_score`` on the 8-device virtual
CPU mesh (``tests/conftest.py``; its ``lax.scan`` tile, and its banded
Pallas tile in interpret mode where named) and the port's on a mesh of D
CPU shards (K2's plain version), and through the NumPy oracle. Tolerance:
exact equality (integer DP scores). The reference escapes scores past the
f32 window to its single-device path with a WARNING; the port runs them on
the ring, in int32 or int64, and logs nothing.
"""
import numpy as np
import pytest
import torch

from libssa_tpu.parallel import ring as j_ring
from libssa_tpu.parallel.sharded import make_db_mesh as j_mesh
from libssa_tpu_torch import matrices, oracle
from libssa_tpu_torch.constants import OutputMode
from libssa_tpu_torch.ops import ring_block
from libssa_tpu_torch.parallel import ring
from libssa_tpu_torch.parallel.ring import ring_score
from libssa_tpu_torch.parallel.sharded import make_db_mesh
from libssa_tpu_torch.util.logging import set_output_mode

torch.set_num_threads(1)

B62 = matrices.builtin("BLOSUM62")
SCORES = {True: oracle.sw_score, False: oracle.nw_score}


def _pair(m, n, seed, hi=20):
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, m).astype(np.uint8), rng.integers(0, hi, n).astype(np.uint8)


def _mesh(D):
    return make_db_mesh(devices=["cpu"] * D)


def _both(q, s, go, ge, local, D=8, RB=32, mat=B62, **jax_kw):
    """(port, JAX scan ring, oracle) scores of one pair at D shards."""
    got = ring_score(q, s, mat.padded(), go, ge, local=local, mesh=_mesh(D), RB=RB)
    want = j_ring.ring_score(q, s, mat.padded(), go, ge, local=local, mesh=j_mesh(D),
                             RB=RB, **jax_kw)
    return got, int(want), SCORES[local](q, s, mat.scores, go, ge)


@pytest.mark.parametrize("m,n", [(128, 1024), (100, 777), (64, 64), (96, 40)])
def test_ring_sw_matches_jax(m, n):
    q, s = _pair(m, n, m * 1000 + n)
    got, want, oracle_ = _both(q, s, 11, 1, True)
    assert got == want == oracle_


@pytest.mark.parametrize("m,n", [(128, 1024), (128, 777), (64, 111)])
def test_ring_nw_matches_jax(m, n):
    q, s = _pair(m, n, m * 1000 + n + 7)
    got, want, oracle_ = _both(q, s, 11, 1, False)
    assert got == want == oracle_


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_ring_shard_counts(D):
    """Every mesh size of the reference's tests, SW and NW, one pair."""
    q, s = _pair(70, 200, 3 + D)
    for local in (True, False):
        got, want, oracle_ = _both(q, s, 11, 1, local, D=D)
        assert got == want == oracle_


def test_ring_gap_conventions():
    """Other gap costs at the default RB, and first_residue_opens=False."""
    q, s = _pair(64, 300, 5)
    for go, ge in [(5, 2), (20, 1)]:
        got = ring_score(q, s, B62.padded(), go, ge, local=True, mesh=_mesh(8))
        want = j_ring.ring_score(q, s, B62.padded(), go, ge, local=True, mesh=j_mesh())
        assert got == int(want) == oracle.sw_score(q, s, B62.scores, go, ge)
    for local in (True, False):
        got = ring_score(q, s, B62.padded(), 6, 2, local, _mesh(4), 16, first_residue_opens=False)
        want = j_ring.ring_score(q, s, B62.padded(), 6, 2, local, j_mesh(4), 16,
                                 first_residue_opens=False)
        assert got == int(want) == SCORES[local](q, s, B62.scores, 6, 2, False)


@pytest.mark.parametrize("m,n", [(41, 179), (30, 30), (65, 500)])
def test_ring_nw_arbitrary_lengths(m, n):
    """NW captures H[m][n] at any (m, n): no shard or row-block alignment."""
    q, s = _pair(m, n, m + n)
    got, want, oracle_ = _both(q, s, 12, 2, False)
    assert got == want == oracle_


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_ring_matches_jax_banded_and_scan(local):
    """The reference's two tile bodies, the scan and the banded Pallas tile
    (interpret mode), on the same inputs as the port."""
    q, s = _pair(40, 40, 40 * 77 + 40 + local)
    got, scan, oracle_ = _both(q, s, 11, 1, local)
    banded = j_ring.ring_score(q, s, B62.padded(), 11, 1, local=local, mesh=j_mesh(),
                               RB=32, kernel="banded", interpret=True)
    assert got == scan == int(banded) == oracle_


@pytest.mark.parametrize("m,n,D,RB", [
    (40, 5, 8, 32),  # n < D: shards 5-7 hold no column
    (33, 9, 4, 8),  # n = (D - 1) W: the last shard is empty
    (20, 200, 4, 32),  # m < RB: one row block
    (50, 123, 3, 16),  # m not a multiple of RB: a short last row block
    (1, 1, 2, 1),  # one cell
], ids=["n<D", "empty-shard", "m<RB", "short-block", "1x1"])
def test_ring_edge_shapes(m, n, D, RB):
    q, s = _pair(m, n, m * n + D)
    for local in (True, False):
        got, want, oracle_ = _both(q, s, 11, 1, local, D=D, RB=RB)
        assert got == want == oracle_


def test_ring_empty_pairs():
    """Empty pairs are scored on the host, as the reference does."""
    for m, n in [(0, 7), (9, 0), (0, 0)]:
        q, s = _pair(m, n, 1)
        for local in (True, False):
            got = ring_score(q, s, B62.padded(), 11, 1, local, _mesh(2))
            assert got == j_ring.ring_score(q, s, B62.padded(), 11, 1, local, j_mesh(2))
            assert got == SCORES[local](q, s, B62.scores, 11, 1)


def test_ring_past_f32_window_and_int32(capsys):
    """Scores past 2**24 (the reference escapes them to its single-device
    path with a WARNING) and past int32 (the port's int64 DP): equal to the
    oracle, with no WARNING from the port."""
    set_output_mode(OutputMode.WARNING)
    rng = np.random.default_rng(3)
    q = rng.integers(0, 4, 40).astype(np.uint8)
    s = np.concatenate([q, rng.integers(0, 4, 20).astype(np.uint8)])
    mat = matrices.constant_scoring(2**25, -4)
    want = oracle.sw_score(q, s, mat.scores, 10, 2)
    assert want > 2**24
    capsys.readouterr()
    assert ring_score(q, s, mat.padded(), 10, 2, True, _mesh(4), 16) == want
    assert capsys.readouterr().err == ""
    assert int(j_ring.ring_score(q, s, mat.padded(), 10, 2, True, j_mesh(4), 16)) == want
    assert "f32 exactness window" in capsys.readouterr().err
    mat = matrices.constant_scoring(2**28, -4)
    for local in (True, False):
        want = SCORES[local](q, s, mat.scores, 10, 2)
        assert abs(want) > 2**31
        assert ring_score(q, s, mat.padded(), 10, 2, local, _mesh(4), 16) == want
    assert capsys.readouterr().err == ""


def test_ring_one_k2_batch_a_phase(monkeypatch):
    """The staircase: every phase is ONE K2 batch (the plain version's, on
    the CPU) holding each active shard's tile, ceil(m / RB) + D - 1 phases."""
    calls = []
    plain = ring_block.ring_block_batch_plain

    def counted(q, s, jobs, *args):
        calls.append(np.asarray(jobs).copy())
        return plain(q, s, jobs, *args)

    monkeypatch.setattr(ring_block, "ring_block_batch_plain", counted)
    q, s = _pair(50, 90, 4)
    D, RB = 4, 16
    for local in (True, False):
        calls.clear()
        ring.phases = 0
        assert ring_score(q, s, B62.padded(), 11, 1, local, _mesh(D), RB) == \
            SCORES[local](q, s, B62.scores, 11, 1)
        Rb = -(-50 // RB)
        assert len(calls) == ring.phases == Rb + D - 1
        # Phase p holds the tiles (rb = p - d, d) with 0 <= rb < Rb.
        assert [len(j) for j in calls] == [
            sum(0 <= p - d < Rb for d in range(D)) for p in range(Rb + D - 1)]
        assert all((j[:, 1] <= RB).all() and (j[:, 3] <= -(-90 // D)).all() for j in calls)


def test_ring_defaults_to_the_card():
    """mesh=None takes every card, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    q, s = _pair(10, 10, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ring_score(q, s, B62.padded(), 11, 1)
