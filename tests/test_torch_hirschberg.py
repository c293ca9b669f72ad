"""The port's linear-space aligner against the JAX package's, on the CPU.

``align_pair_linear`` must return the JAX package's score, coordinates and
cigar on the host path (NumPy passes, as both run on the CPU) and on the
device path forced onto the CPU (``DevicePair`` on K2's plain version),
under a common ``LEAF_CELLS``: the leaf size decides which of several
equal-cost paths is taken. The native leaf solver must equal the Python
one. Tolerance: exact equality.
"""
import itertools

import numpy as np
import pytest
import torch

from libssa_tpu import oracle as jax_oracle
from libssa_tpu.search import hirschberg as jhb
from libssa_tpu_torch import matrices, oracle
from libssa_tpu_torch.search import hirschberg as hb
from libssa_tpu_torch.search.leafnative import leaf_ops_native, native_available
from libssa_tpu_torch.search.manager import SearchStats

torch.set_num_threads(1)

B62 = matrices.builtin("BLOSUM62")


def _key(tb):
    return tb.score, tb.q_begin, tb.q_end, tb.s_begin, tb.s_end, tb.cigar


@pytest.fixture
def leaf(monkeypatch):
    """Set both packages' LEAF_CELLS."""
    def set_leaf(cells):
        monkeypatch.setattr(hb, "LEAF_CELLS", cells)
        monkeypatch.setattr(jhb, "LEAF_CELLS", cells)
    return set_leaf


@pytest.fixture
def on_device(monkeypatch):
    """Run the port's device path (DevicePair on K2's plain version) on the CPU."""
    monkeypatch.setattr(hb, "DEVICE_ON_CPU", True)
    monkeypatch.setattr(hb, "DEVICE_MIN_CELLS", 1024)


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_fuzz_host_path_matches_jax(local, leaf):
    """Random shapes and gaps; deletion- and insertion-heavy pairs drive the
    t2 (gap-crossing) split; LEAF_CELLS 0, 64 and the default."""
    rng = np.random.default_rng(11 if local else 12)
    for trial in range(24):
        m, n = int(rng.integers(1, 90)), int(rng.integers(1, 90))
        if trial % 3 == 1:
            m, n = m * 3, max(2, n // 4)
        elif trial % 3 == 2:
            m, n = max(2, m // 4), n * 3
        go = int(rng.integers(1, 14))
        ge = int(rng.integers(1, min(go + 1, 5)))
        q = rng.integers(0, 20, m).astype(np.uint8)
        s = rng.integers(0, 20, n).astype(np.uint8)
        want_score = (jax_oracle.sw_score if local else jax_oracle.nw_score)(
            q, s, B62.scores, go, ge)
        for cells in (0, 64, 1 << 20):
            leaf(cells)
            got = hb.align_pair_linear(q, s, B62.scores, go, ge, local, device="cpu")
            want = jhb.align_pair_linear(q, s, B62.scores, go, ge, local)
            assert _key(got) == _key(want), (m, n, go, ge, cells)
            assert got.score == want_score


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_device_path_matches_jax(local, leaf, on_device):
    """DevicePair levels and end cells (forced onto the CPU) give the JAX
    package's alignments; the stats count the levels."""
    rng = np.random.default_rng(5 if local else 6)
    leaf(256)
    for m, n in ((230, 310), (97, 40), (41, 260)):
        q = rng.integers(0, 20, m).astype(np.uint8)
        s = rng.integers(0, 20, n).astype(np.uint8)
        s[10:40] = q[20:50] if m > 50 else s[10:40]  # a planted local hit
        st = SearchStats()
        got = hb.align_pair_linear(q, s, B62.scores, 10, 1, local, stats=st, device="cpu")
        want = jhb.align_pair_linear(q, s, B62.scores, 10, 1, local)
        assert _key(got) == _key(want), (m, n)
        assert st.aligner_levels >= (0 if local else 1)  # SW: the local path may be short
        assert st.aligner_dispatches == st.aligner_levels + (2 if local else 0)
        assert st.aligner_device_seconds > 0


def test_device_path_ties(leaf, on_device):
    """Repeated motifs: equal-cost crossings everywhere; the first minimum
    must be taken, as the JAX package does."""
    leaf(128)
    motif = np.array([12, 4, 9, 1, 17, 3], np.uint8)
    q, s = np.tile(motif, 40), np.tile(motif, 33)
    s = np.concatenate([s[:50], s[57:]])
    for local in (True, False):
        got = hb.align_pair_linear(q, s, B62.scores, 10, 1, local, device="cpu")
        want = jhb.align_pair_linear(q, s, B62.scores, 10, 1, local)
        assert _key(got) == _key(want), local


def test_cpu_device_keeps_numpy_passes(monkeypatch):
    """Above DEVICE_MIN_CELLS on the CPU the NumPy passes run (no DevicePair)."""
    monkeypatch.setattr(hb, "DEVICE_MIN_CELLS", 16)
    assert not hb._device_ok(100, 100, torch.device("cpu"))
    assert hb._device_ok(100, 100, torch.device("cuda"))
    assert not hb._device_ok(1, 100, torch.device("cuda"))
    assert not hb._device_ok(3, 5, torch.device("cuda"))
    st = SearchStats()
    q = np.arange(20, dtype=np.uint8)
    hb.align_pair_linear(q, q, B62.scores, 10, 1, True, stats=st, device="cpu")
    assert st.aligner_dispatches == 0


def test_empty_and_edge():
    q = np.array([], dtype=np.uint8)
    s = np.array([3, 4], dtype=np.uint8)
    for local in (True, False):
        got = hb.align_pair_linear(q, s, B62.scores, 10, 1, local, device="cpu")
        assert _key(got) == _key(jhb.align_pair_linear(q, s, B62.scores, 10, 1, local))
    one = hb.align_pair_linear(np.array([5], np.uint8), np.array([5], np.uint8),
                               B62.scores, 10, 1, False, device="cpu")
    assert (one.score, one.cigar) == (B62.scores[5, 5], "M")


def test_ops_score_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.integers(0, 20, 60).astype(np.uint8)
    s = rng.integers(0, 20, 50).astype(np.uint8)
    tb = jhb.align_pair_linear(q, s, B62.scores, 10, 1, False)
    Q, R = oracle.gap_qr(10, 1)
    ops = list(tb.cigar)
    assert hb._ops_score(q, s, B62.scores, Q, R, ops) == jhb._ops_score(
        q, s, B62.scores, Q, R, ops) == tb.score


def test_leaf_native_matches_python():
    """csrc/leafalign.cpp == the port's _ops_small == the JAX package's, for
    every (tb, te) boundary-contract combination, random and tie-heavy."""
    if not native_available():
        pytest.skip("no host C++ compiler to build csrc/leafalign.cpp")
    cost = -B62.scores.astype(np.int64)
    Q, R = oracle.gap_qr(10, 1)
    g = Q - R
    rng = np.random.default_rng(7)
    cases = [(rng.integers(0, 20, int(rng.integers(2, 70))).astype(np.intp),
              rng.integers(0, 20, int(rng.integers(1, 70))).astype(np.intp))
             for _ in range(30)]
    motif = np.array([12, 4, 9, 1], np.intp)
    cases.append((np.tile(motif, 30), np.tile(motif, 35)))
    for q, s in cases:
        for tb, te in itertools.product((0, g), (0, g)):
            want = jhb._ops_small(q, s, cost, g, R, tb, te)
            assert hb._ops_small(q, s, cost, g, R, tb, te) == want
            assert leaf_ops_native(q, s, cost, g, R, tb, te) == want, (len(q), len(s), tb, te)
