"""The port's ``DevicePair`` (K2's plain version, on the CPU) against the JAX package.

The JAX side is its own ``DevicePair`` in Pallas interpret mode (RB = WC =
256, as ``tests/test_mm_device.py`` runs it) and its host NumPy passes
(``search/hirschberg.py``). Divide levels with every boundary-open
combination, windows into the forward and reversed codes, SW end cells
forward and reverse, and inputs built to tie: the splits take the first
minimum and the end cell the smallest (i, j), so ties must break alike.
Tolerance: exact equality.
"""
import numpy as np
import pytest
import torch

from libssa_tpu.ops.mm_device import DevicePair as JaxPair
from libssa_tpu.search import hirschberg as jhb
from libssa_tpu_torch import matrices, oracle
from libssa_tpu_torch.ops import ring_block_cuda
from libssa_tpu_torch.ops.mm_device import DevicePair, mm_pass_rows, sw_end_cell

torch.set_num_threads(1)

B62 = matrices.builtin("BLOSUM62")
Q, R = oracle.gap_qr(10, 1)
G = Q - R
COST = -B62.scores.astype(np.int64)
MOTIF = np.array([12, 4, 9, 1, 17, 3], np.intp)


def _pairs(rng, m, n):
    return rng.integers(0, 20, m).astype(np.intp), rng.integers(0, 20, n).astype(np.intp)


def _jax(q, s):
    return JaxPair(q, s, B62.padded(), Q, R, interpret=True, RB=256, WC=256)


def _host_split(q, s, node):
    qs, qe, ss, se, f0, r0 = node
    mid = (qe - qs) // 2
    CCf, DDf = jhb._mm_pass(q[qs:qs + mid], s[ss:se], COST, G, R, 0 if f0 else G)
    CCr, DDr = jhb._mm_pass(q[qs + mid:qe][::-1].copy(), s[ss:se][::-1].copy(),
                            COST, G, R, 0 if r0 else G)
    t1 = CCf + CCr[::-1]
    t2 = DDf + DDr[::-1] - G
    return int(np.argmin(t1)), int(np.argmin(t2)), int(t1.min()), int(t2.min())


@pytest.mark.parametrize("tbs", [(False, False), (True, False), (False, True), (True, True)],
                         ids=["g-g", "0-g", "g-0", "0-0"])
def test_divide_level_matches_jax(tbs):
    """One launch for a level of nodes of different sizes == JAX's level
    and the host t1/t2 argmins, node by node."""
    rng = np.random.default_rng(sum(tbs) + 11)
    q, s = _pairs(rng, 601, 240)
    nodes = [(0, 301, 0, 120, tbs[0], tbs[1]), (301, 601, 120, 240, tbs[1], tbs[0]),
             (10, 120, 5, 230, False, False), (500, 502, 200, 201, tbs[0], tbs[0])]
    pair = DevicePair(q, s, B62.padded(), Q, R, device="cpu")
    before = ring_block_cuda.launches
    got = pair.divide_level(nodes)
    assert (pair.dispatches, pair.levels) == (1, 1)
    assert ring_block_cuda.launches == before  # the plain version: no launch on the CPU
    assert got == _jax(q, s).divide_level(nodes)
    assert got == [_host_split(q, s, nd) for nd in nodes]


def test_divide_level_ties():
    """Repeated motifs: many crossing columns cost the same; the first wins."""
    q, s = np.tile(MOTIF, 40), np.tile(MOTIF, 30)
    nodes = [(0, 240, 0, 180, False, False), (6, 120, 12, 150, True, False),
             (60, 240, 0, 90, False, True)]
    got = DevicePair(q, s, B62.padded(), Q, R, device="cpu").divide_level(nodes)
    assert got == _jax(q, s).divide_level(nodes)
    assert got == [_host_split(q, s, nd) for nd in nodes]


@pytest.mark.parametrize("tb0", [False, True], ids=["tb=g", "tb=0"])
def test_windowed_pass_matches_jax(tb0):
    """(offset, m, n) windows into the forward and reversed codes."""
    rng = np.random.default_rng(37 + tb0)
    q, s = _pairs(rng, 500, 400)
    pair, ref = DevicePair(q, s, B62.padded(), Q, R, device="cpu"), _jax(q, s)
    for qs, mi, ss, ni in ((37, 150, 91, 200), (0, 1, 0, 400), (499, 1, 399, 1)):
        for reverse in (False, True):
            got = pair.mm_pass(qs, mi, ss, ni, tb0, reverse)
            want = ref.mm_pass(qs, mi, ss, ni, tb0, reverse=reverse)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    CC, DD = mm_pass_rows(q[:90], s[:70], B62.padded(), Q, R, tb0, device="cpu")
    wCC, wDD = jhb._mm_pass(q[:90], s[:70], COST, G, R, 0 if tb0 else G)
    np.testing.assert_array_equal(CC, wCC)
    np.testing.assert_array_equal(DD, wDD)


def test_sw_end_matches_jax():
    """Whole-pair and reverse-prefix windows, and a pair with no positive
    cell (every substitution negative)."""
    rng = np.random.default_rng(40)
    q, s = _pairs(rng, 420, 350)
    pair, ref = DevicePair(q, s, B62.padded(), Q, R, device="cpu"), _jax(q, s)
    got = pair.sw_end(0, 420, 0, 350)
    assert got == ref.sw_end(0, 420, 0, 350) == jhb._score_end_sw(q, s, B62.scores, Q, R)
    ei, ej = got[1], got[2]
    got = pair.sw_end(420 - ei, ei, 350 - ej, ej, reverse=True)
    assert got == ref.sw_end(420 - ei, ei, 350 - ej, ej, reverse=True)
    assert got == jhb._score_end_sw(q[:ei][::-1].copy(), s[:ej][::-1].copy(),
                                    B62.scores, Q, R)
    w, c = np.array([22], np.intp), np.array([23], np.intp)  # B62[*, X] < 0
    assert sw_end_cell(w.repeat(5), c.repeat(4), B62.padded(), Q, R, device="cpu") == (0, 0, 0)


@pytest.mark.parametrize("shape", [(50, 80), (300, 300), (430, 190)])
def test_sw_end_cell_matches_jax(shape):
    m, n = shape
    rng = np.random.default_rng(m * 7 + n)
    q, s = _pairs(rng, m, n)
    got = sw_end_cell(q, s, B62.padded(), Q, R, device="cpu")
    assert got == jhb._score_end_sw(q, s, B62.scores, Q, R)


def test_sw_end_cell_tie_break():
    """Many cells share the best score: the smallest i, then the smallest j."""
    q, s = np.tile(MOTIF, 50), np.tile(MOTIF, 60)
    got = sw_end_cell(q, s, B62.padded(), Q, R, device="cpu")
    assert got == jhb._score_end_sw(q, s, B62.scores, Q, R)
    assert got == _jax(q, s).sw_end(0, len(q), 0, len(s))


def test_int64_past_the_int32_bound():
    """Entries that push score_bound past 2**31 - 1: the pair runs in
    int64, and its passes equal the host's int64 NumPy."""
    big = np.full((32, 32), -64, np.int64)
    big[:20, :20] = -(2**21)
    np.fill_diagonal(big[:20, :20], 2**26)
    rng = np.random.default_rng(3)
    q = rng.integers(0, 20, 80).astype(np.intp)
    s = np.concatenate([q[4:], rng.integers(0, 20, 9)])
    pair = DevicePair(q, s, big, Q, R, device="cpu")
    assert pair.dtype == torch.int64
    CC, DD = pair.mm_pass(0, 80, 0, len(s), False)
    wCC, wDD = jhb._mm_pass(q, s, -big[:20, :20], G, R, G)
    np.testing.assert_array_equal(CC, wCC)
    np.testing.assert_array_equal(DD, wDD)
    assert pair.sw_end(0, 80, 0, len(s)) == jhb._score_end_sw(q, s, big[:20, :20], Q, R)


@pytest.mark.parametrize("bad", [32, 300, -1])
def test_codes_checked_once_before_the_upload(bad):
    """A code outside 0 .. 31 is refused before the pair is uploaded, so
    K2's launches skip their own check (a wrap to uint8 would hide 300)."""
    q = np.array([1, 2, bad, 4], np.int64)
    with pytest.raises(ValueError, match="codes"):
        DevicePair(q, q[:2], B62.padded(), Q, R, device="cpu")
    with pytest.raises(ValueError, match="codes"):
        DevicePair(q[:2], q, B62.padded(), Q, R, device="cpu")
