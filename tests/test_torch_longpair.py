"""The port's long-pair scorer and ``pair_scores_batch`` against the JAX package.

The plain PyTorch row sweep must equal JAX's scan (f32 and int32) and the
Pallas kernel (interpret mode); the port's ``longpair_score`` must equal
JAX's ``longpair_score``; the int64 route must equal the NumPy oracle past
2**31. K3's CUDA source is held against the plain version here through its
column routine, built by the host C++ compiler; ``tests/test_torch_cuda.py``
holds the kernel itself on the card. Tolerance: exact equality, since every
value is an integer.
"""
import ctypes
import functools
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libssa_tpu import matrices, oracle
from libssa_tpu.constants import SymType
from libssa_tpu.io.db import PAD_CODE
from libssa_tpu.ops import interseq as jax_interseq
from libssa_tpu.ops import longpair as jax_longpair
from libssa_tpu.ops.scoring import make_padded_profile
from libssa_tpu_torch.ops import interseq, longpair, longpair_cuda
from libssa_tpu_torch.util import cudabuild

torch.set_num_threads(1)

B62 = matrices.builtin("BLOSUM62")
PADDED = B62.padded()
ACGT = matrices.constant_scoring(5, -4, SymType.NUCLEOTIDE)

SHAPES = [(1, 1), (1, 37), (37, 1), (3, 5), (60, 40), (200, 9), (9, 200)]


def _codes(rng, k, hi=20):
    return rng.integers(0, hi, k).astype(np.uint8)


def _plain(q, s, mat, Q, R, local, dtype=torch.int32):
    return int(longpair.longpair_score_plain(
        torch.as_tensor(q), torch.as_tensor(s),
        torch.as_tensor(np.asarray(mat, np.int32)), Q, R, local=local, dtype=dtype,
    ))


def _jax_scan(q, s, mat, Q, R, local, dtype_name):
    """JAX's scan with its own wrapper's padding (``longpair.py:251-265``)."""
    m, n = len(q), len(s)
    P = jax_longpair.subject_profile(s, mat)
    P = np.pad(P, ((0, 0), (0, -(-n // 512) * 512 - n)), constant_values=-64)
    qi = np.full(-(-m // 256) * 256, 31, np.int32)
    qi[:m] = q
    return int(jax_longpair.longpair_score_scan(
        jnp.asarray(P, jnp.int32), jnp.asarray(qi), Q, R, m, n,
        local=local, dtype_name=dtype_name,
    ))


@pytest.mark.parametrize("dtype_name", ["float32", "int32"])
@pytest.mark.parametrize("go,ge", [(10, 1), (5, 2), (20, 1)])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_plain_matches_jax_scan(local, go, ge, dtype_name):
    rng = np.random.default_rng(go * 10 + ge + local)
    Q, R = oracle.gap_qr(go, ge)
    for m, n in SHAPES:
        q, s = _codes(rng, m), _codes(rng, n)
        want = _jax_scan(q, s, PADDED, Q, R, local, dtype_name)
        assert _plain(q, s, PADDED, Q, R, local) == want, (m, n)


@pytest.mark.parametrize("alpha", ["protein", "acgt"])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_plain_matches_pallas_interpret(local, alpha):
    from libssa_tpu.ops.longpair_pallas import longpair_score_pallas

    mat, hi = (PADDED, 20) if alpha == "protein" else (ACGT.padded(), 4)
    rng = np.random.default_rng(31 + local)
    cases = [(40, 60, 10, 1), (9, 300, 5, 2), (130, 1100, 20, 1)]
    if local:
        cases.append((600, 500, 10, 1))  # a query longer than one row block
    for m, n, go, ge in cases:
        q, s = _codes(rng, m, hi), _codes(rng, n, hi)
        Q, R = oracle.gap_qr(go, ge)
        want = longpair_score_pallas(q, s, mat, Q, R, local=local, interpret=True)
        assert _plain(q, s, mat, Q, R, local) == want, (m, n, go, ge)


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_longpair_score_matches_jax(local):
    """Empty inputs, both gap conventions, and entries above 256."""
    rng = np.random.default_rng(5 + local)
    big = matrices.constant_scoring(300, -200, SymType.AMINOACID).padded()
    empty = np.zeros(0, np.uint8)
    cases = [
        (empty, _codes(rng, 5), PADDED, True),
        (_codes(rng, 7), empty, PADDED, True),
        (empty, empty, PADDED, True),
        (_codes(rng, 50), _codes(rng, 70), PADDED, False),
        (_codes(rng, 50), _codes(rng, 70), PADDED, True),
        (_codes(rng, 40), _codes(rng, 33), big, True),
    ]
    for q, s, mat, fro in cases:
        want = jax_longpair.longpair_score(q, s, mat, 10, 1, local, fro)
        for kernel in ("auto", "cuda", "plain"):
            got = longpair.longpair_score(
                q, s, mat, 10, 1, local, fro, kernel=kernel, device="cpu"
            )
            assert got == want, (len(q), len(s), fro, kernel)
    with pytest.raises(ValueError, match="unknown kernel"):
        longpair.longpair_score(q, s, mat, 10, 1, local, kernel="scan", device="cpu")


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_int64_route_past_int32(local):
    """A score past 2**31 (JAX's int32 escape would wrap there) is exact."""
    scores = np.full((20, 20), -(2**20), np.int64)
    np.fill_diagonal(scores, 2**27)
    mat = np.full((32, 32), -64, np.int64)
    mat[:20, :20] = scores
    rng = np.random.default_rng(12)
    q = _codes(rng, 40)
    s = np.concatenate([q[3:], _codes(rng, 5)])
    assert longpair.score_bound(40, 42, mat, 11, 1) >= longpair.INT32_LIMIT
    want = (oracle.sw_score if local else oracle.nw_score)(q, s, scores, 10, 1)
    assert abs(want) > 2**31
    got = longpair.longpair_score(q, s, mat, 10, 1, local, device="cpu")
    assert got == want
    forced = _plain(q, s, mat, 11, 1, local, dtype=torch.int64)
    assert forced == want


def test_subject_profile_matches_jax():
    rng = np.random.default_rng(2)
    s = _codes(rng, 30)
    np.testing.assert_array_equal(
        longpair.subject_profile(s, PADDED), jax_longpair.subject_profile(s, PADDED)
    )


def test_wrapper_on_cpu_runs_plain_without_launch():
    rng = np.random.default_rng(4)
    q, s = (torch.as_tensor(_codes(rng, k)) for k in (70, 45))
    mat = torch.as_tensor(PADDED.astype(np.int32))
    before = longpair_cuda.launches
    for local in (True, False):
        for dt in (torch.int32, torch.int64):
            got = longpair_cuda.longpair_score_cuda(q, s, mat, 11, 1, local, dt)
            want = longpair.longpair_score_plain(q, s, mat, 11, 1, local, dt)
            assert got.dtype == dt and torch.equal(got, want)
    assert longpair_cuda.launches == before
    with pytest.raises(ValueError, match="dtype"):
        longpair.longpair_score_plain(q, s, mat, 11, 1, dtype=torch.float32)


def test_band_rows_rule():
    """4 rows a thread at every query length (the sweep on the card)."""
    assert longpair_cuda.band_rows(16_384, 132) == 4
    assert longpair_cuda.band_rows(100_000, 132) == 4
    assert longpair_cuda.band_rows(65_536, 132) == 4
    assert longpair_cuda.band_rows(1, 132) == 4
    assert all(longpair_cuda.band_rows(m, 132) in longpair_cuda.BAND_ROWS
               for m in (1, 4096, 16_896, 10**7))


def _host_k3(tmp_path):
    """K3's column routine and group pipeline, built by the C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path / "k3_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
         str(out), str(cudabuild.CSRC / longpair_cuda.SOURCE)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.k3_longpair_host.argtypes = [p, ll, p, i, p, ll, ll, i, i, i, ll, i, p, p, p]
    lib.k3_longpair_host.restype = i
    longpair_cuda.bind_layout(lib)
    return lib


def _run_host(lib, q, s, mat, Q, R, local, ch, wide, warps=1):
    """(rc, score) of K3's host build on one pair."""
    m, n = len(q), len(s)
    dt = np.int64 if wide else np.int32
    bufs = np.zeros((2, lib.k3_ring_slots(), n), dt)
    res = np.zeros(1, dt)
    rc = lib.k3_longpair_host(
        q.ctypes.data, m, s.ctypes.data, n, mat.ctypes.data, Q, R, int(local), wide,
        ch, -(-m // (32 * ch)), warps, bufs[0].ctypes.data, bufs[1].ctypes.data,
        res.ctypes.data,
    )
    return rc, int(res[0])


def test_k3_stripe_routine_matches_plain(tmp_path):
    """K3's source, host-built at one stripe a block: both modes and types,
    every band height, stripe edges crossed, m not a multiple of a stripe,
    m or n = 1."""
    lib = _host_k3(tmp_path)
    ring = lib.k3_ring_slots()
    assert ring >= 2
    rng = np.random.default_rng(21)
    mats = [(PADDED, 20), (ACGT.padded(), 4)]
    shapes = [(1, 1), (1, 70), (70, 1), (31, 33), (300, 50), (50, 300), (700, 97)]
    for k, (m, n) in enumerate(shapes):
        mat, hi = mats[k % 2]
        mat = np.ascontiguousarray(mat, np.int32)
        q, s = _codes(rng, m, hi), _codes(rng, n, hi)
        Q, R = ((12, 1), (7, 2))[k % 2]
        for local in (True, False):
            want = _plain(q, s, mat, Q, R, local, torch.int64)
            for ch in longpair_cuda.BAND_ROWS:
                for wide in (0, 1):
                    rc, got = _run_host(lib, q, s, mat, Q, R, local, ch, wide)
                    assert rc == 0
                    assert got == want, (m, n, local, ch, wide)
    res = np.zeros(1, np.int32)
    assert lib.k3_longpair_host(q.ctypes.data, 1, s.ctypes.data, 1, mat.ctypes.data,
                                12, 1, 1, 0, 2, 1, 1, None, None, res.ctypes.data) == -1


@pytest.fixture(scope="module")
def k3_host(tmp_path_factory):
    return _host_k3(tmp_path_factory.mktemp("k3"))


@functools.cache
def _warps_pairs():
    """Pairs for K3 at W stripes a block, with their plain scores (SW, NW):
    4,200 rows (33 stripes of 128 rows, 17 of 256: more groups than the
    global ring's slots at every W, and a stripe count no W > 1 divides),
    300 rows (3 stripes of 128, 2 of 256: fewer stripes than W), m = 1,
    n = 1, n < SEG, one stripe, and a matrix with entries above 256."""
    rng = np.random.default_rng(93)
    big = matrices.constant_scoring(300, -200, SymType.AMINOACID).padded()
    cases = [(4200, 45, PADDED, 20, (12, 1)), (300, 90, ACGT.padded(), 4, (7, 2)),
             (1, 40, PADDED, 20, (11, 1)), (70, 1, PADDED, 20, (11, 1)),
             (520, 5, PADDED, 20, (10, 3)), (100, 120, big, 20, (11, 1))]
    out = []
    for m, n, mat, hi, (Q, R) in cases:
        mat = np.ascontiguousarray(mat, np.int32)
        q, s = _codes(rng, m, hi), _codes(rng, n, hi)
        want = {local: _plain(q, s, mat, Q, R, local, torch.int64) for local in (True, False)}
        out.append((q, s, mat, Q, R, want))
    return out


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
@pytest.mark.parametrize("ch", longpair_cuda.BAND_ROWS)
@pytest.mark.parametrize("wide", [0, 1], ids=["int32", "int64"])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_k3_warps_match_plain(k3_host, local, wide, ch, warps):
    """K3's source, host-built with ``warps`` stripes a block: every group
    runs warp by warp through the shared-ring handoff in the kernel's
    segment order (rc 0: no handoff or publish that would race on the
    card), and equals the plain version. A block past the shared memory is
    refused."""
    if not longpair_cuda.fits(warps, ch, 8 if wide else 4):
        res = np.zeros(1, np.int64)
        assert k3_host.k3_longpair_host(None, 1, None, 1, None, 11, 1, int(local), wide, ch,
                                        1, warps, None, None, res.ctypes.data) == -1
        return
    for q, s, mat, Q, R, want in _warps_pairs():
        rc, got = _run_host(k3_host, q, s, mat, Q, R, local, ch, wide, warps)
        assert rc == 0, (len(q), len(s))  # -2: a handoff would race on the card
        assert got == want[local], (len(q), len(s))


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_k3_warps_match_pallas_interpret(k3_host, local):
    """K3's source, host-built at 2 stripes a block (3 stripes of 128 rows
    in 2 groups, so one edge through the shared ring and one through the
    global ring), equals the JAX package's kernel in interpret mode."""
    from libssa_tpu.ops.longpair_pallas import longpair_score_pallas

    rng = np.random.default_rng(97 + local)
    q, s = _codes(rng, 300), _codes(rng, 75)
    Q, R = oracle.gap_qr(10, 1)
    mat = np.ascontiguousarray(PADDED, np.int32)
    want = longpair_score_pallas(q, s, PADDED, Q, R, local=local, interpret=True)
    assert _run_host(k3_host, q, s, mat, Q, R, local, 4, 0, warps=2) == (0, want)


@pytest.mark.parametrize("m,ch,want", [
    (16_384, 4, 4),    # 8a: 128 stripes
    (100_000, 4, 4),   # 8b: 782 stripes
    (100_000, 8, 4),   # 8b at 8 rows: 391 stripes
    (300, 4, 3),       # 3 stripes: one warp a stripe
    (1, 4, 1),
])
def test_choose_warps(m, ch, want):
    """K3's stripes a block at phase 8's pairs, at the band height
    ``band_rows`` picks there, and at queries of fewer stripes."""
    assert longpair_cuda.choose_warps(m, ch, 132) == want
    assert longpair_cuda.fits(want, ch, 8)


def _subject_batch(rng, P, n, zero=1):
    lengths = rng.integers(1, n + 1, P).astype(np.int32)
    lengths[:zero] = 0
    subjects = rng.integers(0, 20, (P, n)).astype(np.uint8)
    subjects[np.arange(n)[None, :] >= lengths[:, None]] = PAD_CODE
    return subjects, lengths


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_pair_scores_batch_matches_jax_and_oracle(local):
    rng = np.random.default_rng(17 + local)
    q = _codes(rng, 30)
    prof = make_padded_profile(q, PADDED, rows=40)  # m_real 30 < 40 rows
    subjects, lengths = _subject_batch(rng, 11, 26)
    want = np.asarray(jax_interseq.pair_scores_batch(
        jnp.asarray(prof, jnp.int32), jnp.asarray(subjects), jnp.asarray(lengths),
        12, 1, local=local, m_real=30,
    ))
    fn = oracle.sw_score if local else oracle.nw_score
    expect = [fn(q, subjects[p, : lengths[p]], B62.scores, 11, 1) for p in range(11)]
    np.testing.assert_array_equal(want, expect)
    for kernel in ("auto", "cuda", "plain"):
        got = interseq.pair_scores_batch(
            torch.as_tensor(prof), torch.as_tensor(subjects), torch.as_tensor(lengths),
            12, 1, local=local, m_real=30, kernel=kernel,
        )
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="unknown kernel"):
        interseq.pair_scores_batch(
            torch.as_tensor(prof), torch.as_tensor(subjects),
            torch.as_tensor(lengths), 12, 1, kernel="pallas",
        )
