"""The kernels' gap check (``interseq_cuda.check_gaps``) and the CPU branches
of K1's, K2's and K3's wrappers at Q < R, against the JAX package.

K1, K2 and K3 compute F lazily, which is exact only for Q >= R >= 0, so
their CUDA branches refuse other gaps before any launch
(``tests/test_torch_cuda.py`` holds that on the card). Their CPU branches
keep running the plain versions, which equal the reference at Q < R too:
K1's input here is the one at which K1's host build gave 3 where the
reference gives 2. Tolerance: exact equality, since every value is an
integer.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libssa_tpu import matrices
from libssa_tpu.ops import interseq as jax_interseq
from libssa_tpu.ops import longpair as jax_longpair
from libssa_tpu.ops.scoring import make_profile
from libssa_tpu_torch.ops import (
    interseq_cuda,
    longpair,
    longpair_cuda,
    ring_block,
    ring_block_cuda,
)

torch.set_num_threads(1)

PADDED = matrices.builtin("BLOSUM62").padded()
Q_FAULT, S_FAULT = np.array([13, 5, 15], np.uint8), np.array([6, 13], np.uint8)


@pytest.mark.parametrize("Q,R", [(1, 2), (0, 1), (5, -1), (-3, -1)])
def test_check_gaps_refuses(Q, R):
    with pytest.raises(ValueError, match="Q >= R >= 0"):
        interseq_cuda.check_gaps(Q, R)


@pytest.mark.parametrize("Q,R", [(0, 0), (2, 2), (11, 1), (12, 0)])
def test_check_gaps_passes(Q, R):
    assert interseq_cuda.check_gaps(Q, R) is None


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_k1_wrapper_on_cpu_at_q_below_r(local):
    """K1's wrapper on CPU tensors at Q = 1, R = 2 runs the plain version,
    equal to the JAX package's ``interseq_scores``, and launches nothing."""
    rng = np.random.default_rng(3 + local)
    cases = [(Q_FAULT, S_FAULT)] + [
        (rng.integers(0, 20, 40).astype(np.uint8), rng.integers(0, 20, 30).astype(np.uint8))]
    before = interseq_cuda.launches
    for q, s in cases:
        prof = make_profile(q, PADDED).astype(np.int32)
        codes, lens = s.astype(np.int8)[:, None], np.array([len(s)], np.int32)
        want = jax_interseq.interseq_scores(
            jnp.asarray(prof), jnp.asarray(codes), jnp.asarray(lens), jnp.int32(1),
            jnp.int32(2), local=local, use_matmul=False)
        got = interseq_cuda.interseq_scores_cuda(
            torch.as_tensor(prof), torch.as_tensor(codes), torch.as_tensor(lens), 1, 2,
            local=local)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert interseq_cuda.launches == before


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_k3_wrapper_on_cpu_at_q_below_r(local):
    """K3's wrapper on CPU tensors at Q = 1, R = 2 runs the plain version,
    equal to the JAX package's long-pair scan, and launches nothing. (JAX's
    ``longpair_score`` takes gap open and extend through ``gap_qr``, which
    refuses Q < R, so the scan it routes to is called directly.)"""
    rng = np.random.default_rng(5 + local)
    cases = [(Q_FAULT, S_FAULT)] + [
        (rng.integers(0, 20, 70).astype(np.uint8), rng.integers(0, 20, 45).astype(np.uint8))]
    mat = torch.as_tensor(PADDED.astype(np.int32))
    before = longpair_cuda.launches
    for q, s in cases:
        m, n = len(q), len(s)
        prof = np.pad(jax_longpair.subject_profile(s, PADDED),
                      ((0, 0), (0, -(-n // 512) * 512 - n)), constant_values=-64)
        qi = np.full(-(-m // 256) * 256, 31, np.int32)
        qi[:m] = q
        want = int(jax_longpair.longpair_score_scan(
            jnp.asarray(prof, jnp.int32), jnp.asarray(qi), 1, 2, m, n, local=local,
            dtype_name="int32"))
        got = longpair_cuda.longpair_score_cuda(torch.as_tensor(q), torch.as_tensor(s), mat,
                                                1, 2, local)
        plain = longpair.longpair_score_plain(torch.as_tensor(q), torch.as_tensor(s), mat,
                                              1, 2, local)
        assert int(got) == int(plain) == want, (m, n)
    assert longpair_cuda.launches == before


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_k2_wrapper_on_cpu_at_q_below_r(local):
    """K2's wrapper on CPU tensors at Q = 1, R = 2 runs the plain version
    tile by tile, and launches nothing."""
    rng = np.random.default_rng(7 + local)
    q = torch.as_tensor(rng.integers(0, 20, 90).astype(np.uint8))
    s = torch.as_tensor(rng.integers(0, 20, 80).astype(np.uint8))
    jobs = np.array([[0, 90, 0, 80], [10, 33, 5, 40]], np.int64)
    n_rows, n_cols = int(jobs[:, 1].sum()), int(jobs[:, 3].sum())
    lo = 0 if local else -60

    def h(k):
        return torch.as_tensor(rng.integers(lo, 30, k).astype(np.int32))

    def gap(k):
        return torch.as_tensor(rng.integers(1, 9, k).astype(np.int32))

    leftH, leftE = h(n_rows + len(jobs)), h(n_rows) - gap(n_rows)
    topH = h(n_cols)
    topF = topH - gap(n_cols)
    mat = torch.as_tensor(PADDED.astype(np.int32))
    before = ring_block_cuda.launches
    got = ring_block_cuda.ring_block_cuda(q, s, jobs, mat, 1, 2, local, leftH, leftE, topH,
                                          topF)
    want = ring_block.ring_block_batch_plain(q, s, jobs, mat, 1, 2, local, leftH, leftE,
                                             topH, topF)
    for name, g, w in zip(ring_block.Tiles._fields, got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert torch.equal(g, w), name
    assert ring_block_cuda.launches == before
