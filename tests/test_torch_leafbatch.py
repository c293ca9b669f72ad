"""The leaf kernel (``csrc/leafbatch.cu``) and the batched leaves of the
port's Myers-Miller, on the CPU.

The kernel's source, built by the host C++ compiler, runs each leaf's
stripes as a warp runs them (the 32 lanes in lock-step, values passed
between lanes as the shuffles pass them): its ops must equal the native
leaf solver's (``csrc/leafalign.cpp``) and ``hirschberg._ops_small``'s.
``align_pair_linear`` with its leaves batched through ``DevicePair`` (the
wrapper's plain version, forced onto the CPU) must equal the JAX package's
alignments. Tolerance: exact equality.
"""
import ctypes
import itertools
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from libssa_tpu.search import hirschberg as jhb
from libssa_tpu_torch import matrices, oracle
from libssa_tpu_torch.ops import leaf_cuda
from libssa_tpu_torch.ops.mm_device import DevicePair
from libssa_tpu_torch.search import hirschberg as hb
from libssa_tpu_torch.search.leafnative import leaf_ops_native, native_available
from libssa_tpu_torch.search.manager import SearchStats
from libssa_tpu_torch.util import cudabuild

torch.set_num_threads(1)

B62 = matrices.builtin("BLOSUM62")
Q, R = oracle.gap_qr(10, 1)
G = Q - R


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The leaf kernel's source built by the host C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("leafbatch") / "leafbatch_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC", "-o", str(out),
         str(cudabuild.CSRC / leaf_cuda.SOURCE)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lb_leaf_batch_host.argtypes = [p, p, p, ll, p, ll, ll, p, p, p, i]
    lib.lb_leaf_batch_host.restype = i
    leaf_cuda.bind_layout(lib)  # raises if the layouts differ
    return lib


def run_host(lib, q, s, leaves, cost, g, h, wide):
    """One host 'launch' of the kernel's source over ``leaves``; each
    leaf's ops as a string."""
    leaves = np.asarray(leaves, np.int64).reshape(-1, 6)
    lay = leaf_cuda.layout(leaves)
    table = np.zeros((len(leaves), leaf_cuda.LEAF_WORDS), np.int64)
    table[:, :6] = leaves
    table[:, 6], table[:, 7], table[:, 8] = lay["dir"], lay["carry"], lay["ops"]
    q8, s8 = np.ascontiguousarray(q, np.uint8), np.ascontiguousarray(s, np.uint8)
    cost32 = np.ascontiguousarray(cost, np.int32)
    dirs = np.full(lay["dir_total"], 0xAA, np.uint8)  # garbage where nothing is written
    carry = np.full(lay["carry_total"], -7, np.int64 if wide else np.int32)
    out = np.full(lay["out_total"], 0xAA, np.uint8)
    rc = lib.lb_leaf_batch_host(q8.ctypes.data, s8.ctypes.data, table.ctypes.data,
                                len(leaves), cost32.ctypes.data, g, h, dirs.ctypes.data,
                                carry.ctypes.data, out.ctypes.data, int(wide))
    assert rc == 0
    return leaf_cuda.unpack(out, leaves)


def padded_cost(sub):
    out = np.full((32, 32), 64, np.int32)
    out[:sub.shape[0], :sub.shape[1]] = -sub
    return out


def draw_batch(rng, alphabet, count, m_hi=64, n_hi=64, tbte=None):
    """Code buffers and ``count`` leaves of m = 2 .. m_hi, n = 1 .. n_hi at
    offsets into them, with their (tb, te)."""
    q = rng.integers(0, alphabet, 4000).astype(np.uint8)
    s = rng.integers(0, alphabet, 4000).astype(np.uint8)
    leaves = []
    for _ in range(count):
        m, n = int(rng.integers(2, m_hi + 1)), int(rng.integers(1, n_hi + 1))
        tb, te = tbte if tbte is not None else (G * int(rng.integers(2)), G * int(rng.integers(2)))
        leaves.append((int(rng.integers(0, 4001 - m)), m, int(rng.integers(0, 4001 - n)), n,
                       tb, te))
    return q, s, leaves


ALPHABETS = {"ties": (2, np.array([[4, -3], [-3, 4]])), "blosum62": (20, B62.scores)}


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("alphabet", sorted(ALPHABETS))
@pytest.mark.parametrize("tb,te", list(itertools.product((0, G), (0, G))))
def test_host_build_equals_native_and_ops_small(host_lib, tb, te, alphabet, wide):
    """Drawn leaves of m = 2 .. 64 and n = 1 .. 64 in one launch, each
    (tb, te); the 2-letter alphabet is full of equal-cost paths."""
    if not native_available():
        pytest.skip("no host C++ compiler to build csrc/leafalign.cpp")
    A, sub = ALPHABETS[alphabet]
    rng = np.random.default_rng([A, tb, te, wide])
    q, s, leaves = draw_batch(rng, A, 40, tbte=(tb, te))
    cost = padded_cost(sub)
    got = run_host(host_lib, q, s, leaves, cost, G, R, wide)
    for (qo, m, so, n, _, _), ops in zip(leaves, got):
        qq, ss = q[qo:qo + m].astype(np.intp), s[so:so + n].astype(np.intp)
        want = "".join(hb._ops_small(qq, ss, cost.astype(np.int64), G, R, tb, te))
        assert ops == want, (m, n, tb, te)
        assert "".join(leaf_ops_native(qq, ss, cost, G, R, tb, te)) == want


@pytest.mark.parametrize("shape", [(2, 1), (2, 3000), (3000, 2), (33, 65), (64, 1), (700, 700)],
                         ids=lambda x: f"{x}")
def test_host_build_one_leaf_at_stripe_and_chunk_edges(host_lib, shape):
    """A batch of one leaf: m = 2, thin and tall leaves past many carry
    chunks, rows past one stripe."""
    m, n = shape
    rng = np.random.default_rng(m * 7919 + n)
    q = rng.integers(0, 4, m).astype(np.uint8)
    s = q[rng.integers(0, m, n)] if m > 2 else rng.integers(0, 4, n).astype(np.uint8)
    cost = padded_cost(np.where(np.eye(4, dtype=bool), 10, -8))
    for tb, te in ((G, G), (0, G), (G, 0)):
        got = run_host(host_lib, q, s, [(0, m, 0, n, tb, te)], cost, G, R, False)
        want = "".join(hb._ops_small(q.astype(np.intp), s.astype(np.intp),
                                     cost.astype(np.int64), G, R, tb, te))
        assert got == [want]


def test_wrapper_plain_version_on_cpu_tensors():
    """On CPU tensors the wrapper runs the plain version, in the kernel's
    layout; it refuses leaves it cannot take."""
    rng = np.random.default_rng(3)
    q, s, leaves = draw_batch(rng, 20, 12)
    cost = torch.from_numpy(padded_cost(B62.scores))
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    before = leaf_cuda.launches
    out = leaf_cuda.leaf_batch_cuda(qt, st, leaves, cost, G, R)
    assert leaf_cuda.launches == before  # the plain version is no launch
    assert out.dtype == torch.uint8
    assert out.shape == (leaf_cuda.layout(np.array(leaves))["out_total"],)
    got = leaf_cuda.unpack(out.numpy(), np.array(leaves))
    for (qo, m, so, n, tb, te), ops in zip(leaves, got):
        assert ops == "".join(hb._ops_leaf(q[qo:qo + m].astype(np.intp),
                                           s[so:so + n].astype(np.intp),
                                           cost.numpy().astype(np.int64), G, R, tb, te))
    for bad, match in (([], "no leaves"), ([(0, 0, 0, 5, G, G)], "row"),
                       ([(3990, 20, 0, 5, G, G)], "outside"), ([(0, 5, 0, 5, 3, G)], "0 or g")):
        with pytest.raises(ValueError, match=match):
            leaf_cuda.leaf_batch_cuda(qt, st, bad, cost, G, R)


def test_int64_bound():
    """int32 holds every value unless (m + n)(max |cost| + 2h) + 4(g + h)
    reaches 2**27."""
    small = np.array([[0, 500, 0, 524, G, G]])
    assert not leaf_cuda.needs_int64(small, 64, G, R)
    assert leaf_cuda.needs_int64(small, 200_000, G, R)
    assert leaf_cuda.needs_int64(small, 0, G, 70_000)


def _key(tb):
    return tb.score, tb.q_begin, tb.q_end, tb.s_begin, tb.s_end, tb.cigar


@pytest.mark.parametrize("cells", [64, 256, 4096])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_batched_leaves_match_jax(monkeypatch, local, cells):
    """align_pair_linear with its levels on K2's plain version and each
    pass's leaves batched through DevicePair.solve_leaves (the wrapper's
    plain version) equals the JAX package's score, coordinates and ops."""
    monkeypatch.setattr(hb, "DEVICE_ON_CPU", True)
    monkeypatch.setattr(hb, "DEVICE_MIN_CELLS", 1024)
    monkeypatch.setattr(hb, "LEAF_CELLS", cells)
    monkeypatch.setattr(jhb, "LEAF_CELLS", cells)
    calls = []
    solve = DevicePair.solve_leaves

    def counted(self, leaves):
        calls.append(len(leaves))
        return solve(self, leaves)

    monkeypatch.setattr(DevicePair, "solve_leaves", counted)
    rng = np.random.default_rng(17 + cells + local)
    for m, n in ((230, 310), (97, 40), (41, 260)):
        q = rng.integers(0, 20, m).astype(np.uint8)
        s = rng.integers(0, 20, n).astype(np.uint8)
        s[10:40] = q[20:50] if m > 50 else s[10:40]  # a planted local hit
        got = hb.align_pair_linear(q, s, B62.scores, 10, 1, local, device="cpu")
        want = jhb.align_pair_linear(q, s, B62.scores, 10, 1, local)
        assert _key(got) == _key(want), (m, n)
    assert calls and all(c >= 1 for c in calls)


@pytest.mark.parametrize("on_device", [False, True])
def test_leaves_span_counts_each_pass(monkeypatch, on_device):
    """Each pass's leaves are one mm.leaves span under mm.align, with their
    count and cells; on the device path one solve_leaves call (and its
    fetch, a device.wait) a span."""
    monkeypatch.setattr(hb, "LEAF_CELLS", 4096)
    if on_device:
        monkeypatch.setattr(hb, "DEVICE_ON_CPU", True)
        monkeypatch.setattr(hb, "DEVICE_MIN_CELLS", 1024)
    rng = np.random.default_rng(9)
    q, s = rng.integers(0, 20, 300).astype(np.uint8), rng.integers(0, 20, 280).astype(np.uint8)
    stats = SearchStats()
    with profile(activities=[ProfilerActivity.CPU]):
        tb = hb.align_pair_linear(q, s, B62.scores, 10, 1, local=False, stats=stats,
                                  device="cpu")
    spans = stats.spans
    leaves = [x for x in spans if x.name == "mm.leaves"]
    assert leaves and all(x.parent == 0 for x in leaves)
    assert all(0 < x.counts["cells"] <= x.counts["leaves"] * 4096 for x in leaves)
    waits = [spans[x.parent].name for x in spans if x.name == "device.wait"]
    assert waits.count("mm.leaves") == (len(leaves) if on_device else 0)
    assert tb == hb.align_pair_linear(q, s, B62.scores, 10, 1, local=False, device="cpu")
