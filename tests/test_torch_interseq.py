"""The port's inter-sequence kernel layer against the JAX package.

The plain PyTorch ``interseq_scores`` must equal JAX's scan kernel on
scores, hi and lo (exact equality: every value is an integer), and the
Pallas kernel (interpret mode) on scores. K1's CUDA source is held against
the plain version here through its strip routine, built by the host C++
compiler; ``tests/test_torch_cuda.py`` holds the kernel itself on the card.
"""
import ctypes
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
from libssa_tpu.ops.scoring import make_padded_profile, make_profile
from libssa_tpu_torch.ops import interseq, interseq_cuda
from libssa_tpu_torch.util import cudabuild

torch.set_num_threads(1)

B62 = matrices.builtin("BLOSUM62")
PADDED = B62.padded()


def _batch(rng, B, n_pad, zero_lanes=2):
    """(n_pad, B) int8 codes, PAD beyond each length, some length-0 lanes."""
    lengths = rng.integers(1, n_pad + 1, B).astype(np.int32)
    lengths[:zero_lanes] = 0
    codes = rng.integers(0, 20, (n_pad, B)).astype(np.int8)
    codes[np.arange(n_pad)[:, None] >= lengths[None, :]] = PAD_CODE
    return codes, lengths


def _jax(profile, codes, lengths, Q, R, local, track, dtype, m_real):
    jdt = jnp.int64 if dtype == "int64" else jnp.int32
    with jax_interseq.x64_scope(dtype == "int64"):
        out = jax_interseq.interseq_scores(
            jnp.asarray(profile, jnp.int32), jnp.asarray(codes),
            jnp.asarray(lengths), jnp.int32(Q), jnp.int32(R), local=local,
            use_matmul=False, track_range=track, dtype=jdt, m_real=m_real,
        )
        return [np.asarray(x) for x in out]


def _torch(profile, codes, lengths, Q, R, local, track, dtype, m_real):
    out = interseq.interseq_scores(
        torch.as_tensor(profile), torch.as_tensor(codes),
        torch.as_tensor(lengths), Q, R, local=local, track_range=track,
        dtype=dtype, m_real=m_real,
    )
    return [x.numpy() for x in out]


def _assert_same(got, want):
    for name, g, w in zip(("scores", "hi", "lo"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("track", [True, False], ids=["tracked", "untracked"])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_plain_matches_jax_scan(local, track, dtype):
    """Padded profile (m_real < rows), ragged and length-0 lanes, gap grid."""
    rng = np.random.default_rng(7)
    codes, lengths = _batch(rng, 37, 48)
    for m, (go, ge) in ((45, (10, 1)), (40, (3, 2)), (33, (0, 1))):
        q = rng.integers(0, 20, m).astype(np.uint8)
        prof = make_padded_profile(q, PADDED, rows=64)
        Q, R = go + ge, ge
        want = _jax(prof, codes, lengths, Q, R, local, track, dtype, m)
        got = _torch(prof, codes, lengths, Q, R, local, track, dtype, m)
        _assert_same(got, want)
        assert got[0].dtype == (np.int64 if dtype == "int64" else np.int32)


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_plain_matches_jax_large_matrix(local):
    """|score| > 127 (constant scoring 500/-300), tracked ranges included."""
    mat = matrices.constant_scoring(500, -300, SymType.AMINOACID)
    rng = np.random.default_rng(11)
    codes, lengths = _batch(rng, 16, 30, zero_lanes=1)
    q = codes[:, 5][: lengths[5]].astype(np.uint8)  # a guaranteed self-hit
    prof = make_profile(q, mat.padded())
    want = _jax(prof, codes, lengths, 11, 1, local, True, "int32", None)
    got = _torch(prof, codes, lengths, 11, 1, local, True, "int32", None)
    _assert_same(got, want)
    if local:
        assert got[0][5] == 500 * len(q)


def test_plain_matches_oracle():
    rng = np.random.default_rng(3)
    q = rng.integers(0, 20, 21).astype(np.uint8)
    prof = make_profile(q, PADDED)
    codes, lengths = _batch(rng, 9, 25, zero_lanes=1)
    for local, fn in ((True, oracle.sw_score), (False, oracle.nw_score)):
        got = _torch(prof, codes, lengths, 11, 1, local, False, "int32", None)
        want = [fn(q, codes[: lengths[b], b], B62.scores, 10, 1) for b in range(9)]
        np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_plain_matches_pallas_interpret(local):
    from libssa_tpu.ops.interseq_pallas import interseq_scores_pallas

    rng = np.random.default_rng(5)
    q = rng.integers(0, 20, 13).astype(np.uint8)
    prof = make_profile(q, PADDED)
    codes, lengths = _batch(rng, 9, 24, zero_lanes=1)
    s, _, _ = interseq_scores_pallas(
        jnp.asarray(prof, jnp.int32), jnp.asarray(codes, jnp.int32),
        jnp.asarray(lengths), 11, 1, local=local, b_tile=128, interpret=True,
    )
    got = _torch(prof, codes, lengths, 11, 1, local, False, "float32", None)
    np.testing.assert_array_equal(got[0], np.asarray(s))


def test_overflow_flags_match_jax():
    rng = np.random.default_rng(2)
    s, hi, lo = (rng.integers(-400, 400, 64).astype(np.int32) for _ in range(3))
    for limit in (None, 255, 32767):
        for local in (True, False):
            want = np.asarray(jax_interseq.overflow_flags(
                jnp.asarray(s), jnp.asarray(hi), jnp.asarray(lo), limit, local
            ))
            got = interseq.overflow_flags(
                torch.as_tensor(s), torch.as_tensor(hi), torch.as_tensor(lo),
                limit, local,
            ).numpy()
            np.testing.assert_array_equal(got, want)


def _pair_batch(rng, m=40, nq=3, g=2, n_pad=36, B=21):
    profs = np.stack([
        make_padded_profile(rng.integers(0, 20, m).astype(np.uint8), PADDED)
        for _ in range(nq)
    ]).astype(np.int32)
    m_reals = rng.integers(1, m + 1, nq).astype(np.int32)
    batches = [_batch(rng, B, n_pad) for _ in range(g)]
    codes = np.stack([c for c, _ in batches])
    lengths = np.stack([n for _, n in batches])
    iq = rng.integers(0, nq, 7).astype(np.int32)
    ic = rng.integers(0, g, 7).astype(np.int32)
    return profs, codes, lengths, iq, ic, m_reals


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_pairs_equal_per_pair_scores(local):
    """One pair-batched call equals one single-query call per pair."""
    rng = np.random.default_rng(9)
    profs, codes, lengths, iq, ic, m_reals = _pair_batch(rng)
    t = [torch.as_tensor(a) for a in (profs, codes, lengths, iq, ic, m_reals)]
    got = interseq.interseq_pairs(*t, 11, 1, local=local, track_range=True)
    for p in range(len(iq)):
        one = interseq.interseq_scores(
            t[0][iq[p]], t[1][ic[p]], t[2][ic[p]], 11, 1, local=local,
            track_range=True, m_real=int(m_reals[iq[p]]),
        )
        for g, w in zip(got, one):
            torch.testing.assert_close(g[p], w, rtol=0, atol=0)


def test_wrapper_on_cpu_runs_plain_without_launch():
    rng = np.random.default_rng(4)
    t = [torch.as_tensor(a) for a in _pair_batch(rng)]
    before = interseq_cuda.launches
    got = interseq_cuda.interseq_pairs_cuda(*t, 11, 1, track_range=True)
    want = interseq.interseq_pairs(*t, 11, 1, track_range=True)
    assert interseq_cuda.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    s = interseq_cuda.interseq_scores_cuda(
        t[0][0], t[1][0], t[2][0], 11, 1, local=False, m_real=int(t[5][0])
    )
    w = interseq.interseq_scores(
        t[0][0], t[1][0], t[2][0], 11, 1, local=False, m_real=int(t[5][0])
    )
    for g, ww in zip(s, w):
        assert torch.equal(g, ww)


def test_int32_request_widens_past_int32_bound():
    assert interseq.compute_dtype("float32", 64, 256, 512, 12, 1) == torch.int32
    assert interseq.compute_dtype("int64", 64, 256, 512, 12, 1) == torch.int64
    assert interseq.compute_dtype("int32", 2**25, 256, 512, 12, 1) == torch.int64
    with pytest.raises(ValueError):
        interseq.compute_dtype("bfloat16", 64, 8, 8, 12, 1)
    big = np.full((8, 32), 2**28, dtype=np.int32)  # SW score 2**31
    codes = np.zeros((300, 2), dtype=np.int8)
    s, _, _ = interseq.interseq_scores(
        torch.as_tensor(big), torch.as_tensor(codes),
        torch.tensor([300, 300], dtype=torch.int32), 11, 1,
    )
    assert s.dtype == torch.int64 and int(s[0]) == 2**31


def test_cudabuild_keys_on_content_and_flags(monkeypatch):
    a = cudabuild.library_path("interseq.cu", "tools-a/nvcc")
    assert a == cudabuild.library_path("interseq.cu", "tools-a/nvcc")
    assert a != cudabuild.library_path("interseq.cu", "tools-b/nvcc")
    monkeypatch.setattr(cudabuild, "NVCC_FLAGS", cudabuild.NVCC_FLAGS + ("-G",))
    assert a != cudabuild.library_path("interseq.cu", "tools-a/nvcc")
    assert a.parent == cudabuild.BUILD_DIR and a.name.startswith("interseq-")


def test_cudabuild_without_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: a missing compiler is an error."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cudabuild.nvcc_path()


@pytest.fixture(scope="module")
def host_k1(tmp_path_factory):
    """K1's source built for the host by the C++ compiler: Part A lane by
    lane, Part B warp by warp in the kernel's lockstep."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("k1") / "k1_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
         str(out), str(cudabuild.CSRC / interseq_cuda.SOURCE)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.k1_interseq_host.argtypes = [
        p, i, p, p, i, i, p, p, p, i, ll, ll, i, i, i, i, p, p, p, p,
    ]
    lib.k1_interseq_host.restype = i
    lib.k1_strip_rows.argtypes = [i]
    lib.k1_strip_rows.restype = i
    return lib


def _run_host(lib, profs, codes, lengths, iq, ic, m_reals, Q, R, local,
              track, wide, warps):
    """One host K1 call: (scores, hi, lo) as numpy arrays."""
    rows = profs.shape[1]
    P, (g, n_pad, B) = len(iq), codes.shape
    dt = np.int64 if wide else np.int32
    out = [np.zeros((P, B), dt) for _ in range(3)]
    scratch = np.zeros(P * 2 * n_pad * B, dt)
    rc = lib.k1_interseq_host(
        profs.ctypes.data, rows, codes.ctypes.data, lengths.ctypes.data,
        n_pad, B, iq.ctypes.data, ic.ctypes.data, m_reals.ctypes.data, P, Q,
        R, int(local), int(track), int(wide), warps, out[0].ctypes.data,
        out[1].ctypes.data, out[2].ctypes.data, scratch.ctypes.data,
    )
    assert rc == 0
    return out


def test_k1_strip_routine_matches_plain(host_k1):
    """K1's source, host-built: every mode, both types, strip edges crossed,
    Part A and a four-warp Part B."""
    lib = host_k1
    assert lib.k1_strip_rows(0) == 32 and lib.k1_strip_rows(1) == 16
    rng = np.random.default_rng(21)
    for m in (1, 17, 33, 70):
        batch = _pair_batch(rng, m=m)
        t = [torch.as_tensor(a) for a in batch]
        for local in (True, False):
            for track in (True, False):
                for wide in (0, 1):
                    want = interseq.interseq_pairs(
                        *t, 12, 2, local=local, track_range=track,
                        dtype="int64" if wide else "int32",
                    )
                    for warps in (1, 4):
                        out = _run_host(lib, *batch, 12, 2, local, track, wide, warps)
                        for o, w in zip(out, want):
                            np.testing.assert_array_equal(o, w.numpy())


def _pipeline_batch(rng, m, B):
    """Three padded queries (m_real <= m), two chunks of B lanes with
    length-0 and full-length lanes, 32-lane blocks of mixed lengths, and an
    all-empty block where B > 64."""
    profs, codes, lengths, iq, ic, m_reals = _pair_batch(rng, m=m, n_pad=36, B=B)
    lengths[:, 3] = 36
    if B > 64:
        lengths[1, 32:64] = 0
        codes[1, :, 32:64] = PAD_CODE
    m_reals[0] = m
    return profs, codes, lengths, iq, ic, m_reals


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
@pytest.mark.parametrize("m", [1, 31, 32, 33, 70, 300])
@pytest.mark.parametrize("warps", [1, 2, 4, 8])
def test_k1_host_pipeline_matches_plain(host_k1, warps, m, local):
    """Host K1 at each warps count against the plain version: SW/NW x
    track_range x int32/int64, the last strip's guard, the pipeline's edges
    and the wrap past warps x S rows; 4-byte code slices (B = 64) and byte
    slices (B = 70)."""
    rng = np.random.default_rng(1000 + 10 * m + warps)
    B = 64 if m % 2 == 0 else 70
    batch = _pipeline_batch(rng, m, B)
    t = [torch.as_tensor(a) for a in batch]
    Q, R = (12, 2) if m % 3 else (11, 1)
    for track in (True, False):
        for wide in (0, 1):
            want = interseq.interseq_pairs(
                *t, Q, R, local=local, track_range=track,
                dtype="int64" if wide else "int32",
            )
            got = _run_host(host_k1, *batch, Q, R, local, track, wide, warps)
            for name, o, w in zip(("scores", "hi", "lo"), got, want):
                np.testing.assert_array_equal(o, w.numpy(), err_msg=f"{name} {track} {wide}")


@pytest.mark.parametrize("warps", [1, 4])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_k1_host_equals_jax_k1(host_k1, local, warps):
    """The JAX package's K1 function (its scan, as its own CPU tests run it)
    and the host-built redesign on the same inputs: exactly equal."""
    rng = np.random.default_rng(77 + warps)
    codes, lengths = _batch(rng, 70, 40)
    lengths[5] = 40
    for m_real, rows in ((70, 70), (45, 64)):
        q = rng.integers(0, 20, m_real).astype(np.uint8)
        prof = make_padded_profile(q, PADDED, rows=rows).astype(np.int32)
        want = _jax(prof, codes, lengths, 11, 1, local, True, "int32", m_real)
        got = _run_host(
            host_k1, prof[None], codes[None], lengths[None], np.zeros(1, np.int32),
            np.zeros(1, np.int32), np.array([m_real], np.int32), 11, 1, local, True, 0,
            warps,
        )
        _assert_same([g[0] for g in got], want)


def test_choose_warps():
    """Part A where 128-lane blocks fill the card; else one warp a strip,
    up to 8, or up to 16 where 8 leaves the card under half full; even over
    the passes down the query."""
    cw = interseq_cuda.choose_warps
    assert cw(65536, 1, 8, 132) == 1  # 512 blocks: about four an SM
    assert cw(8192, 8, 8, 132) == 1  # a filled multi-chunk group
    assert cw(57344, 1, 8, 132) == 8  # 448 blocks: 3.4 an SM
    assert cw(8192, 1, 1, 132) == 1  # one strip: nothing to pipeline
    assert cw(8192, 1, 8, 132) == 8  # bench.py's kernel shape
    assert cw(8192, 7, 8, 132) == 8
    assert cw(2048, 1, 16, 132) == 16  # pair_scores_batch, m = n = 512
    assert cw(8192, 1, 16, 132) == 8  # int64 at m = 256: two passes of 8
    assert cw(8192, 1, 3, 132) == 3  # capped by the strips
    assert cw(8192, 1, 10, 132) == 5  # two even passes
    assert cw(300, 1, 40, 132) == 14  # capped at 16: 40 strips in 3 passes of 14
    for B, P, strips in ((37, 6, 10), (8192, 4, 8), (128, 1, 3), (4096, 3, 20)):
        w = cw(B, P, strips, 132)
        assert 2 <= w <= min(strips, interseq_cuda.MAX_WARPS)
