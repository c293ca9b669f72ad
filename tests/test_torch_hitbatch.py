"""The hit kernel (``csrc/hitbatch.cu``) and the batched tracebacks of a
call's hits (``aligner.align_batch``), on the CPU.

The kernel's source, built by the host C++ compiler, runs each hit's
stripes as a warp runs them (the 32 lanes in lock-step, values passed
between lanes as the shuffles pass them): its score, coordinates and ops
must equal the JAX package's (``libssa_tpu.search.aligner.align_pair``
and the scalar ``libssa_tpu.oracle``), and the port's copies of them.
``align_batch``, on the CPU (the plain version: ``align_pair`` hit by hit)
and on the card's path with the host build in the launch's place, must
equal ``align_pair`` hit for hit. Tolerance: exact equality.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from libssa_tpu_torch import matrices, oracle
from libssa_tpu_torch.ops import hit_cuda
from libssa_tpu_torch.search import aligner
from libssa_tpu_torch.search.manager import SearchStats
from libssa_tpu_torch.util import cudabuild

torch.set_num_threads(1)

B62 = matrices.builtin("BLOSUM62")
# Four letters, +2 on a match and -1 elsewhere: many equal-score paths.
TIES = np.where(np.eye(4, dtype=bool), 2, -1)
NEGATIVE = -np.ones((4, 4), np.int64) - np.eye(4, dtype=np.int64)  # every SW hit scores 0
MATRICES = {"blosum62": B62.scores, "ties": TIES, "negative": NEGATIVE}
GAPS = {"11/1": (11, 1), "Q=R": (0, 2)}  # (gap_open, gap_extend): Q = 12, R = 1; Q = R = 2


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The hit kernel's source built by the host C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("hitbatch") / "hitbatch_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC", "-o", str(out),
         str(cudabuild.CSRC / hit_cuda.SOURCE)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hb_hit_batch_host.argtypes = [p, p, ll, p, ll, ll, p, p, p, i, i]
    lib.hb_hit_batch_host.restype = i
    hit_cuda.bind_layout(lib)  # raises if the layouts differ
    return lib


def run_host(lib, codes, hits, sub, Q, R, local, wide) -> np.ndarray:
    """One host 'launch' of the kernel's source over ``hits``: its output
    bytes in the wrapper's layout."""
    hits = np.asarray(hits, np.int64).reshape(-1, 4)
    lay = hit_cuda.layout(hits)
    table = np.zeros((len(hits), hit_cuda.HIT_WORDS), np.int64)
    table[:, :4] = hits
    table[:, 4], table[:, 5], table[:, 6] = lay["dir"], lay["carry"], lay["ops"]
    codes8 = np.ascontiguousarray(codes, np.uint8)
    padded = np.zeros((32, 32), np.int32)
    padded[:sub.shape[0], :sub.shape[1]] = sub
    dirs = np.full(lay["dir_total"], 0xAA, np.uint8)  # garbage where nothing is written
    carry = np.full(lay["carry_total"], -7, np.int64 if wide else np.int32)
    out = np.full(lay["out_total"], 0xAA, np.uint8)
    rc = lib.hb_hit_batch_host(codes8.ctypes.data, table.ctypes.data, len(hits),
                               padded.ctypes.data, Q, R, dirs.ctypes.data, carry.ctypes.data,
                               out.ctypes.data, int(wide), int(local))
    assert rc == 0
    return out


def homolog(rng, q, alphabet, sub_rate=0.3, indel_rate=0.05):
    """A mutated copy of ``q``: substitutions, and insertions and deletions
    of 1-6 residues, so the optimal paths open and extend gaps."""
    out, i = [], 0
    while i < len(q):
        r = rng.random()
        if r < indel_rate / 2:
            out.extend(rng.integers(0, alphabet, int(rng.integers(1, 7))).tolist())
        elif r < indel_rate:
            i += int(rng.integers(1, 7))
            continue
        out.append(int(rng.integers(0, alphabet)) if rng.random() < sub_rate else int(q[i]))
        i += 1
    return np.array(out or [0], np.uint8)


def draw_batch(rng, alphabet, shapes):
    """One code buffer and a hit for each (m, n) of ``shapes``: a query and
    a subject each, homologs where the subject is long enough."""
    parts, hits, at = [], [], 0
    for m, n in shapes:
        q = rng.integers(0, alphabet, m).astype(np.uint8)
        s = homolog(rng, q, alphabet)
        s = np.resize(s, n) if len(s) >= n else np.concatenate(
            [s, rng.integers(0, alphabet, n - len(s)).astype(np.uint8)])
        hits.append((at, m, at + m, n))
        parts += [q, s]
        at += m + n
    return np.concatenate(parts), np.array(hits, np.int64)


def fields(tbs) -> list[tuple]:
    """Tracebacks of either package as (score, coordinates, cigar) tuples."""
    return [(tb.score, tb.q_begin, tb.q_end, tb.s_begin, tb.s_end, tb.cigar) for tb in tbs]


def want(codes, hits, sub, gaps, local) -> list[tuple]:
    """The JAX package's aligner hit by hit, which the port's copy must
    equal. Imported here and not at the top: tests/test_torch_cuda.py
    imports this module's draws on a card where the JAX package is absent."""
    from libssa_tpu.search import aligner as jax_aligner

    pairs = [(codes[qo:qo + m], codes[so:so + n]) for qo, m, so, n in hits.tolist()]
    ref = fields(jax_aligner.align_pair(q, s, sub, *gaps, local) for q, s in pairs)
    assert fields(aligner.align_pair(q, s, sub, *gaps, local) for q, s in pairs) == ref
    return ref


def qr(gaps):
    return oracle.gap_qr(*gaps)


SHAPES = [(1, 1), (1, 65), (65, 1), (31, 33), (32, 32), (33, 31), (64, 65), (65, 64),
          (33, 64), (2, 31)]


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("gaps", sorted(GAPS))
@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_host_build_equals_align_pair(host_lib, local, name, gaps, wide):
    """Hits of every length at a stripe's and a chunk's edges (1, 31, 32,
    33, 64, 65) in one launch, against the JAX package's align_pair hit for
    hit."""
    sub, g = MATRICES[name], GAPS[gaps]
    rng = np.random.default_rng([len(name), len(gaps), wide, local])
    codes, hits = draw_batch(rng, sub.shape[0], SHAPES)
    got = hit_cuda.unpack(run_host(host_lib, codes, hits, sub, *qr(g), local, wide), hits)
    assert fields(got) == want(codes, hits, sub, g, local)
    if name == "negative" and local:
        assert all(tb == oracle.Traceback(0, 0, 0, 0, 0, "") for tb in got)


@pytest.mark.parametrize("shape", [(400, 389), (361, 361), (97, 410)], ids=lambda x: f"{x}")
@pytest.mark.parametrize("name", ["blosum62", "ties"])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_host_build_long_hits_equal_align_pair(host_lib, local, name, shape):
    """Homolog hits of about 400 residues: many stripes, many carry chunks,
    gaps opened and extended; int32 and int64 in turn."""
    sub = MATRICES[name]
    rng = np.random.default_rng([shape[0], shape[1], local, len(name)])
    codes, hits = draw_batch(rng, sub.shape[0], [shape, (shape[1] // 3, shape[0])])
    expect = want(codes, hits, sub, GAPS["11/1"], local)
    for wide in (False, True):
        out = run_host(host_lib, codes, hits, sub, *qr(GAPS["11/1"]), local, wide)
        assert fields(hit_cuda.unpack(out, hits)) == expect
    assert any("D" in cigar or "I" in cigar for *_, cigar in expect)


@pytest.mark.parametrize("gaps", sorted(GAPS))
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_host_build_equals_scalar_oracle(host_lib, local, gaps):
    """Against the JAX package's scalar oracle (per-cell loops) too, and
    the port's copy of it, on hits of different shapes in one launch."""
    from libssa_tpu import oracle as jax_oracle  # imported here: see ``want``

    g = GAPS[gaps]
    rng = np.random.default_rng([local, len(gaps), 5])
    codes, hits = draw_batch(rng, 20, [(70, 64), (33, 90), (1, 5), (40, 40)])
    got = hit_cuda.unpack(run_host(host_lib, codes, hits, B62.scores, *qr(g), local, False),
                          hits)
    name = "sw_align" if local else "nw_align"
    for tb, (qo, m, so, n) in zip(got, hits.tolist()):
        q, s = codes[qo:qo + m], codes[so:so + n]
        ref = getattr(jax_oracle, name)(q, s, B62.scores, *g)
        assert fields([tb]) == fields([ref])
        assert tb == getattr(oracle, name)(q, s, B62.scores, *g)


def test_plain_version_on_the_cpu():
    """On the CPU align_batch runs the plain version, align_pair hit by hit,
    equal to the JAX package's; the wrapper refuses a CPU device, and hits
    it cannot take, without a launch."""
    rng = np.random.default_rng(3)
    codes, hits = draw_batch(rng, 20, [(30, 40), (5, 90), (64, 65)])
    pairs = [(codes[qo:qo + m], codes[so:so + n]) for qo, m, so, n in hits.tolist()]
    before = hit_cuda.launches
    for local in (True, False):
        got = aligner.align_batch(pairs, B62.scores, 11, 1, local, device="cpu")
        assert fields(got) == want(codes, hits, B62.scores, (11, 1), local)
    with pytest.raises(ValueError, match="runs on CUDA"):
        hit_cuda.hit_batch(codes, hits, B62.scores, 12, 1, True, "cpu")
    for bad, match in (([], "no hits"), ([(0, 0, 0, 5)], "row"),
                       ([(len(codes) - 3, 20, 0, 5)], "outside")):
        with pytest.raises(ValueError, match=match):
            hit_cuda.hit_batch(codes, bad, B62.scores, 12, 1, True, "cpu")
    with pytest.raises(ValueError, match="alphabet"):
        hit_cuda.hit_batch(codes, hits, TIES, 12, 1, True, "cpu")
    assert hit_cuda.launches == before


def test_int64_bound():
    """int32 holds every value unless (m + n)(max |score| + 2R) + 4Q
    reaches 2**27."""
    small = np.array([[0, 767, 0, 767]])
    assert hit_cuda.value_bound(small, 11, 12, 1) == 1534 * 13 + 48 < hit_cuda.INT32_BOUND
    assert hit_cuda.value_bound(small, 100_000, 12, 1) >= hit_cuda.INT32_BOUND
    assert hit_cuda.value_bound(small, 4, 40_000_000, 1) >= hit_cuda.INT32_BOUND


def test_groups_split_at_the_direction_byte_cap(monkeypatch):
    """A batch splits into launches of at most DIR_BYTES_CAP direction bytes,
    in order; a hit above the cap goes alone."""
    hits = np.array([[0, 10, 0, 10], [0, 10, 0, 17], [0, 3, 0, 8], [0, 40, 0, 8],
                     [0, 1, 0, 1]], np.int64)
    assert hit_cuda.dir_bytes(hits).tolist() == [160, 240, 24, 320, 8]
    assert hit_cuda.groups(hits) == [(0, 5)]
    monkeypatch.setattr(hit_cuda, "DIR_BYTES_CAP", 264)
    assert hit_cuda.groups(hits) == [(0, 1), (1, 3), (3, 4), (4, 5)]
    monkeypatch.setattr(hit_cuda, "DIR_BYTES_CAP", 1)
    assert hit_cuda.groups(hits) == [(k, k + 1) for k in range(5)]
    # the largest hit under MATRIX_CELL_LIMIT fits one launch alone
    thin = np.array([[0, aligner.MATRIX_CELL_LIMIT, 0, 1]], np.int64)
    assert hit_cuda.dir_bytes(thin)[0] < 1 << 28


def _pairs(rng, count, lo=20, hi=120):
    q = rng.integers(0, 20, int(rng.integers(lo, hi))).astype(np.uint8)
    return [(q, homolog(rng, q, 20)) for _ in range(count)]


def _host_launches(monkeypatch, host_lib) -> list[int]:
    """``hit_cuda.hit_batch`` replaced by the kernel's host build (a CUDA
    device asked for, the output on the CPU); returns the list each launch
    appends its hit count to."""
    calls = []

    def host_launch(codes, hits, sub, Q, R, local, dev, wide=None):
        assert dev.type == "cuda"
        calls.append(len(hits))
        return torch.from_numpy(run_host(host_lib, codes, hits, sub, Q, R, local, False))

    monkeypatch.setattr(hit_cuda, "hit_batch", host_launch)
    return calls


@pytest.mark.parametrize("cap", [None, 2000], ids=["one_launch", "split"])
def test_align_batch_equals_align_pair_in_traced_runs(host_lib, monkeypatch, cap):
    """align_batch's tracebacks equal align_pair's in order, on the CPU and
    on the card's path (the kernel's host build in the launch's place), with
    empty sequences and a pair past MATRIX_CELL_LIMIT sent to align_pair
    alone: on the CPU one traceback.batch span with ``device`` 0, on the
    card one a run of groups with ``device`` its hits and its fetch in a
    device.wait; one traceback.fill span a pair sent alone."""
    launches = _host_launches(monkeypatch, host_lib)
    if cap is not None:
        monkeypatch.setattr(hit_cuda, "DIR_BYTES_CAP", cap)
    monkeypatch.setattr(aligner, "MATRIX_CELL_LIMIT", 5000)
    rng = np.random.default_rng(11)
    pairs = _pairs(rng, 6)
    empty = np.zeros(0, np.uint8)
    pairs[2] = (pairs[2][0], empty)
    pairs.append((rng.integers(0, 20, 90).astype(np.uint8),
                  rng.integers(0, 20, 70).astype(np.uint8)))  # 6,300 cells: alone
    batched = [p for k, p in enumerate(pairs) if k not in (2, 6)]
    sizes = [hi - lo for lo, hi in hit_cuda.groups(
        np.array([(0, len(q), 0, len(s)) for q, s in batched]))]
    assert (len(sizes) == 1) == (cap is None)
    for local in (True, False):
        ref = [aligner.align_pair(q, s, B62.scores, 10, 1, local) for q, s in pairs]
        for device in ("cpu", "cuda"):
            on_card = device == "cuda"
            launches.clear()
            stats = SearchStats()
            with profile(activities=[ProfilerActivity.CPU]):
                got = aligner.align_batch(pairs, B62.scores, 10, 1, local, stats=stats,
                                          device=device)
            assert got == ref
            spans = stats.spans
            batches = [x for x in spans if x.name == "traceback.batch"]
            assert launches == (sizes if on_card else [])
            assert [x.counts["hits"] for x in batches] == (sizes if on_card else [len(batched)])
            assert [x.counts["device"] for x in batches] == (sizes if on_card else [0])
            assert sum(x.counts["cells"] for x in batches) == sum(len(q) * len(s)
                                                                  for q, s in batched)
            waits = [spans[x.parent] for x in spans if x.name == "device.wait"]
            assert waits == (batches if on_card else [])
            assert [x.name for x in spans].count("traceback.fill") == 2
            assert (stats.aligner_device_seconds > 0) == on_card


def test_align_batch_card_path_with_the_host_build(host_lib, monkeypatch):
    """The card's side of align_batch at a query's ten hits of 200-400
    residues (one device.wait fetch in the one traceback.batch span, the
    card's hits and seconds counted) with the kernel's host build in the
    launch's place, against align_pair."""
    calls = _host_launches(monkeypatch, host_lib)
    rng = np.random.default_rng(12)
    pairs = _pairs(rng, 10, 200, 400)
    pairs.append((pairs[0][0], np.zeros(0, np.uint8)))  # alone: align_pair's empty branch
    stats = SearchStats()
    with profile(activities=[ProfilerActivity.CPU]):
        got = aligner.align_batch(pairs, B62.scores, 11, 1, True, stats=stats,
                                  device=torch.device("cuda"))
    assert got == [aligner.align_pair(q, s, B62.scores, 11, 1, True) for q, s in pairs]
    assert calls == [10]
    spans = stats.spans
    (batch,) = [x for x in spans if x.name == "traceback.batch"]
    assert batch.counts["hits"] == batch.counts["device"] == 10
    waits = [x for x in spans if x.name == "device.wait"]
    assert len(waits) == 1 and spans[waits[0].parent] is batch
    assert stats.aligner_device_seconds > 0
