"""The level kernels (``csrc/mmlevel.cu``) around K2 and their wrapper, on the CPU.

The kernels' source, built by the host C++ compiler, runs every block's
threads in turn and the split's reduction tree in the kernel's order: the
prologue's boundaries must equal the plain version's (the PyTorch ops
that built K2's boundaries before the kernels), and the split's
``(j1, j2, v1, v2)`` the plain combine and first minima. Drawn levels of
1 to 300 nodes, every (tbf, tbr), nn = 1 and rows wider than a block,
minima at j = 0 and j = nn, rows built to tie, int32 and int64 (past the
int32 bound). With the host build in the launches' place, ``divide_level``
and ``align_pair_linear`` must equal the JAX package's. Tolerance: exact
equality.
"""
import ctypes
import itertools
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from libssa_tpu.ops.mm_device import DevicePair as JaxPair
from libssa_tpu.search import hirschberg as jhb
from libssa_tpu_torch import matrices, oracle
from libssa_tpu_torch.ops import mm_level_cuda, ring_block_cuda
from libssa_tpu_torch.ops.mm_device import DevicePair
from libssa_tpu_torch.search import hirschberg as hb
from libssa_tpu_torch.search.manager import SearchStats
from libssa_tpu_torch.util import cudabuild

torch.set_num_threads(1)

B62 = matrices.builtin("BLOSUM62")
Q, R = oracle.gap_qr(10, 1)
G = Q - R
COST = -B62.scores.astype(np.int64)
MOTIF = np.array([12, 4, 9, 1, 17, 3], np.intp)
NP_TYPE = {torch.int32: np.int32, torch.int64: np.int64}
DTYPES = [torch.int32, torch.int64]
DT_IDS = ["int32", "int64"]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The level kernels' source built by the host C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("mmlevel") / "mmlevel_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC", "-o", str(out),
         str(cudabuild.CSRC / mm_level_cuda.SOURCE)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mml_prologue_host.argtypes = [p, ll, i, i, ll, ll, i, p, p, p, p]
    lib.mml_prologue_host.restype = i
    lib.mml_split_host.argtypes = [p, ll, ll, ll, i, p, p, p]
    lib.mml_split_host.restype = i
    mm_level_cuda.bind_layout(lib)  # raises if the layouts differ
    return lib


def host_prologue(lib, table, dtype, Q, R, local, spread=None):
    """One host 'launch' of the prologue over ``table``'s tiles."""
    table = np.ascontiguousarray(table, np.int64)
    n_rows, n_cols = int(table[:, 3].sum()), int(table[:, 4].sum())
    out = [np.full(n, 0x5A5A5A5, NP_TYPE[dtype])  # garbage where nothing is written
           for n in (n_rows + len(table), n_rows, n_cols, n_cols)]
    spread = mm_level_cuda.spread(table) if spread is None else spread
    rc = lib.mml_prologue_host(table.ctypes.data, len(table), spread, int(local), Q, R,
                               int(dtype == torch.int64), *(a.ctypes.data for a in out))
    assert rc == 0
    return tuple(torch.from_numpy(a) for a in out)


def host_split(lib, table, botH, botF, g, R):
    """One host 'launch' of the split; (nodes, 4) int64."""
    table = np.ascontiguousarray(table, np.int64)
    h, f = np.ascontiguousarray(botH.numpy()), np.ascontiguousarray(botF.numpy())
    out = np.full((len(table) // 2, 4), -7, np.int64)
    rc = lib.mml_split_host(table.ctypes.data, len(table) // 2, g, R,
                            int(botH.dtype == torch.int64), h.ctypes.data, f.ctypes.data,
                            out.ctypes.data)
    assert rc == 0
    return torch.from_numpy(out)


def draw_nodes(rng, k, M, N, tbs=None, widths=(1, 400)):
    """``k`` nodes (qs, qe, ss, se, tbf_is_zero, tbr_is_zero) inside an
    M x N pair, qe - qs >= 2 and nn in ``widths``; (tbf, tbr) drawn or
    fixed by ``tbs``."""
    out = []
    for _ in range(k):
        rows = int(rng.integers(2, min(M, 600) + 1))
        nn = int(rng.integers(widths[0], min(N, widths[1]) + 1))
        qs, ss = int(rng.integers(0, M - rows + 1)), int(rng.integers(0, N - nn + 1))
        f, r = tbs if tbs is not None else (bool(rng.integers(2)), bool(rng.integers(2)))
        out.append((qs, qs + rows, ss, ss + nn, f, r))
    return out


def level_of(pair, nodes):
    jobs, tbs = pair.level_jobs(nodes)
    return mm_level_cuda.level_table(jobs, tbs)


def assert_same(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _pair(M, N, seed=0):
    rng = np.random.default_rng(seed)
    return DevicePair(rng.integers(0, 20, M), rng.integers(0, 20, N), B62.padded(), Q, R,
                      device="cpu")


# The prologue.

@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("k", [1, 2, 7, 64, 300])
def test_prologue_drawn_levels(host_lib, k, dtype):
    """Drawn levels of k nodes (each a forward and a reverse tile)."""
    rng = np.random.default_rng(1000 + k)
    pair = _pair(3000, 2500)
    table = level_of(pair, draw_nodes(rng, k, pair.m, pair.n))
    want = mm_level_cuda.prologue_plain(table, dtype, Q, R, False)
    assert_same(host_prologue(host_lib, table, dtype, Q, R, False), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("tbs", list(itertools.product((False, True), (False, True))),
                         ids=["g-g", "g-0", "0-g", "0-0"])
def test_prologue_every_open(host_lib, tbs, dtype):
    """Every (tbf, tbr): the left columns open at g or at 0."""
    rng = np.random.default_rng(sum(tbs) * 3 + tbs[0])
    pair = _pair(900, 800)
    table = level_of(pair, draw_nodes(rng, 9, pair.m, pair.n, tbs))
    assert set(table[:, 5]) == {0 if tbs[0] else G} | {0 if tbs[1] else G}
    want = mm_level_cuda.prologue_plain(table, dtype, Q, R, False)
    assert_same(host_prologue(host_lib, table, dtype, Q, R, False), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("spread", [1, 3, 64])
def test_prologue_slices_cover_every_element(host_lib, spread, dtype):
    """Whatever the blocks a tile, every element is written once: tiles of
    one row and one column, and tiles longer than a block's stride."""
    jobs = np.array([[0, 1, 0, 1], [5, 1, 3, 9000], [0, 7000, 1, 1], [9, 300, 9, 300]],
                    np.int64)
    table = mm_level_cuda.level_table(jobs, np.array([G, 0, G, 0]))
    want = mm_level_cuda.prologue_plain(table, dtype, Q, R, False)
    assert_same(host_prologue(host_lib, table, dtype, Q, R, False, spread), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_prologue_sw_zero_boundaries(host_lib, dtype):
    """SW tiles (``sw_end``): zero H, no gap state."""
    jobs = np.array([[0, 420, 0, 350], [11, 1, 2, 5]], np.int64)
    table = mm_level_cuda.level_table(jobs, None)
    got = host_prologue(host_lib, table, dtype, Q, R, True)
    assert_same(got, mm_level_cuda.prologue_plain(table, dtype, Q, R, True))
    assert not got[0].any() and not got[2].any() and (got[1] == R - Q).all()


def test_prologue_plain_is_what_bounds_gives():
    """``DevicePair.bounds`` is the prologue's plain version on the CPU."""
    rng = np.random.default_rng(4)
    pair = _pair(500, 400)
    jobs, tbs = pair.level_jobs(draw_nodes(rng, 5, pair.m, pair.n))
    table = mm_level_cuda.level_table(jobs, tbs)
    assert_same(pair.bounds(jobs, tbs),
                mm_level_cuda.prologue_plain(table, pair.dtype, Q, R, False))


# The split.

def _bottoms(rng, table, dtype, lo, hi):
    n = int(table[:, 4].sum())
    draw = lambda: torch.from_numpy(rng.integers(lo, hi, n).astype(NP_TYPE[dtype]))  # noqa: E731
    return draw(), draw()


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("k", [1, 3, 50, 300])
def test_split_drawn_levels(host_lib, k, dtype):
    """Drawn levels and drawn bottom rows, some wider than a block."""
    rng = np.random.default_rng(2000 + k)
    pair = _pair(4000, 5000)
    table = level_of(pair, draw_nodes(rng, k, pair.m, pair.n, widths=(1, 3000)))
    botH, botF = _bottoms(rng, table, dtype, -5000, 5000)
    want = mm_level_cuda.split_plain(table, botH, botF, G, R)
    assert torch.equal(host_split(host_lib, table, botH, botF, G, R), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("tbs", list(itertools.product((False, True), (False, True))),
                         ids=["g-g", "g-0", "0-g", "0-0"])
@pytest.mark.parametrize("nn", [1, 2, 1023, 1024, 1025, 4099])
def test_split_ties_take_the_first(host_lib, nn, tbs, dtype):
    """Bottom rows of three values: most columns tie; the first minimum
    wins, at nn = 1 and around the block's width."""
    rng = np.random.default_rng(nn * 4 + 2 * tbs[0] + tbs[1])
    pair = _pair(50, 5000)
    table = level_of(pair, [(3, 40, 7, 7 + nn, *tbs), (0, 2, 0, nn, *tbs)])
    botH, botF = _bottoms(rng, table, dtype, -2, 1)
    want = mm_level_cuda.split_plain(table, botH, botF, G, R)
    assert torch.equal(host_split(host_lib, table, botH, botF, G, R), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("at", ["j=0", "j=nn", "both"])
@pytest.mark.parametrize("nn", [1, 5, 3000])
def test_split_minimum_on_a_boundary(host_lib, nn, at, dtype):
    """Rows whose every inner value is large, so the minimum lies in
    column 0 (forward's boundary term), in column nn (the reverse's) or,
    tied, in both (the first wins)."""
    pair = _pair(60, 3100)
    tbf, tbr = {"j=0": (True, False), "j=nn": (False, True), "both": (True, True)}[at]
    table = level_of(pair, [(10, 50, 0, nn, tbf, tbr)])
    n = int(table[:, 4].sum())
    big = -(1 << 20) if dtype == torch.int32 else -(1 << 40)
    botH = torch.full((n,), big, dtype=dtype)
    botF = botH.clone()
    got = host_split(host_lib, table, botH, botF, G, R)
    assert torch.equal(got, mm_level_cuda.split_plain(table, botH, botF, G, R))
    j1 = got[0, 0].item()
    assert j1 == (nn if at == "j=nn" else 0)


def test_split_past_the_int32_bound(host_lib):
    """int64 rows whose sums pass 2**31 where each row does not, and rows
    past it: the combine stays exact in int64."""
    rng = np.random.default_rng(31)
    pair = _pair(800, 900)
    table = level_of(pair, draw_nodes(rng, 20, pair.m, pair.n))
    for lo, hi in ((-(2**31) + 1, -(2**30)), (-(2**45), 2**45)):
        botH, botF = _bottoms(rng, table, torch.int64, lo, hi)
        want = mm_level_cuda.split_plain(table, botH, botF, G, R)
        assert torch.equal(host_split(host_lib, table, botH, botF, G, R), want)
    botH32 = torch.full((int(table[:, 4].sum()),), -(2**31) + 1, dtype=torch.int32)
    got = host_split(host_lib, table, botH32, botH32, G, R)
    assert torch.equal(got, mm_level_cuda.split_plain(table, botH32, botH32, G, R))
    assert (got[:, 2] >= 2**31).all()  # t1 of rows at the int32 floor


# The host build in the launches' place: the DevicePair and the traceback.

@pytest.fixture
def host_launches(host_lib, monkeypatch):
    """``mm_level_cuda.prologue`` and ``split`` on the host build, counted."""
    calls = {"prologue": 0, "split": 0}

    def prologue(level, dtype, Q, R, local):
        calls["prologue"] += 1
        return host_prologue(host_lib, level.table, dtype, Q, R, local)

    def split(level, botH, botF, g, R):
        calls["split"] += 1
        return host_split(host_lib, level.table, botH, botF, g, R)

    monkeypatch.setattr(mm_level_cuda, "prologue", prologue)
    monkeypatch.setattr(mm_level_cuda, "split", split)
    return calls


def _jax(q, s, sub=B62):
    return JaxPair(q, s, sub.padded(), Q, R, interpret=True, RB=256, WC=256)


@pytest.mark.parametrize("tbs", list(itertools.product((False, True), (False, True))),
                         ids=["g-g", "g-0", "0-g", "0-0"])
def test_divide_level_on_host_build_matches_jax(host_launches, tbs):
    """A level of nodes of different sizes through the host build equals
    the JAX package's level and the plain version's."""
    rng = np.random.default_rng(sum(tbs) + 23)
    q, s = rng.integers(0, 20, 601).astype(np.intp), rng.integers(0, 20, 240).astype(np.intp)
    nodes = [(0, 301, 0, 120, tbs[0], tbs[1]), (301, 601, 120, 240, tbs[1], tbs[0]),
             (10, 120, 5, 230, False, False), (500, 502, 200, 201, tbs[0], tbs[0])]
    pair = DevicePair(q, s, B62.padded(), Q, R, device="cpu")
    got = pair.divide_level(nodes)
    assert host_launches == {"prologue": 1, "split": 1}
    assert (pair.levels, pair.staged_levels) == (1, 0)  # staged counts a card's levels
    assert got == _jax(q, s).divide_level(nodes)


def test_divide_level_ties_on_host_build(host_launches):
    """Repeated motifs: many crossing columns cost the same; the first wins."""
    q, s = np.tile(MOTIF, 40), np.tile(MOTIF, 30)
    nodes = [(0, 240, 0, 180, False, False), (6, 120, 12, 150, True, False),
             (60, 240, 0, 90, False, True)]
    got = DevicePair(q, s, B62.padded(), Q, R, device="cpu").divide_level(nodes)
    assert got == _jax(q, s).divide_level(nodes)


def test_divide_level_int64_on_host_build(host_launches):
    """A pair past the int32 bound runs in int64 through the host build."""
    big = np.full((32, 32), -64, np.int64)
    big[:20, :20] = -(2**21)
    np.fill_diagonal(big[:20, :20], 2**26)
    rng = np.random.default_rng(3)
    q = rng.integers(0, 20, 80).astype(np.intp)
    s = np.concatenate([q[4:], rng.integers(0, 20, 9)])
    pair = DevicePair(q, s, big, Q, R, device="cpu")
    assert pair.dtype == torch.int64
    nodes = [(0, 80, 0, len(s), False, False), (10, 70, 3, 60, True, False)]
    got = pair.divide_level(nodes)
    cost = -big[:20, :20]
    for (qs, qe, ss, se, f0, r0), (j1, j2, v1, v2) in zip(nodes, got):
        mid = (qe - qs) // 2
        CCf, DDf = jhb._mm_pass(q[qs:qs + mid], s[ss:se], cost, G, R, 0 if f0 else G)
        CCr, DDr = jhb._mm_pass(q[qs + mid:qe][::-1].copy(), s[ss:se][::-1].copy(), cost,
                                G, R, 0 if r0 else G)
        t1, t2 = CCf + CCr[::-1], DDf + DDr[::-1] - G
        assert (j1, j2, v1, v2) == (int(np.argmin(t1)), int(np.argmin(t2)), int(t1.min()),
                                    int(t2.min()))
    assert abs(max(v for r in got for v in r[2:])) > 2**31


def _key(tb):
    return tb.score, tb.q_begin, tb.q_end, tb.s_begin, tb.s_end, tb.cigar


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
@pytest.mark.parametrize("motif", [False, True], ids=["drawn", "motif"])
def test_traceback_on_host_build_matches_jax(host_launches, monkeypatch, motif, local):
    """align_pair_linear with every level (and SW's end cells) staged
    through the host build equals the JAX package's alignment."""
    monkeypatch.setattr(hb, "DEVICE_ON_CPU", True)
    monkeypatch.setattr(hb, "DEVICE_MIN_CELLS", 1024)
    monkeypatch.setattr(hb, "LEAF_CELLS", 256)
    monkeypatch.setattr(jhb, "LEAF_CELLS", 256)
    rng = np.random.default_rng(41 + motif + 2 * local)
    for m, n in ((230, 310), (97, 40)):
        if motif:
            q, s = np.resize(MOTIF, m).astype(np.uint8), np.resize(MOTIF, n).astype(np.uint8)
        else:
            q = rng.integers(0, 20, m).astype(np.uint8)
            s = rng.integers(0, 20, n).astype(np.uint8)
        got = hb.align_pair_linear(q, s, B62.scores, 10, 1, local, device="cpu")
        want = jhb.align_pair_linear(q, s, B62.scores, 10, 1, local)
        assert _key(got) == _key(want), (m, n)
    assert 0 < host_launches["split"] <= host_launches["prologue"]


# The wrapper on CPU tensors.

def test_wrapper_runs_the_plain_versions_on_cpu_tensors():
    """On CPU tensors nothing is launched, the table stays the host's, and
    ``fetch`` gives lists."""
    rng = np.random.default_rng(8)
    pair = _pair(300, 200)
    jobs, tbs = pair.level_jobs(draw_nodes(rng, 3, pair.m, pair.n))
    before = mm_level_cuda.launches
    level = mm_level_cuda.stage(jobs, tbs, "cpu")
    assert np.shares_memory(level.table_d.numpy(), level.table)
    bounds = mm_level_cuda.prologue(level, torch.int32, Q, R, False)
    out = ring_block_cuda.ring_block_cuda(pair.q, pair.s, jobs, pair.matrix, Q, R, False,
                                          *bounds, codes_checked=True)
    res = mm_level_cuda.split(level, out.botH, out.botF, G, R)
    assert mm_level_cuda.launches == before
    assert mm_level_cuda.fetch(res) == res.tolist() and res.dtype == torch.int64


def test_split_refuses_what_is_not_a_level():
    """An odd number of tiles, or a node's two tiles of unequal width."""
    table = mm_level_cuda.level_table(np.array([[0, 2, 0, 3]], np.int64), np.array([0]))
    z = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="node"):
        mm_level_cuda.split(mm_level_cuda.Level(table, torch.from_numpy(table)), z, z, G, R)
    table = mm_level_cuda.level_table(np.array([[0, 2, 0, 3], [0, 2, 0, 4]], np.int64),
                                      np.array([0, 0]))
    z = torch.zeros(7, dtype=torch.int32)
    with pytest.raises(ValueError, match="node"):
        mm_level_cuda.split(mm_level_cuda.Level(table, torch.from_numpy(table)), z, z, G, R)


def test_level_span_counts_staged_levels(monkeypatch):
    """Each mm.level span carries ``staged``: 0 on the CPU's plain versions
    (the card's levels count 1, ``test_torch_cuda.py``)."""
    monkeypatch.setattr(hb, "DEVICE_ON_CPU", True)
    monkeypatch.setattr(hb, "DEVICE_MIN_CELLS", 1024)
    monkeypatch.setattr(hb, "LEAF_CELLS", 4096)
    rng = np.random.default_rng(12)
    q, s = rng.integers(0, 20, 300).astype(np.uint8), rng.integers(0, 20, 280).astype(np.uint8)
    stats = SearchStats()
    with profile(activities=[ProfilerActivity.CPU]):
        hb.align_pair_linear(q, s, B62.scores, 10, 1, local=False, stats=stats, device="cpu")
    levels = [x for x in stats.spans if x.name == "mm.level"]
    assert levels and all(x.counts["staged"] == 0 for x in levels)
    assert any(x.counts["device"] for x in levels)
