"""K1, K3, K2, the search engine, the linear-space traceback and the
probes' kernels on an NVIDIA GPU, against the plain version and the CPU.

Every test here needs a card: it is marked ``cuda`` and skips without one.
The file imports neither JAX nor the JAX package, so it also runs where
they are not installed; on a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``tests/conftest.py`` configures JAX for the rest of the suite.)
Tolerance: exact equality: the DP values are integers, and the probes'
f32 and bf16 ops round exactly as their plain versions do.
"""
import numpy as np
import pytest
import torch

from libssa_tpu_torch import matrices, oracle
from libssa_tpu_torch.constants import BitWidth, SymType
from libssa_tpu_torch.io.db import PAD_CODE, SequenceDB
from libssa_tpu_torch.ops import (
    interseq,
    interseq_cuda,
    longpair,
    longpair_cuda,
    ring_block,
    ring_block_cuda,
)
from libssa_tpu_torch.ops.mm_device import DevicePair
from libssa_tpu_torch.ops.scoring import make_padded_profile
from libssa_tpu_torch.search import hirschberg
from libssa_tpu_torch.search.manager import SearchEngine, SearchParams, SearchStats

B62 = matrices.builtin("BLOSUM62")
PADDED = B62.padded()

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1, K2 and K3 have no CPU mode)")
    return torch.device("cuda", 0)


def _pairs(rng, m, nq=3, g=2, n_pad=36, B=21, P=7):
    """A stack group with ragged, padded and length-0 lanes, and P pairs."""
    profs = np.stack([
        make_padded_profile(rng.integers(0, 20, m).astype(np.uint8), PADDED)
        for _ in range(nq)
    ]).astype(np.int32)
    m_reals = rng.integers(1, m + 1, nq).astype(np.int32)
    lengths = rng.integers(0, n_pad + 1, (g, B)).astype(np.int32)
    lengths[:, :2] = 0
    codes = rng.integers(0, 20, (g, n_pad, B)).astype(np.int8)
    codes[np.arange(n_pad)[None, :, None] >= lengths[:, None, :]] = PAD_CODE
    iq = rng.integers(0, nq, P).astype(np.int32)
    ic = rng.integers(0, g, P).astype(np.int32)
    return profs, codes, lengths, iq, ic, m_reals


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_k1_matches_plain(dev, local, dtype):
    rng = np.random.default_rng(31)
    for m in (1, 33, 300):
        t = [torch.as_tensor(a).to(dev) for a in _pairs(rng, m)]
        for track in (True, False):
            before = interseq_cuda.launches
            got = interseq_cuda.interseq_pairs_cuda(
                *t, 12, 1, local=local, track_range=track, dtype=dtype
            )
            torch.cuda.synchronize()
            assert interseq_cuda.launches == before + 1
            want = interseq.interseq_pairs(
                *t, 12, 1, local=local, track_range=track, dtype=dtype
            )
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w)


def test_k1_splits_pairs_to_fit_scratch(dev):
    """A scratch for two pairs: seven pairs take four launches, same result."""
    rng = np.random.default_rng(5)
    t = [torch.as_tensor(a).to(dev) for a in _pairs(rng, 70, n_pad=40, B=130)]
    per_pair = 2 * 40 * 130 * 4  # H and F rows, int32
    scratch = torch.empty(2 * per_pair, dtype=torch.uint8, device=dev)
    before = interseq_cuda.launches
    got = interseq_cuda.interseq_pairs_cuda(*t, 11, 1, track_range=True, scratch=scratch)
    torch.cuda.synchronize()
    assert interseq_cuda.launches == before + 4
    want = interseq.interseq_pairs(*t, 11, 1, track_range=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k1_wrapper_rejects_what_it_cannot_take(dev):
    rng = np.random.default_rng(6)
    t = [torch.as_tensor(a).to(dev) for a in _pairs(rng, 8)]
    bad_type = list(t)
    bad_type[1] = t[1].to(torch.int32)
    with pytest.raises(TypeError, match="codes"):
        interseq_cuda.interseq_pairs_cuda(*bad_type, 11, 1)
    strided = list(t)
    strided[1] = t[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        interseq_cuda.interseq_pairs_cuda(*strided, 11, 1)
    mixed = list(t)
    mixed[2] = t[2].cpu()
    with pytest.raises(ValueError, match="device"):
        interseq_cuda.interseq_pairs_cuda(*mixed, 11, 1)


def test_engine_on_card_equals_cpu(dev):
    """Every search path: hit lists and stats on the card equal the CPU's."""
    rng = np.random.default_rng(8)
    seqs = [rng.integers(0, 20, int(rng.integers(20, 120))).astype(np.uint8)
            for _ in range(300)]
    seqs[7] = seqs[3].copy()  # a tie
    db = SequenceDB.from_sequences([f"s{i}" for i in range(300)], seqs, SymType.AMINOACID)
    engines = [SearchEngine(db, B62, 10, 1, SearchParams(batch_size=64), device=d)
               for d in (dev, "cpu")]
    queries = [seqs[3][:90], rng.integers(0, 20, 40).astype(np.uint8)]

    def run(eng):
        out = []
        for local in (True, False):
            for bw in (BitWidth.EXACT, BitWidth.BIT8, BitWidth.BIT64):
                st = SearchStats()
                out.append((eng.search(queries[0], 8, local, bw, st),
                            st.cells, st.rescored))
            st = SearchStats()
            out.append((eng.search_many(queries, 6, local, st, BitWidth.BIT16),
                        st.cells, st.rescored))
            st = SearchStats()
            out.append((eng.search_reduced(queries, None, 5, local, st),
                        st.cells, st.rescored))
        return out

    got, want = run(engines[0]), run(engines[1])
    for (g, gc, gr), (w, wc, wr) in zip(got, want):
        np.testing.assert_equal(g, w)
        assert (gc, gr) == (wc, wr)


@pytest.mark.parametrize("ch", longpair_cuda.BAND_ROWS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_k3_matches_plain(dev, local, dtype, ch):
    """Stripe edges crossed, m not a multiple of a stripe, m or n = 1."""
    rng = np.random.default_rng(41 + ch)
    mat = torch.as_tensor(PADDED.astype(np.int32)).to(dev)
    for m, n in ((1, 1), (1, 90), (90, 1), (31, 33), (1000, 70), (70, 1000), (2100, 517)):
        q = torch.as_tensor(rng.integers(0, 20, m).astype(np.uint8)).to(dev)
        s = torch.as_tensor(rng.integers(0, 20, n).astype(np.uint8)).to(dev)
        before = longpair_cuda.launches
        got = longpair_cuda.longpair_score_cuda(
            q, s, mat, 12, 1, local, dtype, rows_per_thread=ch
        )
        torch.cuda.synchronize()
        assert longpair_cuda.launches == before + 1
        want = longpair.longpair_score_plain(q, s, mat, 12, 1, local, dtype)
        assert got.dtype == want.dtype and torch.equal(got, want), (m, n)


def test_k3_wrapper_rejects_what_it_cannot_take(dev):
    mat = torch.as_tensor(PADDED.astype(np.int32)).to(dev)
    q = torch.zeros(40, dtype=torch.uint8, device=dev)
    with pytest.raises(TypeError, match="q"):
        longpair_cuda.longpair_score_cuda(q.to(torch.int32), q, mat, 12, 1)
    with pytest.raises(ValueError, match="device"):
        longpair_cuda.longpair_score_cuda(q.cpu(), q, mat, 12, 1)
    with pytest.raises(ValueError, match="codes"):
        longpair_cuda.longpair_score_cuda(q + 32, q, mat, 12, 1)
    with pytest.raises(ValueError, match="rows_per_thread"):
        longpair_cuda.longpair_score_cuda(q, q, mat, 12, 1, rows_per_thread=3)


def test_pair_scores_batch_on_card_equals_cpu(dev):
    rng = np.random.default_rng(13)
    prof = make_padded_profile(rng.integers(0, 20, 50).astype(np.uint8), PADDED)
    subjects = rng.integers(0, 20, (300, 64)).astype(np.uint8)
    lengths = rng.integers(0, 65, 300).astype(np.int32)
    for local in (True, False):
        args = [torch.as_tensor(a) for a in (prof, subjects, lengths)]
        want = interseq.pair_scores_batch(*args, 12, 1, local=local, m_real=50)
        before = interseq_cuda.launches
        got = interseq.pair_scores_batch(
            *[a.to(dev) for a in args], 12, 1, local=local, m_real=50
        )
        assert interseq_cuda.launches == before + 1
        assert torch.equal(got.cpu(), want)


def _tiles(rng, dev, local, dtype, n_jobs=6):
    """Mixed tiles of one random pair with consistent random boundaries:
    leftE/topF one gap below leftH/topH, as a real DP's never exceed them."""
    q = torch.as_tensor(rng.integers(0, 20, 900).astype(np.uint8)).to(dev)
    s = torch.as_tensor(rng.integers(0, 20, 700).astype(np.uint8)).to(dev)
    jobs = []
    for _ in range(n_jobs):
        RB, W = int(rng.choice([1, 31, 33, 257, 600])), int(rng.choice([1, 32, 45, 300]))
        jobs.append([int(rng.integers(0, 900 - RB + 1)), RB, int(rng.integers(0, 700 - W + 1)), W])
    jobs = np.array(jobs, np.int64)
    n_rows, n_cols = int(jobs[:, 1].sum()), int(jobs[:, 3].sum())
    lo = 0 if local else -500
    h = lambda k: torch.as_tensor(rng.integers(lo, 300, k)).to(dtype).to(dev)
    leftH, topH = h(n_rows + len(jobs)), h(n_cols)
    gap = lambda k: torch.as_tensor(rng.integers(11, 40, k)).to(dtype).to(dev)
    leftE = h(n_rows) - gap(n_rows)
    return q, s, jobs, leftH, leftE, topH, topH - gap(n_cols)


@pytest.mark.parametrize("ch", ring_block_cuda.BAND_ROWS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_k2_matches_plain(dev, local, dtype, ch):
    """One launch of mixed tiles (RB or W = 1, stripe edges crossed)."""
    rng = np.random.default_rng(61 + ch + local)
    mat = torch.as_tensor(PADDED.astype(np.int32)).to(dev)
    q, s, jobs, *bounds = _tiles(rng, dev, local, dtype)
    before = ring_block_cuda.launches
    got = ring_block_cuda.ring_block_cuda(q, s, jobs, mat, 12, 1, local, *bounds,
                                          rows_per_thread=ch)
    torch.cuda.synchronize()
    assert ring_block_cuda.launches == before + 1
    want = ring_block_cuda.ring_block_cuda(q.cpu(), s.cpu(), jobs, mat.cpu(), 12, 1, local,
                                           *(b.cpu() for b in bounds))
    for name, g, w in zip(ring_block.Tiles._fields, got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w), name


def test_k2_staged_launch_repeats(dev):
    """``stage`` then its launch, twice: each call is one K2 launch and gives
    the one-call wrapper's outputs; codes_checked skips only the code check."""
    rng = np.random.default_rng(67)
    mat = torch.as_tensor(PADDED.astype(np.int32)).to(dev)
    q, s, jobs, *bounds = _tiles(rng, dev, True, torch.int32)
    want = ring_block_cuda.ring_block_cuda(q, s, jobs, mat, 12, 1, True, *bounds)
    launch = ring_block_cuda.stage(q, s, jobs, mat, 12, 1, True, *bounds, codes_checked=True)
    before = ring_block_cuda.launches
    for k in (1, 2):
        got = launch()
        torch.cuda.synchronize()
        assert ring_block_cuda.launches == before + k
        for name, g, w in zip(ring_block.Tiles._fields, got, want):
            assert torch.equal(g, w), name


def test_k2_wrapper_rejects_what_it_cannot_take(dev):
    mat = torch.as_tensor(PADDED.astype(np.int32)).to(dev)
    q = torch.zeros(40, dtype=torch.uint8, device=dev)
    b = [torch.zeros(k, dtype=torch.int32, device=dev) for k in (41, 40, 40, 40)]
    jobs = [[0, 40, 0, 40]]
    with pytest.raises(TypeError, match="q_codes"):
        ring_block_cuda.ring_block_cuda(q.int(), q, jobs, mat, 12, 1, True, *b)
    with pytest.raises(ValueError, match="device"):
        ring_block_cuda.ring_block_cuda(q, q, jobs, mat, 12, 1, True, b[0].cpu(), *b[1:])
    with pytest.raises(ValueError, match="codes"):
        ring_block_cuda.ring_block_cuda(q + 32, q, jobs, mat, 12, 1, True, *b)
    with pytest.raises(ValueError, match="rows_per_thread"):
        ring_block_cuda.ring_block_cuda(q, q, jobs, mat, 12, 1, True, *b, rows_per_thread=2)


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_device_pair_on_card_equals_cpu(dev, local, monkeypatch):
    """Divide levels and end cells on K2 equal DevicePair on the plain
    version, and the traceback (its levels on K2) equals the CPU's NumPy
    passes."""
    monkeypatch.setattr(hirschberg, "DEVICE_MIN_CELLS", 1 << 16)
    monkeypatch.setattr(hirschberg, "LEAF_CELLS", 1 << 14)
    rng = np.random.default_rng(71 + local)
    q = rng.integers(0, 20, 1500).astype(np.uint8)
    s = rng.integers(0, 20, 1300).astype(np.uint8)
    s[200:900] = q[300:1000]
    Q, R = oracle.gap_qr(11, 1)
    pairs = [DevicePair(q, s, PADDED, Q, R, device=d) for d in (dev, "cpu")]
    nodes = [(0, 1500, 0, 1300, False, False), (10, 700, 5, 640, True, False),
             (700, 1499, 640, 1290, False, True)]
    assert pairs[0].divide_level(nodes) == pairs[1].divide_level(nodes)
    assert pairs[0].sw_end(0, 1500, 0, 1300) == pairs[1].sw_end(0, 1500, 0, 1300)
    assert pairs[0].sw_end(3, 900, 7, 800, True) == pairs[1].sw_end(3, 900, 7, 800, True)
    st = SearchStats()
    got = hirschberg.align_pair_linear(q, s, B62.scores, 10, 1, local, stats=st, device=dev)
    want = hirschberg.align_pair_linear(q, s, B62.scores, 10, 1, local, device="cpu")
    assert st.aligner_levels > 0
    assert (got.score, got.q_begin, got.s_begin, got.cigar) == (
        want.score, want.q_begin, want.s_begin, want.cigar)


# -- the probes (libssa_tpu_torch/experiments/) ------------------------------------


@pytest.mark.parametrize("type_name", ["f32", "bf16x2", "i32", "i16x2", "i8x4", "u8x4"])
def test_probe_chain_matches_plain(dev, type_name):
    """chain_kernel, one and four accumulators, every op of r2_dtype's part A
    and the rate probes' DPX ops, against the plain version."""
    from libssa_tpu_torch.experiments import _common as C
    from libssa_tpu_torch.experiments import r2_dtype_probe, r2_ilp_probe

    a, b = r2_dtype_probe.inputs_a(type_name, dev)
    for name in r2_dtype_probe.ops_of(type_name):
        if r2_dtype_probe.OPS.get(name, ("", 0))[1]:
            continue  # the rolls: test_probe_tile_matches_plain
        got = r2_dtype_probe.stage(name, type_name, a, b, 3)()
        assert torch.equal(got, r2_dtype_probe.plain(name, a, b, 3)), name
    for ty, op, _, _ in r2_ilp_probe.CASES:
        if ty == type_name:
            got = C.stage_chain(op, ty, a, b, 4, 4, c1=1, c2=3)()
            assert torch.equal(got, C.plain_chain(op, a, b, 4, 4, c1=1, c2=3)), op


def test_probe_tile_matches_plain(dev):
    """tile_kernel at every instantiated layout: op_rate's, r2_dtype's rolls,
    r3_roll's and r3_longpair's."""
    from libssa_tpu_torch.experiments import (
        op_rate_probe, r2_dtype_probe, r3_longpair_probe, r3_roll_probe)

    for op in op_rate_probe.OPS:
        for ty in op_rate_probe.types_of(op):
            x = op_rate_probe.tile_input(ty, 2, dev)
            got = op_rate_probe.stage(x, op, ty, 4, iters=2)()
            assert torch.equal(got, op_rate_probe.plain(x, op, 4, iters=2)), (op, ty)
    for ty in r2_dtype_probe.TYPES:
        a, b = r2_dtype_probe.inputs_a(ty, dev)
        for name in ("roll1", "roll2", "max_roll"):
            got = r2_dtype_probe.stage(name, ty, a, b, 5)()
            assert torch.equal(got, r2_dtype_probe.plain(name, a, b, 5)), (name, ty)
        a, b = r2_dtype_probe.inputs_b(ty, dev)
        got = r2_dtype_probe.stage("max_roll", ty, a, b, 3)()
        assert torch.equal(got, r2_dtype_probe.plain("max_roll", a, b, 3)), ty
    for spec in [*r3_roll_probe.PROBES.values(), *r3_longpair_probe.PROBES.values()]:
        x = r3_roll_probe.tile_input(spec[1], 2, dev)
        got = r3_roll_probe.stage(x, spec, 9, None)()
        assert torch.equal(got, r3_roll_probe.plain(x, spec, 9)), spec


@pytest.mark.parametrize("variant", ["single", "tuple3", "with1b", "slice78", "subroll",
                                     "laneroll1b", "iota_t"])
def test_probe_carry_matches_plain(dev, variant):
    from libssa_tpu_torch.experiments import r3_carry_probe

    x = r3_carry_probe.tile_input(2, dev)
    before = r3_carry_probe.launches
    got = r3_carry_probe.stage(x, variant, 2100)()
    assert r3_carry_probe.launches == before + 1
    assert torch.equal(got, r3_carry_probe.plain(x, variant, 2100))


@pytest.mark.parametrize("variant", ["full", "noscan", "empty"])
def test_row_sweep_matches_plain(dev, variant):
    """Every column width with an instantiation; full equals K3's score."""
    from libssa_tpu_torch.experiments import r3_lp_bisect

    q, s, mat = (torch.as_tensor(a).to(dev) for a in r3_lp_bisect.pair(16384))
    for n in r3_lp_bisect.WIDTHS:
        m = min(n, 700)
        got = r3_lp_bisect.stage(q[:m], s[:n], mat, 11, 1, variant, copies=3)()
        want = r3_lp_bisect.plain(q[:m], s[:n], mat, 11, 1, variant)
        assert got.tolist() == [want] * 3, n
        if variant == "full":
            k3 = longpair_cuda.longpair_score_cuda(q[:m], s[:n], mat, 11, 1)
            assert int(k3) == want


def test_k3_stage_cuts_build_and_terminate(dev):
    """Each stage-cut build runs to its end without a fault; the default
    (``full``) is the production K3 and equals the plain version."""
    from libssa_tpu_torch.experiments import r3_banded_bisect

    q, s, mat, Q, R = r3_banded_bisect.pair("16k protein", dev)
    q, s = q[:2500], s[:1900]
    for v in r3_banded_bisect.CUTS:
        out = r3_banded_bisect.stage(q, s, mat, Q, R, v)()
        torch.cuda.synchronize()
        if v == "full":
            assert int(out) == int(r3_banded_bisect.plain(q, s, mat, Q, R))
