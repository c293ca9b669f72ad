"""Drawn inputs: the port against the JAX package, and K1, K2 and K3's host
builds against their plain versions.

``hypothesis`` draws the shapes and parameters, with ``derandomize=True``
and a fixed ``max_examples``: every run draws the same inputs, so the
count of cases never changes and a failure reproduces. Sequence contents
come from a drawn numpy seed.

1. ``SSAContext(device="cpu")`` against ``libssa_tpu.api.SSAContext`` on
   drawn databases (1-24 subjects of 1-300 residues, ambiguity codes among
   them), queries, gaps (both conventions, Q = R and R = 0 included),
   ``BitWidth`` and ``ComputeMode``: ``sw_align``, ``nw_align`` and
   ``align_many``, hit lists equal field by field.
2. ``align_pair`` in SCORE and ALIGNMENT mode on both, protein and ACGT on
   both strands.
3. The host builds of K1 (``csrc/interseq.cu``), K2 (``csrc/ring_block.cu``)
   and K3 (``csrc/longpair.cu``), from ``tests/test_torch_interseq.py``,
   ``test_torch_ring_block.py`` and ``test_torch_longpair.py``, against the
   plain versions: every warps count and band height, sizes weighted
   towards the stripe, group and segment edges. A host build returns -2
   where a hand-off between warps would race on the card.
"""
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, assume, given, settings
from hypothesis import strategies as st

import test_torch_interseq as k1_tests
import test_torch_longpair as k3_tests
import test_torch_ring_block as k2_tests
from libssa_tpu import api as jax_api
from libssa_tpu import constants as jax_constants
from libssa_tpu_torch import api, matrices
from libssa_tpu_torch.constants import (
    AA_ALPHABET, NT_ALPHABET, AlignType, BitWidth, ComputeMode, Strand, SymType)
from libssa_tpu_torch.io.db import PAD_CODE
from libssa_tpu_torch.ops import interseq, longpair_cuda, ring_block, ring_block_cuda
from libssa_tpu_torch.ops.mm_level_cuda import open_edge
from libssa_tpu_torch.ops.scoring import make_padded_profile

torch.set_num_threads(1)

DRAWS = settings(derandomize=True, deadline=None, database=None, print_blob=True,
                 suppress_health_check=list(HealthCheck))
# Sizes at the kernels' edges: a K1 strip is 32 rows (16 in int64), a K2/K3
# stripe 32 x 4 or 32 x 8 rows, a group 1-8 stripes, a segment 8 columns.
EDGES = (1, 2, 3, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256,
         257, 511, 512, 513)
SEEDS = st.integers(0, 2**32 - 1)


def sizes(hi: int):
    """1 .. ``hi``, half the draws on an edge."""
    return st.one_of(st.sampled_from([e for e in EDGES if e <= hi]), st.integers(1, hi))


@st.composite
def gaps(draw):
    """(gap_open, gap_extend, first_residue_opens) that ``gap_qr`` takes:
    Q >= R >= 0, with R = 0 and Q = R among them."""
    ge = draw(st.integers(0, 4))
    fro = draw(st.booleans())
    go = draw(st.integers(0 if fro else ge, 15))
    return go, ge, fro


def _ref(member):
    return getattr(jax_constants, type(member).__name__)[member.name]


def _seq(rng, n: int, nt: bool) -> str:
    """``n`` residues, about 3% of them ambiguity codes."""
    alpha, core = (NT_ALPHABET, 4) if nt else (AA_ALPHABET[:-1], 20)
    codes = rng.integers(0, core, n)
    amb = rng.random(n) < 0.03
    codes[amb] = rng.integers(core, len(alpha), int(amb.sum()))
    return "".join(alpha[c] for c in codes)


def _contexts(nt: bool, go: int, ge: int, fro: bool):
    """The JAX package's context and the port's on the CPU, alike."""
    out = []
    for ctx, enum in ((jax_api.SSAContext(), _ref), (api.SSAContext(device="cpu"), None)):
        enum = enum or (lambda e: e)
        if nt:
            ctx.init_symbol_translation(enum(SymType.NUCLEOTIDE), enum(Strand.BOTH), 1, 1)
            ctx.init_constant_scoring(5, -4)
        else:
            ctx.init_score_matrix("BLOSUM62")
        ctx.init_gap_penalties(go, ge, fro)
        out.append((ctx, enum))
    return out


def _hit(h):
    return (h.seq_id, h.header, h.score, h.align_type.name, h.strand, h.db_frame,
            h.q_begin, h.q_end, h.s_begin, h.s_end, h.cigar, h.aligned)


@settings(DRAWS, max_examples=24)
@given(seed=SEEDS, nt=st.booleans(), gap=gaps(), n_seqs=st.integers(1, 24),
       align_type=st.sampled_from(list(AlignType)), bit_width=st.sampled_from(list(BitWidth)),
       mode=st.sampled_from(list(ComputeMode)), k=st.integers(1, 8),
       many=st.integers(0, 3))
def test_api_search_matches_reference(seed, nt, gap, n_seqs, align_type, bit_width, mode,
                                      k, many):
    """``sw_align``/``nw_align`` (``many`` = 0) or ``align_many`` over
    ``many`` queries: equal hit lists and statistics."""
    rng = np.random.default_rng(seed)
    lens = np.exp(rng.uniform(0, np.log(300), n_seqs)).astype(int)
    db = "".join(f">s{i}\n{_seq(rng, int(n), nt)}\n" for i, n in enumerate(lens))
    queries = [_seq(rng, int(np.exp(rng.uniform(0, np.log(300)))), nt)
               for _ in range(max(1, many))]
    got = []
    for ctx, enum in _contexts(nt, *gap):
        ctx.init_db_fasta(db)
        qs = [ctx.init_sequence_fasta(q) for q in queries]
        if many:
            lists = ctx.align_many(qs, k, enum(mode), enum(align_type), enum(bit_width))
        else:
            fn = ctx.sw_align if align_type is AlignType.SW else ctx.nw_align
            lists = [fn(qs[0], k, enum(bit_width), enum(mode))]
        got.append([([_hit(h) for h in hl], hl.stats.cells, hl.stats.rescored)
                    for hl in lists])
    assert got[1] == got[0]


@settings(DRAWS, max_examples=40)
@given(seed=SEEDS, nt=st.booleans(), gap=gaps(), m=sizes(900), n=sizes(1800),
       align_type=st.sampled_from(list(AlignType)), mode=st.sampled_from(list(ComputeMode)))
def test_align_pair_matches_reference(seed, nt, gap, m, n, align_type, mode):
    rng = np.random.default_rng(seed)
    q, s = _seq(rng, m, nt), _seq(rng, n, nt)
    got = []
    for ctx, enum in _contexts(nt, *gap):
        hit = ctx.align_pair(ctx.init_sequence_fasta(q), s, enum(align_type), enum(mode))
        got.append(_hit(hit))
    assert got[1] == got[0]


# -- the host builds -----------------------------------------------------------

MATRICES = {
    "BLOSUM62": (matrices.builtin("BLOSUM62").padded(), 24),
    "BLOSUM45": (matrices.builtin("BLOSUM45").padded(), 24),
    "BLOSUM80": (matrices.builtin("BLOSUM80").padded(), 24),
    "const 3/-2": (matrices.constant_scoring(3, -2, SymType.AMINOACID).padded(), 24),
    "ACGT 5/-4": (matrices.constant_scoring(5, -4).padded(), 4),
}


@pytest.fixture(scope="module")
def host_k1(tmp_path_factory):
    return k1_tests._host_k1(tmp_path_factory.mktemp("k1"))


@pytest.fixture(scope="module")
def host_k2(tmp_path_factory):
    return k2_tests._host_k2(tmp_path_factory.mktemp("k2"))


@pytest.fixture(scope="module")
def host_k3(tmp_path_factory):
    return k3_tests._host_k3(tmp_path_factory.mktemp("k3"))


@st.composite
def qr(draw):
    """Gotoh's (Q, R) with Q >= R >= 0, R = 0 and Q = R among them."""
    R = draw(st.sampled_from([0, 1, 2, 3]))
    return draw(st.sampled_from([R, R + 1, R + 9])), R


@settings(DRAWS, max_examples=80)
@given(seed=SEEDS, m=sizes(300), pad_rows=st.sampled_from([0, 0, 1, 31]),
       nq=st.integers(1, 4), g=st.integers(1, 3), P=st.integers(1, 8),
       n_pad=sizes(80), B=st.one_of(sizes(100), st.sampled_from([32, 64, 96, 128])),
       gap=qr(), local=st.booleans(), track=st.booleans(), wide=st.booleans(),
       warps=st.integers(1, 16), matrix=st.sampled_from(sorted(MATRICES)))
def test_host_k1_matches_plain(host_k1, seed, m, pad_rows, nq, g, P, n_pad, B, gap, local,
                               track, wide, warps, matrix):
    """K1: padded profiles (m_real < m), ragged lanes with length-0 and
    full-length ones, Part A (warps = 1) and Part B at 2-16 warps."""
    rng = np.random.default_rng(seed)
    mat, hi = MATRICES[matrix]
    rows = m + pad_rows
    profs = np.stack([make_padded_profile(rng.integers(0, hi, m).astype(np.uint8), mat,
                                          rows) for _ in range(nq)]).astype(np.int32)
    m_reals = np.full(nq, m, np.int32)
    lengths = rng.integers(0, n_pad + 1, (g, B)).astype(np.int32)
    lengths[:, rng.integers(0, B)] = n_pad
    codes = rng.integers(0, hi, (g, n_pad, B)).astype(np.int8)
    codes[np.arange(n_pad)[None, :, None] >= lengths[:, None, :]] = PAD_CODE
    iq = rng.integers(0, nq, P).astype(np.int32)
    ic = rng.integers(0, g, P).astype(np.int32)
    batch = (profs, codes, lengths, iq, ic, m_reals)
    want = interseq.interseq_pairs(*(torch.as_tensor(a) for a in batch), *gap, local=local,
                                   track_range=track, dtype="int64" if wide else "int32")
    got = k1_tests._run_host(host_k1, *batch, *gap, local, track, int(wide), warps)
    for name, a, b in zip(("scores", "hi", "lo"), got, want):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


def _size(rng, hi: int) -> int:
    """1 .. ``hi``: half the draws on an edge, the rest log-uniform."""
    edges = [e for e in EDGES if e <= hi]
    if rng.random() < 0.5:
        return int(rng.choice(edges))
    return int(np.exp(rng.uniform(0, np.log(hi + 1)))) or 1


def _edges(rng, q, s, Q, R, local, dt, kind):
    """A tile's boundaries (leftH, leftE, topH, topF) as K2's callers make
    them: SW's zeros or NW's open edges (``mm_level_cuda.open_edge``) ("open"),
    or the edges carried out of a tile to its left and one above it, each
    run by the plain version from open edges ("carried")."""
    rows, cols = len(q), len(s)
    if kind == "carried":
        sl = torch.as_tensor(rng.integers(0, 20, _size(rng, 64)).astype(np.uint8))
        ql = torch.as_tensor(rng.integers(0, 20, _size(rng, 64)).astype(np.uint8))
        left = ring_block.ring_block_plain(q, sl, k2_tests.PADDED, Q, R, local,
                                           *_edges(rng, q, sl, Q, R, local, dt, "open"))
        top = ring_block.ring_block_plain(ql, s, k2_tests.PADDED, Q, R, local,
                                          *_edges(rng, ql, s, Q, R, local, dt, "open"))
        corner = _edges(rng, q, sl, Q, R, local, dt, "open")[2][-1:]  # H[r0-1][c0-1]
        return torch.cat([corner, left.rightH]), left.rightE, top.botH, top.botF
    k = torch.arange(max(rows, cols) + 1, dtype=torch.int64)
    if local:
        left, top = torch.zeros(rows + 1, dtype=dt), torch.zeros(cols, dtype=dt)
    else:
        left = open_edge(Q - R, k[:rows + 1], R).to(dt)  # H[i][0]
        top = open_edge(Q - R, k[1:cols + 1], R).to(dt)  # H[0][j], j >= 1
    return left, left[1:] - Q + R, top, top - Q + R


@settings(DRAWS, max_examples=80)
@given(seed=SEEDS, n_tiles=st.integers(1, 8), gap=qr(), local=st.booleans(),
       wide=st.booleans(), ch=st.sampled_from(ring_block_cuda.BAND_ROWS),
       warps=st.integers(1, ring_block_cuda.MAX_WARPS))
def test_host_k2_matches_plain(host_k2, seed, n_tiles, gap, local, wide, ch, warps):
    """K2: a batch of tiles at offsets into shared code buffers, 1-300 rows
    x 1-300 columns, with SW/NW open and carried edges; every output of
    ``ring_block.Tiles`` equal."""
    dt = torch.int64 if wide else torch.int32
    assume(ring_block_cuda.smem_bytes(warps, ch, dt.itemsize) <= ring_block_cuda.MAX_SMEM)
    rng = np.random.default_rng(seed)
    Q, R = gap
    qbuf = torch.as_tensor(rng.integers(0, 20, 700).astype(np.uint8))
    sbuf = torch.as_tensor(rng.integers(0, 20, 700).astype(np.uint8))
    jobs, parts = [], []
    for _ in range(n_tiles):
        rows, cols = _size(rng, 300), _size(rng, 300)
        q0, s0 = int(rng.integers(0, 701 - rows)), int(rng.integers(0, 701 - cols))
        jobs.append([q0, rows, s0, cols])
        kind = "carried" if rng.random() < 0.3 else "open"
        parts.append(_edges(rng, qbuf[q0:q0 + rows], sbuf[s0:s0 + cols], Q, R, local, dt,
                            kind))
    jobs = np.array(jobs, np.int64)
    flat = [torch.cat(x) for x in zip(*parts)]
    want = ring_block_cuda.ring_block_cuda(qbuf, sbuf, jobs, k2_tests.PADDED, Q, R, local,
                                           *flat)
    got = k2_tests._run_host(host_k2, qbuf, sbuf, jobs, flat, Q, R, local, ch, warps)
    for name, a, b in zip(ring_block.Tiles._fields, got, want):
        assert (a is None) == (b is None), name
        if b is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), name


@settings(DRAWS, max_examples=100)
@given(seed=SEEDS, m=sizes(700), n=sizes(700), acgt=st.booleans(), gap=qr(),
       local=st.booleans(), wide=st.booleans(), ch=st.sampled_from(longpair_cuda.BAND_ROWS),
       warps=st.integers(1, longpair_cuda.MAX_WARPS))
def test_host_k3_matches_plain(host_k3, seed, m, n, acgt, gap, local, wide, ch, warps):
    """K3: m and n at the stripe, group and segment edges, every band
    height and warps count, protein and ACGT."""
    assume(longpair_cuda.fits(warps, ch, 8 if wide else 4))
    rng = np.random.default_rng(seed)
    mat, hi = MATRICES["ACGT 5/-4" if acgt else "BLOSUM62"]
    mat = np.ascontiguousarray(mat, np.int32)
    q, s = rng.integers(0, hi, m).astype(np.uint8), rng.integers(0, hi, n).astype(np.uint8)
    want = k3_tests._plain(q, s, mat, *gap, local, torch.int64)
    rc, got = k3_tests._run_host(host_k3, q, s, mat, *gap, local, ch, int(wide), warps)
    assert rc == 0 and got == want
