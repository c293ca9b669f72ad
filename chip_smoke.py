"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — database search through ``SearchEngine`` and
``SSAContext`` — on the card, at the flagship database size of ``bench.py``
(500,000 lognormal subjects, about 174M residues). Phases, one line each:

1. build K1 (``libssa_tpu_torch/csrc/interseq.cu``) with nvcc, and beside
   it K3, K2, the probes (``csrc/probes.cu``, ``csrc/lp_rowsweep.cu``) and
   K3's stage-cut builds, one nvcc each, all in parallel;
2. K1 against its plain PyTorch version on random inputs (exact equality);
3. the 500k-subject search: 8 queries through ``search_many`` (SW, k=10),
   one NW and one BIT8 query through ``search``, with K1's launch count;
4. those hit lists against the same engine forced onto the plain version,
   and every reported hit rescored by the scalar NumPy oracle;
5. ``SSAContext(device="cuda")`` on ``tests/testdata`` (ALIGNMENT-mode
   ``sw_align``, whose traceback cross-checks K1; ``nw_align``;
   ``align_many``) against ``SSAContext(device="cpu")``;
6. K1's time against the plain version's at bench.py's kernel shape (SW,
   BLOSUM62 11/1, m=256, B=8192, n=512, track_range);
7. K3 (``libssa_tpu_torch/csrc/longpair.cu``, built in phase 1 beside K1)
   against its plain PyTorch version on random pairs (exact equality):
   SW/NW, int32/int64, both band heights, protein and ACGT, m or n = 1,
   m >> n, n >> m, a matrix entry above 256, and a score bound past 2**31;
8. the 1-vs-1 score path at full width through
   ``SSAContext(device="cuda").align_pair(..., mode=ComputeMode.SCORE)``,
   held against the same call on the plain version: (a) a 16,384 x 16,384
   protein pair, BLOSUM62 11/1, SW and NW; (b) a 100,000 x 100,000 ACGT
   pair, 5/-4, gaps 10/1, SW, both strands; with K3's launch count and
   time (CUDA events) beside the plain version's;
9. BASELINE config 1's batched half: ``pair_scores_batch`` on K1, m = n =
   512, P = 2048, NW, BLOSUM62 11/1, against the plain version and the
   NumPy oracle;
10. K2 (``libssa_tpu_torch/csrc/ring_block.cu``, built in phase 1) against
    its plain PyTorch version on tiles whose boundaries come from a real DP
    (exact equality): SW/NW, int32/int64, both band heights, RB or W = 1,
    tall and wide tiles, one batched launch of mixed-size tiles, and the
    tiles of one pair chained into its score, equal to K3's; K2's time
    (the launch alone, and the whole wrapper) beside the plain version's
    at phase 11a's first level;
11. the linear-space traceback at full width through
    ``SSAContext(device="cuda").align_pair(..., mode=ComputeMode.ALIGNMENT)``
    (Myers-Miller levels on K2, leaves on the native host solver): (a)
    phase 8a's 16,384 x 16,384 pair, SW and NW, score, coordinates and
    cigar equal to ``SSAContext(device="cpu")`` (NumPy passes); (b) a
    100,000 x 100,000 random protein pair, BLOSUM62 11/1, SW and NW, whose
    score equals K3's, whose path re-scores to it and consumes its span;
    with K2's launch count, the levels and the seconds on the device and
    on the host;
12. the probes (``libssa_tpu_torch/experiments/``, the counterparts of the
    TPU probes in ``experiments/``): each at its JAX probe's shape, with
    their launch counts; each exact one against its plain version at
    reduced trips (exact equality); the op-rate table (latency at one warp
    an SM, throughput at full occupancy), the row sweep and K3's stage
    cuts at 16,384^2 and 100,000^2 beside the production K3.

The second-to-last line is a JSON object with each kernel's launches by
the main path, its largest difference from the plain version, its time,
the plain version's and the least time the card could take (``bound_ms``).

Any failed phase exits non-zero. Without CUDA the script exits non-zero
before printing any result. JAX and the JAX package ``libssa_tpu`` are
blocked from import.
"""
from __future__ import annotations

import sys

sys.modules["jax"] = None  # the port must run with JAX absent
sys.modules["libssa_tpu"] = None  # and without the JAX package

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

K1_REPLACES = "libssa_tpu/ops/interseq_pallas.py:92"
K1_SOURCE = "libssa_tpu_torch/csrc/interseq.cu"
K3_REPLACES = "libssa_tpu/ops/longpair_pallas.py:96"
K3_SOURCE = "libssa_tpu_torch/csrc/longpair.cu"
K2_REPLACES = "libssa_tpu/ops/ring_block_pallas.py:68"
K2_SOURCE = "libssa_tpu_torch/csrc/ring_block.cu"
PROBES_SOURCE = "libssa_tpu_torch/csrc/probes.cu"
ROWSWEEP_SOURCE = "libssa_tpu_torch/csrc/lp_rowsweep.cu"
TRACE_PAIR = 100_000  # phase 11b: m = n, the reference's largest traceback demo
# The least time for a kernel's work (the kernels line's bound_ms): the
# larger of bytes over HBM's rate and operations over the card's rate for
# their type. One H100 SXM at 700 W: 3.35 TB/s; float32 at 67e12 / 2 a
# second (128 FP32 lanes an SM; 67e12 counts a fused multiply-add as two).
# The data sheet's int32 rate (half as many INT32 lanes, 16.75e12) is no
# ceiling: phase 12 measures int32 add and max at 22.1-22.4e12 a second
# (25.6e12 at most), as nvcc issues half the adds as IMAD.IADD on
# the FMA pipe, and a DPX instruction (__viaddmax_s32, __vimax3_s32, its
# _relu form) at 13.1-13.4e12 (r2_ilp_probe at full occupancy; PERF.md §6).
# The bound takes the highest reading for each type, rounded up; phase 12
# prints each run's beside it.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"f32": 67e12 / 2, "i32": 25.6e12, "dpx": 13.5e12}
# The fewest int32 instructions a DP cell of Gotoh's recurrence needs on
# Hopper: h = __vimax3_s32(diag + s, e, f) is an add and a DPX max3 (SW's
# floor at 0 rides in __vimax3_s32_relu); t = h - Q is shared by both gaps;
# e' = __viaddmax_s32(e, -R, t) and f' likewise: 2 adds and 3 DPX for NW.
# SW's running max of H folds two cells into one __vimax3_s32: 3.5 DPX.
# K1's track_range adds the running min the same way: 0.5 DPX more. The
# adds can issue on the FMA pipe beside the DPX, so a cell takes at least
# the larger of the two counts over their rates: the DPX's.
CELL_NW, CELL_SW, CELL_SW_TRACK = (2, 3), (2, 3.5), (2, 4)  # (int32 adds, DPX)
PAIR_PROTEIN = 16_384  # phase 8a: m = n, the shape libssa_tpu/api.py names
PAIR_GENOME = 100_000  # phase 8b: m = n, 10**10 cells a strand
BATCH_M, BATCH_P = 512, 2048  # phase 9: BASELINE config 1's batched half
TESTDATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "testdata")


def fail(phase: int, msg: str):
    raise SystemExit(f"phase {phase} FAILED: {msg}")


def say(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- phase 2 ---------------------------------------------------------------


def k1_cases(rng, padded_matrix):
    """Random pair batches: SW/NW x tracked x int32/int64 x m x shapes."""
    from libssa_tpu_torch.io.db import PAD_CODE
    from libssa_tpu_torch.ops.scoring import make_padded_profile, make_profile

    for m in (1, 33, 300):
        for n_pad, B in ((40, 37), (96, 300), (200, 128)):
            nq, g = 3, 2
            seqs = [rng.integers(0, 20, m).astype(np.uint8) for _ in range(nq)]
            pad_rows = n_pad != 96  # padded profiles: m_real < rows
            profs = np.stack([
                make_padded_profile(q, padded_matrix) if pad_rows
                else make_profile(q, padded_matrix) for q in seqs
            ]).astype(np.int32)
            lengths = rng.integers(0, n_pad + 1, (g, B)).astype(np.int32)
            lengths[:, :3] = 0  # length-0 lanes
            lengths[:, 3] = n_pad
            codes = rng.integers(0, 20, (g, n_pad, B)).astype(np.int8)
            cols = np.arange(n_pad)[None, :, None]
            codes[cols >= lengths[:, None, :]] = PAD_CODE  # padding cells
            iq = np.repeat(np.arange(nq, dtype=np.int32), g)
            ic = np.tile(np.arange(g, dtype=np.int32), nq)
            yield m, profs, codes, lengths, iq, ic, np.full(nq, m, np.int32)


def phase2(dev):
    import torch

    from libssa_tpu_torch import matrices
    from libssa_tpu_torch.ops import interseq, interseq_cuda

    rng = np.random.default_rng(2024)
    padded = matrices.builtin("BLOSUM62").padded()
    n_cases = 0
    max_err = 0
    for case in k1_cases(rng, padded):
        m, profs, codes, lengths, iq, ic, mrs = case
        t = [torch.as_tensor(a).to(dev) for a in (profs, codes, lengths, iq, ic, mrs)]
        for local in (True, False):
            for track in (True, False):
                for dtype in ("int32", "int64"):
                    gaps = (12, 1) if n_cases % 2 else (5, 2)
                    kw = dict(local=local, track_range=track, dtype=dtype)
                    ref = interseq.interseq_pairs(*t, *gaps, **kw)
                    # A scratch for two pairs splits the batch into launches.
                    scratch = None
                    if n_cases % 3 == 0:
                        per_pair = 2 * codes.shape[1] * codes.shape[2] * 8
                        scratch = torch.empty(2 * per_pair, dtype=torch.uint8, device=dev)
                    got = interseq_cuda.interseq_pairs_cuda(*t, *gaps, scratch=scratch, **kw)
                    torch.cuda.synchronize()
                    for name, a, b in zip(("scores", "hi", "lo"), got, ref):
                        if a.dtype != b.dtype or not torch.equal(a, b):
                            bad = (a.long() - b.long()).abs().max().item()
                            fail(2, f"{name} differ (m={m}, shape={codes.shape}, "
                                    f"{kw}, max |diff| {bad})")
                        max_err = max(max_err, (a.long() - b.long()).abs().max().item())
                    n_cases += 1
    say(f"phase 2 K1 vs plain on the card: {n_cases} cases equal "
        "(scores, hi, lo; tolerance: exact)")
    return max_err


# -- phases 3 and 4 ----------------------------------------------------------


def flagship_db(n_seqs=500_000):
    """bench.py's flagship database: lognormal lengths, seed 99."""
    from libssa_tpu_torch.constants import SymType
    from libssa_tpu_torch.io.db import SequenceDB

    rng = np.random.default_rng(99)
    lengths = np.clip(
        rng.lognormal(mean=5.7, sigma=0.55, size=n_seqs).astype(int), 50, 2000
    )
    seqs = [rng.integers(0, 20, L).astype(np.uint8) for L in lengths]
    return SequenceDB.from_sequences(
        [f"synth{i}" for i in range(n_seqs)], seqs, SymType.AMINOACID
    )


def _oracle_score(args):
    local, q, s = args
    from libssa_tpu_torch import matrices, oracle

    fn = oracle.sw_score if local else oracle.nw_score
    return fn(q, s, matrices.builtin("BLOSUM62").scores, 11, 1)


def phase34(dev):
    import concurrent.futures
    import multiprocessing

    import torch

    from libssa_tpu_torch import matrices
    from libssa_tpu_torch.constants import BitWidth
    from libssa_tpu_torch.ops import interseq_cuda
    from libssa_tpu_torch.search.manager import SearchEngine, SearchStats

    t0 = time.perf_counter()
    db = flagship_db()
    t_db = time.perf_counter() - t0
    eng = SearchEngine(db, matrices.builtin("BLOSUM62"), 11, 1, device=dev)
    t0 = time.perf_counter()
    eng.prepare()
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    qrng = np.random.default_rng(7)
    queries = [qrng.integers(0, 20, 256).astype(np.uint8) for _ in range(8)]
    eng.search_many(queries, 10, local=True)  # warm, as bench.py does

    interseq_cuda.launches = 0  # count the main path's launches only
    st = SearchStats()
    t0 = time.perf_counter()
    sw_hits = eng.search_many(queries, 10, local=True, stats=st)
    wall = time.perf_counter() - t0
    st_nw = SearchStats()
    nw_hit = eng.search(queries[0], 10, local=False, stats=st_nw)
    st8 = SearchStats()
    b8_hit = eng.search(queries[0], 10, local=True, bit_width=BitWidth.BIT8, stats=st8)
    # A slice of a database subject: its self-hit leaves the 8-bit window,
    # so the ladder's packed flags come back set.
    homolog = db.sequence(int(np.argmax(db.lengths >= 300)))[:256]
    st8h = SearchStats()
    b8h_hit = eng.search(homolog, 10, local=True, bit_width=BitWidth.BIT8, stats=st8h)
    exh_hit = eng.search(homolog, 10, local=True)
    launches = interseq_cuda.launches

    if launches <= 0:
        fail(3, "K1 was not launched by the search")
    for s, i in [*sw_hits, nw_hit, b8_hit, b8h_hit]:
        if len(s) != 10 or not np.all(np.isfinite(s)) or len(set(i.tolist())) != 10:
            fail(3, f"malformed hit list {s} {i}")
    for name, a, b in (("BIT8", b8_hit, sw_hits[0]), ("BIT8 homolog", b8h_hit, exh_hit)):
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            fail(3, f"{name} hit list differs from the EXACT one")
    if not st8h.rescored:
        fail(3, "the homolog's self-hit did not leave the 8-bit window")
    rate = st.subjects / st.seconds
    say(f"phase 3 search 8q x {len(db)} subjects ({db.total_residues} residues), "
        f"SW k=10: {rate:.0f} q*subj/s, {st.gcups:.2f} GCUPS, {wall:.3f} s wall; "
        f"NW 1q {st_nw.seconds:.3f} s; BIT8 1q {st8.seconds:.3f} s, "
        f"rescored {st8.rescored}; BIT8 homolog rescored {st8h.rescored}, "
        f"top score {int(b8h_hit[0][0])}; K1 launches {launches}; "
        f"db build {t_db:.1f} s, prepare {t_prep:.1f} s")

    # Phase 4: the same engine on the plain version, and the oracle.
    eng.params.kernel = "plain"
    t0 = time.perf_counter()
    p_sw = eng.search_many([queries[0]], 10, local=True)[0]
    p_nw = eng.search(queries[0], 10, local=False)
    t_plain = time.perf_counter() - t0
    eng.params.kernel = "auto"
    for name, a, b in (("SW", sw_hits[0], p_sw), ("NW", nw_hit, p_nw)):
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            fail(4, f"{name} hit list differs from the plain version's: {a} vs {b}")
    jobs, want = [], []
    for q, (s, ids) in zip(queries, sw_hits):
        jobs += [(True, q, db.sequence(int(i))) for i in ids]
        want += s.tolist()
    jobs += [(False, queries[0], db.sequence(int(i))) for i in nw_hit[1]]
    want += nw_hit[0].tolist()
    for q, (s, ids) in ((queries[0], b8_hit), (homolog, b8h_hit)):
        jobs += [(True, q, db.sequence(int(i))) for i in ids]
        want += s.tolist()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(8, mp_context=ctx) as pool:
        got = list(pool.map(_oracle_score, jobs, chunksize=2))
    if got != want:
        bad = [(g, w) for g, w in zip(got, want) if g != w][:5]
        fail(4, f"oracle rescoring disagrees (oracle, search): {bad}")
    say(f"phase 4 hit lists equal the plain version's (SW q0, NW q0; plain "
        f"{t_plain:.1f} s) and {len(jobs)} hits equal the oracle's rescoring")
    return launches, rate, st.gcups


# -- phase 5 ----------------------------------------------------------------


def phase5():
    from libssa_tpu_torch.constants import BitWidth, ComputeMode
    from libssa_tpu_torch.api import SSAContext

    def run(device):
        ctx = SSAContext(device=device)
        ctx.init_score_matrix("BLOSUM62")
        ctx.init_gap_penalties(10, 1)
        ctx.init_db_fasta(os.path.join(TESTDATA, "proteins.fas"))
        q = ctx.init_sequence_fasta(os.path.join(TESTDATA, "query_prot.fas"))
        sw = ctx.sw_align(q, 10, BitWidth.EXACT, ComputeMode.ALIGNMENT)
        nw = ctx.nw_align(q, 10, BitWidth.BIT16, ComputeMode.SCORE)
        many = ctx.align_many(
            ctx.init_sequences_fasta(os.path.join(TESTDATA, "proteins.fas"))[:6], k=5
        )
        key = lambda hl: [(h.seq_id, h.score, h.cigar, h.q_begin, h.s_begin) for h in hl]
        return [key(sw), key(nw), *[key(hl) for hl in many]]

    gpu, cpu = run("cuda"), run("cpu")
    if gpu != cpu:
        fail(5, "SSAContext on cuda differs from SSAContext on cpu")
    if not gpu[0] or any(c is None for _, _, c, _, _ in gpu[0]):
        fail(5, "sw_align returned no traced hits")
    say(f"phase 5 SSAContext(device='cuda'): sw_align ALIGNMENT ({len(gpu[0])} hits, "
        "traceback cross-check passed), nw_align, align_many equal device='cpu'")


# -- phase 6 ----------------------------------------------------------------


def phase6(dev):
    import torch

    from libssa_tpu_torch import matrices
    from libssa_tpu_torch.ops.scoring import make_profile
    from libssa_tpu_torch.ops import interseq, interseq_cuda

    rng = np.random.default_rng(0)
    m, B, n = 256, 8192, 512
    padded = matrices.builtin("BLOSUM62").padded()
    prof = torch.as_tensor(make_profile(rng.integers(0, 20, m).astype(np.uint8), padded)).to(dev)
    subj = torch.as_tensor(rng.integers(0, 20, (n, B)).astype(np.int8)).to(dev)
    lens = torch.full((B,), n, dtype=torch.int32, device=dev)
    kw = dict(local=True, track_range=True, dtype="float32")

    def k1():
        return interseq_cuda.interseq_scores_cuda(prof, subj, lens, 12, 1, **kw)

    def plain():
        return interseq.interseq_scores(prof, subj, lens, 12, 1, **kw)

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            out = fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps, out

    tp1, ref = timed(plain, 3)
    tk1, got = timed(k1, 20)
    tk2, _ = timed(k1, 20)
    tp2, _ = timed(plain, 3)
    err = max((a.long() - b.long()).abs().max().item() for a, b in zip(got, ref))
    if err != 0:
        fail(6, f"K1 differs from plain at the bench shape (max |diff| {err})")
    t_k1, t_plain = min(tk1, tk2), min(tp1, tp2)
    gcups = m * B * n / (t_k1 * 1e-3) / 1e9
    say(f"phase 6 bench kernel shape m={m} B={B} n={n} SW track_range: "
        f"K1 {t_k1:.3f} ms ({gcups:.2f} GCUPS), plain {t_plain:.3f} ms "
        f"({m * B * n / (t_plain * 1e-3) / 1e9:.2f} GCUPS); runs plain,K1,K1,plain: "
        f"{tp1:.3f} {tk1:.3f} {tk2:.3f} {tp2:.3f} ms")
    return t_k1, t_plain, err


def cuda_ms(fn, reps=3):
    """Min of ``reps`` CUDA-event timings after one warm-up: (ms, last output)."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return min(times), out


def build_kernels():
    """Phase 1: one nvcc per source (and per K3 stage-cut set), all started
    together."""
    import concurrent.futures
    import functools

    from libssa_tpu_torch.ops import interseq_cuda, longpair_cuda, ring_block_cuda

    t0 = time.perf_counter()

    def build(lib):
        lib()
        return time.perf_counter() - t0

    from libssa_tpu_torch.experiments import _common, r3_banded_bisect, r3_lp_bisect

    cuts = [functools.partial(longpair_cuda._lib, r3_banded_bisect.CUTS[v])
            for v in r3_banded_bisect.CUTS if v != "full"]
    libs = (interseq_cuda._lib, longpair_cuda._lib, ring_block_cuda._lib,
            functools.partial(_common.lib, "chain"), functools.partial(_common.lib, "tile"),
            r3_lp_bisect._lib, *cuts)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        t_k1, t_k3, t_k2, t_chain, t_tile, t_rs, *t_cuts = pool.map(build, libs)
    say(f"phase 1 build K1 ({K1_SOURCE}), K3 ({K3_SOURCE}), K2 ({K2_SOURCE}), the probes "
        f"({PROBES_SOURCE} in two builds, {ROWSWEEP_SOURCE}) and K3's {len(cuts)} stage-cut "
        f"builds, nvcc sm_90a in parallel: ok, K1 {t_k1:.1f} s, K3 {t_k3:.1f} s, K2 "
        f"{t_k2:.1f} s, probes {t_chain:.1f} s (chain) and {t_tile:.1f} s (tile), row sweep "
        f"{t_rs:.1f} s, stage cuts {max(t_cuts):.1f} s")


# -- phase 7 ----------------------------------------------------------------


def phase7(dev):
    import torch

    from libssa_tpu_torch import matrices, oracle
    from libssa_tpu_torch.constants import SymType
    from libssa_tpu_torch.ops import longpair, longpair_cuda

    rng = np.random.default_rng(77)
    mats = {
        "protein": (matrices.builtin("BLOSUM62").padded(), 20),
        "acgt": (matrices.constant_scoring(5, -4, SymType.NUCLEOTIDE).padded(), 4),
        "entry>256": (matrices.constant_scoring(300, -200, SymType.AMINOACID).padded(), 20),
    }
    shapes = ((1, 1), (1, 300), (300, 1), (1000, 37), (37, 1000), (3000, 200),
              (257, 1500), (5000, 4000))
    n_cases, max_err = 0, 0
    for name, (mat, hi) in mats.items():
        mat_d = torch.as_tensor(mat.astype(np.int32)).to(dev)
        for k, (m, n) in enumerate(shapes if name != "entry>256" else shapes[3:6]):
            q = torch.as_tensor(rng.integers(0, hi, m).astype(np.uint8)).to(dev)
            s = torch.as_tensor(rng.integers(0, hi, n).astype(np.uint8)).to(dev)
            Q, R = oracle.gap_qr(*((11, 1), (5, 2))[k % 2])
            for local in (True, False):
                want = longpair.longpair_score_plain(q, s, mat_d, Q, R, local, torch.int64)
                for dt in (torch.int32, torch.int64):
                    for ch in longpair_cuda.BAND_ROWS:
                        got = longpair_cuda.longpair_score_cuda(
                            q, s, mat_d, Q, R, local, dt, rows_per_thread=ch)
                        torch.cuda.synchronize()
                        err = abs(int(got) - int(want))
                        max_err = max(max_err, err)
                        n_cases += 1
                        if got.dtype != dt or err:
                            fail(7, f"K3 {int(got)} != plain {int(want)} ({name}, m={m}, "
                                    f"n={n}, local={local}, {dt}, rows {ch})")
    # A matrix whose entries push score_bound past 2**31: the routing
    # itself picks int64.
    big = np.full((32, 32), -64, np.int64)
    big[:20, :20] = -(2**20)
    np.fill_diagonal(big[:20, :20], 2**27)
    q = rng.integers(0, 20, 600).astype(np.uint8)
    s = np.concatenate([q[5:], rng.integers(0, 20, 40).astype(np.uint8)])
    if longpair.score_bound(len(q), len(s), big, 11, 1) < longpair.INT32_LIMIT:
        fail(7, "the large-entry matrix did not reach the int64 route")
    for local in (True, False):
        got = longpair.longpair_score(q, s, big, 10, 1, local, device=dev)
        want = longpair.longpair_score(q, s, big, 10, 1, local, kernel="plain", device=dev)
        ref = (oracle.sw_score if local else oracle.nw_score)(q, s, big[:20, :20], 10, 1)
        if not got == want == ref or abs(ref) < 2**31:
            fail(7, f"int64 route: K3 {got}, plain {want}, oracle {ref}")
        n_cases += 1
    say(f"phase 7 K3 vs plain on the card: {n_cases} cases equal (SW/NW, int32/int64, "
        f"rows per thread {longpair_cuda.BAND_ROWS}, protein/ACGT/entry>256, score "
        f"past 2**31 also equal to the oracle); max |diff| {max_err} (tolerance: exact)")
    return max_err


# -- phase 8 ----------------------------------------------------------------


def pair_cases():
    """Phase 8's pairs (seed 88): a homolog of a random query, with
    substitutions at 15% and a few indels, cut to the query's length."""
    from libssa_tpu_torch.constants import AlignType, SymType

    rng = np.random.default_rng(88)

    def related(codes, hi, rate):
        out = codes.copy()
        hit = rng.random(len(out)) < rate
        out[hit] = rng.integers(0, hi, int(hit.sum()))
        cut = rng.integers(0, len(out) - 100, 4)
        out = np.delete(out, np.concatenate([np.arange(c, c + 7) for c in cut[:2]]))
        for c in cut[2:]:
            out = np.insert(out, c, rng.integers(0, hi, 5))
        return out

    cases = []
    for label, nucleotide, m, hi, modes in (
        (f"8a {PAIR_PROTEIN} x {PAIR_PROTEIN} protein BLOSUM62 11/1", False,
         PAIR_PROTEIN, 20, (AlignType.SW, AlignType.NW)),
        (f"8b {PAIR_GENOME} x {PAIR_GENOME} ACGT 5/-4 10/1 both strands", True,
         PAIR_GENOME, 4, (AlignType.SW,)),
    ):
        symtype = SymType.NUCLEOTIDE if nucleotide else SymType.AMINOACID
        q_codes = rng.integers(0, hi, m).astype(np.uint8)
        s_codes = related(q_codes, hi, 0.15)
        s_codes = np.concatenate([s_codes, rng.integers(0, hi, m)])[:m].astype(np.uint8)
        cases.append((label, nucleotide, symtype, q_codes, s_codes, modes))
    return cases


def phase8(dev):
    import torch

    from libssa_tpu_torch import alphabet, matrices, oracle
    from libssa_tpu_torch.constants import AlignType, ComputeMode, Strand, SymType
    from libssa_tpu_torch.api import SSAContext
    from libssa_tpu_torch.ops import longpair, longpair_cuda

    def context(nucleotide):
        ctx = SSAContext(device="cuda")
        if nucleotide:
            ctx.init_symbol_translation(SymType.NUCLEOTIDE, Strand.BOTH)
            ctx.init_constant_scoring(5, -4)
            ctx.init_gap_penalties(10, 1)
        else:
            ctx.init_score_matrix("BLOSUM62")
            ctx.init_gap_penalties(11, 1)
        return ctx

    cases = pair_cases()

    # The main path: counts from zero, read right after.
    longpair_cuda.launches = 0
    results = []
    for label, nucleotide, symtype, q_codes, s_codes, modes in cases:
        ctx = context(nucleotide)
        q = ctx.init_sequence_fasta(alphabet.decode(q_codes, symtype))
        subject = alphabet.decode(s_codes, symtype)
        for at in modes:
            a = ctx.align_pair(q, subject, at, ComputeMode.SCORE)
            results.append((label, at, a))
    launches = longpair_cuda.launches
    if launches <= 0:
        fail(8, "K3 was not launched by align_pair(mode=SCORE)")

    lines, sw16 = [], None
    max_err = 0
    for (label, nucleotide, symtype, q_codes, s_codes, modes), k in zip(
            cases, (0, len(cases[0][5]))):
        ctx = context(nucleotide)
        ctx.params.kernel = "plain"
        q = ctx.init_sequence_fasta(alphabet.decode(q_codes, symtype))
        subject = alphabet.decode(s_codes, symtype)
        for i, at in enumerate(modes):
            _, _, a = results[k + i]
            p = ctx.align_pair(q, subject, at, ComputeMode.SCORE)
            if (a.score, a.strand, a.stats.cells) != (p.score, p.strand, p.stats.cells):
                fail(8, f"{label} {at.name}: K3 ({a.score}, {a.strand}) != plain "
                        f"({p.score}, {p.strand})")
            max_err = max(max_err, abs(a.score - p.score))
            # K3 alone on the best strand, on the tensors the API builds.
            qc = dict(q.sequences)[a.strand]
            Q, R = oracle.gap_qr(ctx.gap_open, ctx.gap_extend)
            mat = torch.as_tensor(ctx.matrix.padded().astype(np.int32)).to(dev)
            qt = torch.as_tensor(qc).to(dev)
            st = torch.as_tensor(alphabet.encode(subject, symtype)).to(dev)
            dt = (torch.int32 if longpair.score_bound(len(qc), len(st), ctx.matrix.padded(),
                                                      Q, R) < longpair.INT32_LIMIT
                  else torch.int64)
            local = at is AlignType.SW
            ms, out = cuda_ms(lambda: longpair_cuda.longpair_score_cuda(
                qt, st, mat, Q, R, local, dt))
            if int(out) != a.score:
                fail(8, f"{label}: timed K3 run gave {int(out)}, not {a.score}")
            cells = len(qc) * len(st)
            plain_ms = 1e3 * p.stats.seconds / len(q.sequences)
            lines.append(f"{label} {at.name}: score {a.score} (strand {a.strand}); K3 "
                         f"{ms:.3f} ms ({cells / ms / 1e6:.2f} GCUPS, rows per thread "
                         f"{longpair_cuda.band_rows(len(qc), torch.cuda.get_device_properties(dev).multi_processor_count)}); "
                         f"plain {plain_ms:.1f} ms a strand "
                         f"({cells / plain_ms / 1e6:.3f} GCUPS); align_pair wall K3 "
                         f"{a.stats.seconds:.3f} s, plain {p.stats.seconds:.3f} s")
            if sw16 is None:
                sw16 = (ms, plain_ms)
    for line in lines:
        say("phase 8 " + line)
    say(f"phase 8 align_pair(mode=SCORE) equals the plain version in every case; "
        f"K3 launches {launches}")
    return launches, max_err, sw16


# -- phase 9 ----------------------------------------------------------------


def phase9(dev):
    import torch

    from libssa_tpu_torch import matrices, oracle
    from libssa_tpu_torch.ops.scoring import make_profile
    from libssa_tpu_torch.ops import interseq, interseq_cuda

    rng = np.random.default_rng(99)
    m = n = BATCH_M
    P = BATCH_P
    b62 = matrices.builtin("BLOSUM62")
    q = rng.integers(0, 20, m).astype(np.uint8)
    subj = rng.integers(0, 20, (P, n)).astype(np.uint8)
    prof = torch.as_tensor(make_profile(q, b62.padded())).to(dev)
    s_d = torch.as_tensor(subj).to(dev)
    lens = torch.full((P,), n, dtype=torch.int32, device=dev)
    interseq_cuda.launches = 0
    got = interseq.pair_scores_batch(prof, s_d, lens, 12, 1, local=False)
    torch.cuda.synchronize()
    launches = interseq_cuda.launches
    if launches <= 0:
        fail(9, "K1 was not launched by pair_scores_batch")
    t0 = time.perf_counter()
    want = interseq.pair_scores_batch(prof, s_d, lens, 12, 1, local=False, kernel="plain")
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    if not torch.equal(got, want):
        fail(9, "pair_scores_batch on K1 differs from the plain version")
    for p in (0, 1, P - 1):
        ref = oracle.nw_score(q, subj[p], b62.scores, 11, 1)
        if int(got[p]) != ref:
            fail(9, f"pair {p}: {int(got[p])} != oracle {ref}")
    ms, _ = cuda_ms(lambda: interseq.pair_scores_batch(prof, s_d, lens, 12, 1, local=False))
    say(f"phase 9 pair_scores_batch m=n={m} P={P} NW BLOSUM62 11/1 on K1: {ms:.3f} ms, "
        f"{P / ms * 1e3:.0f} pairs/s, {m * n * P / ms / 1e6:.2f} GCUPS (plain {plain_ms:.1f} "
        f"ms); equal to the plain version, pairs 0, 1, {P - 1} equal to the oracle; "
        f"K1 launches {launches}")

# -- phase 10 ----------------------------------------------------------------


def dp_bounds(m, n, Q, R, local, dt):
    """The boundaries of a whole pair's DP as K2 takes them (CPU tensors):
    leftH (m + 1,) corner first, leftE (m,), topH (n,), topF (n,)."""
    import torch

    if local:
        leftH, topH = torch.zeros(m + 1, dtype=dt), torch.zeros(n, dtype=dt)
    else:
        leftH = torch.cat([torch.zeros(1, dtype=dt), -(Q + R * torch.arange(m, dtype=dt))])
        topH = -(Q + R * torch.arange(n, dtype=dt))
    return leftH, leftH[1:] - Q + R, topH, topH - Q + R


def real_bounds(q, s, mat, Q, R, local, r0, c0, RB, W, dt):
    """The boundaries of tile (r0, c0, RB, W) in the pair's real DP, from the
    plain version over the strips to its left and above it (CPU tensors)."""
    import torch

    from libssa_tpu_torch.ops.ring_block import ring_block_plain

    lH, lE, tH, tF = dp_bounds(len(q), len(s), Q, R, local, dt)
    colH, colE = lH, lE  # H, E at column c0 - 1 for rows -1 .. r0 + RB - 1
    if c0 > 0:
        left = ring_block_plain(q[:r0 + RB], s[:c0], mat, Q, R, local, lH[:r0 + RB + 1],
                                lE[:r0 + RB], tH[:c0], tF[:c0])
        colH, colE = torch.cat([tH[c0 - 1:c0], left.rightH]), left.rightE
    topH, topF = tH[c0:c0 + W], tF[c0:c0 + W]  # H, F of row r0 - 1
    if r0 > 0:
        top = ring_block_plain(q[:r0], s[:c0 + W], mat, Q, R, local, lH[:r0 + 1], lE[:r0],
                               tH[:c0 + W], tF[:c0 + W])
        topH, topF = top.botH[c0:], top.botF[c0:]
    return colH[r0:r0 + RB + 1], colE[r0:r0 + RB], topH, topF


def tiles_diff(got, want) -> int:
    """Largest |difference| over K2's outputs; fails on a dtype mismatch."""
    err = 0
    for a, b in zip(got, want):
        if (a is None) != (b is None):
            raise AssertionError("one side lacks an output")
        if a is not None:
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"{a.dtype} {tuple(a.shape)} != {b.dtype} {tuple(b.shape)}")
            err = max(err, (a.long() - b.long()).abs().max().item())
    return err


def phase10(dev):
    import torch

    from libssa_tpu_torch import matrices, oracle
    from libssa_tpu_torch.ops import longpair_cuda, ring_block, ring_block_cuda
    from libssa_tpu_torch.ops.mm_device import DevicePair

    rng = np.random.default_rng(1010)
    padded = matrices.builtin("BLOSUM62").padded().astype(np.int32)
    mat_c, mat_d = torch.as_tensor(padded), torch.as_tensor(padded).to(dev)
    Q, R = oracle.gap_qr(11, 1)
    # (RB, W, r0, c0): RB or W = 1, tall, wide, square, a tile at the origin.
    shapes = ((1, 1, 5, 7), (1, 300, 40, 3), (300, 1, 2, 40), (2000, 37, 100, 60),
              (37, 3000, 60, 100), (700, 700, 0, 0), (513, 250, 31, 0), (250, 513, 0, 31))
    n_cases, max_err = 0, 0
    batch = {True: [], False: []}  # local -> [(q, s, bounds, plain)], int32
    for RB, W, r0, c0 in shapes:
        q = torch.as_tensor(rng.integers(0, 20, r0 + RB + 3).astype(np.uint8))
        s = torch.as_tensor(rng.integers(0, 20, c0 + W + 5).astype(np.uint8))
        q_d, s_d = q.to(dev), s.to(dev)
        for local in (True, False):
            for dt in (torch.int32, torch.int64):
                bounds = [b.contiguous().to(dev) for b in
                          real_bounds(q, s, mat_c, Q, R, local, r0, c0, RB, W, dt)]
                want = ring_block.ring_block_plain(q_d[r0:r0 + RB], s_d[c0:c0 + W], mat_d, Q,
                                                   R, local, *bounds)
                if dt == torch.int32:
                    batch[local].append((q_d[r0:r0 + RB], s_d[c0:c0 + W], bounds, want))
                for ch in ring_block_cuda.BAND_ROWS:
                    got = ring_block_cuda.ring_block_cuda(
                        q_d, s_d, [[r0, RB, c0, W]], mat_d, Q, R, local, *bounds,
                        rows_per_thread=ch)
                    torch.cuda.synchronize()
                    err = tiles_diff(got, want)
                    max_err = max(max_err, err)
                    n_cases += 1
                    if err:
                        fail(10, f"K2 differs from plain (RB={RB}, W={W}, at ({r0}, {c0}), "
                                 f"local={local}, {dt}, rows {ch}): max |diff| {err}")
    # Every tile above in one launch, SW and NW.
    for local, tiles in batch.items():
        qs = torch.cat([t[0] for t in tiles])
        ss = torch.cat([t[1] for t in tiles])
        rows = np.array([len(t[0]) for t in tiles])
        cols = np.array([len(t[1]) for t in tiles])
        jobs = np.stack([np.cumsum(rows) - rows, rows, np.cumsum(cols) - cols, cols], 1)
        flat = [torch.cat([t[2][k] for t in tiles]) for k in range(4)]
        got = ring_block_cuda.ring_block_cuda(qs, ss, jobs, mat_d, Q, R, local, *flat)
        want = [torch.cat(parts) if parts[0] is not None else None
                for parts in zip(*[t[3] for t in tiles])]
        torch.cuda.synchronize()
        err = tiles_diff(got, want)
        max_err = max(max_err, err)
        n_cases += 1
        if err:
            fail(10, f"the batched launch of {len(tiles)} tiles differs (local={local})")
    # One pair's tiles chained into its score: equal to K3's.
    m, n, RB, W = 3000, 2500, 1024, 1000
    q = torch.as_tensor(rng.integers(0, 20, m).astype(np.uint8)).to(dev)
    s = torch.as_tensor(rng.integers(0, 20, n).astype(np.uint8)).to(dev)
    for local in (True, False):
        lH, lE, tH, tF = (b.to(dev) for b in dp_bounds(m, n, Q, R, local, torch.int32))
        best = 0
        for r0 in range(0, m, RB):
            rb = min(RB, m - r0)
            left_H, left_E = lH[r0:r0 + rb + 1], lE[r0:r0 + rb]
            rowH, rowF = [], []
            for c0 in range(0, n, W):
                w = min(W, n - c0)
                out = ring_block_cuda.ring_block_cuda(
                    q, s, [[r0, rb, c0, w]], mat_d, Q, R, local, left_H.contiguous(),
                    left_E.contiguous(), tH[c0:c0 + w].contiguous(), tF[c0:c0 + w].contiguous())
                left_H, left_E = torch.cat([tH[c0 + w - 1:c0 + w], out.rightH]), out.rightE
                rowH.append(out.botH)
                rowF.append(out.botF)
                if local:
                    best = max(best, int(out.rowmax.max()))
            tH, tF = torch.cat(rowH), torch.cat(rowF)
        chained = best if local else int(tH[-1])
        k3 = int(longpair_cuda.longpair_score_cuda(q, s, mat_d, Q, R, local, torch.int32))
        n_cases += 1
        if chained != k3:
            fail(10, f"{m} x {n} in {RB} x {W} tiles on K2 scores {chained}, K3 {k3} "
                     f"(local={local})")
    # K2's time at phase 11a's first Myers-Miller level (both passes of the
    # root node of the 16,384^2 NW traceback), beside the plain version's.
    _, _, _, q8, s8, _ = pair_cases()[0]
    pair = DevicePair(q8, s8, padded, Q, R, device=dev)
    jobs, tbs = pair.level_jobs([(0, pair.m, 0, pair.n, False, False)])
    bounds = pair.bounds(jobs, tbs)
    # The launch alone: its job table, ticket map and outputs staged first.
    ms, got = cuda_ms(ring_block_cuda.stage(pair.q, pair.s, jobs, pair.matrix, Q, R, False,
                                            *bounds, codes_checked=True))
    # And the whole wrapper: staging, the code check and its wait included.
    ms_wrapper, _ = cuda_ms(lambda: ring_block_cuda.ring_block_cuda(
        pair.q, pair.s, jobs, pair.matrix, Q, R, False, *bounds))
    t0 = time.perf_counter()
    want = ring_block.ring_block_batch_plain(pair.q, pair.s, jobs, pair.matrix, Q, R, False,
                                             *bounds)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = tiles_diff(got, want)
    max_err = max(max_err, err)
    if err:
        fail(10, "K2 differs from plain at phase 11a's first level")
    cells = int((jobs[:, 1] * jobs[:, 3]).sum())
    say(f"phase 10 K2 vs plain on the card: {n_cases} cases equal (SW/NW, int32/int64, "
        f"rows per thread {ring_block_cuda.BAND_ROWS}, RB or W = 1, tall, wide, one launch "
        f"of {len(batch[True])} mixed tiles, {m} x {n} chained in {RB} x {W} tiles = K3's "
        f"score); max |diff| {max_err} (tolerance: exact). First level of 11a NW (2 tiles "
        f"of {jobs[0, 1]} x {jobs[0, 3]}): K2 launch alone {ms:.3f} ms ({cells / ms / 1e6:.2f} "
        f"GCUPS, min of 3), the whole wrapper {ms_wrapper:.3f} ms, plain {plain_ms:.1f} ms")
    return max_err, ms, plain_ms, cells


# -- phase 11 ----------------------------------------------------------------


def phase11(dev):
    from libssa_tpu_torch import alphabet, matrices, oracle
    from libssa_tpu_torch.api import SSAContext
    from libssa_tpu_torch.constants import AlignType, ComputeMode, SymType
    from libssa_tpu_torch.ops import ring_block_cuda
    from libssa_tpu_torch.search import leafnative
    from libssa_tpu_torch.search.hirschberg import _ops_score

    if not leafnative.native_available():
        fail(11, "the native leaf solver (csrc/leafalign.cpp) did not build")
    b62 = matrices.builtin("BLOSUM62")
    Q, R = oracle.gap_qr(11, 1)
    label8, _, _, q8, s8, _ = pair_cases()[0]
    rng = np.random.default_rng(111)
    qb = rng.integers(0, 20, TRACE_PAIR).astype(np.uint8)
    sb = rng.integers(0, 20, TRACE_PAIR).astype(np.uint8)
    pairs = ((f"11a {label8[3:]}", q8, s8),
             (f"11b {TRACE_PAIR} x {TRACE_PAIR} random protein BLOSUM62 11/1", qb, sb))

    def context(device):
        ctx = SSAContext(device=device)
        ctx.init_score_matrix("BLOSUM62")
        ctx.init_gap_penalties(11, 1)
        return ctx

    def decode(codes):
        return alphabet.decode(codes, SymType.AMINOACID)

    # The main path: counts from zero, read right after.
    gpu = context("cuda")
    ring_block_cuda.launches = 0
    runs = []
    for label, qc, sc in pairs:
        q, subject = gpu.init_sequence_fasta(decode(qc)), decode(sc)
        for at in (AlignType.SW, AlignType.NW):
            t0 = time.perf_counter()
            a = gpu.align_pair(q, subject, at, ComputeMode.ALIGNMENT)
            runs.append((label, at, qc, sc, a, time.perf_counter() - t0))
    launches = ring_block_cuda.launches
    if launches <= 0:
        fail(11, "K2 was not launched by align_pair(mode=ALIGNMENT)")

    cpu = context("cpu")
    for label, at, qc, sc, a, wall in runs:
        st = a.stats
        span = (a.q_begin, a.q_end, a.s_begin, a.s_end)
        ops = np.frombuffer(a.cigar.encode(), np.uint8)
        steps_q = int(np.isin(ops, (ord("M"), ord("D"))).sum())
        steps_s = int(np.isin(ops, (ord("M"), ord("I"))).sum())
        if (steps_q, steps_s) != (a.q_end - a.q_begin, a.s_end - a.s_begin):
            fail(11, f"{label} {at.name}: the path does not consume its span {span}")
        if at is AlignType.NW and span != (0, len(qc), 0, len(sc)):
            fail(11, f"{label} NW: span {span} is not the whole pair")
        rescored = _ops_score(qc[a.q_begin:a.q_end], sc[a.s_begin:a.s_end], b62.scores,
                              Q, R, list(a.cigar))
        if rescored != a.score:
            fail(11, f"{label} {at.name}: the path re-scores to {rescored}, not {a.score}")
        if label.startswith("11a"):
            c = cpu.align_pair(cpu.init_sequence_fasta(decode(qc)), decode(sc), at,
                               ComputeMode.ALIGNMENT)
            if (c.score, c.q_begin, c.q_end, c.s_begin, c.s_end, c.cigar) != (
                    a.score, *span, a.cigar):
                fail(11, f"{label} {at.name}: the card's traceback differs from the CPU's "
                         f"(score {a.score} vs {c.score}, span {span} vs "
                         f"{(c.q_begin, c.q_end, c.s_begin, c.s_end)})")
            check = f"equal to device='cpu' ({c.stats.aligner_seconds:.1f} s there)"
        else:
            k3 = gpu.align_pair(gpu.init_sequence_fasta(decode(qc)), decode(sc), at,
                                ComputeMode.SCORE)
            if k3.score != a.score:
                fail(11, f"{label} {at.name}: traceback score {a.score} != K3's {k3.score}")
            check = f"= K3's score ({k3.stats.seconds:.3f} s)"
        say(f"phase 11 {label} {at.name}: score {a.score}, span {span}, {len(a.cigar)} ops, "
            f"re-scored equal, {check}; {wall:.3f} s wall: K2 launches "
            f"{st.aligner_dispatches} over {st.aligner_levels} levels, device "
            f"{st.aligner_device_seconds:.3f} s, host "
            f"{st.aligner_seconds - st.aligner_device_seconds:.3f} s")
    say(f"phase 11 align_pair(mode=ALIGNMENT) on the card: every check passed; K2 "
        f"launches {launches}; native leaf solver used")
    # Where 11b NW's wall time goes: one more run under cProfile (host
    # functions by own time; K2's time shows where the host waits on it).
    import cProfile
    import pstats

    q, subject = gpu.init_sequence_fasta(decode(qb)), decode(sb)
    prof = cProfile.Profile()
    prof.runcall(gpu.align_pair, q, subject, AlignType.NW, ComputeMode.ALIGNMENT)
    stats = pstats.Stats(prof)
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:8]
    say("phase 11 profile of 11b NW (own seconds, calls): " + "; ".join(
        f"{fn[2]} ({os.path.basename(fn[0])}:{fn[1]}) {v[2]:.3f} s, {v[1]}" for fn, v in top)
        + f"; total {stats.total_tt:.3f} s")
    return launches

# -- phase 12 ----------------------------------------------------------------


def timed_pair(kernel, plain):
    """(kernel ms, plain ms) on CUDA events, each after a warm-up: the
    kernel's the min of 3, the plain version's one timing."""
    return cuda_ms(kernel)[0], cuda_ms(plain, 1)[0]


def rate_bound(ops: float, type_name: str, nbytes: int):
    """(bound ms, bound_by) for ``ops`` elementwise ops of ``type_name`` at
    its rate in ``OPS_PER_S``."""
    t_ops, t_bytes = ops / OPS_PER_S[type_name], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase12(dev):
    """The probes of experiments/ on the card: every counterpart at its JAX
    shape (the counts read right after), each exact variant against its
    plain version at reduced trips, the rates table and K3's stage cuts."""
    import torch

    from libssa_tpu_torch.ops import longpair_cuda
    from libssa_tpu_torch.experiments import _common as C
    from libssa_tpu_torch.experiments import (
        op_rate_probe, r2_dtype_probe, r2_ilp_probe, r2_rate_probe, r3_banded_bisect,
        r3_carry_probe, r3_longpair_probe, r3_lp_bisect, r3_roll_probe)

    mods = (op_rate_probe, r2_rate_probe, r2_ilp_probe, r2_dtype_probe, r3_carry_probe,
            r3_roll_probe, r3_longpair_probe, r3_banded_bisect, r3_lp_bisect)
    t0 = time.perf_counter()
    clock0 = C.sample()
    # The probes' path: counts from zero, read right after.
    for mod in mods:
        mod.launches = 0
    op_rate = [op_rate_probe.measure(op, ty, dev) for op in op_rate_probe.OPS
               for ty in op_rate_probe.types_of(op)]
    lat = [r2_rate_probe.measure(ty, op, r, c, dev) for ty, op, r, c in r2_rate_probe.CASES]
    thr = [r2_ilp_probe.measure(ty, op, r, c, dev) for ty, op, r, c in r2_ilp_probe.CASES]
    matrix = {(ty, name): r2_dtype_probe.probe_op(ty, name, dev)[0]
              for ty in r2_dtype_probe.TYPES for name in r2_dtype_probe.ops_of(ty)}
    part_b = [r2_dtype_probe.measure_rate(ty, name, dev) for ty in r2_dtype_probe.TYPES
              for name in r2_dtype_probe.RATE_OPS if matrix[(ty, name)] == "EXACT"]
    carry = [r3_carry_probe.measure(v, dev) for v in r3_carry_probe.VARIANTS]
    rolls = [r3_roll_probe.measure(name, dev) for name in r3_roll_probe.PROBES]
    lp2 = [r3_longpair_probe.measure(name, dev) for name in r3_longpair_probe.PROBES]
    cuts = {name: r3_banded_bisect.measure(name, dev) for name in r3_banded_bisect.PAIRS}
    sweep = [r3_lp_bisect.measure(v, dev) for v in r3_lp_bisect.VARIANTS]
    launches = {mod.__name__.rsplit(".", 1)[1]: mod.launches for mod in mods}
    clock1 = C.sample()
    t_path = time.perf_counter() - t0
    for name, n in launches.items():
        if n <= 0:
            fail(12, f"{name}'s kernel was not launched")
    bad = [k for k, st in matrix.items() if st != "EXACT"]
    if bad:
        fail(12, f"r2_dtype part A: not EXACT on the card: {bad}")

    # Each exact variant against its plain version (reduced trips where the
    # plain loop would be long: stated in each line).
    err = {}
    for op in op_rate_probe.OPS:  # 2 trips x 4 reps
        for ty in op_rate_probe.types_of(op):
            x = op_rate_probe.tile_input(ty, op_rate_probe.COPIES, dev)
            got = op_rate_probe.stage(x, op, ty, 4, iters=2)()
            want = op_rate_probe.plain(x, op, 4, iters=2)
            if not torch.equal(got, want):
                fail(12, f"op_rate {op} {ty} differs from the plain version")
    err["op_rate_probe"] = 0
    for mod, cases in ((r2_rate_probe, r2_rate_probe.CASES), (r2_ilp_probe, r2_ilp_probe.CASES)):
        for ty, op, r, c in cases:  # 5 reps
            a, b = r2_rate_probe.inputs(ty, r, c, dev, seed=3)
            b = a.flip(0)  # a non-zero b
            got = mod.stage(a, b, op, ty, 5)()
            if not torch.equal(got, mod.plain(a, b, op, 5)):
                fail(12, f"{mod.__name__} {ty} {op} differs from the plain version")
        err[mod.__name__.rsplit(".", 1)[1]] = 0
    for ty in r2_dtype_probe.TYPES:  # part B's ops, 3 reps
        a, b = r2_dtype_probe.inputs_b(ty, dev)
        for name in r2_dtype_probe.RATE_OPS:
            if not torch.equal(r2_dtype_probe.stage(name, ty, a, b, 3)(),
                               r2_dtype_probe.plain(name, a, b, 3)):
                fail(12, f"r2_dtype part B {ty} {name} differs from the plain version")
    err["r2_dtype_probe"] = 0
    x = r3_carry_probe.tile_input(3, dev)
    for v in r3_carry_probe.VARIANTS:  # 40 trips
        if not torch.equal(r3_carry_probe.stage(x, v, 40)(), r3_carry_probe.plain(x, v, 40)):
            fail(12, f"r3_carry {v} differs from the plain version")
    err["r3_carry_probe"] = 0
    for mod, probes in ((r3_roll_probe, r3_roll_probe.PROBES),
                        (r3_longpair_probe, r3_longpair_probe.PROBES)):
        for name, spec in probes.items():  # 12 applications
            x = r3_roll_probe.tile_input(spec[1], 4, dev)
            got = r3_roll_probe.stage(x, spec, 12, None)()
            if not torch.equal(got, r3_roll_probe.plain(x, spec, 12)):
                fail(12, f"{mod.__name__} {name} differs from the plain version")
        err[mod.__name__.rsplit(".", 1)[1]] = 0
    q, s, mat = (torch.as_tensor(a).to(dev) for a in r3_lp_bisect.pair())
    sweep_err = 0
    for v in r3_lp_bisect.VARIANTS:  # 1,024 rows x 4,096 columns
        got = r3_lp_bisect.stage(q[:1024], s[:4096], mat, 11, 1, v, copies=2)()
        want = r3_lp_bisect.plain(q[:1024], s[:4096], mat, 11, 1, v)
        sweep_err = max(sweep_err, int((got.long() - want).abs().max()))
    k3_16k = int(longpair_cuda.longpair_score_cuda(q, s, mat, 11, 1, True, torch.int32))
    if sweep_err or sweep[0]["score"] != k3_16k:
        fail(12, f"row sweep differs: max |diff| {sweep_err}; 16k full "
                 f"{sweep[0]['score']} vs K3 {k3_16k}")
    err["r3_lp_bisect"] = 0
    qb, sb, matb, Qb, Rb = r3_banded_bisect.pair("16k protein", dev)
    k3_err = 0
    for v in r3_banded_bisect.CUTS:  # each build terminates; full is exact (3000 x 2000)
        out = r3_banded_bisect.stage(qb[:3000], sb[:2000], matb, Qb, Rb, v)()
        torch.cuda.synchronize()
        if v == "full":
            k3_err = abs(int(out) - int(r3_banded_bisect.plain(qb[:3000], sb[:2000], matb, Qb,
                                                               Rb)))
    if k3_err:
        fail(12, f"K3 (default build) differs from plain by {k3_err}")
    say(f"phase 12 probes' path {t_path:.1f} s ({clock0} -> {clock1}: clocks.sm, power.draw, "
        f"power.limit); launches {launches}; every exact variant equals its plain version "
        "(op_rate 2 trips x 4 reps; r2_rate, r2_ilp 5 reps; r2_dtype part A once, part B 3 "
        "reps; r3_carry 40 trips; r3_roll, r3_longpair 12 applications; row sweep 1,024 x "
        "4,096, and 16,384^2 full = K3's score; K3 default build 3,000 x 2,000; tolerance "
        "exact); r2_dtype part A: all EXACT")
    sms = C.sm_count(dev)
    say("phase 12 rates (one H100; ns a dependent op at one warp an SM; G element-ops/s "
        "at full occupancy, card and a SM; elem-ops count plain ops: max_add 2, max3 2, "
        "max3_relu 3, dpmix 5):")
    thr_by = {(m["type"], m["op"], m["rows"]): m for m in thr}
    for m in lat:
        t = thr_by.get((m["type"], m["op"], m["rows"]))
        tp = (f"{t['gops_card']:9.1f} card {t['gops_card'] / sms:7.2f} a SM" if t
              else "  (latency only)")
        say(f"phase 12 rate {m['type']:6s} {m['op']:14s} ({m['rows']},{m['cols']}): latency "
            f"{m['ns_dependent']:7.3f} ns, {m['gelem_s']:9.1f} G elem/s at one warp an SM; "
            f"throughput {tp}")
    for t in thr:
        if (t["type"], t["op"]) not in {(m["type"], m["op"]) for m in lat}:
            say(f"phase 12 rate {t['type']:6s} {t['op']:14s} ({t['rows']},{t['cols']}): "
                f"throughput {t['gops_card']:9.1f} card {t['gops_card'] / sms:7.2f} a SM")
    # The bound's rates against this run's: one instruction an application.
    for key, ops in (("i32", ("add", "max")), ("dpx", ("max_add_dpx", "max3_dpx", "max3_relu_dpx"))):
        got = max(t["gapps_card"] for t in thr if t["type"] == "i32" and t["op"] in ops)
        note = "" if got * 1e9 <= OPS_PER_S[key] else " (above it: raise OPS_PER_S)"
        say(f"phase 12 bound rate {key}: measured {got:.1f} G instructions/s, the bound "
            f"takes {OPS_PER_S[key] / 1e9:.1f}{note}")
    for m in op_rate:
        say(f"phase 12 op_rate {m['op']:9s} {m['type']:6s}: {m['ns_per_op_tile']:8.4f} ns an op "
            f"a (256, 512) tile, {m['gops_card']:9.1f} G elem/s card, {m['gops_sm']:7.2f} a SM")
    for m in part_b:
        say(f"phase 12 r2_dtype B {m['type']:6s} {m['op']:9s}: {m['gelem_s']:9.1f} G elem/s "
            f"(256, 2048) one tile")
    for m in rolls + lp2:
        extra = (f", {m['gops_card']:9.1f} G elem/s card, {m['gops_sm']:7.2f} a SM"
                 if "gops_card" in m else f" ({m['ms']:.3f} ms / {r3_longpair_probe.ITERS})")
        say(f"phase 12 roll {m['name']:18s}: {m['ns_op_tile']:8.4f} ns an op a (8, 2048) "
            f"tile{extra}")
    for m in carry:
        say(f"phase 12 carry {m['variant']:10s}: {m['ns_trip']:8.1f} ns a trip, one tile; "
            f"{m['copies']} tiles {m['ns_trip_card']:8.1f} ns a trip")
    for m in sweep:
        say(f"phase 12 row sweep 16k {m['variant']:6s}: one SM {m['ms_one']:8.3f} ms "
            f"({m['gcups_one']:6.2f} GCUPS), {sms} copies {m['ms_card']:8.3f} ms "
            f"({m['gcups_card']:7.2f} GCUPS), score {m['score']}"
            f"{'' if m['variant'] == 'full' else ' [timed only]'}")
    for name, r in cuts.items():
        side = r3_banded_bisect.PAIRS[name][0]
        say(f"phase 12 K3 stage cuts {name} SW (score {r['score']}): " + "; ".join(
            f"{v} {r[v]:.3f} ms" for v in r3_banded_bisect.CUTS)
            + f" (production K3 = full, timed first and last; {side}^2 cells)")

    # The kernels line: one representative run per counterpart, kernel and
    # plain on the same work.
    entries = []

    def entry(name, mod_name, source, replaces, ms, plain_ms, ops, ty, nbytes):
        b_ms, b_by = rate_bound(ops, ty, nbytes)
        entries.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[mod_name], "max_abs_err": err[mod_name],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None})

    x = op_rate_probe.tile_input("f32", op_rate_probe.COPIES, dev)
    n_el = x.numel()
    k, p = timed_pair(op_rate_probe.stage(x, "max", "f32", 8),
                      lambda: op_rate_probe.plain(x, "max", 8))
    entry("op_rate tile probe (f32 max, 16 tiles of 256 x 512, 2048 x 8 applications)",
          "op_rate_probe", PROBES_SOURCE, "experiments/op_rate_probe.py:47", k, p,
          2 * n_el * op_rate_probe.ITERS * 8, "f32", 8 * n_el)
    a, b = r2_rate_probe.inputs("i32", 256, 1024, dev)
    k, p = timed_pair(r2_rate_probe.stage(a, b, "add", "i32", r2_rate_probe.HI),
                      lambda: r2_rate_probe.plain(a, b, "add", r2_rate_probe.HI))
    entry("r2_rate chain probe (int32 add, 256 x 1024, 4096 reps, one warp an SM)",
          "r2_rate_probe", PROBES_SOURCE, "experiments/r2_rate_probe.py:47", k, p,
          a.numel() * r2_rate_probe.HI, "i32", 12 * a.numel())
    a, b = r2_ilp_probe.inputs("f32", 256, 1024, dev)
    k, p = timed_pair(r2_ilp_probe.stage(a, b, "dpmix", "f32", r2_ilp_probe.HI),
                      lambda: r2_ilp_probe.plain(a, b, "dpmix", r2_ilp_probe.HI))
    entry("r2_ilp streams probe (f32 dpmix, 256 x 1024, 4 streams, 1024 reps)",
          "r2_ilp_probe", PROBES_SOURCE, "experiments/r2_ilp_probe.py:55", k, p,
          5 * 4 * a.numel() * r2_ilp_probe.HI, "f32", 12 * a.numel())
    a, b = r2_dtype_probe.inputs_b("i32", dev)
    k, p = timed_pair(r2_dtype_probe.stage("max_roll", "i32", a, b, r2_dtype_probe.HI),
                      lambda: r2_dtype_probe.plain("max_roll", a, b, r2_dtype_probe.HI))
    entry("r2_dtype probe (part B int32 max_roll, 256 x 2048, 256 reps; part A's matrix "
          "on 32 x 256)", "r2_dtype_probe", PROBES_SOURCE,
          "experiments/r2_dtype_probe.py:75, :82, :108", k, p,
          a.numel() * r2_dtype_probe.HI, "i32", 12 * a.numel())
    x = r3_carry_probe.tile_input(1, dev)
    k, p = timed_pair(r3_carry_probe.stage(x, "single", 256),
                      lambda: r3_carry_probe.plain(x, "single", 256))
    entry("r3_carry probe (single, one 8 x 2048 tile, 256 of the 16384 trips)",
          "r3_carry_probe", PROBES_SOURCE, "experiments/r3_carry_probe.py:103", k, p,
          24 * x.numel() * 256, "f32", 8 * x.numel())
    spec = r3_roll_probe.PROBES["roll_lane1+max"]
    x = r3_roll_probe.tile_input("f32", r3_roll_probe.copies_for(dev), dev)
    k, p = timed_pair(r3_roll_probe.stage(x, spec, r3_roll_probe.LO, None),
                      lambda: r3_roll_probe.plain(x, spec, r3_roll_probe.LO))
    entry(f"r3_roll probe (roll_lane1+max, {x.shape[0]} tiles of 8 x 2048, 1024 "
          "applications; bound: f32 add and max, shuffles uncounted)", "r3_roll_probe",
          PROBES_SOURCE, "experiments/r3_roll_probe.py:34", k, p,
          2 * x.numel() * r3_roll_probe.LO, "f32", 8 * x.numel())
    spec = r3_longpair_probe.PROBES["roll_lane1"]
    k, p = timed_pair(r3_roll_probe.stage(x, spec, r3_longpair_probe.ITERS, None),
                      lambda: r3_roll_probe.plain(x, spec, r3_longpair_probe.ITERS))
    entry(f"r3_longpair probe 2 (roll_lane1, {x.shape[0]} tiles of 8 x 2048, 512 "
          "applications; bound: f32 adds, shuffles uncounted)", "r3_longpair_probe",
          PROBES_SOURCE, "experiments/r3_longpair_probe.py:41", k, p,
          x.numel() * r3_longpair_probe.ITERS, "f32", 8 * x.numel())
    # bare's score is wrong by design: it has no plain version and no error,
    # so both are null (the default build, K3 itself, is checked above).
    b_ms, b_by = bound_ms(16384 ** 2, CELL_SW, 2 * 16384)
    entries.append({
        "name": "K3 stage cuts (csrc/longpair.cu with K3_PROBE_* on; bare = all six, 16,384^2 "
                "SW; timed only, no plain version)", "route": "cuda", "source": K3_SOURCE,
        "replaces": "experiments/r3_banded_bisect.py:138, :255",
        "launches": launches["r3_banded_bisect"], "max_abs_err": None,
        "ms": cuts["16k protein"]["bare"], "plain_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None})
    qs, ss = q[:2048], s
    k, p = timed_pair(r3_lp_bisect.stage(qs, ss, mat, 11, 1, "full"),
                      lambda: r3_lp_bisect.plain(qs, ss, mat, 11, 1, "full"))
    b_ms, b_by = bound_ms(2048 * 16384, CELL_SW, 2048 + 16384)
    entries.append({
        "name": "row sweep (csrc/lp_rowsweep.cu, full, 2,048 x 16,384 on one SM)",
        "route": "cuda", "source": ROWSWEEP_SOURCE, "replaces": "experiments/r3_lp_bisect.py:197",
        "launches": launches["r3_lp_bisect"], "max_abs_err": err["r3_lp_bisect"], "ms": k,
        "plain_ms": p, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    say(f"phase 12 done in {time.perf_counter() - t0:.1f} s")
    return entries


def bound_ms(cells: int, cell: tuple[float, float], nbytes: int) -> tuple[float, str]:
    """The least time for ``cells`` DP cells of ``cell`` = (int32 adds, DPX)
    each, in ms, and what bounds it."""
    adds, dpx = cell
    t_ops = cells * max(adds / OPS_PER_S["i32"], dpx / OPS_PER_S["dpx"])
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    # Fails here, before any output, where the port is not beside the script.
    from libssa_tpu_torch.ops import interseq_cuda, longpair_cuda, ring_block_cuda  # noqa: F401

    say(card_line())  # name, power limit: as nvidia-smi prints them
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)

    build_kernels()
    err2 = phase2(dev)
    launches, _, _ = phase34(dev)
    phase5()
    t_k1, t_plain, err6 = phase6(dev)
    err7 = phase7(dev)
    k3_launches, err8, (t_k3, t_k3_plain) = phase8(dev)
    phase9(dev)
    err10, t_k2, t_k2_plain, k2_cells = phase10(dev)
    k2_launches = phase11(dev)
    probe_entries = phase12(dev)

    # bound_ms at each timed shape: K1 at bench.py's kernel shape (subject
    # codes in, one score and range out per subject), K3 at 8a SW (codes in),
    # K2 at 11a's first level (codes, boundaries and outputs: 4 words a row
    # and a column, int32).
    b_k1 = bound_ms(256 * 8192 * 512, CELL_SW_TRACK, 8192 * 512 + 8192 * 12)
    b_k3 = bound_ms(PAIR_PROTEIN ** 2, CELL_SW, 2 * PAIR_PROTEIN)
    b_k2 = bound_ms(k2_cells, CELL_NW, 4 * PAIR_PROTEIN * 17)
    say(json.dumps({"kernels": [{
        "name": "K1 interseq (inter-sequence SW/NW scoring)",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": launches,
        "max_abs_err": max(err2, err6),
        "ms": t_k1,
        "plain_ms": t_plain,
        "bound_ms": b_k1[0],
        "bound_by": b_k1[1],
        "library_ms": None,
    }, {
        "name": "K3 longpair (one whole pair, SW/NW score)",
        "route": "cuda",
        "source": K3_SOURCE,
        "replaces": K3_REPLACES,
        "launches": k3_launches,
        "max_abs_err": max(err7, err8),
        "ms": t_k3,
        "plain_ms": t_k3_plain,
        "bound_ms": b_k3[0],
        "bound_by": b_k3[1],
        "library_ms": None,
    }, {
        "name": "K2 ring_block (tiles with boundary I/O, the Myers-Miller levels)",
        "route": "cuda",
        "source": K2_SOURCE,
        "replaces": K2_REPLACES,
        "launches": k2_launches,
        "max_abs_err": err10,
        "ms": t_k2,
        "plain_ms": t_k2_plain,
        "bound_ms": b_k2[0],
        "bound_by": b_k2[1],
        "library_ms": None,
    }, *probe_entries]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
