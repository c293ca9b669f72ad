"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — database search through ``SearchEngine`` and
``SSAContext`` — on the card, at the flagship database size of ``bench.py``
(500,000 lognormal subjects, about 174M residues). Phases, one line each:

1. build K1 (``libssa_tpu_torch/csrc/interseq.cu``) with nvcc, and beside
   it K3, K2, the probes (``csrc/probes.cu``, ``csrc/lp_rowsweep.cu``), K3's
   stage-cut builds and the parts of ``csrc/interseq_variants.cu``, one
   nvcc each, all in parallel; K1's registers, local bytes and blocks an SM
   for each instantiation at 1, 8 and 16 warps down the query, and K2's and
   K3's at each band height and warps count a block whose shared memory
   fits;
2. K1 against its plain PyTorch version on random inputs (exact equality),
   at every warps count and at the wrapper's choice;
3. the 500k-subject search: 8 queries through ``search_many`` (SW, k=10),
   one SW, one NW and one BIT8 query through ``search``, with K1's launch
   count;
4. those hit lists against the same engine forced onto the plain version,
   and every reported hit rescored by the scalar NumPy oracle;
5. ``SSAContext(device="cuda")`` on ``tests/testdata`` (ALIGNMENT-mode
   ``sw_align``, whose traceback cross-checks K1; ``nw_align``;
   ``align_many``) against ``SSAContext(device="cpu")``;
6. K1 at four shapes, BLOSUM62 11/1: bench.py's kernel shape (SW, m=256,
   B=8192, n=512, track_range), a filled launch (B = 65,536), the shape of
   phase 9 (NW, m = n = 512, P = 2048) and one query over every stack group
   of phase 3's database; each with its warps down the query, registers,
   local bytes, blocks an SM, ms and GCUPS, Part A's time, the ``seq``
   variant's (K1's chain in ``csrc/interseq_variants.cu``) and the plain
   version's (exact equality), beside the earlier K1 design's times; then
   one query at B = 2048 .. 65,536 at every warps count (the evidence for
   ``choose_warps``), and int64 at the kernel shape;
7. K3 (``libssa_tpu_torch/csrc/longpair.cu``, built in phase 1 beside K1)
   against its plain PyTorch version on random pairs (exact equality):
   SW/NW, int32/int64, both band heights at 1, 2, 3, 4, 6 and 8 stripes (warps)
   a block where the shared memory fits, protein and ACGT, m or n = 1,
   m >> n, n >> m, a matrix entry above 256, and a score bound past 2**31;
8. the 1-vs-1 score path at full width through
   ``SSAContext(device="cuda").align_pair(..., mode=ComputeMode.SCORE)``,
   held against the same call on the plain version: (a) a 16,384 x 16,384
   protein pair, BLOSUM62 11/1, SW and NW; (b) a 100,000 x 100,000 ACGT
   pair, 5/-4, gaps 10/1, SW, both strands; with K3's launch count and
   time (CUDA events) beside the plain version's, and K3's launch at every
   (band height, warps) on 8a SW and 8b's best strand, beside the
   wrapper's choice and the earlier K3 design's times;
9. BASELINE config 1's batched half: ``pair_scores_batch`` on K1, m = n =
   512, P = 2048, NW, BLOSUM62 11/1, against the plain version and the
   NumPy oracle;
10. K2 (``libssa_tpu_torch/csrc/ring_block.cu``, built in phase 1) against
    its plain PyTorch version on tiles whose boundaries come from a real DP
    (exact equality): SW/NW, int32/int64, both band heights at 1, 2, 4 and
    8 stripes (warps) a block, RB or W = 1, tall and wide tiles, one batched
    launch of mixed-size tiles at every warps count, and the tiles of one
    pair chained into its score, equal to K3's; K2's launch alone at the
    wrapper's choice and at every (band height, warps) at three shapes: (a)
    phase 11a's first level (equal to the plain version, whose time and the
    whole wrapper's are printed beside), (b) 11b's first SW end scan, one
    100,000^2 tile, and (c) 11b NW's level with the most tiles (each equal
    to the launch at 4 rows and 1 warp), with their bounds and the earlier
    K2 design's times; and int64 at (a), equal to int32;
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
    cuts at 16,384^2 and 100,000^2 beside the production K3;
13. K1's lazy-F design variants (``csrc/interseq_variants.cu``, the
    counterparts of ``experiments/f_scan_probe.py``, ``v6_probe.py``,
    ``v7_probe.py``, ``v8_probe.py`` and ``r2_kernel_golf.py``): every
    variant at its probe's shape and at B = 65,536, beside the production
    K1, with their launch counts, registers and spills; each exact variant's
    scores equal to the production K1's at both shapes, and each variant
    equal to its plain version (exact equality);
14. sharded search (``libssa_tpu_torch/parallel/sharded.py``) on the card
    over phase 3's database: meshes of 1 and 2 shards on the one card run
    ``search`` SW and NW, ``search_many`` of 8 queries, a BIT8 ladder search
    whose self-hit leaves the 8-bit window and the BIT64 lane, and 2 shards
    a translated search (``search_reduced``) over 20,000 nucleotide records
    in six frames; then two ranks under gloo and one under NCCL (world size
    1), each a subprocess with one shard on the card, run ``search`` and
    ``search_many`` over a smaller flagship database. Every hit list equals
    the single-device engine's; walls beside the single-device engine's,
    the host time of the plan and of ``SequenceDB.shard``, K1's launches and
    ``requeued_chunks`` (which must be 0);
15. the ring (``libssa_tpu_torch/parallel/ring.py`` and ``ring_mm.py``, K2
    on every shard's tiles, one launch a staircase phase): (a)
    ``ring_score`` on phase 8b's 100,000 x 100,000 ACGT pair, SW and NW, on
    meshes of 1, 2 and 4 shards of the one card, each equal to K3's score,
    its K2 launches equal to its phases, and SW at 2 shards at each RB of
    ``RING_RBS``; (b) ``ring_align_pair`` on 11b's 100,000 x 100,000
    protein pair, SW and NW, 2 shards, ``ring_min_cells`` 2**29 (levels 0-2
    on the ring), equal to ``align_pair_linear`` on the card field for
    field; (c) two gloo ranks of one shard each and (d) one NCCL rank of two
    shards, subprocesses on the card, run ``ring_score`` and
    ``ring_align_pair`` on 8a's 16,384^2 pair (``ring_min_cells`` 2**26),
    equal to one process's; with the walls, K2's launches and each call's
    phases;
16. K1, K2 and K3 over drawn inputs (``numpy.random.default_rng`` from
    fixed seeds, a fixed count of draws a part; any difference prints the
    part, seed, draw and its parameters and fails): (a) K1 on the card
    against the same wrapper on the CPU (the plain version): 1-8 queries
    of 1-3,000 rows, some shorter than their profiles, 1-600 lanes of
    ragged subjects up to 700 columns, five matrices, Q >= R >= 0, SW/NW,
    track_range, int32/int64, warps None or 1-16; (b) K2 against its plain
    version, three launches a draw: 1-200 tiles of 1-400 x 1-600 at
    offsets into shared code buffers, with SW/NW open edges and edges
    carried out of neighbouring tiles, int32/int64, every (rows, warps)
    that fits; (c) K3 against its plain version at every (rows, warps) that
    fits, int32 and int64, three launches each, m and n 1-5,000 weighted to
    the stripe, group and segment edges; (d) one ACGT pair of 524,288 x
    4,096, 1,024 K3 groups (past one wave of resident blocks): K3, K2 as one
    tile, K1 through ``pair_scores_batch`` and the plain sweep of the
    transposed pair on the card, SW and NW, all equal, with K3's and K2's
    times; (e) ``SSAContext(device="cuda")`` against ``device="cpu"`` on
    drawn DBs (1-60 subjects, ambiguity codes) and queries: ``sw_align``,
    ``nw_align`` and ``align_many`` at every ``BitWidth``, some sharded
    (``set_device_count``), and ``align_pair`` SCORE and ALIGNMENT on pairs
    up to 6,000 x 6,000 (K2's levels past 16M cells), hit lists equal field
    by field; (f) ``examples/torch_database_search.py`` and
    ``examples/torch_genome_pair.py`` as subprocesses, exit 0 with every
    section's line.

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
VARIANTS_SOURCE = "libssa_tpu_torch/csrc/interseq_variants.cu"
VARIANTS_PLAIN_N = 24  # phase 13: subject columns of the plain-version checks
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
K1_WARPS = (None, 1, 2, 4, 8, 16)  # phase 2: K1's warps down the query
K2_WARPS = (1, 2, 4, 8)  # phase 10: K2's stripes (warps) a block
K3_WARPS = (1, 2, 3, 4, 6, 8)  # phases 7 and 8: K3's stripes (warps) a block
# Phase 8: the earlier K3 design's launch (one warp a block; PERF.md §6, one
# H100 80GB HBM3 at 700 W), printed beside this run's sweep.
K3_EARLIER = {"8a": "5.718-5.942 ms", "8b": "35.5-36.1 ms"}
# Phase 10: the earlier K2 design's launch alone at shapes (a)-(c) (one warp a
# block; PERF.md §6, experiments/k2_ab.py on one H100 80GB HBM3 at 700 W),
# printed beside this run's.
K2_EARLIER = {"a": "4.389-4.544 ms", "b": "35.300-35.564 ms", "c": "0.618-0.662 ms"}
B_FILLED = 65_536  # phase 6: a filled K1 launch, 512 blocks of 128 lanes
K1_SWEEP_B = (2048, 8192, 16384, 32768, 49152, 57344, 65536)  # phase 6: warps sweep
# Phase 6: the earlier K1 design's times (one thread a lane with a row guard a
# cell; PERF.md §4 and §6, one H100 80GB HBM3 at 700 W), printed beside this
# run's.
K1_EARLIER = {"kernel": "2.902-3.188 ms", "filled": "5.398-5.610 ms",
              "pairs": "2.722 ms, 599-686k pairs/s",
              "single": "SW about 364 GCUPS, 0.122 s a query"}
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
                    for warps in K1_WARPS:
                        got = interseq_cuda.interseq_pairs_cuda(*t, *gaps, scratch=scratch,
                                                                warps=warps, **kw)
                        torch.cuda.synchronize()
                        for name, a, b in zip(("scores", "hi", "lo"), got, ref):
                            if a.dtype != b.dtype or not torch.equal(a, b):
                                bad = (a.long() - b.long()).abs().max().item()
                                fail(2, f"{name} differ (m={m}, shape={codes.shape}, "
                                        f"{kw}, warps {warps}, max |diff| {bad})")
                            max_err = max(max_err, (a.long() - b.long()).abs().max().item())
                    n_cases += 1
    say(f"phase 2 K1 vs plain on the card: {n_cases} cases equal at every warps count "
        f"{K1_WARPS} (None: the wrapper's choice) (scores, hi, lo; tolerance: exact)")
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
    st1 = SearchStats()
    sw1_hit = eng.search(queries[0], 10, local=True, stats=st1)
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
    for name, a, b in (("BIT8", b8_hit, sw_hits[0]), ("BIT8 homolog", b8h_hit, exh_hit),
                       ("SW 1q", sw1_hit, sw_hits[0])):
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            fail(3, f"{name} hit list differs from the EXACT one")
    if not st8h.rescored:
        fail(3, "the homolog's self-hit did not leave the 8-bit window")
    rate = st.subjects / st.seconds
    say(f"phase 3 search 8q x {len(db)} subjects ({db.total_residues} residues), "
        f"SW k=10: {rate:.0f} q*subj/s, {st.gcups:.2f} GCUPS, {wall:.3f} s wall; "
        f"SW 1q {st1.seconds:.3f} s ({st1.gcups:.2f} GCUPS); NW 1q {st_nw.seconds:.3f} s; BIT8 1q {st8.seconds:.3f} s, "
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
    return launches, rate, st.gcups, eng


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


def phase6(dev, eng):
    """K1 at four shapes: bench.py's kernel shape, a filled launch (B =
    65,536), ``pair_scores_batch``'s, and one query over every stack group of
    the flagship database. Each at the wrapper's warps and at Part A (warps
    1), beside K1's own chain in the variants' harness (``seq``) and the
    plain version, every output equal to the plain version's. K1 and
    ``seq`` are timed over five calls back to back, as the engine issues
    them. Returns {shape: (K1 ms, plain ms)}."""
    import torch

    from libssa_tpu_torch import matrices
    from libssa_tpu_torch.experiments import _interseq_variants as IV
    from libssa_tpu_torch.ops import interseq, interseq_cuda
    from libssa_tpu_torch.ops.scoring import make_profile

    rng = np.random.default_rng(0)
    padded = matrices.builtin("BLOSUM62").padded()
    Q, R = 12, 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def profile(m):
        return torch.as_tensor(make_profile(rng.integers(0, 20, m).astype(np.uint8),
                                            padded)).to(dev)

    def one_chunk(n, B):
        codes = torch.as_tensor(rng.integers(0, 20, (1, n, B)).astype(np.int8)).to(dev)
        return [(codes, torch.full((1, B), n, dtype=torch.int32, device=dev))]

    flagship = [(c, n) for c, n, _ in eng._stacks_on_device(eng.db, eng.params.batch_size)[1]]
    m_q = 256
    shapes = (  # key, label, profile, groups, local, track
        ("kernel", f"bench kernel shape m={m_q} B=8192 n=512 SW track_range", profile(m_q),
         one_chunk(512, 8192), True, True),
        ("filled", f"filled m={m_q} B={B_FILLED} n=512 SW", profile(m_q),
         one_chunk(512, B_FILLED), True, False),
        ("pairs", f"pair_scores_batch m=n={BATCH_M} P={BATCH_P} NW", profile(BATCH_M),
         one_chunk(BATCH_M, BATCH_P), False, False),
        ("single", f"single query m={m_q} over the flagship's {len(flagship)} stack groups "
         f"({sum(c.shape[0] for c, _ in flagship)} chunks) SW", profile(m_q), flagship,
         True, False),
    )

    # As the engine calls K1: max_abs known and one scratch reused, so that a
    # timing holds the launches and no device sync.
    scratch = torch.empty(interseq_cuda.SCRATCH_BUDGET, dtype=torch.uint8, device=dev)

    def calls(fn, prof, groups, local, track, **kw):
        """One call a stack group, its index tensors made beforehand."""
        mr = torch.tensor([prof.shape[0]], dtype=torch.int32, device=dev)
        kw.update(local=local, track_range=track, max_abs=int(prof.abs().max()))
        idx = [(torch.zeros(c.shape[0], dtype=torch.int32, device=dev),
                torch.arange(c.shape[0], dtype=torch.int32, device=dev)) for c, _ in groups]
        return lambda: [fn(prof[None], codes, lens, iq, ic, mr, Q, R, **kw)
                        for (codes, lens), (iq, ic) in zip(groups, idx)]

    def k1(prof, groups, local, track, warps=None, dtype="int32"):
        return calls(interseq_cuda.interseq_pairs_cuda, prof, groups, local, track,
                     scratch=scratch, warps=warps, dtype=dtype)

    def seq(prof, groups):
        stages = [IV.stage(prof, codes.permute(1, 0, 2).reshape(codes.shape[1], -1).contiguous(),
                           lens.reshape(-1).contiguous(), Q, R, IV.BASELINE)
                  for codes, lens in groups]
        return lambda: [st() for st in stages]

    def plain(prof, groups, local, track):
        run = calls(interseq.interseq_pairs, prof, groups, local, track)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), out

    results = {}
    for key, label, prof, groups, local, track in shapes:
        m = prof.shape[0]
        cells = m * sum(int(lens.sum()) for _, lens in groups)
        warps = sorted({interseq_cuda.choose_warps(c.shape[2], c.shape[0], -(-m // 32), sms)
                        for c, _ in groups})
        tp1, ref = plain(prof, groups, local, track)
        tk1, got = cuda_ms(k1(prof, groups, local, track), calls=5)
        ta, got_a = cuda_ms(k1(prof, groups, local, track, 1), calls=5)
        t_seq, _ = cuda_ms(seq(prof, groups), calls=5)
        tk2, _ = cuda_ms(k1(prof, groups, local, track), calls=5)
        tp2 = plain(prof, groups, local, track)[0] if key == "kernel" else tp1
        for outs in (got, got_a):
            for o, r in zip(outs, ref):
                if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(o, r)):
                    fail(6, f"K1 differs from plain at {label}")
        t_k1 = min(tk1, tk2)
        results[key] = (t_k1, min(tp1, tp2))
        layouts = "; ".join(
            f"{a['regs']} regs, {a['local']} B local, {a['blocks_an_sm']} blocks an SM"
            for a in (interseq_cuda.attrs(local, track, False, w) for w in warps))
        say(f"phase 6 {label}: K1 warps {warps} ({layouts}) {t_k1:.3f} ms "
            f"({cells / t_k1 / 1e6:.2f} GCUPS; runs {tk1:.3f} {tk2:.3f}); Part A (warps 1) "
            f"{ta:.3f} ms ({cells / ta / 1e6:.2f} GCUPS); seq variant {t_seq:.3f} ms (SW, "
            f"untracked, same cells; K1 / seq {t_k1 / t_seq:.3f}); plain {tp1:.1f} ms"
            + (f", {tp2:.1f} ms" if key == "kernel" else "")
            + f"; equal to plain (exact); earlier K1 design {K1_EARLIER[key]}")

    # The warps rule's evidence: one query, SW, m = 256 (8 strips), one chunk
    # of B lanes at each warps count, every output equal to Part A's; and
    # int64 (16-row strips) at the kernel shape.
    prof = profile(m_q)
    rows = []
    for B in K1_SWEEP_B:
        groups = one_chunk(512, B)
        ref = None
        times = []
        for w in (1, 2, 4, 8, 16):
            t, out = cuda_ms(k1(prof, groups, True, False, w), calls=5)
            ref = out[0] if ref is None else ref
            if not all(torch.equal(a, b) for a, b in zip(out[0], ref)):
                fail(6, f"K1 at B={B} warps {w} differs from warps 1")
            times.append(f"W{w} {t:.3f}")
        choice = interseq_cuda.choose_warps(B, 1, m_q // 32, sms)
        rows.append(f"B={B} ({-(-B // 128)} Part A blocks, choice W{choice}): " + " ".join(times))
    groups = one_chunk(512, 8192)
    t32, out32 = cuda_ms(k1(prof, groups, True, True), calls=5)
    t64, out64 = cuda_ms(k1(prof, groups, True, True, dtype="int64"), calls=5)
    t64a, _ = cuda_ms(k1(prof, groups, True, True, 1, dtype="int64"), calls=5)
    if not all(torch.equal(a.long(), b) for a, b in zip(out32[0], out64[0])):
        fail(6, "K1 int64 differs from int32 at the kernel shape")
    w64 = interseq_cuda.choose_warps(8192, 1, m_q // 16, sms)
    say("phase 6 warps sweep, SW m=256 n=512 one query, ms: " + "; ".join(rows)
        + f". int64 at the kernel shape (track_range, 16-row strips): warps {w64} {t64:.3f} ms, "
        f"warps 1 {t64a:.3f} ms, int32 {t32:.3f} ms; equal to int32")
    return results


def cuda_ms(fn, reps=3, calls=1):
    """Min of ``reps`` CUDA-event timings after one warm-up: (ms, last output).
    With ``calls`` > 1 each timing spans that many calls back to back and is
    divided by it, so that the host's time to reach a launch hides behind
    the card's work."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
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

    from libssa_tpu_torch.experiments import (
        _common, _interseq_variants, r3_banded_bisect, r3_lp_bisect)

    cuts = [functools.partial(longpair_cuda._lib, r3_banded_bisect.CUTS[v])
            for v in r3_banded_bisect.CUTS if v != "full"]
    parts = [functools.partial(_interseq_variants.lib, p)
             for p in range(_interseq_variants.PARTS)]
    libs = (interseq_cuda._lib, longpair_cuda._lib, ring_block_cuda._lib,
            functools.partial(_common.lib, "chain"), functools.partial(_common.lib, "tile"),
            r3_lp_bisect._lib, *parts, *cuts)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        t_k1, t_k3, t_k2, t_chain, t_tile, t_rs, *t_rest = pool.map(build, libs)
    t_parts, t_cuts = t_rest[:len(parts)], t_rest[len(parts):]
    say(f"phase 1 build K1 ({K1_SOURCE}), K3 ({K3_SOURCE}), K2 ({K2_SOURCE}), the probes "
        f"({PROBES_SOURCE} in two builds, {ROWSWEEP_SOURCE}), K3's {len(cuts)} stage-cut "
        f"builds and K1's variants ({VARIANTS_SOURCE} in {len(parts)} parts), nvcc sm_90a "
        f"in parallel: ok, K1 {t_k1:.1f} s, K3 {t_k3:.1f} s, K2 {t_k2:.1f} s, probes "
        f"{t_chain:.1f} s (chain) and {t_tile:.1f} s (tile), row sweep {t_rs:.1f} s, stage "
        f"cuts {max(t_cuts):.1f} s, K1 variants "
        + " ".join(f"{t:.1f}" for t in t_parts) + " s")
    rows = []
    for wide in (False, True):
        for local in (True, False):
            for track in (True, False):
                got = [interseq_cuda.attrs(local, track, wide, w) for w in (1, 8, 16)]
                rows.append(f"{'int64' if wide else 'int32'} {'SW' if local else 'NW'}"
                            f"{' track' if track else ''} " + " / ".join(
                                f"{a['regs']},{a['local']},{a['blocks_an_sm']}" for a in got))
    say("phase 1 K1 instantiations (registers, local bytes, blocks an SM at warps 1 / 8 / "
        "16): " + "; ".join(rows))
    rows = []
    for wide in (False, True):
        for local in (True, False):
            for ch, w in k2_configs(8 if wide else 4):
                a = ring_block_cuda.attrs(local, wide, ch, w)
                rows.append(f"{'int64' if wide else 'int32'} {'SW' if local else 'NW'} rows "
                            f"{ch} warps {w}: {a['regs']},{a['local']},{a['blocks_an_sm']}")
    say("phase 1 K2 instantiations (registers, local bytes, blocks an SM): " + "; ".join(rows))
    rows = []
    for wide in (False, True):
        for local in (True, False):
            for ch, w in k3_configs(8 if wide else 4):
                a = longpair_cuda.attrs(local, wide, ch, w)
                rows.append(f"{'int64' if wide else 'int32'} {'SW' if local else 'NW'} rows "
                            f"{ch} warps {w}: {a['regs']},{a['local']},{a['blocks_an_sm']}")
    say("phase 1 K3 instantiations (registers, local bytes, blocks an SM): " + "; ".join(rows))


def k3_configs(itemsize):
    """K3's (band height, warps) pairs whose block fits in shared memory."""
    from libssa_tpu_torch.ops import longpair_cuda

    return [(ch, w) for ch in longpair_cuda.BAND_ROWS for w in K3_WARPS
            if longpair_cuda.fits(w, ch, itemsize)]


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
                    for ch, w in k3_configs(8 if dt == torch.int64 else 4):
                        got = longpair_cuda.longpair_score_cuda(
                            q, s, mat_d, Q, R, local, dt, rows_per_thread=ch, warps=w)
                        torch.cuda.synchronize()
                        err = abs(int(got) - int(want))
                        max_err = max(max_err, err)
                        n_cases += 1
                        if got.dtype != dt or err:
                            fail(7, f"K3 {int(got)} != plain {int(want)} ({name}, m={m}, "
                                    f"n={n}, local={local}, {dt}, rows {ch}, warps {w})")
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
        f"(rows per thread, warps) {k3_configs(4)} in int32, {k3_configs(8)} in int64, "
        f"protein/ACGT/entry>256, score past 2**31 also equal to the oracle); max |diff| "
        f"{max_err} (tolerance: exact)")
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

    lines, sweeps, sw16 = [], [], None
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
            if local:
                sweeps.append(k3_sweep(label, qt, st, mat, Q, R, dt, a.score))
    for line in lines + sweeps:
        say("phase 8 " + line)
    say(f"phase 8 align_pair(mode=SCORE) equals the plain version in every case; "
        f"K3 launches {launches}")
    return launches, max_err, sw16


def k3_sweep(label, q, s, mat, Q, R, dt, score) -> str:
    """K3's launch (SW) at every (band height, warps) that fits, each equal
    to ``score``, beside the wrapper's choice and the earlier design; at 8b
    also in int64 at each band height at the chosen warps and at the
    wrapper's choice."""
    import torch

    from libssa_tpu_torch.ops import longpair_cuda

    def run(ch=None, w=None, dtype=dt):
        ms, out = cuda_ms(lambda: longpair_cuda.longpair_score_cuda(
            q, s, mat, Q, R, True, dtype, rows_per_thread=ch, warps=w))
        if int(out) != score:
            fail(8, f"{label} K3 at rows {ch}, warps {w}, {dtype}: {int(out)}, not {score}")
        return ms

    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    ch0 = longpair_cuda.band_rows(len(q), sms)
    w0 = longpair_cuda.choose_warps(len(q), ch0, sms)
    by = {}
    for ch, w in k3_configs(8 if dt == torch.int64 else 4):
        by.setdefault(ch, []).append(f"{w} {run(ch, w):.3f}")
    wide = ""
    if label.startswith("8b") and dt == torch.int32:
        wide = "; int64 " + ", ".join(
            f"rows {ch} warps {w0} {run(ch, w0, torch.int64):.3f}"
            for ch in longpair_cuda.BAND_ROWS if longpair_cuda.fits(w0, ch, 8))
        wide += f", at the choice {run(dtype=torch.int64):.3f} ms"
    return (f"{label} SW K3 sweep, ms by rows a thread and warps a block: "
            + "; ".join(f"rows {ch}: " + ", ".join(v) for ch, v in by.items())
            + f"; the wrapper's choice (rows {ch0}, warps {w0}) {run():.3f}{wide} (earlier K3 "
            f"design {K3_EARLIER[label[:2]]}; all equal to the score {score})")


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
                for ch, warps in k2_configs(dt.itemsize):
                    got = ring_block_cuda.ring_block_cuda(
                        q_d, s_d, [[r0, RB, c0, W]], mat_d, Q, R, local, *bounds,
                        rows_per_thread=ch, warps=warps)
                    torch.cuda.synchronize()
                    err = tiles_diff(got, want)
                    max_err = max(max_err, err)
                    n_cases += 1
                    if err:
                        fail(10, f"K2 differs from plain (RB={RB}, W={W}, at ({r0}, {c0}), "
                                 f"local={local}, {dt}, rows {ch}, warps {warps}): max "
                                 f"|diff| {err}")
    # Every tile above in one launch, SW and NW, at the wrapper's choice and
    # at every warps count.
    for (local, tiles), warps in [(kv, w) for kv in batch.items() for w in (None, *K2_WARPS)]:
        qs = torch.cat([t[0] for t in tiles])
        ss = torch.cat([t[1] for t in tiles])
        rows = np.array([len(t[0]) for t in tiles])
        cols = np.array([len(t[1]) for t in tiles])
        jobs = np.stack([np.cumsum(rows) - rows, rows, np.cumsum(cols) - cols, cols], 1)
        flat = [torch.cat([t[2][k] for t in tiles]) for k in range(4)]
        got = ring_block_cuda.ring_block_cuda(qs, ss, jobs, mat_d, Q, R, local, *flat,
                                              rows_per_thread=4 if warps else None,
                                              warps=warps)
        want = [torch.cat(parts) if parts[0] is not None else None
                for parts in zip(*[t[3] for t in tiles])]
        torch.cuda.synchronize()
        err = tiles_diff(got, want)
        max_err = max(max_err, err)
        n_cases += 1
        if err:
            fail(10, f"the batched launch of {len(tiles)} tiles differs (local={local}, "
                     f"warps {warps})")
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
    say(f"phase 10 K2 vs plain on the card: {n_cases} cases equal (SW/NW, int32/int64, "
        f"rows per thread {ring_block_cuda.BAND_ROWS} x warps {K2_WARPS} where the block "
        f"fits shared memory, RB or W = 1, tall, wide, one launch of {len(batch[True])} "
        f"mixed tiles at every warps count, {m} x {n} chained in {RB} x {W} tiles = K3's "
        f"score); max |diff| {max_err} (tolerance: exact)")
    # K2's launch alone at shapes (a)-(c), at the wrapper's choice and at every
    # (rows per thread, warps): (a) held to the plain version, (b) and (c) to
    # the launch at 4 rows and 1 warp (the plain version takes minutes there).
    from libssa_tpu_torch.experiments import k2_ab

    shapes = k2_ab.shapes(sys.modules[__name__], dev)
    res = k2_sweep(shapes, Q, R)
    a_pair, a_jobs, a_bounds, _ = shapes["a"]
    # And the whole wrapper at (a): staging, the code check and its wait included.
    ms_wrapper, _ = cuda_ms(lambda: ring_block_cuda.ring_block_cuda(
        a_pair.q, a_pair.s, a_jobs, a_pair.matrix, Q, R, False, *a_bounds))
    t0 = time.perf_counter()
    want = ring_block.ring_block_batch_plain(a_pair.q, a_pair.s, a_jobs, a_pair.matrix, Q, R,
                                             False, *a_bounds)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    for key, got in res["a"]["outputs"].items():
        err = tiles_diff(got, want)
        max_err = max(max_err, err)
        if err:
            fail(10, f"K2 differs from plain at (a), 11a's first level, at {key}")
    for shape in ("b", "c"):
        ref = res[shape]["outputs"][(4, 1)]
        for key, got in res[shape]["outputs"].items():
            if tiles_diff(got, ref):
                fail(10, f"K2 at ({shape}) with {key} differs from rows 4, warps 1")
    for shape, r in res.items():
        jobs = shapes[shape][1]
        say(f"phase 10 K2 at ({shape}) {K2_SHAPES[shape]}: {len(jobs)} tiles, rows "
            f"{int(jobs[:, 1].min())}-{int(jobs[:, 1].max())}, cols "
            f"{int(jobs[:, 3].min())}-{int(jobs[:, 3].max())}, {r['cells']} cells; launch "
            f"alone at the wrapper's choice (rows {r['chosen'][0]}, warps {r['chosen'][1]}) "
            f"{r['ms']:.3f} ms ({r['cells'] / r['ms'] / 1e6:.2f} GCUPS, min of 3; earlier "
            f"design {K2_EARLIER[shape]}); bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}); sweep (rows, warps: ms) "
            + ", ".join(f"{ch},{w}: {t:.3f}" for (ch, w), t in r["sweep"].items())
            + ("; outputs equal to the plain version's" if shape == "a" else
               "; every output equal to rows 4, warps 1"))
    # int64 runs the same pipeline: (a) again with int64 boundaries, held to
    # int32's outputs; its time is recorded only.
    wide = ring_block_cuda.stage(a_pair.q, a_pair.s, a_jobs, a_pair.matrix, Q, R, False,
                                 *(b.long() for b in a_bounds), codes_checked=True)
    ms64, got64 = cuda_ms(wide)
    if tiles_diff([t.long() if t is not None else None for t in res["a"]["outputs"][(4, 1)]],
                  got64):
        fail(10, "K2 in int64 differs from int32 at (a)")
    say(f"phase 10 K2 at (a): the whole wrapper {ms_wrapper:.3f} ms, plain {plain_ms:.1f} ms; "
        f"int64 (rows {wide.rows_per_thread}, warps {wide.warps}) {ms64:.3f} ms, equal to int32")
    return max_err, res["a"]["ms"], plain_ms, res["a"]["bound"]


K2_SHAPES = {"a": "11a's first level, NW", "b": "11b's first SW end scan",
             "c": "11b NW's level with the most tiles"}


def k2_configs(itemsize):
    """K2's (rows per thread, warps a block) pairs whose block fits shared
    memory."""
    from libssa_tpu_torch.ops import ring_block_cuda as k2

    return [(ch, w) for ch in k2.BAND_ROWS for w in K2_WARPS
            if k2.smem_bytes(w, ch, itemsize) <= k2.MAX_SMEM]


def k2_bound(jobs, local):
    """``bound_ms`` of one K2 launch over ``jobs`` in int32: its cells, and
    its bytes (codes in, boundaries in and out: 4 words a row and a column;
    in SW each row's maximum and its column, 2 words more)."""
    rows, cols = int(jobs[:, 1].sum()), int(jobs[:, 3].sum())
    cells = int((jobs[:, 1] * jobs[:, 3]).sum())
    nbytes = rows + cols + 16 * (rows + cols) + (8 * rows if local else 0)
    return cells, bound_ms(cells, CELL_SW if local else CELL_NW, nbytes)


def k2_sweep(shapes, Q, R):
    """K2's launch alone (``stage``) at each shape, at the wrapper's choice
    and at every ``k2_configs``: ms (min of 3 after a warm-up), outputs,
    cells and bound."""
    from libssa_tpu_torch.ops import ring_block_cuda

    res = {}
    for shape, (pair, jobs, bounds, local) in shapes.items():
        def stage(**pin):
            return ring_block_cuda.stage(pair.q, pair.s, jobs, pair.matrix, Q, R, local,
                                         *bounds, codes_checked=True, **pin)

        chosen = stage()
        ms, _ = cuda_ms(chosen)
        sweep, outputs = {}, {}
        for ch, w in k2_configs(4):
            sweep[(ch, w)], outputs[(ch, w)] = cuda_ms(stage(rows_per_thread=ch, warps=w))
        cells, bound = k2_bound(jobs, local)
        res[shape] = {"chosen": (chosen.rows_per_thread, chosen.warps), "ms": ms,
                      "sweep": sweep, "outputs": outputs, "cells": cells, "bound": bound}
    return res


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
    from libssa_tpu_torch.experiments.k2_ab import trace_pair

    qb, sb = trace_pair()
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


# -- phase 13 ----------------------------------------------------------------

# Each probe's variant in the kernels line.
VARIANT_ENTRIES = (("f_scan_probe", "v1", "experiments/f_scan_probe.py:181",
                    "the full in-strip scan, masked form"),
                   ("v6_probe", "T8", "experiments/v6_probe.py:116",
                    "the full scan, T = 8 codes a load, IL 1"),
                   ("v7_probe", "v7", "experiments/v7_probe.py:91",
                    "the full scan on narrowing rows"),
                   ("v8_probe", "CH8", "experiments/v8_probe.py:94",
                    "chunked-sequential F, CH = 8"),
                   ("r2_kernel_golf", "a8nof", "experiments/r2_kernel_golf.py:154",
                    "CH = 8, 8 running-max registers of Hnof, 2 columns a trip"))


def phase13(dev):
    """K1's lazy-F variants: every variant of the five probes at its probe's
    shape and at B = 65,536 (the counts read right after), the exact ones
    against the production K1, each against its plain version."""
    import torch

    from libssa_tpu_torch.experiments import _common as C
    from libssa_tpu_torch.experiments import _interseq_variants as IV
    from libssa_tpu_torch.experiments import (
        f_scan_probe, r2_kernel_golf, v6_probe, v7_probe, v8_probe)

    probes = {m.PROBE.name: m.PROBE
              for m in (f_scan_probe, v6_probe, v7_probe, v8_probe, r2_kernel_golf)}
    t0 = time.perf_counter()
    clock0 = C.sample()
    # The variants' path: counts from zero, read right after.
    for p in probes.values():
        p.launches = 0
    results = {name: {B: p.measure_all(B, dev) for B in (p.B, IV.B_FILLED)}
               for name, p in probes.items()}
    launches = {name: p.launches for name, p in probes.items()}
    clock1 = C.sample()
    t_path = time.perf_counter() - t0
    for name, n in launches.items():
        if n <= 0:
            fail(13, f"{name}'s kernel was not launched")
    for name, by_b in results.items():
        for B, (rows, _) in by_b.items():
            bad = [v for v, r in rows.items() if r["equal_k1"] is False]
            if bad:
                fail(13, f"{name} at B={B}: {bad} differ from the production K1")
    for name, p in probes.items():
        bad = p.check_plain(dev, VARIANTS_PLAIN_N)
        if bad:
            fail(13, f"{name}: {bad} differ from their plain versions")
    # K1's own chain inside the same harness, beside the production K1.
    base = IV.Probe("K1 chain in the variants' harness (seq)", {"seq": IV.BASELINE},
                    B=2048, Q=11, R=1)
    base_runs = {B: base.measure_all(B, dev) for B in (base.B, IV.B_FILLED)}
    if any(rows["seq"]["equal_k1"] is False for rows, _ in base_runs.values()) or \
            base.check_plain(dev, VARIANTS_PLAIN_N):
        fail(13, "the seq variant differs from the production K1 or its plain version")
    say(f"phase 13 K1 variants' path {t_path:.1f} s ({clock0} -> {clock1}: clocks.sm, "
        f"power.draw, power.limit); launches {launches}; every exact variant equals the "
        f"production K1 at both shapes; every variant equals its plain version (m=256, "
        f"subjects cut to n={VARIANTS_PLAIN_N}; tolerance exact)")
    for name, by_b in results.items():
        for B, (rows, k1_ms) in by_b.items():
            say(f"phase 13 {probes[name].report(B, rows, k1_ms)}")
    for B, run in base_runs.items():
        say(f"phase 13 {base.report(B, *run)}")

    # The kernels line: each probe's representative at its probe's shape,
    # and its plain version once on the same inputs.
    entries = []
    for name, variant, replaces, what in VARIANT_ENTRIES:
        p = probes[name]
        inputs = p.inputs(p.B, dev)
        got = p.stage(*inputs, variant)()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = p.plain(*inputs, variant)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t1)
        err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
        if err:
            fail(13, f"{name} {variant} differs from its plain version by {err}")
        b_ms, b_by = bound_ms(IV.M * p.B * IV.N, CELL_SW, IV.N * p.B + 12 * p.B)
        entries.append({
            "name": f"K1 variant {name} {variant} ({what}; SW, m={IV.M} B={p.B} n={IV.N})",
            "route": "cuda", "source": VARIANTS_SOURCE, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err,
            "ms": results[name][p.B][0][variant]["ms"], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    say(f"phase 13 done in {time.perf_counter() - t0:.1f} s")
    return entries


# -- phase 14 ----------------------------------------------------------------

RANK_SEQS = 100_000  # phase 14's subprocess ranks: a flagship-like DB of 100k
RANK_TIMEOUT = 240  # seconds a phase-14 subprocess may take before it is killed
NT_RECORDS = 20_000  # phase 14's translated database


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _same_hits(a, b) -> bool:
    if isinstance(a, list):
        return len(a) == len(b) and all(_same_hits(x, y) for x, y in zip(a, b))
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def sharded_paths(eng, queries, homolog, reps=1):
    """Every path phase 14 drives, on ``eng``: ``{name: (hits, min wall s
    of ``reps`` runs, stats of the last)}``."""
    import torch

    from libssa_tpu_torch.constants import BitWidth
    from libssa_tpu_torch.search.manager import SearchStats

    calls = {
        "SW": lambda st: eng.search(queries[0], 10, True, stats=st),
        "NW": lambda st: eng.search(queries[0], 10, False, stats=st),
        "8q": lambda st: eng.search_many(queries, 10, True, st),
        "BIT8": lambda st: eng.search(homolog, 10, True, BitWidth.BIT8, st),
        "BIT64": lambda st: eng.search(queries[0], 10, True, BitWidth.BIT64, st),
    }
    out = {}
    for name, fn in calls.items():
        walls = []
        for _ in range(reps):
            st = SearchStats()
            t0 = time.perf_counter()
            hits = fn(st)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[name] = (hits, min(walls), st)
    return out


def rank_main(backend: str, rank: int, world: int, port: int, n_seqs: int) -> int:
    """One rank of phase 14's ``torch.distributed`` job: one shard on the
    card; prints one JSON line."""
    import torch
    import torch.distributed as dist

    from libssa_tpu_torch import matrices
    from libssa_tpu_torch.ops import interseq_cuda
    from libssa_tpu_torch.parallel.sharded import ShardedSearchEngine, make_db_mesh
    from libssa_tpu_torch.search.manager import SearchEngine

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        db = flagship_db(n_seqs)
        b62 = matrices.builtin("BLOSUM62")
        single = SearchEngine(db, b62, 11, 1, device=dev)
        t0 = time.perf_counter()
        mesh = make_db_mesh()
        eng = ShardedSearchEngine(db, b62, 11, 1, mesh)
        eng._device_groups()
        t_plan = time.perf_counter() - t0
        qrng = np.random.default_rng(14)
        queries = [qrng.integers(0, 20, 256).astype(np.uint8) for _ in range(8)]
        walls = {}
        for name, e in (("single", single), ("mesh", eng)):
            times = []
            for rep in range(4):  # a warm-up (the upload), then min of 3
                if name == "mesh" and rep == 1:
                    interseq_cuda.launches = 0
                t0 = time.perf_counter()
                hits = [e.search(queries[0], 10, True), e.search(queries[0], 10, False),
                        e.search_many(queries, 10, True)]
                times.append(time.perf_counter() - t0)
            walls[name] = min(times[1:])
            if name == "mesh":
                launches = interseq_cuda.launches // 3
            else:
                want = hits
        ok = _same_hits(hits, want) and eng.requeued_chunks == 0 and launches > 0
        print(json.dumps({"rank": rank, "backend": backend, "world": world, "shards": mesh.size,
                          "ok": ok, "wall_s": walls["mesh"], "single_wall_s": walls["single"],
                          "plan_s": t_plan, "k1_launches": launches,
                          "requeued": eng.requeued_chunks}), flush=True)
        return 0 if ok else 1
    finally:
        dist.destroy_process_group()


def run_ranks(backend: str, world: int) -> list[dict]:
    """Phase 14's ``torch.distributed`` job: ``world`` subprocess ranks, each
    killed if it outlives ``RANK_TIMEOUT``; their JSON lines."""
    import subprocess as sp

    port = _free_port()
    procs = [sp.Popen([sys.executable, os.path.abspath(__file__), "rank", backend, str(r),
                       str(world), str(port), str(RANK_SEQS)],
                      stdout=sp.PIPE, stderr=sp.PIPE, text=True)
             for r in range(world)]
    out = []
    try:
        for p in procs:
            try:
                stdout, stderr = p.communicate(timeout=RANK_TIMEOUT)
            except sp.TimeoutExpired:
                fail(14, f"a {backend} rank did not finish in {RANK_TIMEOUT} s")
            if p.returncode != 0:
                fail(14, f"a {backend} rank failed (rc {p.returncode}):\n{stdout}\n"
                         f"{stderr[-3000:]}")
            out.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def phase14(dev, eng):
    import torch

    from libssa_tpu_torch import matrices
    from libssa_tpu_torch.constants import SymType
    from libssa_tpu_torch.io.db import SequenceDB
    from libssa_tpu_torch.ops import interseq_cuda
    from libssa_tpu_torch.parallel.sharded import ShardedSearchEngine, make_db_mesh
    from libssa_tpu_torch.search.manager import SearchEngine

    t_phase = time.perf_counter()
    db, b62 = eng.db, matrices.builtin("BLOSUM62")
    qrng = np.random.default_rng(14)
    queries = [qrng.integers(0, 20, 256).astype(np.uint8) for _ in range(8)]
    homolog = db.sequence(int(np.argmax(db.lengths >= 300)))[:256]
    want = sharded_paths(eng, queries, homolog, reps=3)
    lines = ["single " + " ".join(f"{n} {w:.3f}" for n, (_, w, _) in want.items())]
    t0 = time.perf_counter()
    for d in range(2):
        db.shard(d, 2)
    t_shard = time.perf_counter() - t0
    total_launches = 0
    for n in (1, 2):
        t0 = time.perf_counter()
        mesh_eng = ShardedSearchEngine(db, b62, 11, 1, make_db_mesh(devices=[dev] * n))
        mesh_eng._chunk_plan()
        t_plan = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh_eng._device_groups()
        torch.cuda.synchronize()
        t_up = time.perf_counter() - t0
        interseq_cuda.launches = 0  # the sharded path's launches only
        got = sharded_paths(mesh_eng, queries, homolog)  # also the warm-up
        launches = interseq_cuda.launches
        got = {k: (v[0], w, v[2]) for (k, v), (_, w, _) in zip(
            got.items(), sharded_paths(mesh_eng, queries, homolog, reps=3).values())}
        if launches <= 0:
            fail(14, f"K1 was not launched by the {n}-shard search")
        total_launches += launches
        for name, (hits, _, st) in got.items():
            if not _same_hits(hits, want[name][0]):
                fail(14, f"{n}-shard {name} hits differ from the single-device engine's")
            if (st.cells, st.rescored) != (want[name][2].cells, want[name][2].rescored):
                fail(14, f"{n}-shard {name} stats differ: {st} vs {want[name][2]}")
        if not got["BIT8"][2].rescored:
            fail(14, "the homolog's self-hit did not leave the 8-bit window")
        if mesh_eng.requeued_chunks:
            fail(14, f"{n}-shard engine re-queued {mesh_eng.requeued_chunks} chunks")
        lines.append(f"{n} shard{'s' * (n > 1)} "
                     + " ".join(f"{k} {w:.3f}" for k, (_, w, _) in got.items())
                     + f", plan {t_plan:.2f} s, upload {t_up:.2f} s, K1 launches {launches}")
        del mesh_eng

    # Translated: nucleotide records in six frames, 2 shards.
    rng = np.random.default_rng(15)
    nt_len = np.clip(rng.lognormal(6.5, 0.5, NT_RECORDS).astype(int), 60, 6000)
    ntdb = SequenceDB.from_sequences(
        [f"nt{i}" for i in range(NT_RECORDS)],
        [rng.integers(0, 4, n).astype(np.uint8) for n in nt_len], SymType.NUCLEOTIDE)
    tdb, orig, _ = ntdb.translated(1, use_cache=False)
    frames = [rng.integers(0, 20, 200).astype(np.uint8) for _ in range(6)]
    single_t = SearchEngine(tdb, b62, 11, 1, device=dev)
    mesh_t = ShardedSearchEngine(tdb, b62, 11, 1, make_db_mesh(devices=[dev, dev]))
    walls = []
    for e in (single_t, mesh_t, single_t, mesh_t):
        if e is mesh_t:
            interseq_cuda.launches = 0
        t0 = time.perf_counter()
        red = e.search_reduced(frames, orig, 10, True)
        walls.append(time.perf_counter() - t0)
        if e is single_t:
            want_red = red
        elif red is None or not _same_hits(red, want_red) or not interseq_cuda.launches:
            fail(14, "2-shard search_reduced differs from the single-device engine's "
                     "or did not launch K1")
    total_launches += interseq_cuda.launches
    if mesh_t.requeued_chunks:
        fail(14, f"search_reduced re-queued {mesh_t.requeued_chunks} chunks")
    lines.append(f"search_reduced {len(tdb)} entries ({tdb.total_residues} residues) x 6 "
                 f"frames, 2 shards {walls[3]:.3f} (first {walls[1]:.3f}), single "
                 f"{walls[2]:.3f} (first {walls[0]:.3f})")
    del single_t, mesh_t

    for r in run_ranks("gloo", 2) + run_ranks("nccl", 1):
        lines.append(f"{r['backend']} rank {r['rank']}/{r['world']} ({r['shards']} shards, "
                     f"{RANK_SEQS} subjects): SW+NW+8q {r['wall_s']:.3f} (min of 3) against "
                     f"single {r['single_wall_s']:.3f}, plan {r['plan_s']:.2f} s, K1 launches "
                     f"{r['k1_launches']}, requeued {r['requeued']}")
    say(f"phase 14 sharded search, {card_line()}, {len(db)} subjects, walls s: "
        + "; ".join(lines) + f"; SequenceDB.shard x 2 {t_shard:.2f} s (the plan does not "
        f"call it); every hit list equal, requeued 0; phase {time.perf_counter() - t_phase:.1f} s")
    return total_launches


# -- phase 15 ----------------------------------------------------------------

RING_SHARDS = (1, 2, 4)  # phase 15a: shards of the one card
RING_RBS = (1 << 14, 1 << 15, 1 << 16, 1 << 17)  # phase 15a: RB at 2 shards, SW
RING_MIN_B = 1 << 29  # phase 15b: levels 0-2 of the 100,000^2 pair divide on the ring
RING_MIN_C = 1 << 26  # phases 15c and 15d: the 16,384^2 pair's top levels on the ring


def _tb_row(tb) -> list:
    """A Traceback as JSON: its fields, the ops string as its length and
    sha256."""
    import hashlib

    return [tb.score, tb.q_begin, tb.q_end, tb.s_begin, tb.s_end, len(tb.cigar),
            hashlib.sha256(tb.cigar.encode()).hexdigest()]


def ring_calls(mesh, q, s, mat, go, ge, min_cells):
    """ring_score and ring_align_pair, SW and NW, of one pair on ``mesh``:
    ``{name: (result, wall s, K2 launches, phases)}``."""
    import torch

    from libssa_tpu_torch.ops import ring_block_cuda
    from libssa_tpu_torch.parallel import ring
    from libssa_tpu_torch.parallel.ring_mm import ring_align_pair

    out = {}
    for local in (True, False):
        mode = "SW" if local else "NW"
        for name, fn in ((f"score {mode}", lambda: ring.ring_score(
                q, s, mat, go, ge, local, mesh)),
                         (f"align {mode}", lambda: _tb_row(ring_align_pair(
                             q, s, mat, go, ge, local, mesh=mesh, ring_min_cells=min_cells)))):
            launches, ring.phases = ring_block_cuda.launches, 0
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            out[name] = (got, time.perf_counter() - t0, ring_block_cuda.launches - launches,
                         ring.phases)
    return out


def ring_rank_main(backend: str, rank: int, world: int, port: int, shards: int) -> int:
    """One rank of phase 15's ``torch.distributed`` job: ``shards`` shards
    on the card; prints one JSON line with ``ring_calls`` on 8a's pair."""
    import torch
    import torch.distributed as dist

    from libssa_tpu_torch import matrices
    from libssa_tpu_torch.parallel import ring
    from libssa_tpu_torch.parallel.sharded import make_db_mesh

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        _, _, _, q, s, _ = pair_cases()[0]
        mesh = make_db_mesh(devices=[dev] * shards)
        b62 = matrices.builtin("BLOSUM62").padded()
        ring.ring_score(q[:1024], s[:1024], b62, 11, 1, True, mesh)  # warms the process
        got = ring_calls(mesh, q, s, b62, 11, 1, RING_MIN_C)
        print(json.dumps({"rank": rank, "backend": backend, "world": world,
                          "shards": mesh.size, "calls": got}), flush=True)
        return 0
    finally:
        dist.destroy_process_group()


def run_ring_ranks(backend: str, world: int, shards: int) -> list[dict]:
    """Phase 15's ``torch.distributed`` job: ``world`` subprocess ranks of
    ``shards`` shards, each killed if it outlives ``RANK_TIMEOUT``; their
    JSON lines."""
    import subprocess as sp

    port = _free_port()
    procs = [sp.Popen([sys.executable, os.path.abspath(__file__), "ring", backend, str(r),
                       str(world), str(port), str(shards)],
                      stdout=sp.PIPE, stderr=sp.PIPE, text=True)
             for r in range(world)]
    out = []
    try:
        for p in procs:
            try:
                stdout, stderr = p.communicate(timeout=RANK_TIMEOUT)
            except sp.TimeoutExpired:
                fail(15, f"a {backend} ring rank did not finish in {RANK_TIMEOUT} s")
            if p.returncode != 0:
                fail(15, f"a {backend} ring rank failed (rc {p.returncode}):\n{stdout}\n"
                         f"{stderr[-3000:]}")
            out.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def phase15(dev) -> int:
    """The ring (``parallel/ring.py``, ``parallel/ring_mm.py``) on the card;
    returns the K2 launches of its in-process calls."""
    import torch

    from libssa_tpu_torch import matrices
    from libssa_tpu_torch.experiments.k2_ab import trace_pair
    from libssa_tpu_torch.ops import longpair, ring_block_cuda
    from libssa_tpu_torch.parallel import ring
    from libssa_tpu_torch.parallel.ring_mm import ring_align_pair
    from libssa_tpu_torch.parallel.sharded import make_db_mesh
    from libssa_tpu_torch.search import leafnative
    from libssa_tpu_torch.search.hirschberg import align_pair_linear
    from libssa_tpu_torch.search.manager import SearchStats

    t_phase = time.perf_counter()
    if not leafnative.native_available():  # built before any wall is taken
        fail(15, "the native leaf solver (csrc/leafalign.cpp) did not build")
    nt = matrices.constant_scoring(5, -4).padded()
    b62 = matrices.builtin("BLOSUM62").padded()
    _, _, _, q8a, s8a, _ = pair_cases()[0]
    _, _, _, q8b, s8b, _ = pair_cases()[1]
    qb, sb = trace_pair()

    def wall(fn):
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    # What the ring is held to, outside the counted run: K3's scores and
    # align_pair_linear's alignments on the card.
    k3, linear = {}, {}
    for local in (True, False):
        wall(lambda: longpair.longpair_score(q8b, s8b, nt, 10, 1, local, device=dev))
        k3[local] = wall(lambda: longpair.longpair_score(q8b, s8b, nt, 10, 1, local, device=dev))
        linear[local] = wall(lambda: align_pair_linear(qb, sb, b62, 11, 1, local, device=dev))

    # The main path: counts from zero, read right after.
    ring_block_cuda.launches = 0
    lines = []
    for D in RING_SHARDS:
        mesh = make_db_mesh(devices=[dev] * D)
        for local in (True, False):
            runs = []
            for _ in range(2):  # the first call uploads the pair and warms the path
                launches, ring.phases = ring_block_cuda.launches, 0
                got, t = wall(lambda: ring.ring_score(q8b, s8b, nt, 10, 1, local, mesh))
                runs.append((t, ring_block_cuda.launches - launches, ring.phases))
                if got != k3[local][0]:
                    fail(15, f"15a {D} shards {'SW' if local else 'NW'}: ring score {got} != "
                             f"K3's {k3[local][0]}")
            if runs[1][1] != runs[1][2]:
                fail(15, f"15a {D} shards: {runs[1][1]} K2 launches over {runs[1][2]} phases")
            lines.append(f"15a {D} shard{'s' * (D > 1)} {'SW' if local else 'NW'} "
                         f"{runs[1][0]:.4f} (first {runs[0][0]:.4f}), K2 launches a call "
                         f"{runs[1][1]}, phases {runs[1][2]}")
    mesh = make_db_mesh(devices=[dev, dev])
    sweep = []
    for RB in RING_RBS:
        wall(lambda: ring.ring_score(q8b, s8b, nt, 10, 1, True, mesh, RB))
        ring.phases = 0
        got, t = wall(lambda: ring.ring_score(q8b, s8b, nt, 10, 1, True, mesh, RB))
        if got != k3[True][0]:
            fail(15, f"15a RB {RB}: ring score {got} != K3's {k3[True][0]}")
        sweep.append(f"{RB} {t:.4f} ({ring.phases} phases)")
    lines.append("15a 2 shards SW by RB: " + ", ".join(sweep))
    lines.append(f"15a K3 on the card SW {k3[True][1]:.4f}, NW {k3[False][1]:.4f}")
    for local in (True, False):
        st = SearchStats()
        launches, ring.phases = ring_block_cuda.launches, 0
        got, t = wall(lambda: ring_align_pair(qb, sb, b62, 11, 1, local, mesh=mesh,
                                              ring_min_cells=RING_MIN_B, stats=st))
        want, t_lin = linear[local]
        if got != want:
            fail(15, f"15b {'SW' if local else 'NW'}: the ring's traceback differs from "
                     f"align_pair_linear's (score {got.score} vs {want.score})")
        lines.append(f"15b 2 shards {'SW' if local else 'NW'} {t:.3f} against "
                     f"align_pair_linear {t_lin:.3f}: equal, score {got.score}, "
                     f"{len(got.cigar)} ops; K2 launches {ring_block_cuda.launches - launches}"
                     f", {ring.phases} phases over {st.aligner_dispatches - st.aligner_levels} "
                     f"ring calls, hand-off levels {st.aligner_levels}, device "
                     f"{st.aligner_device_seconds:.3f} s")
    # One process of 2 shards: what the ranks must give.
    want = ring_calls(mesh, q8a, s8a, b62, 11, 1, RING_MIN_C)
    launches = ring_block_cuda.launches
    ranks = run_ring_ranks("gloo", 2, 1) + run_ring_ranks("nccl", 1, 2)
    for r in ranks:
        for name, (got, t, k2, ph) in r["calls"].items():
            if got != want[name][0]:
                fail(15, f"15{'c' if r['backend'] == 'gloo' else 'd'} {r['backend']} rank "
                         f"{r['rank']} {name}: {got} != one process's {want[name][0]}")
    lines.append("15c/d 16,384^2 one process, 2 shards: " + ", ".join(
        f"{k} {t:.3f} ({k2} K2, {ph} phases)" for k, (_, t, k2, ph) in want.items()))
    for r in ranks:
        lines.append(f"15{'c' if r['backend'] == 'gloo' else 'd'} {r['backend']} rank "
                     f"{r['rank']}/{r['world']} (a mesh of {r['shards']}): " + ", ".join(
                         f"{k} {t:.3f} ({k2} K2, {ph} phases)"
                         for k, (_, t, k2, ph) in r["calls"].items()))
    say(f"phase 15 ring, {card_line()}, walls s: " + "; ".join(lines)
        + f"; every ring score equals K3's and every traceback align_pair_linear's or the "
        f"one process's; K2 launches {launches}; NCCL between two ranks not run (one card); "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 16 ----------------------------------------------------------------

# Phase 16: K1, K2 and K3 over drawn inputs. Each part draws from its own
# seed (DRAW_SEED + the part's index), so a failure reproduces from the seed
# and the draw's index it prints. The counts are fixed, sized on one H100
# so that the phase takes about 120 s.
DRAW_SEED = 1600
DRAWS = {"a": 120, "b": 50, "c": 300, "e": 28}
DRAW_REPEATS = 3  # launches of each (b) and (c) draw: a racy hand-off shows only some of the time
K1_DRAW_CELLS = 5 * 10**7  # (a): pairs x rows x columns x lanes at most, for the plain version's time
# Sizes at the kernels' edges: a K1 strip is 32 rows (16 in int64), a K2/K3
# stripe 32 x 4 or 32 x 8 rows, a group 4 stripes, a segment 8 columns.
DRAW_EDGES = (1, 2, 3, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255,
              256, 257, 511, 512, 513)
K3_DRAW_EDGES = (1, 2, 3, 7, 8, 9, 31, 32, 33, 127, 128, 129, 511, 512, 513)
WAVE_M, WAVE_N = 524_288, 4_096  # (d): 1,024 K3 groups of 4 warps x 4 rows x 32 bands
PAIR_DRAW_MAX = 6_000  # (e): align_pair's pairs, up to 36M cells


def draw_size(rng, hi: int, edges=DRAW_EDGES, p_edge: float = 0.3) -> int:
    """1 .. ``hi``: an edge with probability ``p_edge``, else log-uniform."""
    if rng.random() < p_edge:
        return int(rng.choice([e for e in edges if e <= hi]))
    return max(1, min(hi, int(np.exp(rng.uniform(0, np.log(hi + 1))))))


def draw_gaps(rng) -> tuple[int, int]:
    """Gotoh's (Q, R) with Q >= R >= 0, R = 0 and Q = R among them."""
    R = int(rng.integers(0, 5))
    return int(rng.choice([R, R + 1, R + int(rng.integers(2, 16))])), R


def draw_matrices():
    """The matrices the draws take, name -> (padded table, codes drawn)."""
    from libssa_tpu_torch import matrices
    from libssa_tpu_torch.constants import SymType

    out = {name: (matrices.builtin(name).padded(), 24)
           for name in ("BLOSUM62", "BLOSUM45", "BLOSUM80")}
    out["const 3/-2"] = (matrices.constant_scoring(3, -2, SymType.AMINOACID).padded(), 24)
    out["ACGT 5/-4"] = (matrices.constant_scoring(5, -4).padded(), 4)
    return out


def draw_fail(part: str, seed: int, index: int, what: str):
    fail(16, f"16{part} seed {seed} draw {index}: {what}")


def phase16a(dev) -> int:
    """K1 on the card against the same wrapper on the CPU (the plain
    version); returns the draws."""
    import torch

    from libssa_tpu_torch.io.db import PAD_CODE
    from libssa_tpu_torch.ops import interseq_cuda
    from libssa_tpu_torch.ops.scoring import make_padded_profile

    mats = draw_matrices()
    seed = DRAW_SEED + 1
    rng = np.random.default_rng(seed)
    for i in range(DRAWS["a"]):
        while True:  # the plain version's time bounds the draw
            nq, g = int(rng.integers(1, 9)), int(rng.integers(1, 4))
            P = int(rng.integers(1, nq * g + 1))
            m, B, n_pad = draw_size(rng, 3000), draw_size(rng, 600), draw_size(rng, 700)
            if P * m * n_pad * B <= K1_DRAW_CELLS:
                break
        name = str(rng.choice(sorted(mats)))
        mat, hi = mats[name]
        m_reals = np.where(rng.random(nq) < 0.5, m, rng.integers(1, m + 1, nq)).astype(np.int32)
        profs = np.stack([make_padded_profile(rng.integers(0, hi, mr).astype(np.uint8), mat, m)
                          for mr in m_reals]).astype(np.int32)
        lengths = rng.integers(0, n_pad + 1, (g, B)).astype(np.int32)
        lengths[:, rng.integers(0, B)] = n_pad
        codes = rng.integers(0, hi, (g, n_pad, B)).astype(np.int8)
        codes[np.arange(n_pad)[None, :, None] >= lengths[:, None, :]] = PAD_CODE
        iq = rng.integers(0, nq, P).astype(np.int32)
        ic = rng.integers(0, g, P).astype(np.int32)
        Q, R = draw_gaps(rng)
        local, track = bool(rng.integers(2)), bool(rng.integers(2))
        dtype = str(rng.choice(["int32", "int64"]))
        warps = rng.choice([None, *range(1, 17)])
        warps = None if warps is None else int(warps)
        cpu = [torch.as_tensor(a) for a in (profs, codes, lengths, iq, ic, m_reals)]
        kw = dict(local=local, track_range=track, dtype=dtype)
        want = interseq_cuda.interseq_pairs_cuda(*cpu, Q, R, **kw)
        got = interseq_cuda.interseq_pairs_cuda(*(t.to(dev) for t in cpu), Q, R, warps=warps,
                                                **kw)
        torch.cuda.synchronize()
        for out, a, b in zip(("scores", "hi", "lo"), got, want):
            if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
                draw_fail("a", seed, i, f"K1 {out} differ: nq={nq} m={m} m_reals="
                          f"{m_reals.tolist()} g={g} n_pad={n_pad} B={B} P={P} {name} "
                          f"Q={Q} R={R} local={local} track={track} {dtype} warps={warps}")
    return DRAWS["a"]


def draw_edges(rng, q, s, hi, mat, Q, R, local, dt, kind):
    """A tile's boundaries (leftH, leftE, topH, topF), CPU tensors, as K2's
    callers make them: SW's zeros or NW's open edges
    (``mm_device.open_edge``) ("open"), or the edges carried out of a tile
    to its left and one above it, each run by the plain version from open
    edges ("carried"); their codes are drawn below ``hi``."""
    import torch

    from libssa_tpu_torch.ops.mm_device import open_edge
    from libssa_tpu_torch.ops.ring_block import ring_block_plain

    rows, cols = len(q), len(s)
    if kind == "carried":
        sl = torch.as_tensor(rng.integers(0, hi, draw_size(rng, 64)).astype(np.uint8))
        ql = torch.as_tensor(rng.integers(0, hi, draw_size(rng, 64)).astype(np.uint8))
        left_in = draw_edges(rng, q, sl, hi, mat, Q, R, local, dt, "open")
        left = ring_block_plain(q, sl, mat, Q, R, local, *left_in)
        top = ring_block_plain(ql, s, mat, Q, R, local,
                               *draw_edges(rng, ql, s, hi, mat, Q, R, local, dt, "open"))
        return torch.cat([left_in[2][-1:], left.rightH]), left.rightE, top.botH, top.botF
    k = torch.arange(max(rows, cols) + 1, dtype=torch.int64)
    if local:
        left, top = torch.zeros(rows + 1, dtype=dt), torch.zeros(cols, dtype=dt)
    else:
        left = open_edge(Q - R, k[:rows + 1], R).to(dt)  # H[i][0]
        top = open_edge(Q - R, k[1:cols + 1], R).to(dt)  # H[0][j], j >= 1
    return left, left[1:] - Q + R, top, top - Q + R


def phase16b(dev) -> int:
    """K2 on the card, three launches a draw, against its plain version on
    the CPU; returns the draws."""
    import torch

    from libssa_tpu_torch.ops import ring_block, ring_block_cuda

    mats = draw_matrices()
    seed = DRAW_SEED + 2
    rng = np.random.default_rng(seed)
    for i in range(DRAWS["b"]):
        name = str(rng.choice(["BLOSUM62", "ACGT 5/-4"]))
        mat, hi = mats[name]
        mat_c = torch.as_tensor(mat)
        Q, R = draw_gaps(rng)
        local = bool(rng.integers(2))
        dt = torch.int64 if rng.integers(2) else torch.int32
        configs = k2_configs(dt.itemsize)
        ch, warps = configs[int(rng.integers(len(configs)))]
        qbuf = torch.as_tensor(rng.integers(0, hi, 2000).astype(np.uint8))
        sbuf = torch.as_tensor(rng.integers(0, hi, 2000).astype(np.uint8))
        jobs, parts = [], []
        for _ in range(draw_size(rng, 200)):
            rows, cols = draw_size(rng, 400), draw_size(rng, 600)
            q0, s0 = int(rng.integers(0, 2001 - rows)), int(rng.integers(0, 2001 - cols))
            kind = "carried" if rng.random() < 0.3 else "open"
            jobs.append([q0, rows, s0, cols])
            parts.append(draw_edges(rng, qbuf[q0:q0 + rows], sbuf[s0:s0 + cols], hi, mat_c, Q,
                                    R, local, dt, kind))
        jobs = np.array(jobs, np.int64)
        flat = [torch.cat(x) for x in zip(*parts)]
        want = ring_block.ring_block_batch_plain(qbuf, sbuf, jobs, mat_c, Q, R, local, *flat)
        launch = ring_block_cuda.stage(qbuf.to(dev), sbuf.to(dev), jobs, mat_c.to(dev), Q, R,
                                       local, *(t.to(dev) for t in flat), ch, warps=warps)
        for rep in range(DRAW_REPEATS):
            got = [None if t is None else t.cpu() for t in launch()]
            err = tiles_diff(got, want)
            if err:
                draw_fail("b", seed, i, f"K2 launch {rep} differs by {err}: {len(jobs)} tiles "
                          f"(rows, cols) {jobs[:, [1, 3]].tolist()} {name} Q={Q} R={R} "
                          f"local={local} {dt} rows a thread {ch} warps {warps}")
    return DRAWS["b"]


def phase16c(dev) -> int:
    """K3 on the card at every (rows, warps) that fits, three launches each,
    against its plain version on the CPU; returns the draws."""
    import torch

    from libssa_tpu_torch.ops import longpair, longpair_cuda

    mats = draw_matrices()
    seed = DRAW_SEED + 3
    rng = np.random.default_rng(seed)
    for i in range(DRAWS["c"]):
        m, n = (draw_size(rng, 5000, K3_DRAW_EDGES, 0.5) for _ in range(2))
        name = str(rng.choice(sorted(mats)))
        mat, hi = mats[name]
        mat_c = torch.as_tensor(mat)
        q = torch.as_tensor(rng.integers(0, hi, m).astype(np.uint8))
        s = torch.as_tensor(rng.integers(0, hi, n).astype(np.uint8))
        Q, R = draw_gaps(rng)
        local = bool(rng.integers(2))
        # The shorter side as the rows: the score is the same for these
        # symmetric matrices and equal gaps, and the sweep's time is its rows.
        a, b = (q, s) if m <= n else (s, q)
        want = int(longpair.longpair_score_plain(a, b, mat_c, Q, R, local, torch.int64))
        q_d, s_d, mat_d = q.to(dev), s.to(dev), mat_c.to(dev)
        for dt in (torch.int32, torch.int64):
            for ch, w in k3_configs(dt.itemsize):
                for rep in range(DRAW_REPEATS):
                    got = longpair_cuda.longpair_score_cuda(q_d, s_d, mat_d, Q, R, local, dt,
                                                            rows_per_thread=ch, warps=w)
                    if got.dtype != dt or int(got) != want:
                        draw_fail("c", seed, i, f"K3 launch {rep} {int(got)} != plain {want}: "
                                  f"m={m} n={n} {name} Q={Q} R={R} local={local} {dt} rows "
                                  f"a thread {ch} warps {w}")
    return DRAWS["c"]


def phase16d(dev) -> str:
    """One ACGT pair past one wave of K3 blocks, SW and NW: K3, K2 as one
    tile, K1 with P = 1 and the plain sweep of the transposed pair on the
    card, all equal; returns the report."""
    import torch

    from libssa_tpu_torch import matrices, oracle
    from libssa_tpu_torch.ops import interseq, longpair, longpair_cuda, ring_block_cuda
    from libssa_tpu_torch.ops.scoring import make_profile

    rng = np.random.default_rng(DRAW_SEED + 4)
    q = rng.integers(0, 4, WAVE_M).astype(np.uint8)
    s = rng.integers(0, 4, WAVE_N).astype(np.uint8)
    a, b = WAVE_N // 4, 3 * WAVE_N // 4  # a homologous stretch, 10% substituted
    s[a:b] = np.where(rng.random(b - a) < 0.1, rng.integers(0, 4, b - a),
                      q[WAVE_M // 2:WAVE_M // 2 + b - a])
    mat = matrices.constant_scoring(5, -4).padded()
    Q, R = oracle.gap_qr(10, 1)
    q_d, s_d = torch.as_tensor(q).to(dev), torch.as_tensor(s).to(dev)
    mat_d = torch.as_tensor(mat).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ch = longpair_cuda.band_rows(WAVE_M, sms)
    w = longpair_cuda.choose_warps(WAVE_M, ch, sms)
    groups = -(-WAVE_M // (32 * ch * w))
    resident = longpair_cuda.attrs(True, False, ch, w)["blocks_an_sm"] * sms
    if groups <= resident:
        fail(16, f"16d: {groups} K3 groups fit on the card at once ({resident})")
    prof = torch.as_tensor(make_profile(q, mat)).to(dev)
    report = []
    for local in (True, False):
        t_k3, k3 = cuda_ms(lambda: longpair_cuda.longpair_score_cuda(
            q_d, s_d, mat_d, Q, R, local))
        bounds = [b.to(dev) for b in dp_bounds(WAVE_M, WAVE_N, Q, R, local, torch.int32)]
        launch = ring_block_cuda.stage(q_d, s_d, [[0, WAVE_M, 0, WAVE_N]], mat_d, Q, R, local,
                                       *bounds)
        t_k2, tiles = cuda_ms(launch)
        k2 = tiles.rowmax.max() if local else tiles.botH[-1]
        t0 = time.perf_counter()
        k1 = interseq.pair_scores_batch(prof, s_d[None], torch.tensor([WAVE_N], device=dev),
                                        Q, R, local)[0]
        torch.cuda.synchronize()
        t_k1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = longpair.longpair_score_plain(s_d, q_d, mat_d, Q, R, local, torch.int32)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        scores = [int(x) for x in (k3, k2, k1, plain)]
        if len(set(scores)) != 1:
            fail(16, f"16d {'SW' if local else 'NW'}: K3, K2, K1 and the transposed plain "
                     f"sweep give {scores}")
        report.append(f"{'SW' if local else 'NW'} {scores[0]}: K3 {t_k3:.3f} ms, K2 {t_k2:.3f} "
                      f"ms (the launch alone, {launch.rows_per_thread} rows x "
                      f"{launch.warps} warps), K1 {t_k1:.3f} s, plain {t_plain:.3f} s")
    return (f"m={WAVE_M} x n={WAVE_N} ACGT 5/-4 10/1, {groups} K3 groups of {w} warps x {ch} "
            f"rows against {resident} resident: " + "; ".join(report))


def draw_fasta(rng, n_seqs: int, nt: bool) -> str:
    """A FASTA text of ``n_seqs`` records of 1-300 residues."""
    lens = [draw_size(rng, 300) for _ in range(n_seqs)]
    return "".join(f">s{i}\n{draw_residues(rng, n, nt)}\n" for i, n in enumerate(lens))


def draw_residues(rng, n: int, nt: bool) -> str:
    """``n`` residues, about 3% of them ambiguity codes."""
    from libssa_tpu_torch.constants import AA_ALPHABET, NT_ALPHABET

    alpha, core = (NT_ALPHABET, 4) if nt else (AA_ALPHABET[:-1], 20)
    codes = rng.integers(0, core, n)
    amb = rng.random(n) < 0.03
    codes[amb] = rng.integers(core, len(alpha), int(amb.sum()))
    return "".join(alpha[c] for c in codes)


def hit_fields(hits) -> list:
    """A hit list's fields but its statistics."""
    return [(h.seq_id, h.header, h.score, h.align_type, h.strand, h.db_frame, h.q_begin,
             h.q_end, h.s_begin, h.s_end, h.cigar, h.aligned) for h in hits]


def phase16e(dev) -> tuple[int, int, int]:
    """``SSAContext(device="cuda")`` against ``device="cpu"``: ``sw_align``,
    ``nw_align`` and ``align_many`` on drawn DBs and queries, each at every
    ``BitWidth`` in turn, and ``align_pair`` on drawn pairs; returns the
    draws, the sharded ones and the pairs past 16M cells."""
    import torch

    from libssa_tpu_torch.api import SSAContext
    from libssa_tpu_torch.constants import AlignType, BitWidth, ComputeMode, Strand, SymType

    seed = DRAW_SEED + 5
    rng = np.random.default_rng(seed)
    widths = list(BitWidth)
    # set_device_count on the card: 2 shards where there are 2 cards, else
    # 0 (every card: the sharded engine over the one).
    card_shards = 2 if torch.cuda.device_count() > 1 else 0
    sharded = huge = 0
    for i in range(DRAWS["e"]):
        op = ("sw", "nw", "many", "pair")[i % 4]
        bw = widths[(i // 4) % len(widths)]
        nt = bool(rng.random() < 0.3)
        go, ge = int(rng.integers(0, 16)), int(rng.integers(0, 5))
        fro = bool(rng.integers(2)) or go < ge
        mode = ComputeMode.ALIGNMENT if rng.random() < 0.4 else ComputeMode.SCORE
        at = AlignType.SW if rng.integers(2) else AlignType.NW
        k = int(rng.integers(1, 11))
        shard = op != "pair" and bool(rng.random() < 0.3)
        if op == "pair":
            m, n = (draw_size(rng, PAIR_DRAW_MAX) for _ in range(2))
            if i % 8 == 7:  # past 16M cells: the traceback's levels on K2
                m, n = (int(rng.integers(4100, PAIR_DRAW_MAX + 1)) for _ in range(2))
                mode = ComputeMode.ALIGNMENT
                huge += 1
            qs = draw_residues(rng, m, nt)
            ss = draw_residues(rng, n, nt)
            if rng.random() < 0.5:  # a homolog: the query's start, 10% substituted
                ss = "".join(c if rng.random() >= 0.1 else d for c, d in zip(qs[:n], ss))
                ss += draw_residues(rng, n - len(ss), nt)
            what = f"align_pair m={m} n={n}"
        else:
            db = draw_fasta(rng, int(rng.integers(1, 61)), nt)
            queries = [draw_residues(rng, draw_size(rng, 300), nt)
                       for _ in range(int(rng.integers(1, 5)))]
            what = f"{op}, queries of {[len(q) for q in queries]}"
        got = []
        for device in (dev, "cpu"):
            ctx = SSAContext(device=device)
            if nt:
                ctx.init_symbol_translation(SymType.NUCLEOTIDE, Strand.BOTH)
                ctx.init_constant_scoring(5, -4)
            else:
                ctx.init_score_matrix("BLOSUM62")
            ctx.init_gap_penalties(go, ge, fro)
            if op == "pair":
                got.append(hit_fields([ctx.align_pair(ctx.init_sequence_fasta(qs), ss, at,
                                                      mode)]))
                continue
            ctx.init_db_fasta(db)
            if shard:
                ctx.set_device_count(2 if device == "cpu" else card_shards)
            qs_ = [ctx.init_sequence_fasta(q) for q in queries]
            if op == "many":
                lists = ctx.align_many(qs_, k, mode, at, bw)
            else:
                fn = ctx.sw_align if op == "sw" else ctx.nw_align
                lists = [fn(q, k, bw, mode) for q in qs_]
            got.append([hit_fields(hl) for hl in lists])
        sharded += shard
        if got[0] != got[1]:
            draw_fail("e", seed, i, f"device='cuda' differs from 'cpu': {what}, "
                      f"{'ACGT 5/-4' if nt else 'BLOSUM62'} gaps {go}/{ge} "
                      f"first_residue_opens={fro} {at.name} {bw.name} {mode.name} k={k} "
                      f"sharded={shard}")
    return DRAWS["e"], sharded, huge


WALKTHROUGHS = {  # (f): each example and lines its output must hold
    "examples/torch_database_search.py": (
        "=== SW protein search", "=== NW global search", "=== Nucleotide search",
        "=== Translated search", "=== Multi-query batched search", "=== Sharded mesh search",
        "=== Long-pair alignment", "== traceback", "All sections completed."),
    "examples/torch_genome_pair.py": ("SW score ", "traceback: score "),
}


def phase16f() -> list[str]:
    """The walkthroughs as subprocesses on the card: exit 0 and their
    sections' lines; returns each one's seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = []
    for script, lines in WALKTHROUGHS.items():
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, script], capture_output=True, text=True,
                              timeout=600, cwd=root)
        missing = [line for line in lines if line not in proc.stdout]
        if proc.returncode != 0 or missing:
            fail(16, f"16f {script}: exit {proc.returncode}, missing {missing}\n"
                     f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        out.append(f"{script} {time.perf_counter() - t0:.1f} s")
    return out


def phase16(dev):
    """K1, K2 and K3 over drawn inputs, the API end to end and the
    walkthroughs, each part's draws and seconds on a line of its own."""
    t_phase = time.perf_counter()

    def part(name, fn, what):
        t0 = time.perf_counter()
        got = fn()
        say(f"phase 16{name} {what(got)}: {time.perf_counter() - t0:.1f} s")

    part("a", lambda: phase16a(dev), lambda n: f"K1 vs its plain version (the wrapper on "
         f"the CPU): {n} draws (seed {DRAW_SEED + 1}) equal, scores, hi and lo")
    part("b", lambda: phase16b(dev), lambda n: f"K2 vs its plain version: {n} draws (seed "
         f"{DRAW_SEED + 2}) of 1-200 tiles, {DRAW_REPEATS} launches each, every output equal")
    part("c", lambda: phase16c(dev), lambda n: f"K3 vs its plain version: {n} draws (seed "
         f"{DRAW_SEED + 3}) at every (rows, warps) that fits, int32 and int64, "
         f"{DRAW_REPEATS} launches each, equal")
    part("d", lambda: phase16d(dev), lambda r: f"past one wave, {card_line()}: {r}; "
         f"K3, K2, K1 and the transposed plain sweep equal")
    part("e", lambda: phase16e(dev), lambda r: f"SSAContext cuda vs cpu: {r[0]} draws (seed "
         f"{DRAW_SEED + 5}), {r[1]} sharded, {r[2]} align_pair past 16M cells, hit lists "
         f"equal field by field")
    part("f", phase16f, lambda r: "walkthroughs exit 0 with every section: " + ", ".join(r))
    say(f"phase 16 drawn inputs: no difference; phase {time.perf_counter() - t_phase:.1f} s")


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
    launches, _, _, eng = phase34(dev)
    phase5()
    t_k1, t_plain = phase6(dev, eng)["kernel"]
    launches += phase14(dev, eng)
    del eng
    ring_launches = phase15(dev)
    err7 = phase7(dev)
    k3_launches, err8, (t_k3, t_k3_plain) = phase8(dev)
    phase9(dev)
    err10, t_k2, t_k2_plain, b_k2 = phase10(dev)
    k2_launches = phase11(dev) + ring_launches
    probe_entries = phase12(dev)
    variant_entries = phase13(dev)
    phase16(dev)  # after every count of the main path is read

    # bound_ms at each timed shape: K1 at bench.py's kernel shape (subject
    # codes in, one score and range out per subject), K3 at 8a SW (codes in),
    # K2 at (a), 11a's first level (``k2_bound``).
    b_k1 = bound_ms(256 * 8192 * 512, CELL_SW_TRACK, 8192 * 512 + 8192 * 12)
    b_k3 = bound_ms(PAIR_PROTEIN ** 2, CELL_SW, 2 * PAIR_PROTEIN)
    say(json.dumps({"kernels": [{
        "name": "K1 interseq (inter-sequence SW/NW scoring)",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": launches,  # phases 3 and 14
        "max_abs_err": err2,  # phase 6 fails on any difference
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
        "launches": k2_launches,  # phases 11 and 15
        "max_abs_err": err10,
        "ms": t_k2,
        "plain_ms": t_k2_plain,
        "bound_ms": b_k2[0],
        "bound_by": b_k2[1],
        "library_ms": None,
    }, *probe_entries, *variant_entries]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["rank"]:  # one rank of phase 14's job
        sys.exit(rank_main(sys.argv[2], *map(int, sys.argv[3:7])))
    if sys.argv[1:2] == ["ring"]:  # one rank of phase 15's job
        sys.exit(ring_rank_main(sys.argv[2], *map(int, sys.argv[3:7])))
    sys.exit(main())
