"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — database search through ``SearchEngine`` and
``SSAContext`` — on the card, at the flagship database size of ``bench.py``
(500,000 lognormal subjects, about 174M residues). Phases, one line each:

1. build K1 (``libssa_tpu_torch/csrc/interseq.cu``) with nvcc;
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
   NumPy oracle.

Any failed phase exits non-zero. Without CUDA the script exits non-zero
before printing any result. JAX is blocked from import.
"""
from __future__ import annotations

import sys

sys.modules["jax"] = None  # the port must run with JAX absent

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

K1_REPLACES = "libssa_tpu/ops/interseq_pallas.py:92"
K1_SOURCE = "libssa_tpu_torch/csrc/interseq.cu"
K3_REPLACES = "libssa_tpu/ops/longpair_pallas.py:96"
K3_SOURCE = "libssa_tpu_torch/csrc/longpair.cu"
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
    from libssa_tpu.io.db import PAD_CODE
    from libssa_tpu.ops.scoring import make_padded_profile, make_profile

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

    from libssa_tpu import matrices
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
    from libssa_tpu.constants import SymType
    from libssa_tpu.io.db import SequenceDB

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
    from libssa_tpu import matrices, oracle

    fn = oracle.sw_score if local else oracle.nw_score
    return fn(q, s, matrices.builtin("BLOSUM62").scores, 11, 1)


def phase34(dev):
    import concurrent.futures
    import multiprocessing

    import torch

    from libssa_tpu import matrices
    from libssa_tpu.constants import BitWidth
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
    from libssa_tpu.constants import BitWidth, ComputeMode
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

    from libssa_tpu import matrices
    from libssa_tpu.ops.scoring import make_profile
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
    """Phase 1: one nvcc per source, all started together."""
    import concurrent.futures

    from libssa_tpu_torch.ops import interseq_cuda, longpair_cuda

    t0 = time.perf_counter()

    def build(lib):
        lib()
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        t_k1, t_k3 = pool.map(build, (interseq_cuda._lib, longpair_cuda._lib))
    say(f"phase 1 build K1 ({K1_SOURCE}) and K3 ({K3_SOURCE}), nvcc sm_90a in "
        f"parallel: ok, K1 {t_k1:.1f} s, K3 {t_k3:.1f} s")


# -- phase 7 ----------------------------------------------------------------


def phase7(dev):
    import torch

    from libssa_tpu import matrices, oracle
    from libssa_tpu.constants import SymType
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


def phase8(dev):
    import torch

    from libssa_tpu import alphabet, matrices, oracle
    from libssa_tpu.constants import AlignType, ComputeMode, Strand, SymType
    from libssa_tpu_torch.api import SSAContext
    from libssa_tpu_torch.ops import longpair, longpair_cuda

    rng = np.random.default_rng(88)

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

    def related(codes, hi, rate):
        """A homolog: substitutions at ``rate`` and a few indels."""
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

    from libssa_tpu import matrices, oracle
    from libssa_tpu.ops.scoring import make_profile
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    # Fails here, before any output, where the port is not beside the script.
    from libssa_tpu_torch.ops import interseq_cuda, longpair_cuda  # noqa: F401

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

    say(json.dumps({"kernels": [{
        "name": "K1 interseq (inter-sequence SW/NW scoring)",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": launches,
        "max_abs_err": max(err2, err6),
        "ms": t_k1,
        "plain_ms": t_plain,
    }, {
        "name": "K3 longpair (one whole pair, SW/NW score)",
        "route": "cuda",
        "source": K3_SOURCE,
        "replaces": K3_REPLACES,
        "launches": k3_launches,
        "max_abs_err": max(err7, err8),
        "ms": t_k3,
        "plain_ms": t_k3_plain,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
