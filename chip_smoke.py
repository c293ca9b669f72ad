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
   BLOSUM62 11/1, m=256, B=8192, n=512, track_range).

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    # Fails here, before any output, where the port is not beside the script.
    from libssa_tpu_torch.ops import interseq_cuda

    say(card_line())  # name, power limit: as nvidia-smi prints them
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    interseq_cuda._lib()
    say(f"phase 1 build K1 ({K1_SOURCE}, nvcc sm_90a): ok, {time.perf_counter() - t0:.1f} s")
    err2 = phase2(dev)
    launches, _, _ = phase34(dev)
    phase5()
    t_k1, t_plain, err6 = phase6(dev)

    say(json.dumps({"kernels": [{
        "name": "K1 interseq (inter-sequence SW/NW scoring)",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": launches,
        "max_abs_err": max(err2, err6),
        "ms": t_k1,
        "plain_ms": t_plain,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
