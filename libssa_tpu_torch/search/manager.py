"""Search orchestration: chunked DB sweep + adaptive-precision ladder.

Counterpart of ``libssa_tpu/search/manager.py``: split the database into
length-sorted same-shape chunk groups, run the configured precision rung
over every group, collect per-subject scores and overflow flags, and
rescore only the flagged subjects at the next rung until none overflow.

Precision rungs (see ``ops/interseq.py``):
  * 8-/16-bit rungs emulate the reference's saturating windows by flagging
    lanes whose running score range leaves [0, 255] / [-32767, 32767].
  * ``dtype="float32"`` keeps the reference's +/-2**24 window flags, so rung
    statistics equal the JAX package's. The port computes that dtype in
    exact int32: the window only decides which subjects are rescored, and a
    rescore recomputes scores that were already exact.
  * The terminal rung is int64: K1's int64 instantiation on the card, the
    plain version's int64 path on the CPU. ``BitWidth.BIT64`` runs it
    directly over the whole DB.

Every tensor lives on the engine's ``device``. There is no silent device
choice: "cuda" raises where CUDA is absent, and "cpu" runs only when it is
asked for.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..constants import SCORE_LIMIT_8, SCORE_LIMIT_16, BitWidth
from ..convert import stacks_to_device
from ..io.db import SequenceDB
from ..matrices import ScoreMatrix
from ..ops.interseq_cuda import SCRATCH_BUDGET
from ..ops.longpair import score_bound
from ..ops.scoring import make_padded_profile
from ..ops.topk import host_topk
from ..util.profiling import adopt, span

F32_WINDOW = 2**24 - 1  # the reference's exact f32 integer window


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; "cuda" without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda | cpu)")
    return dev


@dataclass
class SearchParams:
    """Tunables mirroring the reference's set_* config calls."""

    batch_size: int = 8192  # subjects per device batch (chunk size)
    length_multiple: int = 64  # pad batch lengths to this multiple
    use_matmul: bool = True  # interface parity; no meaning off the TPU
    dtype: str = "float32"  # "float32" (window flags) | "int32" | "int64"
    kernel: str = "auto"  # "auto" | "cuda" | "plain" (forced)
    # True -> a gap's first residue costs open+extend (Q = open+extend);
    # False -> Q = open.
    first_residue_opens: bool = True


@dataclass
class SearchStats:
    """Per-search instrumentation; the same fields as the JAX package's."""

    cells: int = 0  # DP cells computed (sum of m * subject_len)
    seconds: float = 0.0
    subjects: int = 0
    # Rung statistics: key -> count of work units the rung's window
    # flagged. A bare ``limit>N`` counts SUBJECTS (single-query sweeps),
    # ``limit>N/pairs`` counts (query, subject) PAIRS (batched multi-query
    # sweeps), ``limit>N/entries`` counts DB ENTRIES flagged in any query
    # frame (frame-fanout sweeps).
    rescored: dict = field(default_factory=dict)
    dispatches: int = 0  # stage sweeps run
    fetches: int = 0  # device-to-host result copies
    # Traceback (ALIGNMENT mode) accounting, apart from the search stage so
    # ``gcups`` stays search cells / search seconds.
    aligner_seconds: float = 0.0
    aligner_cells: int = 0
    aligner_dispatches: int = 0  # K2 launches of linear-space tracebacks
    # Port-only: their Myers-Miller levels on the device, and the wall
    # seconds of the device passes (launch to fetch) within aligner_seconds.
    aligner_levels: int = 0
    aligner_device_seconds: float = 0.0
    notes: list = field(default_factory=list)
    # The request's spans while a torch.profiler profile records
    # (util/profiling.py); empty otherwise.
    spans: list = field(default_factory=list)

    @property
    def gcups(self) -> float:
        return self.cells / self.seconds / 1e9 if self.seconds > 0 else 0.0

    def merge(self, other: "SearchStats", work: bool = False) -> None:
        """Fold a nested engine run's accounting into this sweep's stats.

        The outer sweep's wall-clock interval already contains the nested
        run, so ``seconds`` never carries over. ``work=True`` also carries
        cells/subjects (genuine extra work, e.g. an overflow rescore). The
        nested run's spans go under the span open here.
        """
        if work:
            self.cells += other.cells
            self.subjects += other.subjects
        self.dispatches += other.dispatches
        self.fetches += other.fetches
        self.aligner_seconds += other.aligner_seconds
        self.aligner_cells += other.aligner_cells
        self.aligner_dispatches += other.aligner_dispatches
        self.aligner_levels += other.aligner_levels
        self.aligner_device_seconds += other.aligner_device_seconds
        for k, v in other.rescored.items():
            self.rescored[k] = self.rescored.get(k, 0) + v
        self.notes.extend(other.notes)
        adopt(self.spans, other.spans)


def _rungs(bit_width: BitWidth, dtype: str):
    """Ladder of (limit, dtype) stages ending in an exact terminal pass.

    ``BitWidth.BIT64`` runs the int64 lane directly. A float32 rung can
    flag f32-window escapes, and a narrow rung window escapes, so both end
    in the int64 lane; a pinned "int32" EXACT pass is windowless.
    """
    if bit_width == BitWidth.BIT8:
        ladder = [(SCORE_LIMIT_8, dtype), (SCORE_LIMIT_16, dtype)]
    elif bit_width == BitWidth.BIT16:
        ladder = [(SCORE_LIMIT_16, dtype)]
    elif bit_width == BitWidth.BIT64:
        return [(None, "int64")]
    else:  # EXACT: single pass
        ladder = [(None, dtype)]
    if ladder[-1][0] is not None or ladder[-1][1] == "float32":
        ladder.append((None, "int64"))
    return ladder


def _eff_limit(limit, dtype_str: str):
    """The stage's flagging window: the rung's, narrowed by the f32 one."""
    if dtype_str == "float32":
        return min(limit, F32_WINDOW) if limit is not None else F32_WINDOW
    return limit


class SearchEngine:
    """One query-vs-database scoring engine over a packed DB."""

    def __init__(
        self,
        db: SequenceDB,
        matrix: ScoreMatrix,
        gap_open: int,
        gap_extend: int,
        params: SearchParams | None = None,
        device="cuda",
    ):
        from ..oracle import gap_qr
        from ..util.hostmem import retain_large_allocations

        retain_large_allocations()
        self.device = resolve_device(device)
        self.db = db
        self.matrix = matrix
        self.padded_matrix = matrix.padded()
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        self.params = params or SearchParams()
        self.gap_q, self.gap_r = gap_qr(
            gap_open, gap_extend, self.params.first_residue_opens
        )
        # Largest |profile entry|, pad fill included: K1's int32/int64 choice.
        self._max_abs = int(np.abs(self.padded_matrix).max())
        self._device_stacks: dict = {}
        self._scratch: torch.Tensor | None = None

    def _sweeps(self, local: bool, dtype_str: str, eff_limit, nlimit=None):
        """The five stage sweeps for this engine's kernel, gaps and device."""
        from . import kernels

        if self.device.type == "cuda" and self._scratch is None:
            # K1's strip-edge scratch: one budget per engine, reused by every
            # launch (the wrapper splits a group's pairs to fit it).
            self._scratch = torch.empty(
                SCRATCH_BUDGET, dtype=torch.uint8, device=self.device
            )
        return kernels.stage_sweep(
            self.params.kernel, int(self.gap_q), int(self.gap_r), local,
            self.params.use_matmul, dtype_str, eff_limit, nlimit,
            max_abs=self._max_abs, scratch=self._scratch,
        )

    def _profiles(self, seqs, rows=None) -> torch.Tensor:
        """Stacked padded profiles ``(len(seqs), rows, 32)`` int32 on device."""
        profs = np.stack(
            [make_padded_profile(q, self.padded_matrix, rows=rows) for q in seqs]
        )
        return torch.as_tensor(profs, dtype=torch.int32).to(self.device)

    def _stacks_on_device(self, db, bs: int):
        """Device-resident grouped chunk stacks, uploaded ONCE per engine.

        Keyed on the values that shape the stacks — (batch size, length
        multiple) — so mutating ``engine.params`` between searches re-packs.
        Subset databases (ladder rescores) are small and not cached.
        """
        p = self.params
        grouped = db.grouped_stacks(bs, p.length_multiple)
        if db is not self.db:
            return grouped, stacks_to_device(grouped, self.device)
        key = (bs, p.length_multiple)
        if key not in self._device_stacks:
            # Bounded LRU: each entry pins the whole packed DB on the device.
            while len(self._device_stacks) >= 2:
                self._device_stacks.pop(next(iter(self._device_stacks)))
            self._device_stacks[key] = stacks_to_device(grouped, self.device)
        else:
            self._device_stacks[key] = self._device_stacks.pop(key)  # LRU touch
        return grouped, self._device_stacks[key]

    def prepare(
        self, query_length: int = 256, local: bool = True, k: int = 10
    ) -> None:
        """Serving warm-up: pack, upload and build K1 ahead of queries.

        Runs the searches real requests run (EXACT, BIT8, BIT16) on a dummy
        query, so the first request pays none of the one-time costs.
        """
        q = np.zeros(max(1, query_length), dtype=np.uint8)
        for bw in (BitWidth.EXACT, BitWidth.BIT8, BitWidth.BIT16):
            self.search(q, k=k, local=local, bit_width=bw)

    # -- scoring ----------------------------------------------------------

    def _stage_scores(
        self, db: SequenceDB, profile, m_real, local, limit, dtype_str,
        stats=None,
    ):
        """Score every subject in ``db``; return (scores, overflow_ids)."""
        p = self.params
        eff_limit = _eff_limit(limit, dtype_str)
        # Rescore passes touch few subjects: shrink the batch (power of two).
        bs = min(p.batch_size, max(8, 1 << (max(len(db), 1) - 1).bit_length()))
        grouped, dev_stacks = self._stacks_on_device(db, bs)
        sweep, *_ = self._sweeps(local, dtype_str, eff_limit)
        stacks = tuple((codes, lens) for codes, lens, _ in dev_stacks)
        s_flat, f_flat = sweep(profile, stacks, m_real)
        if stats is not None:
            stats.dispatches += 1
        with span(stats, "device.wait"):
            s_all = s_flat.cpu().numpy()
            f_all = f_flat.cpu().numpy() if eff_limit is not None else None
        if stats is not None:
            stats.fetches += 1 + (1 if eff_limit is not None else 0)

        scores = np.zeros(len(db), dtype=np.int64)
        over: list[np.ndarray] = []
        off = 0
        for _, _, seq_id_list in grouped:
            for seq_ids in seq_id_list:
                nb = len(seq_ids)
                lanes = seq_ids >= 0
                local_ids = seq_ids[lanes]
                scores[local_ids] = s_all[off : off + nb][lanes]
                if f_all is not None:
                    over.append(local_ids[f_all[off : off + nb][lanes]])
                off += nb
        over_ids = (
            np.concatenate(over).astype(np.int32)
            if over
            else np.zeros(0, dtype=np.int32)
        )
        return scores, np.sort(over_ids)

    def score_all(
        self,
        q_codes: np.ndarray,
        local: bool = True,
        bit_width: BitWidth = BitWidth.EXACT,
        stats: SearchStats | None = None,
    ) -> np.ndarray:
        """Exact scores for the query vs every DB subject (ladder applied)."""
        if len(q_codes) == 0:
            raise ValueError("empty query")
        m = len(q_codes)
        profile = self._profiles([q_codes])[0]
        stats = stats if stats is not None else SearchStats()

        t0 = time.perf_counter()
        db = self.db
        scores = None
        for limit, dtype_str in _rungs(bit_width, self.params.dtype):
            stage_scores, over_ids = self._stage_scores(
                db, profile, m, local, limit, dtype_str, stats
            )
            if scores is None:
                scores = stage_scores
            else:
                scores[db.subset_ids] = stage_scores  # overwrite rescored
            stats.cells += int(m) * db.total_residues
            if len(over_ids) == 0:
                break
            if db is not self.db:  # a rescore subset: map back to self.db's ids
                over_ids = db.subset_ids[over_ids]
            key = f"limit>{_eff_limit(limit, dtype_str)}"
            stats.rescored[key] = stats.rescored.get(key, 0) + len(over_ids)
            db = self.db.subset(over_ids)
        stats.seconds += time.perf_counter() - t0
        stats.subjects += len(self.db)
        return scores

    def search(
        self,
        q_codes: np.ndarray,
        k: int,
        local: bool = True,
        bit_width: BitWidth = BitWidth.EXACT,
        stats: SearchStats | None = None,
    ):
        """Top-k (scores, seq_ids) for one query, reference hit ordering."""
        if bit_width == BitWidth.BIT64:
            # The int64 lane over the whole DB: full score fetch + host top-k.
            stats = stats if stats is not None else SearchStats()
            scores = self.score_all(q_codes, local, bit_width, stats)
            return host_topk(scores, np.arange(len(scores), dtype=np.int32), k)
        if bit_width == BitWidth.EXACT:
            return self.search_many([q_codes], k, local, stats)[0]
        return self._ladder_search_device(q_codes, k, local, bit_width, stats)

    def _window_risk(self, m: int) -> bool:
        """Could any |score| leave the f32 window (float32 dtype only)?"""
        if self.params.dtype != "float32":
            return False
        L = int(self.db.lengths.max()) if len(self.db) else 0
        bound = score_bound(
            m, L, self.padded_matrix, int(self.gap_q), int(self.gap_r)
        )
        return bound >= F32_WINDOW

    def _ladder_search_device(self, q_codes, k, local, bit_width, stats):
        """BIT8/BIT16 search (SW or NW): one sweep + one small fetch.

        ``sweep_ladder_topk`` computes the rung's scores, the overflow flags
        (32 lanes per word) and the device top-k. The flags are rung
        statistics; the recompute runs only when the f32 window itself is
        at risk (the sweep's scores are exact inside it).
        """
        p = self.params
        stats = stats if stats is not None else SearchStats()
        if len(q_codes) == 0:
            raise ValueError("empty query")
        t0 = time.perf_counter()
        m = len(q_codes)
        profile = self._profiles([q_codes])[0]

        grouped, dev_stacks = self._stacks_on_device(self.db, p.batch_size)
        limit = SCORE_LIMIT_8 if bit_width == BitWidth.BIT8 else SCORE_LIMIT_16
        eff_limit = _eff_limit(limit, p.dtype)
        *_, sweep_ladder = self._sweeps(local, p.dtype, eff_limit)
        out_dev, s_m, _ = sweep_ladder(profile, dev_stacks, m, k)
        stats.dispatches += 1
        fetched = out_dev.cpu().numpy()  # the ONLY fetch when nothing overflows
        stats.fetches += 1
        stats.cells += m * self.db.total_residues

        flat_ids = np.concatenate(
            [np.stack(sids).reshape(-1) for _, _, sids in grouped]
        )
        n_lanes = len(flat_ids)
        kk = min(k, n_lanes)
        top_s = fetched[:kk].astype(np.int64)
        top_i = fetched[kk : 2 * kk].astype(np.int32)
        packed = fetched[2 * kk :].astype(np.uint32)
        flags = (
            (packed[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
        ).astype(bool).reshape(-1)[:n_lanes]

        over_ids = np.unique(flat_ids[flags & (flat_ids >= 0)]).astype(np.int32)
        if len(over_ids):
            stats.rescored[f"limit>{eff_limit}"] = len(over_ids)
        if len(over_ids) and self._window_risk(m):
            # A genuine f32-window risk: rescore the flagged subjects at the
            # next width and merge on the host in int64.
            sub = self.db.subset(over_ids)
            sub_bw = (
                BitWidth.BIT16 if bit_width == BitWidth.BIT8 else BitWidth.EXACT
            )
            rescue_stats = SearchStats()
            r = SearchEngine(
                sub, self.matrix, self.gap_open, self.gap_extend, p,
                device=self.device,
            ).score_all(q_codes, local, sub_bw, rescue_stats)
            stats.merge(rescue_stats, work=True)
            s_host = s_m.cpu().numpy().astype(np.int64)
            stats.fetches += 1
            pos = np.full(len(self.db), -1, dtype=np.int64)
            valid = flat_ids >= 0
            pos[flat_ids[valid]] = np.nonzero(valid)[0]
            s_host[pos[over_ids]] = r
            top_s, top_i = host_topk(s_host, flat_ids, kk)
        n_valid = int((top_i != 2**31 - 1).sum())
        stats.subjects += len(self.db)
        stats.seconds += time.perf_counter() - t0
        return top_s[:n_valid], top_i[:n_valid]

    # -- multi-query ------------------------------------------------------

    def score_all_many(
        self,
        queries: list[np.ndarray],
        local: bool = True,
        stats: SearchStats | None = None,
    ) -> np.ndarray:
        """(n_queries, n_subjects) exact score matrix for many queries.

        Every (query, chunk) pair of a profile-height group is one sweep;
        f32-window escapees are rescored exactly, one subset engine per
        query.
        """
        p = self.params
        stats = stats if stats is not None else SearchStats()
        if not queries or any(len(q) == 0 for q in queries):
            raise ValueError("need at least one non-empty query")
        t0 = time.perf_counter()

        track = p.dtype == "float32"
        qgroups: dict[int, list[int]] = {}
        for qi, q in enumerate(queries):
            qgroups.setdefault(len(q) + ((-len(q)) % 32), []).append(qi)
        grouped, dev_stacks = self._stacks_on_device(self.db, p.batch_size)

        eff_limit = F32_WINDOW if track else None
        _, sweep_multi, *_ = self._sweeps(local, p.dtype, eff_limit)
        results = []  # (row_map: [(qi, seq_ids)], s_all, f_all)
        for qids in qgroups.values():
            prof_stack = self._profiles([queries[qi] for qi in qids])
            m_reals = [len(queries[qi]) for qi in qids]
            stacks = []
            row_map = []
            nq = len(qids)
            for (codes, lens, _), (_, _, seq_id_list) in zip(
                dev_stacks, grouped
            ):
                nc = len(seq_id_list)
                iq = np.repeat(np.arange(nq, dtype=np.int32), nc)
                ic = np.tile(np.arange(nc, dtype=np.int32), nq)
                stacks.append((codes, lens, iq, ic))
                row_map.extend(
                    (qids[qr], seq_id_list[cr]) for qr, cr in zip(iq, ic)
                )
            s_flat, f_flat = sweep_multi(prof_stack, tuple(stacks), m_reals)
            stats.dispatches += 1
            with span(stats, "device.wait"):
                results.append(
                    (
                        row_map,
                        s_flat.cpu().numpy(),
                        f_flat.cpu().numpy() if track else None,
                    )
                )
            stats.fetches += 1 + (1 if track else 0)

        scores = np.zeros((len(queries), len(self.db)), dtype=np.int64)
        needs_exact: list[tuple[int, int]] = []
        for row_map, s_all, f_all in results:
            off = 0
            for qi, seq_ids in row_map:
                nb = len(seq_ids)
                lanes = seq_ids >= 0
                ids = seq_ids[lanes]
                scores[qi, ids] = s_all[off : off + nb][lanes]
                if f_all is not None:
                    flags = f_all[off : off + nb][lanes]
                    needs_exact.extend((qi, int(i)) for i in ids[flags])
                off += nb
        # f32-window escapees: an exact int32 pass while the a-priori bound
        # fits int32, the int64 lane beyond it.
        by_query: dict[int, list[int]] = {}
        for qi, sid in needs_exact:
            by_query.setdefault(qi, []).append(sid)
        for qi, sids in by_query.items():
            sub_ids = np.asarray(sorted(set(sids)), dtype=np.int32)
            sub = self.db.subset(sub_ids)
            bound = score_bound(
                len(queries[qi]), int(sub.lengths.max()),
                self.padded_matrix, int(self.gap_q), int(self.gap_r),
            )
            rescue_stats = SearchStats()
            eng = SearchEngine(
                sub, self.matrix, self.gap_open, self.gap_extend,
                SearchParams(
                    batch_size=8, dtype="int32", kernel=p.kernel,
                    first_residue_opens=p.first_residue_opens,
                ),
                device=self.device,
            )
            scores[qi, sub_ids] = eng.score_all(
                queries[qi], local,
                BitWidth.EXACT if bound < 2**31 - 1 else BitWidth.BIT64,
                rescue_stats,
            )
            stats.merge(rescue_stats, work=True)
        for q in queries:
            stats.cells += len(q) * self.db.total_residues
        stats.subjects += len(queries) * len(self.db)
        stats.seconds += time.perf_counter() - t0
        return scores

    def search_many(
        self,
        queries: list[np.ndarray],
        k: int,
        local: bool = True,
        stats: SearchStats | None = None,
        bit_width: BitWidth = BitWidth.EXACT,
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Per-query top-k hit lists for a batch of queries.

        Top-k reduces on the device: only (Q, k) lists plus an any-overflow
        scalar come back; an f32-window overflow falls back to the
        full-matrix path. A narrow ``bit_width`` (BIT8/BIT16) counts the
        (query, subject) pairs whose score range left the requested window
        as ``stats.rescored``; the hit lists equal EXACT's. Queries of
        different profile heights (32-row multiples) sweep one height at a
        time.
        """
        stats = stats if stats is not None else SearchStats()
        if not queries or any(len(q) == 0 for q in queries):
            raise ValueError("need at least one non-empty query")
        nlimit = {
            BitWidth.BIT8: SCORE_LIMIT_8,
            BitWidth.BIT16: SCORE_LIMIT_16,
        }.get(bit_width)
        if bit_width == BitWidth.BIT64:
            note = (
                "BIT64 on the batched path: exact sweep with "
                "int64-terminal escapes; direct int64 sweep is the "
                "single-query search()"
            )
            if note not in stats.notes:  # once a stats, as the JAX package's
                stats.notes.append(note)
        with span(stats, "search.many"):
            # One device top-k sweep a profile height.
            hgroups: dict[int, list[int]] = {}
            for qi, q in enumerate(queries):
                hgroups.setdefault(len(q) + ((-len(q)) % 32), []).append(qi)
            out: list = [None] * len(queries)
            for rows, qis in hgroups.items():
                with span(stats, "search.group", queries=len(qis), rows=rows):
                    hits = self._search_group(
                        [queries[qi] for qi in qis], k, local, stats, nlimit
                    )
                for qi, r in zip(qis, hits):
                    out[qi] = r
            return out

    def _search_group(self, queries, k, local, stats, nlimit):
        """``search_many`` for queries of one profile height: one sweep, the
        device top-k and one fetch."""
        p = self.params
        t0 = time.perf_counter()
        prof_stack = self._profiles(queries)
        grouped, dev_stacks = self._stacks_on_device(self.db, p.batch_size)
        _, _, sweep_topk, *_ = self._sweeps(
            local, p.dtype, F32_WINDOW if p.dtype == "float32" else None, nlimit
        )
        nq = len(queries)
        m_reals = [len(q) for q in queries]
        stacks = []
        for codes, lens, ids_d in dev_stacks:
            nc = int(codes.shape[0])
            iq = np.repeat(np.arange(nq, dtype=np.int32), nc)
            ic = np.tile(np.arange(nc, dtype=np.int32), nq)
            stacks.append((codes, lens, ids_d, iq, ic))
        top_s, top_i, any_f, n_fl = sweep_topk(
            prof_stack, tuple(stacks), m_reals, k, nq, stats
        )
        stats.dispatches += 1
        fetched = torch.cat(
            [
                top_s.reshape(-1).long(),
                top_i.reshape(-1).long(),
                any_f.long().reshape(1),
                n_fl.long().reshape(1),
            ]
        )
        with span(stats, "device.wait"):
            fetched = fetched.cpu().numpy()
        stats.fetches += 1
        if nlimit is not None and fetched[-1]:
            key = f"limit>{nlimit}/pairs"
            stats.rescored[key] = stats.rescored.get(key, 0) + int(fetched[-1])
        if fetched[-2]:
            # f32-window overflow somewhere: exact full-matrix fallback.
            # Attribute the aborted sweep's cells/time first.
            for q in queries:
                stats.cells += len(q) * self.db.total_residues
            stats.subjects += nq * len(self.db)
            stats.seconds += time.perf_counter() - t0
            scores = self.score_all_many(queries, local, stats)
            ids = np.arange(scores.shape[1])
            return [host_topk(scores[qi], ids, k) for qi in range(nq)]
        kk = min(k, (len(fetched) - 2) // (2 * nq))
        s_mat = fetched[: nq * kk].reshape(nq, kk)
        i_mat = fetched[nq * kk : 2 * nq * kk].reshape(nq, kk)
        # Padding lanes sort last as (NEG, INVALID): trim them (every query
        # sees the same subject set, so the valid count is shared).
        n_valid = int((i_mat[0] != 2**31 - 1).sum()) if nq else 0
        kk = min(kk, n_valid)
        for q in queries:
            stats.cells += len(q) * self.db.total_residues
        stats.subjects += nq * len(self.db)
        stats.seconds += time.perf_counter() - t0
        return [
            (s_mat[qi, :kk], i_mat[qi, :kk].astype(np.int32))
            for qi in range(nq)
        ]

    def search_reduced(
        self,
        frames: list[np.ndarray],
        group_of: np.ndarray | None,
        k: int,
        local: bool = True,
        stats: SearchStats | None = None,
        bit_width: BitWidth = BitWidth.EXACT,
    ):
        """Frame-fanout search reduced to one top-k list on the device.

        ``frames`` are the query's reading-frame (or strand) code sequences;
        ``group_of`` maps a DB entry id to its source record id (identity
        when None). Returns ``(top_s, top_rec, top_entry, top_frame)`` with
        the reference's tie-breaks, or ``None`` when a lane left the f32
        window (the caller then takes the exact host path). A narrow
        ``bit_width`` records entries that left the window in any frame as
        ``stats.rescored``.
        """
        p = self.params
        stats = stats if stats is not None else SearchStats()
        if not frames or any(len(f) == 0 for f in frames):
            raise ValueError("need at least one non-empty query frame")
        nlimit = {
            BitWidth.BIT8: SCORE_LIMIT_8,
            BitWidth.BIT16: SCORE_LIMIT_16,
        }.get(bit_width)
        if bit_width == BitWidth.BIT64:
            stats.notes.append(
                "BIT64 on the frame-fanout path: exact sweep with "
                "int64-terminal escapes; direct int64 sweep is the "
                "single-query search()"
            )
        t0 = time.perf_counter()
        mq = max(len(f) + ((-len(f)) % 32) for f in frames)
        prof_stack = self._profiles(frames, rows=mq)
        m_reals = [len(f) for f in frames]
        if group_of is None:
            group_of = np.arange(len(self.db), dtype=np.int32)
        group_dev = torch.as_tensor(
            np.asarray(group_of, dtype=np.int32)
        ).to(self.device)

        grouped, dev_stacks = self._stacks_on_device(self.db, p.batch_size)
        _, _, _, sweep_reduced, _ = self._sweeps(
            local, p.dtype, F32_WINDOW if p.dtype == "float32" else None, nlimit
        )
        nf = len(frames)
        stacks = []
        for codes, lens, ids_d in dev_stacks:
            nc = int(codes.shape[0])
            iq = np.repeat(np.arange(nf, dtype=np.int32), nc)
            ic = np.tile(np.arange(nc, dtype=np.int32), nf)
            stacks.append((codes, lens, ids_d, iq, ic))
        top_s, top_r, top_e, top_f, any_f, n_fl = sweep_reduced(
            prof_stack, tuple(stacks), m_reals, group_dev, k, nf
        )
        stats.dispatches += 1
        fetched = torch.cat(
            [top_s.long(), top_r.long(), top_e.long(), top_f.long(),
             any_f.long().reshape(1), n_fl.long().reshape(1)]
        ).cpu().numpy()
        stats.fetches += 1
        for f in frames:
            stats.cells += len(f) * self.db.total_residues
        stats.subjects += len(self.db)
        stats.seconds += time.perf_counter() - t0
        if nlimit is not None and fetched[-1]:
            key = f"limit>{nlimit}/entries"
            stats.rescored[key] = stats.rescored.get(key, 0) + int(fetched[-1])
        if fetched[-2]:
            return None  # f32-window escapee: caller takes the exact path
        kk = (len(fetched) - 2) // 4
        s, r, e, f = (fetched[i * kk : (i + 1) * kk] for i in range(4))
        valid = r != 2**31 - 1
        return (
            s[valid], r[valid].astype(np.int32), e[valid].astype(np.int32),
            f[valid].astype(np.int32),
        )
