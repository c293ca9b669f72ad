"""Database search sharded over devices and processes.

Counterpart of ``libssa_tpu/parallel/sharded.py`` on ``torch.distributed``.
The database splits into D strided shards, so every shard sees the whole
length distribution. Each shard sweeps its own length-sorted stacks with the
single-device engine's stage sweeps (K1 on the card, its plain version on
the CPU) and reduces them to a top-k list with its overflow flags on its
device. The lists of every rank then merge with ONE ``all_gather`` a search
call, and every rank sorts the same candidates the same way (score desc, id
asc). A shard-local subject j is the global subject ``j * D + d``.

Layout: shards are numbered rank-major. The production layout is one rank a
card under NCCL. A process may own several shards, which run in turn: the
CPU tests put D shards on the CPU, ``chip_smoke.py`` two on one card. A
gloo group gathers host tensors, an NCCL group the rank's card's.

Every rank makes the same collectives the same number of times: one gather
a ``search``, ``search_many`` or ``search_reduced`` call, after the rank's
own sweeps, whatever its plan steps or re-queued chunks. Only a shard's own
sweep sits inside the fault gate, never a collective. A rank reduces its
shards' lists (and any re-queued chunk's) to k before the gather, so every
rank's gathered row has the same length; the gathered counts are summed
where the reference used ``psum``.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..constants import BitWidth, OutputMode
from ..io.db import SequenceDB
from ..ops.scoring import make_padded_profile
from ..ops.topk import INVALID_ID, host_topk
from ..search import kernels, manager
from ..search.manager import SearchEngine, SearchParams, SearchStats, resolve_device
from ..util.logging import log

PAD_SCORE = -(2**63) + 1  # a gathered list's padding: below every int64 score


@dataclass(frozen=True)
class DBMesh:
    """The database axis: ``size`` shards numbered rank-major, the shards
    this process owns (``local``: global shard index -> device), the
    process group (None in one process) and each rank's count of shards
    (``rank_shards``, in rank order)."""

    size: int
    local: dict
    group: object = None
    rank_shards: tuple = ()


def _gather(row: np.ndarray, group, device) -> np.ndarray:
    """Every rank's int64 ``row``, stacked in rank order by one all_gather.

    A gloo group gathers host tensors, an NCCL group ``device``'s.
    """
    row = np.asarray(row, dtype=np.int64)
    if group is None:
        return row[None]
    t = torch.as_tensor(row)
    if dist.get_backend(group) == dist.Backend.NCCL:
        t = t.to(device)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return torch.stack(out).cpu().numpy()


def local_devices(device) -> list[torch.device]:
    """The devices this process may put shards on, for a context on
    ``device``: every visible card in one process, the rank's current card
    in a ``torch.distributed`` job; the CPU counts as one device a core."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * (os.cpu_count() or 1)
    if dist.is_available() and dist.is_initialized():
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_db_mesh(n_devices: int | None = None, devices=None, group=None) -> DBMesh:
    """1-D mesh over the database axis.

    ``devices`` are this process's shards' devices, one entry a shard
    (repeat a device to put several shards on it); default
    ``local_devices("cuda")``, which raises without CUDA. In one process
    ``n_devices`` takes the first n of them. Under ``torch.distributed``
    (``group``, or the default group once it is initialised) every rank
    passes its own devices and the mesh spans every rank's shards, numbered
    rank-major; ``n_devices``, if given, must equal their total.
    """
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if devices is None:
        devices = local_devices("cuda")
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if group is None:
        if n_devices is not None:
            if not 1 <= n_devices <= len(devices):
                raise ValueError(f"n_devices={n_devices}: {len(devices)} devices given")
            devices = devices[:n_devices]
        return DBMesh(len(devices), dict(enumerate(devices)), None, (len(devices),))
    counts = _gather(np.array([len(devices)]), group, devices[0])[:, 0]
    total = int(counts.sum())
    if n_devices is not None and n_devices != total:
        raise ValueError(f"n_devices={n_devices}, but the ranks own {total} shards")
    first = int(counts[: dist.get_rank(group)].sum())
    return DBMesh(total, {first + j: d for j, d in enumerate(devices)}, group,
                  tuple(int(c) for c in counts))


def _pad(a, k: int, fill) -> np.ndarray:
    out = np.full(k, fill, dtype=np.int64)
    out[: len(a)] = a[:k]
    return out


def _best_records(s, r, e, f, k: int):
    """Best entry a record (score desc, lowest entry on ties), then the top
    k records by (score desc, record asc); INVALID records dropped."""
    keep = r != INVALID_ID
    s, r, e, f = s[keep], r[keep], e[keep], f[keep]
    o = np.lexsort((e, -s, r))
    s, r, e, f = s[o], r[o], e[o], f[o]
    first = np.ones(len(r), dtype=bool)
    first[1:] = r[1:] != r[:-1]
    s, r, e, f = s[first], r[first], e[first], f[first]
    o = np.lexsort((r, -s))[:k]
    return s[o], r[o], e[o], f[o]


class ShardedSearchEngine:
    """Database search over every shard of a mesh.

    The same scores, ids and order as ``search.manager.SearchEngine``
    (tests/test_torch_sharded.py). The ladder's rescores and the f32-window
    fallbacks run on the single-device engine: they touch few subjects.

    Plan steps are synchronized: step t is every shard's t-th batch of
    ``B = max(8, min(batch_size // D, 1024))`` lanes, padded to the widest
    shard's bucket at t, as in the reference. ``fault_injector(i)`` is
    called once a plan step (``search``) or a width group (``search_many``,
    once a query height, and ``search_reduced``); where it raises, this
    process's chunks of that step or group are re-queued on the
    single-device engine, as is a shard whose sweep raises, with a WARNING
    that names the exception. ``requeued_chunks`` counts re-queued steps.

    Statistics: ``cells``, ``subjects`` and ``rescored`` equal the
    single-device engine's. ``dispatches`` counts the shard sweeps run, one
    a shard a call (a query height in ``search_many``); on the card each is
    one K1 launch a width group, or a few where K1's scratch splits one.
    ``fetches`` counts device-to-host copies: one a shard sweep, and one of
    the gathered lists under NCCL. In a job of several ranks, re-queued and
    rescued work, and its statistics, stay with the rank that ran it.
    """

    def __init__(self, db, matrix, gap_open, gap_extend, mesh=None, params=None):
        self.db = db
        self.matrix = matrix
        self.mesh = mesh if mesh is not None else make_db_mesh()
        self.params = params or SearchParams()
        self.gap_open, self.gap_extend = gap_open, gap_extend
        # One engine a device: its stage sweeps and K1's scratch serve every
        # shard there. The first is the single-device fallback.
        self._engines: dict[torch.device, SearchEngine] = {}
        for dev in self.mesh.local.values():
            if dev not in self._engines:
                self._engines[dev] = SearchEngine(
                    db, matrix, gap_open, gap_extend, self.params, device=dev
                )
        self._fallback = next(iter(self._engines.values()))
        # Keyed on the params they derive from: mutating engine.params
        # gives a fresh plan.
        self._plan = None
        self._plan_key = None
        self._device_plan = None
        self.fault_injector = None  # callable(index) for tests
        self.requeued_chunks = 0

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    # -- the plan ---------------------------------------------------------

    def _chunk_plan(self):
        """``[(n_pad, {shard: (codes (n_pad, B) uint8, lengths (B,), ids
        (B,))})]``, one entry a step, for this process's shards.

        Widths come from the lengths alone, so every rank plans the same
        steps without a collective. Ids are global, -1 on padding lanes.
        """
        p = self.params
        key = (p.batch_size, p.length_multiple)
        if self._plan is not None and self._plan_key == key:
            return self._plan
        self._device_plan = None  # derived from the plan: invalidate together
        D = self.n_devices
        B = max(8, min(p.batch_size // D, 1024))
        lengths = self.db.lengths
        # Shard d's subjects in SequenceDB.chunks' order: ascending length,
        # stable, so shard-local j is global j * D + d.
        orders = []
        for d in range(D):
            ids = np.arange(d, len(self.db), D)
            orders.append(ids[np.argsort(lengths[ids], kind="stable")])
        width = np.zeros(max(-(-len(o) // B) for o in orders), dtype=np.int64)
        for o in orders:
            last = np.minimum(np.arange(1, -(-len(o) // B) + 1) * B, len(o)) - 1
            w = SequenceDB._bucket_lengths_vec(lengths[o[last]], p.length_multiple, True)
            width[: len(w)] = np.maximum(width[: len(w)], w)
        plan = []
        for t, n_pad in enumerate(width.tolist()):
            chunks = {
                d: self.db._pack(orders[d][t * B : (t + 1) * B], B, n_pad, transposed=True)
                for d in self.mesh.local
                if t * B < len(orders[d])
            }
            plan.append((n_pad, chunks))
        self._plan, self._plan_key = plan, key
        return plan

    def _device_groups(self):
        """The plan on the shards' devices, uploaded once a plan: ``[(n_pad,
        steps, {shard: (codes (g, n_pad, B) int8, lengths (g, B), ids (g,
        B), host ids (g, B), steps of the rows)})]``, one group a width in
        the plan's order."""
        plan = self._chunk_plan()  # may invalidate _device_plan
        if self._device_plan is None:
            groups: dict[int, tuple[list, dict]] = {}
            for t, (n_pad, chunks) in enumerate(plan):
                steps, per = groups.setdefault(n_pad, ([], {}))
                steps.append(t)
                for d, chunk in chunks.items():
                    per.setdefault(d, []).append((t, chunk))
            dev_plan = []
            for n_pad, (steps, per) in groups.items():
                shards = {}
                for d, rows in per.items():
                    dev = self.mesh.local[d]
                    codes = np.stack([c for _, (c, _, _) in rows]).astype(np.int8)
                    lens = np.stack([l for _, (_, l, _) in rows])
                    ids = np.stack([i for _, (_, _, i) in rows])
                    shards[d] = (
                        torch.as_tensor(codes).to(dev),
                        torch.as_tensor(lens).to(dev),
                        torch.as_tensor(ids).to(dev),
                        ids,
                        [t for t, _ in rows],
                    )
                dev_plan.append((n_pad, steps, shards))
            self._device_plan = dev_plan
        return self._device_plan

    def _stacks(self, failed=frozenset()):
        """``{shard: [(codes, lengths, ids, host ids)]}``: each shard's width
        groups without the rows of ``failed`` steps."""
        out = {d: [] for d in self.mesh.local}
        for _, _, shards in self._device_groups():
            for d, (codes, lens, ids, ids_np, steps) in shards.items():
                keep = [i for i, t in enumerate(steps) if t not in failed]
                if not keep:
                    continue
                if len(keep) < len(steps):
                    idx = torch.as_tensor(keep, device=codes.device)
                    codes, lens, ids, ids_np = codes[idx], lens[idx], ids[idx], ids_np[keep]
                out[d].append((codes, lens, ids, ids_np))
        return out

    def _step_ids(self, steps) -> np.ndarray:
        """(len(steps) x this process's shards, B) global ids at ``steps``."""
        plan = self._chunk_plan()
        rows = [chunk[2] for t in steps for chunk in plan[t][1].values()]
        return np.stack(rows) if rows else np.full((0, 1), -1, dtype=np.int32)

    def _gate(self, n: int) -> list[int]:
        """The indices in range(n) whose ``fault_injector`` call raised."""
        failed = []
        if self.fault_injector is None:
            return failed
        for i in range(n):
            try:
                self.fault_injector(i)
            except Exception as exc:  # any failure re-queues the unit
                self._warn(f"plan unit {i}", exc)
                failed.append(i)
        return failed

    @staticmethod
    def _warn(what: str, exc: Exception) -> None:
        log(
            OutputMode.WARNING,
            f"sharded search: {what} failed ({type(exc).__name__}: {exc}); "
            "re-queued on the single-device engine",
        )

    def _engine_over(self, ids) -> SearchEngine:
        """A single-device engine over ``ids``, on the fallback's device."""
        return SearchEngine(
            self.db.subset(np.asarray(ids, dtype=np.int32)), self.matrix,
            self.gap_open, self.gap_extend, self.params,
            device=self._fallback.device,
        )

    def _profiles(self, seqs, rows=None) -> dict:
        """Stacked padded profiles on every shard device."""
        profs = torch.as_tensor(np.stack([
            make_padded_profile(q, self._fallback.padded_matrix, rows=rows)
            for q in seqs
        ]), dtype=torch.int32)
        return {dev: profs.to(dev) for dev in self._engines}

    def _finish(self, stats, t0, work_units) -> None:
        stats.cells += sum(len(q) for q in work_units) * self.db.total_residues
        stats.seconds += time.perf_counter() - t0

    # -- search -----------------------------------------------------------

    def search(self, q_codes, k, local=True, bit_width=None, stats=None):
        """Top-k (scores, ids), identical to the single-device engine's.

        EXACT, BIT8 and BIT16 sweep with the rung's window flags; a flagged
        subject is rescored exactly only where the f32 window is at risk (the
        sweep's scores are exact inside it). BIT64 sweeps in int64 (K1's
        int64 instantiation on the card) end to end.
        """
        bit_width = bit_width or BitWidth.EXACT
        stats = stats if stats is not None else SearchStats()
        if len(q_codes) == 0:
            raise ValueError("empty query")
        t0 = time.perf_counter()
        m = len(q_codes)
        if bit_width == BitWidth.BIT64:
            dtype_str, eff_limit, requeue_bw = "int64", None, BitWidth.BIT64
        else:
            dtype_str = self.params.dtype
            eff_limit = manager._eff_limit(manager.narrow_limit(bit_width), dtype_str)
            requeue_bw = BitWidth.EXACT  # the exact ladder keeps a re-run exact
        all_s: list[np.ndarray] = []
        all_i: list[np.ndarray] = []
        flagged: list[np.ndarray] = []

        def requeue(ids, n_steps):
            self.requeued_chunks += n_steps
            ids = ids[ids >= 0]
            if not len(ids):  # this process has no chunk at that step
                return
            rq = SearchStats()
            all_s.append(self._engine_over(ids).score_all(q_codes, local, requeue_bw, rq))
            all_i.append(ids)
            stats.merge(rq)

        failed = self._gate(len(self._chunk_plan()))
        for t in failed:
            requeue(self._step_ids([t]).reshape(-1), 1)
        profiles = self._profiles([q_codes])
        for d, stacks in self._stacks(frozenset(failed)).items():
            if not stacks:
                continue
            dev = self.mesh.local[d]
            flat = np.concatenate([s[3].reshape(-1) for s in stacks])
            sweeps = self._engines[dev]._sweeps(local, dtype_str, eff_limit)
            try:
                lad = sweeps.ladder(profiles[dev][0], [s[:3] for s in stacks], m, k, stats)
            except Exception as exc:  # a failed shard re-queues, as a step does
                self._warn(f"shard {d}'s sweep", exc)
                requeue(flat, sum(len(s[3]) for s in stacks))
                continue
            all_s.append(lad.scores)
            all_i.append(lad.ids)
            flagged.append(flat[lad.lane_flags & (flat >= 0)])

        over = np.unique(np.concatenate(flagged)) if flagged else np.empty(0, np.int32)
        scores = np.concatenate(all_s) if all_s else np.empty(0, np.int64)
        ids = np.concatenate(all_i) if all_i else np.empty(0, np.int64)
        if len(over) and self._fallback._window_risk(m):
            # A genuine f32-window risk: this rank's flagged subjects are
            # rescored exactly and replace their first-pass entries.
            rescue_stats = SearchStats()
            r = self._engine_over(over).score_all(q_codes, local, BitWidth.EXACT, rescue_stats)
            stats.merge(rescue_stats, work=True)
            keep = ~np.isin(ids, over)
            scores = np.concatenate([scores[keep], r])
            ids = np.concatenate([ids[keep], over])
        real = ids != INVALID_ID
        s, i = host_topk(scores[real], ids[real], k)
        rows = _gather(
            np.concatenate([_pad(s, k, PAD_SCORE), _pad(i, k, INVALID_ID), [len(over)]]),
            self.mesh.group, self._fallback.device,
        )
        self._count_gather(stats)
        n_over = int(rows[:, 2 * k].sum())
        if n_over:
            stats.rescored[f"limit>{eff_limit}"] = n_over
        stats.subjects += len(self.db)
        self._finish(stats, t0, [q_codes])
        s, i = rows[:, :k].reshape(-1), rows[:, k : 2 * k].reshape(-1)
        real = i != INVALID_ID
        return host_topk(s[real], i[real], k)

    def _count_gather(self, stats) -> None:
        if self.mesh.group is not None and dist.get_backend(self.mesh.group) == dist.Backend.NCCL:
            stats.fetches += 1

    def search_many(self, queries, k, local=True, stats=None, bit_width=None):
        """Per-query top-k over the mesh, identical to ``SearchEngine.search_many``.

        Queries group by 32-row profile height; each shard sweeps every
        (query, step) pair of a height in one call and reduces it to
        per-query top-k lists on its device. A narrow ``bit_width`` counts
        the (query, subject) pairs that left its window in
        ``stats.rescored``; the hit lists equal EXACT's.
        """
        p = self.params
        stats = stats if stats is not None else SearchStats()
        if not queries or any(len(q) == 0 for q in queries):
            raise ValueError("need at least one non-empty query")
        nlimit = manager.narrow_limit(bit_width)
        t0 = time.perf_counter()
        eff_limit = manager._eff_limit(None, p.dtype)
        nq = len(queries)
        cand = [([], []) for _ in range(nq)]
        overflowed = np.zeros(nq, dtype=bool)
        n_flagged = 0
        hgroups: dict[int, list[int]] = {}
        for qi, q in enumerate(queries):
            hgroups.setdefault(manager.profile_rows(len(q)), []).append(qi)
        groups = self._device_groups()

        def requeue(ids, qis, n_steps):
            self.requeued_chunks += n_steps
            flat = ids.reshape(-1)
            valid = np.unique(flat[flat >= 0]).astype(np.int32)
            if not len(valid):
                return
            rq = SearchStats()
            res = self._engine_over(valid).search_many(
                [queries[qi] for qi in qis], k, local, rq, bit_width or BitWidth.EXACT
            )
            stats.merge(rq)  # re-queue: round trips and rungs only
            for qi, (s_r, i_r) in zip(qis, res):
                cand[qi][0].append(np.asarray(s_r, np.int64))
                cand[qi][1].append(valid[i_r].astype(np.int64))

        for mq, qis in hgroups.items():
            failed = self._gate(len(groups))
            for gi in failed:
                requeue(self._step_ids(groups[gi][1]), qis, len(groups[gi][1]))
            failed_steps = frozenset(t for gi in failed for t in groups[gi][1])
            profiles = self._profiles([queries[qi] for qi in qis], rows=mq)
            m_reals = [len(queries[qi]) for qi in qis]
            n = len(qis)
            for d, stacks in self._stacks(failed_steps).items():
                if not stacks:
                    continue
                dev = self.mesh.local[d]
                sweeps = self._engines[dev]._sweeps(local, p.dtype, eff_limit, nlimit)
                try:
                    top = sweeps.topk_many(
                        profiles[dev], kernels.pairs([s[:3] for s in stacks], n), m_reals, k,
                        stats,
                    )
                except Exception as exc:
                    self._warn(f"shard {d}'s sweep", exc)
                    requeue(np.concatenate([s[3] for s in stacks]), qis,
                            sum(len(s[3]) for s in stacks))
                    continue
                for row, qi in enumerate(qis):
                    cand[qi][0].append(top.scores[row])
                    cand[qi][1].append(top.ids[row])
                if top.overflow:
                    overflowed[qis] = True
                n_flagged += top.n_flagged

        top_s = np.full((nq, k), PAD_SCORE, dtype=np.int64)
        top_i = np.full((nq, k), INVALID_ID, dtype=np.int64)
        for qi, (ss, ii) in enumerate(cand):
            s = np.concatenate(ss) if ss else np.empty(0, np.int64)
            i = np.concatenate(ii) if ii else np.empty(0, np.int64)
            real = i != INVALID_ID
            s, i = host_topk(s[real], i[real], k)
            top_s[qi, : len(s)], top_i[qi, : len(i)] = s, i
        rows = _gather(
            np.concatenate([top_s.reshape(-1), top_i.reshape(-1), overflowed, [n_flagged]]),
            self.mesh.group, self._fallback.device,
        )
        self._count_gather(stats)
        total_flagged = int(rows[:, -1].sum())
        if nlimit is not None and total_flagged:
            key = f"limit>{nlimit}/pairs"
            stats.rescored[key] = stats.rescored.get(key, 0) + total_flagged
        overflowed = rows[:, 2 * nq * k : 2 * nq * k + nq].any(axis=0)
        if overflowed.any():
            n_over = int(overflowed.sum())
            log(
                OutputMode.WARNING,
                f"sharded search_many: {n_over} quer{'y' if n_over == 1 else 'ies'} "
                "left the f32 exactness window; rescoring them exactly on the "
                "SINGLE-device engine (those queries will not use the mesh)",
            )
        all_s = rows[:, : nq * k].reshape(-1, nq, k)
        all_i = rows[:, nq * k : 2 * nq * k].reshape(-1, nq, k)
        out = []
        for qi in range(nq):
            if overflowed[qi]:
                rescue_stats = SearchStats()
                scores = self._fallback.score_all_many([queries[qi]], local, rescue_stats)[0]
                stats.merge(rescue_stats, work=True)
                out.append(host_topk(scores, np.arange(len(scores)), k))
                continue
            s, i = all_s[:, qi].reshape(-1), all_i[:, qi].reshape(-1)
            real = i != INVALID_ID
            out.append(host_topk(s[real], i[real], k))
        stats.subjects += nq * len(self.db)
        self._finish(stats, t0, queries)
        return out

    def search_reduced(self, frames, group_of, k, local=True, stats=None, bit_width=None):
        """Translated / frame-fanout search over the mesh.

        The sharded ``SearchEngine.search_reduced``: build the engine over
        the translated entry DB; ``group_of`` maps an entry id to its source
        record id (None = identity). Returns ``(top_s, top_rec, top_entry,
        top_frame)`` as the single-device method does, or ``None`` where it
        would: a lane left the f32 window (the caller then takes the exact
        path). Each shard keeps its best entry a record; records are deduped
        again after the gather, since one record's entries can straddle
        shards.
        """
        p = self.params
        stats = stats if stats is not None else SearchStats()
        if not frames or any(len(f) == 0 for f in frames):
            raise ValueError("need at least one non-empty query frame")
        nlimit = manager.narrow_limit(bit_width)
        t0 = time.perf_counter()
        eff_limit = manager._eff_limit(None, p.dtype)
        mq = max(manager.profile_rows(len(f)) for f in frames)
        profiles = self._profiles(frames, rows=mq)
        m_reals = [len(f) for f in frames]
        if group_of is not None:
            group_of = np.asarray(group_of, dtype=np.int32)
        group_dev = {dev: None if group_of is None else torch.as_tensor(group_of).to(dev)
                     for dev in self._engines}
        nf = len(frames)
        groups = self._device_groups()
        cand: list[tuple] = []
        overflow = False
        n_flagged = 0

        def requeue(ids, n_steps):
            self.requeued_chunks += n_steps
            got = self._requeue_reduced(ids, frames, group_of, k, local, stats, bit_width)
            if got is not None:
                cand.append(got)
            return got is None

        failed = self._gate(len(groups))
        for gi in failed:
            overflow |= requeue(self._step_ids(groups[gi][1]), len(groups[gi][1]))
        failed_steps = frozenset(t for gi in failed for t in groups[gi][1])
        for d, stacks in self._stacks(failed_steps).items():
            if not stacks:
                continue
            dev = self.mesh.local[d]
            sweeps = self._engines[dev]._sweeps(local, p.dtype, eff_limit, nlimit)
            try:
                red = sweeps.reduced(
                    profiles[dev], kernels.pairs([s[:3] for s in stacks], nf), m_reals,
                    group_dev[dev], k, stats,
                )
            except Exception as exc:
                self._warn(f"shard {d}'s sweep", exc)
                overflow |= requeue(np.concatenate([s[3] for s in stacks]),
                                    sum(len(s[3]) for s in stacks))
                continue
            cand.append((red.scores, red.records, red.entries, red.frames))
            overflow |= red.overflow
            n_flagged += red.n_flagged

        parts = [np.concatenate([c[i] for c in cand]) if cand else np.empty(0, np.int64)
                 for i in range(4)]
        s, r, e, f = _best_records(*parts, k)
        rows = _gather(
            np.concatenate([
                _pad(s, k, PAD_SCORE), _pad(r, k, INVALID_ID), _pad(e, k, INVALID_ID),
                _pad(f, k, 0), [overflow, n_flagged],
            ]),
            self.mesh.group, self._fallback.device,
        )
        self._count_gather(stats)
        stats.subjects += len(self.db)
        self._finish(stats, t0, frames)
        total_flagged = int(rows[:, -1].sum())
        if nlimit is not None and total_flagged:
            key = f"limit>{nlimit}/entries"
            stats.rescored[key] = stats.rescored.get(key, 0) + total_flagged
        if rows[:, 4 * k].any():
            log(
                OutputMode.WARNING,
                "sharded search_reduced: a score range left the f32 exactness "
                "window; falling back to the exact path on the SINGLE-device "
                "engine (this search will not use the mesh)",
            )
            return None
        s, r, e, f = _best_records(
            *(rows[:, i * k : (i + 1) * k].reshape(-1) for i in range(4)), k
        )
        return s, r.astype(np.int32), e.astype(np.int32), f.astype(np.int32)

    def _requeue_reduced(self, ids_np, frames, group_of, k, local, stats=None, bit_width=None):
        """Re-run one failed reduced-sweep group on the single-device engine.

        Returns its top-k candidates ``(s, rec, entry, frame)`` with global
        entry ids, or ``None`` on an f32-window escape. ``group_of`` None:
        each entry is its own record.
        """
        flat = ids_np.reshape(-1)
        valid = np.unique(flat[flat >= 0]).astype(np.int32)
        if not len(valid):
            return (np.empty(0, np.int64),) * 4
        rq = SearchStats()
        got = self._engine_over(valid).search_reduced(
            frames, valid if group_of is None else group_of[valid], k, local, rq,
            bit_width or BitWidth.EXACT,
        )
        if stats is not None:
            stats.merge(rq)
        if got is None:
            return None
        s, r, e, f = got
        return (
            np.asarray(s, np.int64), np.asarray(r, np.int64),
            valid[e].astype(np.int64), np.asarray(f, np.int64),
        )

    def score_all(self, q_codes, local=True, bit_width=None, stats=None):
        """Every subject's score: the single-device engine's (the sharded
        engine's purpose is top-k, where scores never leave the shards)."""
        return self._fallback.score_all(q_codes, local, bit_width or BitWidth.EXACT, stats)

    def score_all_many(self, queries, local=True, stats=None):
        """The full score matrix: the single-device engine's (see score_all)."""
        return self._fallback.score_all_many(queries, local, stats)
