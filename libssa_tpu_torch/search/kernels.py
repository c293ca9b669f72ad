"""Kernel choice and the five stage sweeps of a database search.

Counterpart of ``libssa_tpu/search/kernels.py``. Each sweep scores a whole
precision-ladder stage: for every same-shape stack group, ONE call of the
pair-batched kernel covers all of the group's (query, chunk) pairs — one K1
launch on the card — and the per-group results are reduced on the device
(flags, top-k, frame and record reduction), so only small lists reach the
host. The reference fused the whole stage into one ``lax.map`` dispatch
because every TPU round trip cost tens of milliseconds; a CUDA launch costs
microseconds, so the port loops over groups in Python.

Each sweep ends with its own fetch, in a ``device.wait`` span of the
``stats`` it is given, which counts the sweep and its copies, and hands back
host values with named fields. A top-k sweep packs its parts into one int64
vector, so its fetch is one copy; that layout is this module's alone.

Tie-breaks are the reference's, by stable sorts from the last key to the
first: multi-query (query, score desc, id asc); ladder (score desc, id asc);
reduced: first frame on ties, then the lowest entry per record, then
(score desc, record asc).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import interseq, interseq_cuda
from ..util.profiling import span

NEG = -(2**31) + 1  # sorts after every real score
INVALID = 2**31 - 1  # sorts after every real id


class Lanes(NamedTuple):
    """``scores``/``scores_many``: every lane's score, flat in the stacks'
    lane order, and its window flag (None without an exactness window)."""

    scores: np.ndarray
    flags: np.ndarray | None


class TopK(NamedTuple):
    """``topk_many``: ``(Q, k')`` scores and ids a query, padding lanes last
    as (NEG, INVALID); whether a lane left the exactness window; the pairs
    that left the narrow window."""

    scores: np.ndarray
    ids: np.ndarray
    overflow: bool
    n_flagged: int


class Reduced(NamedTuple):
    """``reduced``: the top ``k'`` records (rows past the valid candidates
    carry INVALID records), each with its best entry and that entry's first
    best frame; the exactness and narrow-window counts as in ``TopK``;
    whether any launch computed in int64 (``wide``)."""

    scores: np.ndarray
    records: np.ndarray
    entries: np.ndarray
    frames: np.ndarray
    overflow: bool
    n_flagged: int
    wide: bool


class Ladder(NamedTuple):
    """``ladder``: the top ``k'`` scores and ids, each lane's window flag on
    the host, and every lane's score left on the device for the rare
    rescore."""

    scores: np.ndarray
    ids: np.ndarray
    lane_flags: np.ndarray
    lane_scores: torch.Tensor


def best_kernel(force: str | None = None):
    """The pair-batched scoring callable.

    Signature ``(profiles, codes, lengths, iq, ic, m_reals, gap_q, gap_r,
    local=, track_range=, dtype=) -> (scores, hi, lo)``. ``None``/"auto"/
    "cuda": K1's wrapper, which runs the plain version on CPU tensors and K1
    on CUDA tensors. "plain": the plain PyTorch version on any device (the
    reference K1 is held against on the card).
    """
    if force == "plain":
        return interseq.interseq_pairs
    if force in (None, "auto", "cuda"):
        return interseq_cuda.interseq_pairs_cuda
    raise ValueError(f"unknown kernel {force!r} (auto | cuda | plain)")


def pairs(stacks, n: int) -> list:
    """Each stack group (a tuple whose first entry is its codes ``(g, ...)``)
    with every (query, chunk) pair of ``n`` queries appended as host index
    arrays ``iq``, ``ic``, query-major."""
    out = []
    for stack in stacks:
        nc = int(stack[0].shape[0])
        out.append((*stack, np.repeat(np.arange(n, dtype=np.int32), nc),
                    np.tile(np.arange(nc, dtype=np.int32), n)))
    return out


def unpack_flags(words: np.ndarray, n: int) -> np.ndarray:
    """The first ``n`` lane flags of ``words``, 32 lanes a word, low bit first."""
    words = words.astype(np.uint32)
    return ((words[:, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(bool).reshape(-1)[:n]


def _lexsort(keys):
    """Permutation sorting ascending by ``keys[0]``, then ``keys[1]``, ..."""
    order = torch.arange(keys[0].numel(), device=keys[0].device)
    for key in reversed(keys):
        order = order[torch.argsort(key[order], stable=True)]
    return order


def _index(a, device):
    return torch.as_tensor(a, dtype=torch.int32).to(device)


def _fetch(stats, *parts) -> list:
    """The sweep's device-to-host copies, waited for in a ``device.wait``
    span; ``stats`` counts one sweep and a fetch a part."""
    with span(stats, "device.wait"):
        out = [p.cpu().numpy() for p in parts]
    if stats is not None:
        stats.dispatches += 1
        stats.fetches += len(parts)
    return out


def stage_sweep(
    kernel_name: str,
    gap_q: int,
    gap_r: int,
    local: bool,
    dtype_str: str,
    eff_limit: int | None,
    nlimit: int | None = None,
    max_abs: int | None = None,
    scratch: torch.Tensor | None = None,
) -> "Sweeps":
    """The five sweeps of one stage configuration.

    Normalises the request first: "float32"/"int32" both compute in int32
    ("int64" in int64, K1's int64 instantiation on the card). ``eff_limit``
    is the exactness window whose escapes force an exact rescore; ``nlimit``
    the requested narrow window (255 / 32767) the fan-out sweeps count for
    rung statistics. ``max_abs`` bounds |profile entry| (it picks int32 or
    int64 without a device sync) and ``scratch`` is K1's reusable
    strip-edge buffer; both pass straight to the kernel.
    """
    return Sweeps(
        best_kernel(None if kernel_name == "auto" else kernel_name), gap_q, gap_r, local,
        "int64" if dtype_str == "int64" else "int32", eff_limit, nlimit, max_abs, scratch,
    )


class Sweeps:
    """The sweeps of one stage configuration (``stage_sweep``).

    Stack entries are device tensors ``(codes (g, n_pad, B) int8, lengths
    (g, B) int32[, ids (g, B) int32])``, followed by the host ``iq``/``ic``
    pair index arrays (``pairs``) where a sweep takes several queries; the
    queries are the rows of ``profiles``. ``stats``: the request's
    ``SearchStats`` (None: nothing counted or recorded).
    """

    def __init__(self, kern, gap_q, gap_r, local, cdtype, eff_limit, nlimit, max_abs,
                 scratch):
        self.kern, self.gap_q, self.gap_r, self.local = kern, gap_q, gap_r, local
        self.cdtype, self.eff_limit, self.nlimit = cdtype, eff_limit, nlimit
        self.max_abs, self.scratch = max_abs, scratch
        self.track = eff_limit is not None or nlimit is not None

    def _run(self, profiles, codes, lens, iq, ic, m_reals):
        s, hi, lo = self.kern(
            profiles, codes, lens, iq, ic, m_reals, self.gap_q, self.gap_r,
            local=self.local, track_range=self.track, dtype=self.cdtype,
            max_abs=self.max_abs, scratch=self.scratch,
        )
        return s.long(), hi, lo

    @staticmethod
    def _m_real_index(m_reals, profiles):
        """Per-query true lengths as a device index, range-checked on host."""
        m = profiles.shape[1]
        if m_reals is None:
            m_reals = [m] * profiles.shape[0]
        if any(not 1 <= int(mr) <= m for mr in m_reals):
            raise ValueError(f"m_real out of range for profile rows {m}")
        return _index(m_reals, profiles.device)

    def _one_query(self, profile, codes, lens, m_real):
        """One query against every chunk of a stack group."""
        dev = profile.device
        g = codes.shape[0]
        return self._run(
            profile[None], codes, lens, torch.zeros(g, dtype=torch.int32, device=dev),
            torch.arange(g, dtype=torch.int32, device=dev),
            self._m_real_index([m_real], profile[None]),
        )

    def _flat(self, parts):
        s = torch.cat([s.reshape(-1) for s, _, _ in parts])
        if self.eff_limit is not None:
            f = torch.cat([
                interseq.overflow_flags(s_, hi, lo, self.eff_limit, self.local).reshape(-1)
                for s_, hi, lo in parts
            ])
        else:
            f = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
        return s, f

    def _lanes(self, parts, stats) -> Lanes:
        s, f = self._flat(parts)
        if self.eff_limit is None:
            return Lanes(_fetch(stats, s)[0], None)
        return Lanes(*_fetch(stats, s, f))

    def scores(self, profile, stacks, m_real=None, stats=None) -> Lanes:
        """One query against every lane."""
        mr = profile.shape[0] if m_real is None else int(m_real)
        return self._lanes(
            [self._one_query(profile, codes, lens, mr) for codes, lens, *_ in stacks], stats
        )

    def scores_many(self, profiles, stacks, m_reals=None, stats=None) -> Lanes:
        """Every (query, chunk) pair of the stacks, pair-major."""
        dev = profiles.device
        mrs = self._m_real_index(m_reals, profiles)
        return self._lanes([
            self._run(profiles, codes, lens, _index(iq, dev), _index(ic, dev), mrs)
            for codes, lens, *_, iq, ic in stacks
        ], stats)

    def topk_many(self, profiles, stacks, m_reals, k: int, stats=None) -> TopK:
        """Multi-query sweep reduced to per-query top-k on the device.

        Each stack group's index upload sits in a ``device.wait`` span of
        ``stats``: a blocking copy from host memory waits for the work
        queued before it, the previous group's launch.
        """
        dev = profiles.device
        n_queries = profiles.shape[0]
        mrs = self._m_real_index(m_reals, profiles)
        parts_s, parts_i, parts_q = [], [], []
        any_f = torch.zeros((), dtype=torch.bool, device=dev)
        n_flagged = torch.zeros((), dtype=torch.int64, device=dev)
        for codes, lens, ids, iq, ic in stacks:
            with span(stats, "device.wait"):
                iq_d, ic_d = _index(iq, dev), _index(ic, dev)
            s, hi, lo = self._run(profiles, codes, lens, iq_d, ic_d, mrs)
            ids_rows = ids[ic_d.long()]  # (P, B) global ids, -1 padding
            valid = ids_rows >= 0
            if self.eff_limit is not None:
                f = interseq.overflow_flags(s, hi, lo, self.eff_limit, self.local)
                any_f = any_f | (f & valid).any()
            if self.nlimit is not None:
                fn_ = interseq.overflow_flags(s, hi, lo, self.nlimit, self.local)
                n_flagged = n_flagged + (fn_ & valid).sum()
            parts_s.append(torch.where(valid, s, NEG).reshape(-1))
            parts_i.append(torch.where(valid, ids_rows, INVALID).reshape(-1))
            parts_q.append(iq_d[:, None].expand(ids_rows.shape).reshape(-1))
        s = torch.cat(parts_s)
        i = torch.cat(parts_i)
        qv = torch.cat(parts_q)
        order = _lexsort([qv, -s, i])
        per_q = s.numel() // n_queries
        kk = min(k, per_q)
        top_s = s[order].view(n_queries, per_q)[:, :kk]
        top_i = i[order].view(n_queries, per_q)[:, :kk]
        (out,) = _fetch(stats, torch.cat([
            top_s.reshape(-1).long(), top_i.reshape(-1).long(),
            any_f.long().reshape(1), n_flagged.long().reshape(1),
        ]))
        return TopK(*out[:-2].reshape(2, n_queries, kk), bool(out[-2]), int(out[-1]))

    def ladder(self, profile, stacks, m_real, k: int, stats=None) -> Ladder:
        """A narrow-width stage with its flags and top-k on the device; the
        flags travel 32 lanes a word."""
        s, f = self._flat([
            self._one_query(profile, codes, lens, int(m_real)) for codes, lens, _ in stacks
        ])
        ids = torch.cat([ids.reshape(-1) for _, _, ids in stacks])
        valid = ids >= 0
        # The int64 lane's padding sorts below every int64 score.
        s_m = torch.where(valid, s, NEG if self.cdtype == "int32" else -(2**63) + 1)
        i_m = torch.where(valid, ids, INVALID)
        order = _lexsort([-s_m, i_m])
        n_lanes = s.numel()
        kk = min(k, n_lanes)
        n_words = -(-n_lanes // 32)
        bits = torch.zeros(n_words * 32, dtype=torch.int64, device=s.device)
        bits[:n_lanes] = (f & valid).long()
        shifts = torch.arange(32, dtype=torch.int64, device=s.device)
        packed = (bits.view(n_words, 32) << shifts).sum(dim=1)
        (out,) = _fetch(stats, torch.cat([s_m[order][:kk], i_m[order][:kk].long(), packed]))
        return Ladder(out[:kk], out[kk : 2 * kk], unpack_flags(out[2 * kk :], n_lanes), s_m)

    def reduced(self, profiles, stacks, m_reals, group_of, k: int, stats=None) -> Reduced:
        """Frame-fanout sweep reduced to ONE top-k list on the device; the
        rows of ``profiles`` are the frames.

        Best over frames per DB entry (first frame on ties), best entry per
        source record (``group_of``: entry id -> record id, None when each
        entry is its own record; lowest entry on ties), then (score desc,
        record asc). Every group's pair indexes go up in one blocking copy
        before the first launch, in a ``device.wait`` span of ``stats``: a
        blocking copy a group waits for the launch before it and leaves the
        card idle while the host sets up the next.
        """
        dev = profiles.device
        n_frames = profiles.shape[0]
        mrs = self._m_real_index(m_reals, profiles)
        parts = []
        wide = False
        any_f = torch.zeros((), dtype=torch.bool, device=dev)
        n_flagged = torch.zeros((), dtype=torch.int64, device=dev)
        # A frame's tie rank in the low 3 bits of its score key, the first
        # frame's the highest: one max over the frames finds both the best
        # score and the first frame that reaches it.
        rank = torch.arange(n_frames - 1, -1, -1, device=dev).view(n_frames, 1, 1)
        with span(stats, "device.wait"):
            index = _index(np.concatenate([a for *_, iq, ic in stacks for a in (iq, ic)]), dev)
        at = 0
        for codes, lens, ids, iq, ic in stacks:
            P = len(iq)
            iq_d, ic_d = index[at : at + P], index[at + P : at + 2 * P]
            at += 2 * P
            s, hi, lo = self._run(profiles, codes, lens, iq_d, ic_d, mrs)  # (F*C, B)
            wide |= hi.dtype == torch.int64  # the kernel's own type
            nC = s.shape[0] // n_frames
            B = s.shape[1]
            ids_rows = ids[ic_d[:nC].long()]  # (C, B) entry ids, -1 padding
            valid = ids_rows >= 0
            if self.eff_limit is not None:
                fl = interseq.overflow_flags(s, hi, lo, self.eff_limit, self.local)
                any_f = any_f | (fl & valid.repeat(n_frames, 1)).any()
            if self.nlimit is not None:
                fn_ = interseq.overflow_flags(s, hi, lo, self.nlimit, self.local)
                # An entry sits in exactly one lane: the sum counts entries
                # flagged in ANY frame.
                fn_any = fn_.view(n_frames, nC, B).any(dim=0)
                n_flagged = n_flagged + (fn_any & valid).sum()
            kmax = (s.view(n_frames, nC, B) * 8 + rank).amax(dim=0)
            fmax = torch.div(kmax, 8, rounding_mode="floor")
            farg = (n_frames - 1) - torch.remainder(kmax, 8)
            e_rows = torch.where(valid, ids_rows, INVALID)
            rec_rows = e_rows if group_of is None else torch.where(
                valid, group_of[ids_rows.clamp(min=0).long()], INVALID
            )
            parts.append((
                torch.where(valid, fmax, NEG).reshape(-1),
                e_rows.reshape(-1),
                rec_rows.reshape(-1),
                farg.reshape(-1),
            ))
        s = torch.cat([p[0] for p in parts])
        e = torch.cat([p[1] for p in parts])
        r = torch.cat([p[2] for p in parts])
        fr = torch.cat([p[3] for p in parts])
        # Best entry per record: group records with the best (score, entry)
        # first and keep each record's first row.
        o1 = _lexsort([r, -s, e])
        r1, s1, e1, f1 = r[o1], s[o1], e[o1], fr[o1]
        first = torch.ones_like(r1, dtype=torch.bool)
        first[1:] = r1[1:] != r1[:-1]
        s2 = torch.where(first, s1, NEG)
        r2 = torch.where(first, r1, INVALID)
        o2 = _lexsort([-s2, r2])
        kk = min(k, s.numel())
        o2 = o2[:kk]
        (out,) = _fetch(stats, torch.cat([
            s2[o2].long(), r2[o2].long(), e1[o2].long(), f1[o2].long(),
            any_f.long().reshape(1), n_flagged.long().reshape(1),
        ]))
        return Reduced(*out[:-2].reshape(4, kk), bool(out[-2]), int(out[-1]), wide)
