"""Kernel choice and the five stage sweeps of a database search.

Counterpart of ``libssa_tpu/search/kernels.py``. Each sweep scores a whole
precision-ladder stage: for every same-shape stack group, ONE call of the
pair-batched kernel covers all of the group's (query, chunk) pairs — one K1
launch on the card — and the per-group results are reduced on the device
(flags, top-k, frame and record reduction), so only small lists reach the
host. The reference fused the whole stage into one ``lax.map`` dispatch
because every TPU round trip cost tens of milliseconds; a CUDA launch costs
microseconds, so the port loops over groups in Python.

Tie-breaks are the reference's, by stable sorts from the last key to the
first: multi-query (query, score desc, id asc); ladder (score desc, id asc);
reduced: first frame on ties, then the lowest entry per record, then
(score desc, record asc).
"""
from __future__ import annotations

import torch

from ..ops import interseq, interseq_cuda
from ..util.profiling import span

NEG = -(2**31) + 1  # sorts after every real score
INVALID = 2**31 - 1  # sorts after every real id


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


def _lexsort(keys):
    """Permutation sorting ascending by ``keys[0]``, then ``keys[1]``, ..."""
    order = torch.arange(keys[0].numel(), device=keys[0].device)
    for key in reversed(keys):
        order = order[torch.argsort(key[order], stable=True)]
    return order


def _index(a, device):
    return torch.as_tensor(a, dtype=torch.int32).to(device)


def stage_sweep(
    kernel_name: str,
    gap_q: int,
    gap_r: int,
    local: bool,
    use_matmul: bool,
    dtype_str: str,
    eff_limit: int | None,
    nlimit: int | None = None,
    max_abs: int | None = None,
    scratch: torch.Tensor | None = None,
):
    """The five sweeps of one stage configuration.

    Normalises the request first: ``use_matmul`` has no meaning off the TPU,
    and "float32"/"int32" both compute in int32 ("int64" in int64, K1's
    int64 instantiation on the card). ``eff_limit`` is the exactness window
    whose escapes force an exact rescore; ``nlimit`` the requested narrow
    window (255 / 32767) the fan-out sweeps count for rung statistics.
    ``max_abs`` bounds |profile entry| (it picks int32 or int64 without a
    device sync) and ``scratch`` is K1's reusable strip-edge buffer; both
    pass straight to the kernel.

    Returns ``(sweep, sweep_multi, sweep_multi_topk, sweep_reduced,
    sweep_ladder_topk)``. Stack entries are device tensors ``(codes (g,
    n_pad, B) int8, lengths (g, B) int32[, ids (g, B) int32])`` plus host
    ``iq``/``ic`` pair index arrays where a sweep takes several queries.
    """
    del use_matmul
    kern = best_kernel(None if kernel_name == "auto" else kernel_name)
    cdtype = "int64" if dtype_str == "int64" else "int32"
    track = eff_limit is not None or nlimit is not None

    def run(profiles, codes, lens, iq, ic, m_reals):
        s, hi, lo = kern(
            profiles, codes, lens, iq, ic, m_reals, gap_q, gap_r,
            local=local, track_range=track, dtype=cdtype, max_abs=max_abs,
            scratch=scratch,
        )
        return s.long(), hi, lo

    def m_real_index(m_reals, profiles):
        """Per-query true lengths as a device index, range-checked on host."""
        m = profiles.shape[1]
        if m_reals is None:
            m_reals = [m] * profiles.shape[0]
        if any(not 1 <= int(mr) <= m for mr in m_reals):
            raise ValueError(f"m_real out of range for profile rows {m}")
        return _index(m_reals, profiles.device)

    def one_query(profile, codes, m_real):
        dev = profile.device
        g = codes.shape[0]
        return (
            profile[None],
            torch.zeros(g, dtype=torch.int32, device=dev),
            torch.arange(g, dtype=torch.int32, device=dev),
            m_real_index([m_real], profile[None]),
        )

    def _flat(parts):
        s = torch.cat([s.reshape(-1) for s, _, _ in parts])
        if eff_limit is not None:
            f = torch.cat([
                interseq.overflow_flags(s_, hi, lo, eff_limit, local).reshape(-1)
                for s_, hi, lo in parts
            ])
        else:
            f = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
        return s, f

    def sweep(profile, stacks, m_real=None):
        mr = profile.shape[0] if m_real is None else int(m_real)
        parts = []
        for codes, lens in stacks:
            prof, iq, ic, mrs = one_query(profile, codes, mr)
            parts.append(run(prof, codes, lens, iq, ic, mrs))
        return _flat(parts)

    def sweep_multi(profiles, stacks, m_reals=None):
        dev = profiles.device
        mrs = m_real_index(m_reals, profiles)
        parts = [
            run(profiles, codes, lens, _index(iq, dev), _index(ic, dev), mrs)
            for codes, lens, iq, ic in stacks
        ]
        return _flat(parts)

    def sweep_multi_topk(profiles, stacks, m_reals, k: int, n_queries: int, stats=None):
        """Multi-query sweep reduced to per-query top-k on the device.

        Returns ``(top_s (Q, k'), top_i (Q, k'), any_f, n_flagged)``.
        ``stats``: the request's ``SearchStats``, which gets a
        ``device.wait`` span around each stack group's index upload: a
        blocking copy from host memory waits for the work queued before it,
        the previous group's launch.
        """
        dev = profiles.device
        mrs = m_real_index(m_reals, profiles)
        parts_s, parts_i, parts_q = [], [], []
        any_f = torch.zeros((), dtype=torch.bool, device=dev)
        n_flagged = torch.zeros((), dtype=torch.int64, device=dev)
        for codes, lens, ids, iq, ic in stacks:
            with span(stats, "device.wait"):
                iq_d, ic_d = _index(iq, dev), _index(ic, dev)
            s, hi, lo = run(profiles, codes, lens, iq_d, ic_d, mrs)
            ids_rows = ids[ic_d.long()]  # (P, B) global ids, -1 padding
            valid = ids_rows >= 0
            if eff_limit is not None:
                f = interseq.overflow_flags(s, hi, lo, eff_limit, local)
                any_f = any_f | (f & valid).any()
            if nlimit is not None:
                fn_ = interseq.overflow_flags(s, hi, lo, nlimit, local)
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
        return top_s, top_i, any_f, n_flagged

    def sweep_ladder_topk(profile, stacks, m_real, k: int):
        """A narrow-width stage with its flags and top-k on the device.

        Returns ``(out, s_flat, ids_flat)``: ``out`` is one int64 vector
        ``[top_s (k') | top_i (k') | packed_flags (ceil(N/32))]`` with 32
        lanes' flags per word; ``s_flat``/``ids_flat`` stay on the device
        for the rare rescore.
        """
        parts = []
        for codes, lens, _ in stacks:
            prof, iq, ic, mrs = one_query(profile, codes, int(m_real))
            parts.append(run(prof, codes, lens, iq, ic, mrs))
        s, f = _flat(parts)
        ids = torch.cat([ids.reshape(-1) for _, _, ids in stacks])
        valid = ids >= 0
        # The int64 lane's padding sorts below every int64 score.
        s_m = torch.where(valid, s, NEG if cdtype == "int32" else -(2**63) + 1)
        i_m = torch.where(valid, ids, INVALID)
        order = _lexsort([-s_m, i_m])
        n_lanes = s.numel()
        kk = min(k, n_lanes)
        n_words = -(-n_lanes // 32)
        bits = torch.zeros(n_words * 32, dtype=torch.int64, device=s.device)
        bits[:n_lanes] = (f & valid).long()
        shifts = torch.arange(32, dtype=torch.int64, device=s.device)
        packed = (bits.view(n_words, 32) << shifts).sum(dim=1)
        out = torch.cat([s_m[order][:kk], i_m[order][:kk].long(), packed])
        return out, s_m, i_m

    def sweep_reduced(profiles, stacks, m_reals, group_of, k: int, n_frames: int):
        """Frame-fanout sweep reduced to ONE top-k list on the device.

        Best over frames per DB entry (first frame on ties), best entry per
        source record (``group_of``: entry id -> record id; lowest entry on
        ties), then (score desc, record asc). Returns ``(top_s, top_rec,
        top_entry, top_frame, any_f, n_flagged)``; rows past the valid
        candidates carry INVALID records.
        """
        dev = profiles.device
        mrs = m_real_index(m_reals, profiles)
        parts = []
        any_f = torch.zeros((), dtype=torch.bool, device=dev)
        n_flagged = torch.zeros((), dtype=torch.int64, device=dev)
        for codes, lens, ids, iq, ic in stacks:
            iq_d, ic_d = _index(iq, dev), _index(ic, dev)
            s, hi, lo = run(profiles, codes, lens, iq_d, ic_d, mrs)  # (F*C, B)
            nC = s.shape[0] // n_frames
            B = s.shape[1]
            ids_rows = ids[ic_d[:nC].long()]  # (C, B) entry ids, -1 padding
            valid = ids_rows >= 0
            if eff_limit is not None:
                fl = interseq.overflow_flags(s, hi, lo, eff_limit, local)
                any_f = any_f | (fl & valid.repeat(n_frames, 1)).any()
            if nlimit is not None:
                fn_ = interseq.overflow_flags(s, hi, lo, nlimit, local)
                # An entry sits in exactly one lane: the sum counts entries
                # flagged in ANY frame.
                fn_any = fn_.view(n_frames, nC, B).any(dim=0)
                n_flagged = n_flagged + (fn_any & valid).sum()
            s3 = s.view(n_frames, nC, B)
            fmax = s3.amax(dim=0)
            farg = torch.zeros((nC, B), dtype=torch.int32, device=dev)
            for fi in range(n_frames - 1, -1, -1):  # first max wins
                farg = torch.where(s3[fi] == fmax, fi, farg)
            rec_rows = torch.where(
                valid, group_of[ids_rows.clamp(min=0).long()], INVALID
            )
            parts.append((
                torch.where(valid, fmax, NEG).reshape(-1),
                torch.where(valid, ids_rows, INVALID).reshape(-1),
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
        return s2[o2], r2[o2], e1[o2], f1[o2], any_f, n_flagged

    return sweep, sweep_multi, sweep_multi_topk, sweep_reduced, sweep_ladder_topk
