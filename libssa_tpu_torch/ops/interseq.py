"""Inter-sequence batched SW/NW scoring: the plain PyTorch version.

One query against B subjects, one subject per lane, walking the subject
columns in a Python loop. This is the port of ``libssa_tpu.ops.interseq``'s
column scan and keeps its exact contract, which ``csrc/interseq.cu`` (K1)
also keeps:

* ``(scores, hi, lo)`` per lane. ``hi``/``lo`` are the running max/min of H
  over valid steps (``t < length``), and under NW over real rows only
  (``row < m_real``); with ``track_range=False`` hi == scores and lo == 0.
* A length-0 lane scores 0 under SW and ``-(Q + (m_real - 1) R)`` under NW.
* SW ignores ``m_real``: pad rows (-64 scores) are strictly dominated, so
  unmasked reductions over every profile row are exact.

Per column: E from the previous column, Hnof = max(diag + S, E) (clamped at
0 under SW), then the vertical F by the lazy-F identity
F[i] = cummax(Hnof[k] + k R)[i - 1] - Q - (i - 1) R, which ``torch.cummax``
computes in one pass; H = max(Hnof, F).

The core runs a batch of (query, chunk) pairs at once — the shape a stage
sweep hands to K1 — so the same function serves the single-query
``interseq_scores`` and the pair-batched ``interseq_pairs``;
``pair_scores_batch`` runs P pairs that share one query through it.

``dtype``: "int32" and "float32" both compute in int32 (exact wherever the
reference's f32 was; the manager keeps the f32-window flagging for
statistics parity), "int64" in int64. int32 would wrap past 2**31 where
f32 saturated, so an int32 request whose a-priori bound on |H| reaches
2**31 - 1 computes in int64 (``compute_dtype``), here and in K1 alike.
``use_matmul`` is accepted for interface parity only.
"""
from __future__ import annotations

import torch

NEG = {torch.int32: -(2**30), torch.int64: -(2**62)}  # -inf surrogates
INT32_LIMIT = 2**31 - 1


def compute_dtype(dtype, max_abs: int, m: int, n: int, Q: int, R: int):
    """The torch integer type a requested DP dtype computes in.

    ``max_abs`` bounds |profile entry|, ``m``/``n`` are the profile rows and
    subject columns: int32 is chosen only while every |H| provably fits it.
    """
    if dtype in ("int64", torch.int64):
        return torch.int64
    if dtype not in ("int32", "float32", torch.int32, torch.float32):
        raise ValueError(f"unsupported DP dtype {dtype!r}")
    bound = min(m, n) * max_abs + Q + max(m, n) * R
    return torch.int64 if bound >= INT32_LIMIT else torch.int32


def _max_abs(profiles: torch.Tensor) -> int:
    return int(profiles.abs().max()) if profiles.numel() else 0


def _scan(profiles, codes, ic, lengths, m_reals, Q: int, R: int, local: bool,
          track_range: bool, dt: torch.dtype):
    """Column scan over P pairs at once.

    ``profiles`` (P, m, 32), ``codes`` (g, n_pad, B) with pair p reading
    chunk ``ic[p]``, ``lengths`` (P, B), ``m_reals`` (P,). Returns
    (scores, hi, lo), each (P, B) in ``dt``.
    """
    P, m, _ = profiles.shape
    n_pad, B = codes.shape[1], codes.shape[2]
    dev = profiles.device
    neg = NEG[dt]
    prof = profiles.to(dt)
    lengths = lengths.to(dev)
    mr = m_reals.to(device=dev, dtype=dt)
    kR = torch.arange(m + 1, device=dev, dtype=dt).view(1, m + 1, 1) * R
    if local:
        H = torch.zeros((P, m + 1, B), dtype=dt, device=dev)
    else:
        H = torch.cat(
            [torch.zeros((P, 1, B), dtype=dt, device=dev),
             (-(Q + kR[:, :-1])).expand(P, m, B)],
            dim=1,
        )
    E = torch.full((P, m, B), neg, dtype=dt, device=dev)
    best = torch.zeros((P, B), dtype=dt, device=dev)
    nw = (-(Q + (mr - 1) * R)).view(P, 1).expand(P, B).clone()
    hi = torch.zeros((P, B), dtype=dt, device=dev)
    lo = torch.zeros((P, B), dtype=dt, device=dev)
    rows = torch.arange(m, device=dev).view(1, m, 1)
    rowmask = rows < mr.view(P, 1, 1)
    cap_idx = (mr - 1).clamp(min=0).long().view(P, 1, 1).expand(P, 1, B)
    ic = ic.to(dev).long()

    for t in range(n_pad):
        valid = t < lengths  # (P, B)
        s_t = codes[:, t][ic].long()  # (P, B)
        S = torch.gather(prof, 2, s_t.view(P, 1, B).expand(P, m, B))
        h0 = 0 if local else -(Q + t * R)
        h0_row = torch.full((P, 1, B), h0, dtype=dt, device=dev)
        E = torch.maximum(E - R, H[:, 1:] - Q)
        Hnof = torch.maximum(H[:, :-1] + S, E)
        if local:
            Hnof = Hnof.clamp(min=0)
        W = torch.cat([h0_row, Hnof], dim=1) + kR
        C = torch.cummax(W, dim=1).values
        body = torch.maximum(Hnof, C[:, :-1] - Q - kR[:, :-1])
        H = torch.cat([h0_row, body], dim=1)
        if local:
            col_max = body.amax(dim=1)
        else:
            col_max = torch.where(rowmask, body, neg).amax(dim=1)
        best = torch.where(valid, torch.maximum(best, col_max), best)
        if not local:
            cap = torch.gather(body, 1, cap_idx).squeeze(1)
            nw = torch.where(t == lengths - 1, cap, nw)
        if track_range:
            if local:
                col_min = body.amin(dim=1)
            else:
                col_min = torch.where(rowmask, body, -neg).amin(dim=1)
            hi = torch.where(valid, torch.maximum(hi, col_max), hi)
            lo = torch.where(valid, torch.minimum(lo, col_min), lo)

    scores = best if local else nw
    if not track_range:
        hi, lo = scores, torch.zeros_like(scores)
    return scores, hi, lo


def interseq_scores(
    profile: torch.Tensor,  # (m, PADDED_ALPHABET) int
    subjects_T: torch.Tensor,  # (n_pad, B) int codes, PAD beyond lengths
    lengths: torch.Tensor,  # (B,) int32
    gap_q,
    gap_r,
    local: bool = True,
    use_matmul: bool = True,
    track_range: bool = False,
    dtype="int32",
    m_real: int | None = None,
):
    """Score one query against B subjects; returns ``(scores, hi, lo)``.

    Outputs are int32, or int64 where the computation ran in int64.
    """
    del use_matmul
    m = profile.shape[0]
    mr = m if m_real is None else int(m_real)
    if not 1 <= mr <= m:
        raise ValueError(f"m_real {mr} out of range for profile rows {m}")
    Q, R = int(gap_q), int(gap_r)
    dt = compute_dtype(dtype, _max_abs(profile), m, subjects_T.shape[0], Q, R)
    s, hi, lo = _scan(
        profile[None], subjects_T[None], torch.zeros(1, dtype=torch.long),
        lengths.view(1, -1), torch.tensor([mr]), Q, R, local, track_range, dt,
    )
    return s[0], hi[0], lo[0]


def interseq_pairs(
    profiles: torch.Tensor,  # (n_queries, m, PADDED_ALPHABET) int
    codes: torch.Tensor,  # (g, n_pad, B) int8 codes of one stack group
    lengths: torch.Tensor,  # (g, B) int32
    iq: torch.Tensor,  # (P,) query index of each pair
    ic: torch.Tensor,  # (P,) chunk index of each pair
    m_reals: torch.Tensor,  # (n_queries,) true query lengths
    gap_q,
    gap_r,
    local: bool = True,
    track_range: bool = False,
    dtype="int32",
    max_abs: int | None = None,
    scratch: torch.Tensor | None = None,
):
    """Every (query, chunk) pair of a stack group: ``(scores, hi, lo)`` (P, B).

    The plain counterpart of one K1 launch
    (``interseq_cuda.interseq_pairs_cuda``), with the same arguments:
    ``max_abs`` bounds |profile entry| (computed from ``profiles`` when
    None); ``scratch`` is K1's strip-edge buffer and unused here.
    """
    del scratch
    dev = profiles.device
    Q, R = int(gap_q), int(gap_r)
    if max_abs is None:
        max_abs = _max_abs(profiles)
    dt = compute_dtype(dtype, max_abs, profiles.shape[1], codes.shape[1], Q, R)
    iq = iq.to(dev).long()
    ic = ic.to(dev).long()
    return _scan(
        profiles[iq], codes, ic, lengths.to(dev)[ic], m_reals.to(dev)[iq],
        Q, R, local, track_range, dt,
    )


def pair_scores_batch(
    profile: torch.Tensor,  # (m, PADDED_ALPHABET) int32, SHARED query profile
    subjects: torch.Tensor,  # (P, n) integer codes, PAD-padded
    lengths: torch.Tensor,  # (P,) int32 true subject lengths
    gap_q,
    gap_r,
    local: bool = True,
    m_real: int | None = None,
    kernel: str = "auto",
):
    """Batched 1-vs-1 scoring of P pairs sharing one query: (P,) scores.

    The pairs are the inter-sequence shape, one pair per lane, so this is
    one ``interseq_scores`` call: K1 on CUDA tensors (``kernel`` "auto" or
    "cuda", through ``interseq_cuda.interseq_scores_cuda``), the plain
    version on the CPU or with ``kernel="plain"``. Exact in int32, or in
    int64 where ``compute_dtype`` widens.
    """
    if kernel == "plain":
        fn = interseq_scores
    elif kernel in ("auto", "cuda"):
        from .interseq_cuda import interseq_scores_cuda as fn
    else:
        raise ValueError(f"unknown kernel {kernel!r} (auto | cuda | plain)")
    subjects_T = subjects.to(torch.int8).T.contiguous()  # (n, P)
    scores, _, _ = fn(
        profile.to(torch.int32), subjects_T, lengths.to(torch.int32),
        int(gap_q), int(gap_r), local=local, track_range=False, m_real=m_real,
    )
    return scores


def overflow_flags(scores, hi, lo, limit: int | None, local: bool):
    """Ladder overflow emulation: which lanes left the width's window.

    SW flags when the running max reaches ``limit`` (the reference's
    biased-unsigned saturating window); NW scores are signed and also flag
    on ``lo <= -limit``.
    """
    if limit is None:
        return torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    over = hi >= limit
    if not local:
        over = over | (lo <= -limit)
    return over
