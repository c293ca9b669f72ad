"""Database search by one client in a closed loop.

The database is the configuration's: ``entries`` lognormal lengths drawn
from its fixed ``length_seed`` (the same sizes for every seed), in an order
and with residues drawn from the run's seed. Queries are homologs of
entries (substitutions and short indels, each query as long as its entry):
which entries, and so every query length, come from the traffic file's
fixed ``source_seed``; their residues from the run's seed. A ``family``
gives each query's entry that many homologs among the entries nearest its
length, so that the top hits, and the traceback's work, have the same sizes
for every seed. Request ``i`` is call ``i`` of the pool, in a fixed order,
so every seed sends the same sizes. Each call is one ``align_many`` (a batch) or one ``sw_align`` /
``nw_align`` (one query), with the traffic file's ``k``, mode and bit width.

The check compares ``check_queries`` of the window's answered queries, drawn
from the seed, with the plain reference: each hit list (ids, scores and
their order) with the reference's top ``k`` over the whole database, and in
ALIGNMENT mode each hit's alignment must re-score to its score and to the
reference's. Where a call holds a batch, its positions are cut into
``check_queries`` equal runs and one query is drawn from each, in a call
drawn from those answered: every part of a batch is checked in every run.
The reference scores the drawn queries side by side in one sweep of the
database.
"""
from __future__ import annotations

import numpy as np

from .. import gen
from ..reference import alignment, dp, scoring
from .common import enum, numbers


def family_members(g: np.random.Generator, lengths: np.ndarray, sources: np.ndarray,
                   count: int) -> list[np.ndarray]:
    """For each source, ``count`` other entries of about its length (the
    nearest unused ones in a window of the length order), none used twice."""
    if count == 0:
        return [np.zeros(0, dtype=np.int64)] * len(sources)
    order = np.argsort(lengths, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    used = np.zeros(len(lengths), dtype=bool)
    used[sources] = True
    out = []
    for src in sources:
        width = 8 * count
        while True:
            lo, hi = max(0, rank[src] - width), min(len(order), rank[src] + width + 1)
            free = order[lo:hi][~used[order[lo:hi]]]
            if len(free) >= count or width >= len(order):
                break
            width *= 2
        pick = g.choice(free, count, replace=False)
        used[pick] = True
        out.append(pick)
    return out


class Mix:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from libssa_tpu_torch import api
        from libssa_tpu_torch.constants import AlignType, BitWidth, ComputeMode, SymType
        from libssa_tpu_torch.io.db import SequenceDB

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        d = config["database"]
        n = d["entries"]
        canon = gen.lognormal_lengths(gen.rng(d["length_seed"]), n, d["mean_length"],
                                      d["length_sigma"], d["min_length"], d["max_length"])
        g = gen.rng(seed, 1)
        perm = g.permutation(n)
        self.lengths = canon[perm]
        self.offsets = np.zeros(n, dtype=np.int64)
        np.cumsum(self.lengths[:-1], out=self.offsets[1:])
        self.codes = gen.residues(g, int(self.lengths.sum()), config["composition"])
        self.residues = int(self.lengths.sum())

        tq = traffic["queries"]
        per = traffic["queries_per_call"]
        where = np.empty(n, dtype=np.int64)
        where[perm] = np.arange(n)  # canonical entry -> database id
        fixed = gen.rng(tq["source_seed"])
        n_queries = (traffic["pool_calls"] + 1) * per
        sources = fixed.choice(n, n_queries, replace=False)  # canonical entries
        fam = tq.get("family", {"members": 0})
        members = family_members(fixed, canon, sources, fam["members"])
        self.families = [where[np.concatenate(([s], m))] for s, m in zip(sources, members)]
        gq = gen.rng(seed, 2)
        comp = config["composition"]
        for src, mem in zip(sources, members):
            s = self.entry(where[src])
            for c in mem:  # a family: homologs of the source as long as their entries
                i = where[c]
                self.codes[self.offsets[i] : self.offsets[i] + self.lengths[i]] = gen.evolve(
                    gq, s, int(self.lengths[i]), fam["substitution_rate"], fam["indel_rate"],
                    fam["indel_mean"], comp)
        self.queries = [
            gen.evolve(gq, self.entry(where[c]), int(canon[c]), tq["substitution_rate"],
                       tq["indel_rate"], tq["indel_mean"], comp)
            for c in sources
        ]

        self.ctx = api.SSAContext(device)
        self.ctx.init_score_matrix(config["scoring"]["matrix"])
        self.ctx.init_gap_penalties(config["gap_open"], config["gap_extend"],
                                    config["first_residue_opens"])
        self.ctx.db = SequenceDB(self.codes, self.offsets, self.lengths,
                                 [f"e{i}" for i in range(n)], SymType.AMINOACID)
        self.query_objs = [
            self.ctx.init_sequence_fasta(scoring.decode(q, "aminoacid"), header=f"q{j}")
            for j, q in enumerate(self.queries)
        ]
        self.per = per
        self.entry_point = traffic["entry"]
        self.k = traffic["k"]
        self.mode = enum(ComputeMode, traffic["mode"])
        self.align_type = enum(AlignType, traffic["align_type"])
        self.bit_width = enum(BitWidth, traffic["bit_width"])
        self.local = traffic["align_type"] == "sw"
        self.answers: dict[int, list] = {}  # query index -> hits
        self.stats: list = []  # the port's SearchStats, one a call

    def entry(self, i: int) -> np.ndarray:
        return self.codes[self.offsets[i] : self.offsets[i] + self.lengths[i]]

    def requests(self, call: int) -> list[int]:
        """Query indexes of pool call ``call``; the pool's last call is the
        warm-up's, and the window cycles through the others."""
        c = call % self.traffic["pool_calls"]
        return list(range(c * self.per, (c + 1) * self.per))

    def _run(self, idx: list[int]):
        qs = [self.query_objs[j] for j in idx]
        if self.entry_point == "align_many":
            return self.ctx.align_many(qs, k=self.k, mode=self.mode,
                                       align_type=self.align_type, bit_width=self.bit_width)
        fn = self.ctx.sw_align if self.entry_point == "sw_align" else self.ctx.nw_align
        return [fn(qs[0], k=self.k, bit_width=self.bit_width, mode=self.mode)]

    def warm(self) -> None:
        self._run(list(range(self.traffic["pool_calls"] * self.per, len(self.queries))))

    def call(self, i: int) -> dict:
        idx = self.requests(i)
        lists = self._run(idx)
        for j, hl in zip(idx, lists):
            self.answers[j] = [
                (h.seq_id, h.score, h.q_begin, h.q_end, h.s_begin, h.s_end, h.cigar)
                for h in hl.hits
            ]
        self.stats.append(lists[0].stats)
        q_res = sum(len(self.queries[j]) for j in idx)
        return {"requests": len(idx), "queries": len(idx), "query_residues": q_res,
                "cells": q_res * self.residues}

    def release(self) -> None:
        self.ctx = None
        self.query_objs = None

    def sample(self, done: list[int]) -> list[int]:
        """The answered queries the check compares, drawn from the seed: one
        from each of ``check_queries`` equal runs of a batch's positions, in
        a call drawn from those answered; one query a call: that many of the
        answered ones."""
        g = gen.rng(self.seed, 3)
        answered = sorted(set(done))
        k = self.traffic["check_queries"]
        if self.per == 1:
            return [int(j) for j in g.choice(answered, size=min(k, len(answered)),
                                              replace=False)]
        calls = sorted({j // self.per for j in answered})
        return [int(g.choice(calls)) * self.per + int(g.choice(run))
                for run in np.array_split(np.arange(self.per), min(k, self.per))]

    def check(self, done: list[int], saturate: str | None = None) -> dict:
        """Compare the sample of the answered queries with the plain
        reference. ``saturate`` puts the reference at that window in the
        program's place: the control."""
        import torch

        cfg = self.config
        sub = scoring.substitution(cfg["scoring"])
        Q, R = scoring.gap_qr(cfg["gap_open"], cfg["gap_extend"], cfg["first_residue_opens"])
        pick = self.sample(done)
        db = dp.Database(self.codes, self.offsets, self.lengths, len(sub), self.device)
        qs = [self.queries[j] for j in pick]
        refs = db.scores(qs, sub, Q, R, self.local)
        ctls = None if saturate is None else db.scores(qs, sub, Q, R, self.local, saturate)
        mism = align_err = 0
        for row, j in enumerate(pick):
            q, ref = qs[row], refs[row]
            want = dp.top_hits(ref, self.k)
            if ctls is None:
                got = self.answers[j]
            else:
                got = [(i, s, None, None, None, None, None)
                       for i, s in dp.top_hits(ctls[row], self.k)]
            mism += abs(len(got) - len(want)) + sum(
                (g[0], g[1]) != w for g, w in zip(got, want))
            if self.mode.name == "ALIGNMENT" and ctls is None:
                for sid, score, qb, qe, sb, se, cigar in got:
                    r = alignment.rescore(q, self.entry(sid), sub, Q, R, qb, qe, sb, se,
                                          cigar, self.local)
                    align_err += r is None or r != score or r != ref[sid]
        del db
        if self.device != "cpu":
            torch.cuda.empty_cache()
        values = {"hit_mismatches": mism}
        if self.mode.name == "ALIGNMENT":
            values["alignment_errors"] = align_err
        return numbers(values, self.traffic["limits"])
