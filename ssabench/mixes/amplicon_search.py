"""16S amplicon classification: reads (amplicon sequence variants) by one
client in a closed loop, each searched globally on both strands against a
nucleotide database, with the alignments of its top hits.

The database is the configuration's, drawn as ``db_search`` draws it: its
fixed lengths, in an order and with ACGT residues from the run's seed. Each
read is a homolog of an entry (its source) and as long as it: substitutions
at ``substitution_rate`` (at ``novel_substitution_rate`` for a
``novel_share`` of the reads, which stand for taxa the database lacks) and
indels at ``indel_rate`` a base of mean length ``indel_mean``; a
``reverse_share`` of the reads are reverse-complemented (libraries ligated
in both orientations). Each source has a family of other entries of exactly
its length: ``identical`` copies of it and ``near`` homologs, each at a
substitution rate drawn uniformly from ``near_min_rate``..``near_max_rate``,
so that the top hits are dense and tied, as in a database of rRNA genes. The
sources, their families, which reads are novel or reversed and each
family member's rate come from the traffic file's fixed ``source_seed``, so
every seed sends the same sizes; residues from the run's seed.

Request ``i`` is call ``i`` of the pool, in a fixed order: one
``align_many`` of ``queries_per_call`` reads with the traffic file's ``k``,
mode, alignment type and bit width. The check samples ``check_queries``
reads as ``db_search`` does, one from each equal run of a call's positions,
and scores both strands of each against the whole database with the plain
reference: each hit list (ids and scores in order) against the reference's
top ``k`` of each entry's better strand (``hit_mismatches``); each hit's
strand label against the first strand (``+``, then ``-``) that reaches the
entry's best (``strand_mismatches``); in ALIGNMENT mode each hit's
alignment, re-scored on its strand of the read against its entry, has to
give its score and the reference's for that strand, and under NW consume
both sequences whole (``alignment_errors``).
"""
from __future__ import annotations

import numpy as np

from .. import gen
from ..reference import alignment, dp, scoring, translate
from . import db_search
from .common import enum, numbers

STRANDS = ("+", "-")  # the port's labels, in the order that breaks ties


def same_length_members(g: np.random.Generator, lengths: np.ndarray, sources: np.ndarray,
                        count: int) -> list[np.ndarray]:
    """For each source, ``count`` other entries of exactly its length, drawn
    among those not yet used; no source is a member, no member used twice."""
    used = np.zeros(len(lengths), dtype=bool)
    used[sources] = True
    order = np.argsort(lengths, kind="stable")
    by_length = lengths[order]
    out = []
    for src in sources:
        lo, hi = np.searchsorted(by_length, [lengths[src], lengths[src] + 1])
        block = order[lo:hi]
        free = block[~used[block]]
        if len(free) < count:
            raise ValueError(f"{len(free)} free entries of length {lengths[src]}, "
                             f"a family needs {count}")
        pick = g.choice(free, count, replace=False)
        used[pick] = True
        out.append(pick)
    return out


def layout(config: dict, traffic: dict) -> dict:
    """What the fixed seeds decide, the same for every run's seed: the
    canonical lengths, each read's source entry and family (canonical
    indexes), whether it is novel or reversed, and each near member's rate."""
    d = config["database"]
    n = d["entries"]
    canon = gen.lognormal_lengths(gen.rng(d["length_seed"]), n, d["mean_length"],
                                  d["length_sigma"], d["min_length"], d["max_length"])
    tr = traffic["reads"]
    fam = tr["family"]
    n_reads = (traffic["pool_calls"] + 1) * traffic["queries_per_call"]
    fixed = gen.rng(tr["source_seed"])
    sources = fixed.choice(n, n_reads, replace=False)
    novel = fixed.random(n_reads) < tr["novel_share"]
    reverse = fixed.random(n_reads) < tr["reverse_share"]
    members = same_length_members(fixed, canon, sources, fam["identical"] + fam["near"])
    rates = fixed.uniform(fam["near_min_rate"], fam["near_max_rate"], (n_reads, fam["near"]))
    return {"canon": canon, "sources": sources, "members": members, "novel": novel,
            "reverse": reverse, "near_rates": rates}


class Mix:
    sample = db_search.Mix.sample
    entry = db_search.Mix.entry
    requests = db_search.Mix.requests

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from libssa_tpu_torch import api
        from libssa_tpu_torch.constants import (AlignType, BitWidth, ComputeMode, Strand,
                                                SymType)
        from libssa_tpu_torch.io.db import SequenceDB

        if traffic["align_type"] != config["align_type"]:
            raise ValueError(f"the traffic's {traffic['align_type']} is not the "
                             f"configuration's {config['align_type']}")
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        lay = layout(config, traffic)
        canon = lay["canon"]
        n = len(canon)
        g = gen.rng(seed, 1)
        perm = g.permutation(n)
        self.lengths = canon[perm]
        self.offsets = np.zeros(n, dtype=np.int64)
        np.cumsum(self.lengths[:-1], out=self.offsets[1:])
        comp = config["composition"]
        self.codes = gen.residues(g, int(self.lengths.sum()), comp)
        self.residues = int(self.lengths.sum())
        where = np.empty(n, dtype=np.int64)
        where[perm] = np.arange(n)  # canonical entry -> database id

        tr = traffic["reads"]
        identical = tr["family"]["identical"]
        self.sources = where[lay["sources"]]
        self.novel, self.reverse = lay["novel"], lay["reverse"]
        self.families = [where[np.concatenate(([s], m))]
                         for s, m in zip(lay["sources"], lay["members"])]
        gq = gen.rng(seed, 2)
        for fam, rates in zip(self.families, lay["near_rates"]):
            src = self.entry(fam[0]).copy()
            for c, i in enumerate(fam[1:]):
                at = slice(self.offsets[i], self.offsets[i] + self.lengths[i])
                self.codes[at] = src if c < identical else gen.evolve(
                    gq, src, len(src), rates[c - identical], 0.0, 1.0, comp)
        self.reads = []
        for j, s in enumerate(self.sources):
            rate = tr["novel_substitution_rate"] if self.novel[j] else tr["substitution_rate"]
            read = gen.evolve(gq, self.entry(s), int(self.lengths[s]), rate, tr["indel_rate"],
                              tr["indel_mean"], comp)
            self.reads.append(translate.reverse_complement(read) if self.reverse[j] else read)

        sym = config["symtype"]
        self.ctx = api.SSAContext(device)
        self.ctx.init_symbol_translation(enum(SymType, sym), enum(Strand, config["strands"]))
        self.ctx.init_constant_scoring(config["scoring"]["match"], config["scoring"]["mismatch"])
        self.ctx.init_gap_penalties(config["gap_open"], config["gap_extend"],
                                    first_residue_opens=config["first_residue_opens"])
        self.ctx.db = SequenceDB(self.codes, self.offsets, self.lengths,
                                 [f"e{i}" for i in range(n)], SymType.NUCLEOTIDE)
        self.query_objs = [self.ctx.init_sequence_fasta(scoring.decode(r, sym), header=f"r{j}")
                           for j, r in enumerate(self.reads)]
        self.per = traffic["queries_per_call"]
        self.k = traffic["k"]
        self.mode = enum(ComputeMode, traffic["mode"])
        self.align_type = enum(AlignType, traffic["align_type"])
        self.bit_width = enum(BitWidth, traffic["bit_width"])
        self.local = traffic["align_type"] == "sw"
        # read index -> (id, score, strand, q_begin, q_end, s_begin, s_end, cigar)
        self.answers: dict[int, list] = {}
        self.stats: list = []  # the port's SearchStats, one a read

    def _run(self, idx: list[int]):
        return self.ctx.align_many([self.query_objs[j] for j in idx], k=self.k,
                                   mode=self.mode, align_type=self.align_type,
                                   bit_width=self.bit_width)

    def warm(self) -> None:
        self._run(list(range(self.traffic["pool_calls"] * self.per, len(self.reads))))

    def call(self, i: int) -> dict:
        idx = self.requests(i)
        lists = self._run(idx)
        for j, hl in zip(idx, lists):
            self.answers[j] = [(h.seq_id, h.score, h.strand, h.q_begin, h.q_end, h.s_begin,
                                h.s_end, h.cigar) for h in hl.hits]
            self.stats.append(hl.stats)
        q_res = sum(len(STRANDS) * len(self.reads[j]) for j in idx)
        return {"requests": len(idx), "queries": len(idx), "query_residues": q_res,
                "cells": q_res * self.residues}

    def release(self) -> None:
        self.ctx = None
        self.query_objs = None

    def check(self, done: list[int], saturate: str | None = None) -> dict:
        """Compare the sample of the answered reads with the plain reference.
        ``saturate`` puts the reference at that window in the program's
        place: the control."""
        import torch

        cfg = self.config
        sub = scoring.substitution(cfg["scoring"])
        Q, R = scoring.gap_qr(cfg["gap_open"], cfg["gap_extend"], cfg["first_residue_opens"])
        pick = self.sample(done)
        db = dp.Database(self.codes, self.offsets, self.lengths, len(sub), self.device)
        both = [(self.reads[j], translate.reverse_complement(self.reads[j])) for j in pick]
        qs = [s for pair in both for s in pair]
        refs = db.scores(qs, sub, Q, R, self.local)
        ctls = None if saturate is None else db.scores(qs, sub, Q, R, self.local, saturate)
        hit_mism = strand_mism = align_err = 0
        for row, j in enumerate(pick):
            rows = slice(2 * row, 2 * row + 2)
            best, label = translate.best_frames(refs[rows], list(STRANDS))
            want = dp.top_hits(best, self.k)
            if ctls is None:
                got = self.answers[j]
            else:
                c_best, c_label = translate.best_frames(ctls[rows], list(STRANDS))
                got = [(i, s, c_label[i]) for i, s in dp.top_hits(c_best, self.k)]
            hit_mism += abs(len(got) - len(want)) + sum(
                (h[0], h[1]) != w for h, w in zip(got, want))
            strand_mism += sum(h[2] != label[h[0]] for h in got)
            if self.mode.name == "ALIGNMENT" and ctls is None:
                for sid, score, strand, qb, qe, sb, se, cigar in got:
                    if strand not in STRANDS:
                        align_err += 1
                        continue
                    si = STRANDS.index(strand)
                    r = alignment.rescore(both[row][si], self.entry(sid), sub, Q, R, qb, qe,
                                          sb, se, cigar, self.local)
                    align_err += r is None or r != score or r != refs[2 * row + si][sid]
        del db
        if self.device != "cpu":
            torch.cuda.empty_cache()
        values = {"hit_mismatches": hit_mism, "strand_mismatches": strand_mism}
        if self.mode.name == "ALIGNMENT":
            values["alignment_errors"] = align_err
        return numbers(values, self.traffic["limits"])
