"""Translated search (blastx): nucleotide reads by one client in a closed
loop, each searched in its six reading frames against the protein database.

The database is ``db_search``'s, drawn the same way from the same entries of
the configuration. Reads: a ``full_share`` of them are ``full_length``
bases, the rest uniform over ``trimmed_min``..``trimmed_max``; a
``homolog_share`` of them code for a window of an entry, the rest are
uniform ACGT with no homolog. A homolog read takes its entry's window,
changes it by amino-acid substitutions and in-frame codon indels (``gen.evolve``),
writes each residue as a codon drawn uniformly among its synonymous codons
of code 1, adds sequencing errors (base substitutions and N), puts the
coding frame at an offset of 0-2 bases and, for a ``reverse_share`` of
reads, reverse-complements the read. The lengths, which reads are
homologs, their entries, strands and offsets come from the traffic file's
fixed ``source_seed``; residues, codons and errors from the run's seed.

Request ``i`` is call ``i`` of the pool, in a fixed order: one
``align_many`` of ``queries_per_call`` reads. The check samples
``check_queries`` reads as ``db_search`` does, one from each equal run of a
call's positions, and compares each hit list with the plain reference's top
``k`` over the whole database (``hit_mismatches``: ids and scores in order)
and each hit's frame label with the reference's best frame for that entry
(``frame_mismatches``).
"""
from __future__ import annotations

import numpy as np

from .. import gen
from ..reference import dp, scoring, translate
from . import db_search
from .common import enum, numbers

# Synonymous codons of code 1 a residue of ``scoring.AA_LETTERS``, as rows of
# three ACGT codes (the reference's own table).
_CODONS = [np.array([["ACGT".index(b) for b in c] for c, a in translate.CODE_1.items()
                     if a == aa], dtype=np.uint8) for aa in scoring.AA_LETTERS]


def reverse_translate(g: np.random.Generator, protein: np.ndarray) -> np.ndarray:
    """Nucleotide codes coding for ``protein`` under code 1, each codon drawn
    uniformly among its residue's synonymous codons."""
    pick = g.random(len(protein))
    out = np.empty((len(protein), 3), dtype=np.uint8)
    for a, codons in enumerate(_CODONS):
        at = np.nonzero(protein == a)[0]
        out[at] = codons[(pick[at] * len(codons)).astype(np.int64)]
    return out.reshape(-1)


def sequencing_errors(g: np.random.Generator, read: np.ndarray, sub_rate: float,
                      n_rate: float) -> np.ndarray:
    """Base substitutions (to one of the other three bases) at ``sub_rate``,
    then N at ``n_rate`` a base."""
    out = read.copy()
    hit = np.nonzero(g.random(len(out)) < sub_rate)[0]
    out[hit] = (out[hit] + g.integers(1, 4, len(hit))) % 4
    out[g.random(len(out)) < n_rate] = translate.N
    return out


class Mix:
    sample = db_search.Mix.sample
    entry = db_search.Mix.entry
    requests = db_search.Mix.requests

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from libssa_tpu_torch import api
        from libssa_tpu_torch.constants import (AlignType, BitWidth, ComputeMode, Strand,
                                                SymType)
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
        where = np.empty(n, dtype=np.int64)
        where[perm] = np.arange(n)  # canonical entry -> database id

        tr = traffic["reads"]
        per = traffic["queries_per_call"]
        n_reads = (traffic["pool_calls"] + 1) * per
        fixed = gen.rng(tr["source_seed"])
        full = fixed.random(n_reads) < tr["full_share"]
        self.read_lengths = np.where(
            full, tr["full_length"],
            fixed.integers(tr["trimmed_min"], tr["trimmed_max"] + 1, n_reads))
        self.homolog = fixed.random(n_reads) < tr["homolog_share"]
        self.reverse = fixed.random(n_reads) < tr["reverse_share"]
        self.offset = fixed.integers(0, 3, n_reads)
        need = -(-(self.read_lengths - self.offset) // 3)  # codons a homolog codes
        long_enough = np.nonzero(canon >= need.max())[0]
        self.sources = np.full(n_reads, -1, dtype=np.int64)  # database id, -1: none
        self.sources[self.homolog] = where[
            fixed.choice(long_enough, int(self.homolog.sum()), replace=False)]

        gq = gen.rng(seed, 2)
        comp = config["composition"]
        self.reads = []
        for j in range(n_reads):
            L = int(self.read_lengths[j])
            if not self.homolog[j]:
                self.reads.append(gq.integers(0, 4, L).astype(np.uint8))
                continue
            protein = gen.evolve(gq, self.entry(self.sources[j]), int(need[j]),
                                 tr["substitution_rate"], tr["indel_rate"],
                                 tr["indel_mean"], comp)
            o = int(self.offset[j])
            nt = np.concatenate((gq.integers(0, 4, o).astype(np.uint8),
                                 reverse_translate(gq, protein)))[:L]
            nt = sequencing_errors(gq, nt, tr["base_substitution_rate"], tr["n_rate"])
            self.reads.append(translate.reverse_complement(nt) if self.reverse[j] else nt)

        q = config["query"]
        self.ctx = api.SSAContext(device)
        self.ctx.init_symbol_translation(enum(SymType, q["symtype"]), enum(Strand, q["strands"]),
                                         q_gencode=q["genetic_code"], d_gencode=1,
                                         db_symtype=enum(SymType, config["symtype"]))
        self.ctx.init_score_matrix(config["scoring"]["matrix"])
        self.ctx.init_gap_penalties(config["gap_open"], config["gap_extend"],
                                    first_residue_opens=config["first_residue_opens"])
        self.ctx.db = SequenceDB(self.codes, self.offsets, self.lengths,
                                 [f"e{i}" for i in range(n)], SymType.AMINOACID)
        self.query_objs = [self.ctx.init_sequence_fasta(_letters(r), header=f"r{j}")
                           for j, r in enumerate(self.reads)]
        self.per = per
        self.k = traffic["k"]
        self.mode = enum(ComputeMode, traffic["mode"])
        self.align_type = enum(AlignType, traffic["align_type"])
        self.bit_width = enum(BitWidth, traffic["bit_width"])
        self.frame_residues = [sum(len(aa) for _, aa in translate.frames(r))
                               for r in self.reads]
        self.answers: dict[int, list] = {}  # read index -> (id, score, frame label)
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
            self.answers[j] = [(h.seq_id, h.score, h.strand) for h in hl.hits]
            self.stats.append(hl.stats)
        q_res = sum(self.frame_residues[j] for j in idx)
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
        sub = translate.substitution()
        Q, R = scoring.gap_qr(cfg["gap_open"], cfg["gap_extend"], cfg["first_residue_opens"])
        pick = self.sample(done)
        db = dp.Database(self.codes, self.offsets, self.lengths, len(sub), self.device)
        fr = [translate.frames(self.reads[j]) for j in pick]
        qs = [aa for f in fr for _, aa in f]
        refs = db.scores(qs, sub, Q, R, True)
        ctls = None if saturate is None else db.scores(qs, sub, Q, R, True, saturate)
        hit_mism = frame_mism = row = 0
        for j, f in zip(pick, fr):
            labels = [label for label, _ in f]
            rows = slice(row, row + len(f))
            row += len(f)
            best, best_label = translate.best_frames(refs[rows], labels)
            want = dp.top_hits(best, self.k)
            if ctls is None:
                got = self.answers[j]
            else:
                c_best, c_label = translate.best_frames(ctls[rows], labels)
                got = [(i, s, c_label[i]) for i, s in dp.top_hits(c_best, self.k)]
            hit_mism += abs(len(got) - len(want)) + sum(
                (h[0], h[1]) != w for h, w in zip(got, want))
            frame_mism += sum(h[2] != best_label[h[0]] for h in got)
        del db
        if self.device != "cpu":
            torch.cuda.empty_cache()
        return numbers({"hit_mismatches": hit_mism, "frame_mismatches": frame_mism},
                       self.traffic["limits"])


def _letters(read: np.ndarray) -> str:
    return np.frombuffer(translate.READ_LETTERS.encode(), dtype=np.uint8)[read].tobytes().decode()
