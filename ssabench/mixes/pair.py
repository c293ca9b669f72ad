"""One pair, aligned again and again by one client in a closed loop.

The pair is a homolog pair drawn from the run's seed at the traffic file's
exact lengths: a query of drawn residues, and a subject evolved from it by
substitutions, deletions and insertions that make up its length. Where the
traffic file gives a ``layout_seed``, where those substitutions and gaps
fall, and so the shape of the optimal alignment and of the work that finds
it, comes from that fixed seed, and only the residues from the run's seed.
Every request is one ``align_pair`` with the traffic file's type and mode.

The check compares every request's score with the plain reference's score
of the pair, and in ALIGNMENT mode re-scores every distinct alignment that
came back: it has to give that score.
"""
from __future__ import annotations

from .. import gen
from ..reference import alignment, dp, scoring
from .common import enum, numbers


class Mix:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from libssa_tpu_torch import api
        from libssa_tpu_torch.constants import AlignType, ComputeMode, SymType

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        g = gen.rng(seed, 1)
        comp = config["composition"]
        self.q = gen.residues(g, traffic["query_length"], comp)
        layout = gen.rng(traffic["layout_seed"]) if "layout_seed" in traffic else None
        self.s = gen.evolve(g, self.q, traffic["subject_length"], traffic["substitution_rate"],
                            traffic["indel_rate"], traffic["indel_mean"], comp, layout)
        sym = config["symtype"]
        self.ctx = api.SSAContext(device)
        self.ctx.init_symbol_translation(enum(SymType, sym))
        sc = config["scoring"]
        if "matrix" in sc:
            self.ctx.init_score_matrix(sc["matrix"])
        else:
            self.ctx.init_constant_scoring(sc["match"], sc["mismatch"])
        self.ctx.init_gap_penalties(config["gap_open"], config["gap_extend"],
                                    config["first_residue_opens"])
        self.query = self.ctx.init_sequence_fasta(scoring.decode(self.q, sym))
        self.subject = scoring.decode(self.s, sym)
        self.align_type = enum(AlignType, traffic["align_type"])
        self.mode = enum(ComputeMode, traffic["mode"])
        self.local = traffic["align_type"] == "sw"
        self.answers: dict[int, tuple] = {}  # request -> (score, alignment key)
        self.alignments: dict[tuple, int] = {}  # distinct alignment -> its score
        self.stats: list = []

    def requests(self, call: int) -> list[int]:
        return [call]

    def _run(self):
        return self.ctx.align_pair(self.query, self.subject, self.align_type, self.mode)

    def warm(self) -> None:
        self._run()

    def call(self, i: int) -> dict:
        a = self._run()
        key = None
        if self.mode.name == "ALIGNMENT":
            key = (a.q_begin, a.q_end, a.s_begin, a.s_end, a.cigar)
            self.alignments[key] = a.score
        self.answers[i] = (a.score, key)
        self.stats.append(a.stats)
        return {"requests": 1, "pairs": 1, "cells": len(self.q) * len(self.s)}

    def release(self) -> None:
        self.ctx = None
        self.query = None

    def check(self, done: list[int], saturate: str | None = None) -> dict:
        """Compare every answered request with the plain reference.
        ``saturate`` puts the reference at that window in the program's
        place: the control."""
        cfg = self.config
        sub = scoring.substitution(cfg["scoring"])
        Q, R = scoring.gap_qr(cfg["gap_open"], cfg["gap_extend"], cfg["first_residue_opens"])
        ref = dp.pair_score(self.q, self.s, sub, Q, R, self.local, self.device)
        if saturate is None:
            scores = [self.answers[i][0] for i in done]
            alns = self.alignments
        else:
            ctl = dp.pair_score(self.q, self.s, sub, Q, R, self.local, self.device, saturate)
            scores, alns = [ctl] * len(done), {}
        values = {"score_gap": max(abs(int(s) - ref) for s in scores)}
        if self.mode.name == "ALIGNMENT":
            bad = 0
            for (qb, qe, sb, se, cigar), score in alns.items():
                r = alignment.rescore(self.q, self.s, sub, Q, R, qb, qe, sb, se, cigar,
                                      self.local)
                bad += r is None or r != score or r != ref
            values["alignment_errors"] = bad
        return numbers(values, self.traffic["limits"])
