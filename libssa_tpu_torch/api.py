"""Public API: the reference library's call sequence over the port's engine.

The same surface as ``libssa_tpu.api`` — imperative ``init_*``
configuration, then ``sw_align`` / ``nw_align`` / ``align_many`` returning
alignment lists — on a context object with an explicit ``device``, plus a
module-level default context for reference-style scripts:

    import libssa_tpu_torch.api as ssa
    ssa.init_device("cuda")                    # the default; "cpu" on request
    ssa.init_score_matrix("BLOSUM62")
    ssa.init_gap_penalties(10, 1)
    ssa.init_db_fasta("db.fas")
    q = ssa.init_sequence_fasta("query.fas")
    hits = ssa.sw_align(q, 10, BitWidth.EXACT, ComputeMode.ALIGNMENT)
    ssa.ssa_exit()

``device`` defaults to "cuda" and raises where CUDA is absent; "cpu" runs
only when it is asked for. SCORE-mode ``align_pair`` runs the long-pair
scorer (K3 on the card). ALIGNMENT mode traces a call's hits together
(``aligner.align_batch``): on the card, those of at most
``aligner.MATRIX_CELL_LIMIT`` cells in one launch of the hit kernel
(``ops/hit_cuda.py``); larger ones run the linear-space aligner, whose
large levels run on K2 on the card. ``set_device_count(n > 1)`` shards
the database over n devices (``parallel/sharded.py``): on a "cpu"
context, n shards on the CPU.

The enums are the port's own (``libssa_tpu_torch.constants``); a member of
the JAX package's enums raises ``TypeError``.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np

from . import alphabet, matrices, oracle
from .constants import (
    AlignType,
    BitWidth,
    ComputeMode,
    OutputMode,
    Strand,
    SymType,
)
from .io import fasta
from .io.db import SequenceDB
from .ops.topk import host_topk
from .search import aligner
from .search.manager import SearchEngine, SearchParams, SearchStats, resolve_device
from .util import logging as _logging
from .util.logging import log
from .util.profiling import span


class ScoreMismatchError(RuntimeError):
    """Traceback score disagreed with the search score.

    The search kernel and the NumPy traceback aligner are independent
    implementations; a disagreement means one of them is wrong for this
    input. A real exception, so ``python -O`` cannot silence it.
    """


def _check_scores_match(tb_score: int, search_score: int) -> None:
    if tb_score != search_score:
        raise ScoreMismatchError(
            f"traceback score {tb_score} != search score {search_score}"
        )


def _own(value, cls, name: str):
    """``value`` if it is a member of the port's ``cls``, else TypeError.

    The port's enums are its own classes: a member of the JAX package's
    ``AlignType`` is not ``AlignType.SW`` here, and would silently route a
    local alignment as a global one.
    """
    if not isinstance(value, cls):
        raise TypeError(
            f"{name}: expected libssa_tpu_torch.{cls.__name__}, got {value!r}"
        )
    return value


@dataclass
class Query:
    """A query ready for search: per-strand codes plus the raw encoding."""

    header: str
    symtype: SymType
    strands: Strand
    sequences: list[tuple[str, np.ndarray]]  # (strand label, codes)
    raw: np.ndarray | None = None

    @property
    def length(self) -> int:
        return max((len(s) for _, s in self.sequences), default=0)


@dataclass
class Alignment:
    """One hit. Score-only searches leave the traceback fields None."""

    seq_id: int
    header: str
    score: int
    align_type: AlignType
    strand: str = "+"  # query strand ("+"/"-") or reading frame ("+0".."-2")
    db_frame: str | None = None  # subject reading frame for translated DBs
    q_begin: int | None = None
    q_end: int | None = None
    s_begin: int | None = None
    s_end: int | None = None
    cigar: str | None = None
    aligned: tuple[str, str, str] | None = None  # query row, midline, subject row
    # Set by align_pair (no AlignmentList carries it there); database hits
    # carry stats on their AlignmentList instead.
    stats: "SearchStats | None" = None


@dataclass
class AlignmentList:
    hits: list[Alignment]
    stats: SearchStats

    def __iter__(self):
        return iter(self.hits)

    def __len__(self):
        return len(self.hits)

    def __getitem__(self, i):
        return self.hits[i]


def parse_sequence_arg(
    path_or_seq: str, header: str = "query", what: str = "query"
) -> tuple[str, str]:
    """Strictly resolve a file path / FASTA text / bare sequence argument.

    Returns ``(header, sequence_text)``. A filename-looking string that does
    not exist raises FileNotFoundError rather than aligning the path text.
    """
    if os.path.exists(path_or_seq):
        recs = list(fasta.iter_fasta(path_or_seq))
        if not recs:
            raise ValueError(f"{path_or_seq!r}: no FASTA records")
        return recs[0]
    if path_or_seq.lstrip().startswith(">") or "\n" in path_or_seq:
        recs = list(fasta.iter_fasta(path_or_seq))
        if not recs:
            raise ValueError(f"{what} FASTA text has no records")
        return recs[0]
    if "/" in path_or_seq or path_or_seq.lower().endswith(
        (".fa", ".fas", ".fasta", ".fna", ".faa", ".txt", ".gz")
    ):
        raise FileNotFoundError(f"{what} file {path_or_seq!r} does not exist")
    return header, path_or_seq  # bare sequence string


class SSAContext:
    """Mutable configuration + cached engine on one device."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.reset()

    def reset(self):
        self.symtype: SymType = SymType.AMINOACID
        self.db_symtype: SymType = SymType.AMINOACID
        self.strands: Strand = Strand.FORWARD
        self.q_gencode: int = 1
        self.d_gencode: int = 1
        self.matrix: matrices.ScoreMatrix | None = None
        self.gap_open: int = 0
        self.gap_extend: int = 1
        self.db: SequenceDB | None = None
        self.params = SearchParams()
        self.device_count: int | None = None
        self._engine: SearchEngine | None = None
        self._translated_db = None  # (SequenceDB, orig_ids, frame labels)

    # -- configuration (reference init_*/set_* calls) ---------------------

    def init_symbol_translation(
        self,
        symtype: SymType,
        strands: Strand = Strand.FORWARD,
        q_gencode: int = 1,
        d_gencode: int = 1,
        db_symtype: SymType | None = None,
    ):
        """Configure alphabets, strand search, and genetic codes.

        A NUCLEOTIDE input under an AMINOACID matrix is searched in its
        reading frames (query frames per ``strands``; a nucleotide database
        in all six).
        """
        self.symtype = _own(symtype, SymType, "symtype")
        self.db_symtype = (
            _own(db_symtype, SymType, "db_symtype") if db_symtype is not None
            else symtype
        )
        self.strands = Strand(strands)
        self.q_gencode = q_gencode
        self.d_gencode = d_gencode
        self._engine = None
        self._translated_db = None

    def init_score_matrix(self, name_or_path: str):
        try:
            self.matrix = matrices.builtin(name_or_path)
        except ValueError:
            self.matrix = matrices.from_file(name_or_path, self.symtype)
        self._engine = None

    def init_constant_scoring(self, match: int, mismatch: int):
        self.matrix = matrices.constant_scoring(match, mismatch, self.symtype)
        self._engine = None

    def init_gap_penalties(
        self, gap_open: int, gap_extend: int, first_residue_opens: bool = True
    ):
        """Set affine gap penalties (``first_residue_opens``: Q = open+extend)."""
        oracle.gap_qr(gap_open, gap_extend, first_residue_opens)  # validates
        self.gap_open, self.gap_extend = gap_open, gap_extend
        self.params.first_residue_opens = first_residue_opens
        self._engine = None

    def init_db_fasta(self, path_or_text: str):
        self.db = SequenceDB.from_fasta(path_or_text, self.db_symtype)
        self._engine = None
        self._translated_db = None

    def init_sequence_fasta(self, path_or_seq: str, header: str = "query") -> Query:
        """Read a query from FASTA (file or text) or a bare sequence string."""
        header, seq = parse_sequence_arg(path_or_seq, header, what="query")
        codes = alphabet.encode(seq, self.symtype)
        seqs = [("+", codes)]
        if self.symtype is SymType.NUCLEOTIDE:
            if self.strands == Strand.REVERSE:
                seqs = [("-", alphabet.reverse_complement(codes))]
            elif self.strands == Strand.BOTH:
                seqs = [("+", codes), ("-", alphabet.reverse_complement(codes))]
        return Query(
            header=header,
            symtype=self.symtype,
            strands=self.strands,
            sequences=seqs,
            raw=codes,
        )

    def init_sequences_fasta(self, path_or_text: str) -> list[Query]:
        """Read EVERY record of a query FASTA (multi-query sweeps)."""
        out = []
        for header, seq in fasta.iter_fasta(path_or_text):
            q = self.init_sequence_fasta(seq, header=header)
            q.header = header
            out.append(q)
        if not out:
            raise ValueError("no FASTA records found")
        return out

    def set_chunk_size(self, n: int):
        self.params.batch_size = int(n)
        self._engine = None

    def set_device_count(self, n: int | None):
        """Run searches over ``n`` database shards (``ShardedSearchEngine``).

        ``None`` or 1: the single-device engine (the default). Otherwise the
        DB shards over the first ``n`` devices (``0``/negative: all of them),
        the shards' top-k lists merge with one ``all_gather``, and the hits
        equal the single-device engine's. The devices are the visible cards,
        one a rank in a ``torch.distributed`` job; on a "cpu" context the
        shards go on the CPU, which counts as one device a core. More than
        are visible raises ``RuntimeError`` at the next search.
        """
        self.device_count = None if n in (None, 1) else int(n)
        self._engine = None

    def set_thread_count(self, n: int):
        """Reference parity no-op: parallelism is the device's."""
        log(OutputMode.INFO, f"set_thread_count({n}): no-op on this backend")

    def set_output_mode(self, mode: OutputMode):
        _logging.set_output_mode(mode)

    # -- search -----------------------------------------------------------

    def _search_db(self):
        """(SequenceDB in the matrix alphabet, orig_ids, frame_labels).

        A nucleotide DB searched under a protein matrix is expanded once
        into all six reading frames; orig_ids maps each frame entry back to
        its source record.
        """
        if self.db_symtype is self.matrix.symtype:
            return self.db, None, None
        if not (
            self.db_symtype is SymType.NUCLEOTIDE
            and self.matrix.symtype is SymType.AMINOACID
        ):
            raise RuntimeError(
                f"cannot search a {self.db_symtype.value} database with a "
                f"{self.matrix.symtype.value} matrix"
            )
        if self._translated_db is None:
            self._translated_db = self.db.translated(self.d_gencode)
        return self._translated_db

    def _search_sequences(
        self, query: Query, stats: SearchStats = None
    ) -> list[tuple[str, np.ndarray]]:
        """Query sequences in the matrix alphabet (frames if translated; the
        translation in a ``translate`` span of ``stats``)."""
        mt = self.matrix.symtype
        if query.symtype is mt:
            return query.sequences
        if not (query.symtype is SymType.NUCLEOTIDE and mt is SymType.AMINOACID):
            raise RuntimeError(
                f"cannot search a {query.symtype.value} query with a "
                f"{mt.value} matrix"
            )
        raw = query.raw if query.raw is not None else query.sequences[0][1]
        out = []
        with span(stats, "translate") as rec:
            if self.strands & Strand.FORWARD:
                for f in range(3):
                    aa = alphabet.translate(raw[f:], self.q_gencode)
                    if len(aa):
                        out.append((f"+{f}", aa))
            if self.strands & Strand.REVERSE:
                rc = alphabet.reverse_complement(raw)
                for f in range(3):
                    aa = alphabet.translate(rc[f:], self.q_gencode)
                    if len(aa):
                        out.append((f"-{f}", aa))
            if rec is not None:
                rec.counts["frames"] = len(out)
        if not out:
            raise ValueError("query too short to translate (needs >= 3 bases)")
        return out

    def _get_engine(self) -> SearchEngine:
        if self.db is None:
            raise RuntimeError("init_db_fasta() must be called before searching")
        if self.matrix is None:
            raise RuntimeError("init_score_matrix() must be called before searching")
        if self._engine is None:
            search_db, _, _ = self._search_db()
            if self.device_count is not None:
                self._engine = self._sharded_engine(search_db)
            else:
                self._engine = SearchEngine(
                    search_db, self.matrix, self.gap_open, self.gap_extend,
                    self.params, device=self.device,
                )
        return self._engine

    def _sharded_engine(self, search_db):
        """The ``ShardedSearchEngine`` that ``set_device_count`` asked for."""
        import torch.distributed as dist

        from .parallel.sharded import ShardedSearchEngine, local_devices, make_db_mesh

        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        local = local_devices(self.device)
        avail = world * len(local)
        n = self.device_count if self.device_count > 0 else avail
        if n > avail:
            raise RuntimeError(f"set_device_count({n}): only {avail} devices visible")
        if n % world:
            raise RuntimeError(
                f"set_device_count({n}): {world} ranks must own equal shares of the shards"
            )
        return ShardedSearchEngine(
            search_db, self.matrix, self.gap_open, self.gap_extend,
            make_db_mesh(devices=local[: n // world]), self.params,
        )

    def _fill_tracebacks(self, todo, local: bool, stats: SearchStats = None) -> None:
        """Traceback + decoration of hits (ALIGNMENT mode): ``todo`` holds
        (hit, query codes, subject codes), aligned together by
        ``aligner.align_batch`` (on the card, one launch of the hit kernel).

        Cross-checks each traceback score against its search score
        (ScoreMismatchError on disagreement).
        """
        if not todo:
            return
        t0 = time.perf_counter()
        tbs = aligner.align_batch(
            [(qc, sc) for _, qc, sc in todo], self.matrix.scores, self.gap_open,
            self.gap_extend, local, self.params.first_residue_opens, stats=stats,
            device=self.device,
        )
        if stats is not None:
            stats.aligner_seconds += time.perf_counter() - t0
            stats.aligner_cells += sum(len(qc) * len(sc) for _, qc, sc in todo)
        for (hit, qc, sc), tb in zip(todo, tbs):
            _check_scores_match(tb.score, hit.score)
            hit.q_begin, hit.q_end = tb.q_begin, tb.q_end
            hit.s_begin, hit.s_end = tb.s_begin, tb.s_end
            hit.cigar = tb.cigar
            hit.aligned = self._display(tb, qc, sc, stats)

    def _display(self, tb, qc, sc, stats) -> tuple[str, str, str]:
        """The display rows of one alignment, in a ``display`` span."""
        with span(stats, "display", columns=len(tb.cigar)):
            return tb.aligned_strings(
                qc, sc, lambda c: alphabet.decode(c, self.matrix.symtype)
            )

    def _align(
        self,
        query: Query,
        k: int,
        bit_width: BitWidth,
        mode: ComputeMode,
        align_type: AlignType,
    ) -> AlignmentList:
        _own(mode, ComputeMode, "mode")
        if k < 0:
            raise ValueError(f"hit count k must be >= 0, got {k}")
        engine = self._get_engine()
        local = align_type is AlignType.SW
        stats = SearchStats()
        with span(stats, "api.align"):
            return self._align_hits(
                query, k, bit_width, mode, align_type, engine, local, stats
            )

    def _align_hits(
        self, query, k, bit_width, mode, align_type, engine, local, stats
    ) -> AlignmentList:
        """``_align`` past its checks, in its request's root span."""
        search_db, orig_ids, frame_labels = self._search_db()
        # An entry's score is its best over the query's strands/frames
        # (first listed wins ties).
        q_seqs = self._search_sequences(query, stats)

        if len(q_seqs) == 1 and orig_ids is None:
            # Plain single-sequence search: the engine's device-side top-k.
            label, codes = q_seqs[0]
            top_scores, top_ids = engine.search(codes, k, local, bit_width, stats)
            hits, todo = [], []
            for score, rid in zip(top_scores, top_ids):
                rid = int(rid)
                hit = Alignment(
                    seq_id=rid,
                    header=self.db.headers[rid],
                    score=int(score),
                    align_type=align_type,
                    strand=label,
                )
                if mode is ComputeMode.ALIGNMENT:
                    todo.append((hit, codes, search_db.sequence(rid)))
                hits.append(hit)
            self._fill_tracebacks(todo, local, stats)
            return AlignmentList(hits=hits, stats=stats)

        # Frame-fanout searches (multi-strand/frame queries, translated DBs)
        # reduce on the device: best frame per entry, best entry per record,
        # ranking. None means a lane left the f32 window: the exact
        # full-matrix host path below takes over.
        reduced = engine.search_reduced(
            [c for _, c in q_seqs], orig_ids, k, local, stats, bit_width
        )
        if reduced is not None:
            top_s, top_r, top_e, top_f = reduced
            hits, todo = [], []
            for score, rid, entry, fidx in zip(top_s, top_r, top_e, top_f):
                rid, entry, fidx = int(rid), int(entry), int(fidx)
                label, qc = q_seqs[fidx]
                hit = Alignment(
                    seq_id=rid,
                    header=self.db.headers[rid],
                    score=int(score),
                    align_type=align_type,
                    strand=label,
                    db_frame=(
                        frame_labels[entry] if frame_labels is not None else None
                    ),
                )
                if mode is ComputeMode.ALIGNMENT:
                    todo.append((hit, qc, search_db.sequence(entry)))
                hits.append(hit)
            self._fill_tracebacks(todo, local, stats)
            return AlignmentList(hits=hits, stats=stats)

        best_scores = None
        best_label = None
        if len(q_seqs) > 1:
            mat = engine.score_all_many([c for _, c in q_seqs], local, stats)
            for (label, _), scores in zip(q_seqs, mat):
                if best_scores is None:
                    best_scores = scores.copy()
                    best_label = np.full(len(scores), label)
                else:
                    better = scores > best_scores
                    best_scores = np.where(better, scores, best_scores)
                    best_label = np.where(better, label, best_label)
        else:
            label, codes = q_seqs[0]
            best_scores = engine.score_all(codes, local, bit_width, stats)
            best_label = np.full(len(best_scores), label)

        # Translated DB: reduce frame entries to their source record,
        # keeping the best-scoring frame (lowest entry id on ties).
        entry_of_record = None
        if orig_ids is not None:
            n_rec = len(self.db)
            order = np.lexsort((np.arange(len(best_scores)), -best_scores))
            rec_best = np.full(n_rec, np.iinfo(np.int64).min, dtype=np.int64)
            entry_of_record = np.zeros(n_rec, dtype=np.int64)
            seen = np.zeros(n_rec, dtype=bool)
            for e in order:
                r = orig_ids[e]
                if not seen[r]:
                    seen[r] = True
                    rec_best[r] = best_scores[e]
                    entry_of_record[r] = e
            best_scores = rec_best

        # Records with no scored entry keep the int64.min sentinel: drop them.
        real = best_scores > np.iinfo(np.int64).min
        top_scores, top_ids = host_topk(
            best_scores[real], np.nonzero(real)[0], k
        )

        hits, todo = [], []
        label_codes = dict(q_seqs)
        for score, rid in zip(top_scores, top_ids):
            rid = int(rid)
            entry = int(entry_of_record[rid]) if entry_of_record is not None else rid
            hit = Alignment(
                seq_id=rid,
                header=self.db.headers[rid],
                score=int(score),
                align_type=align_type,
                strand=str(best_label[entry]),
                db_frame=frame_labels[entry] if frame_labels is not None else None,
            )
            if mode is ComputeMode.ALIGNMENT:
                todo.append(
                    (hit, label_codes[hit.strand], search_db.sequence(entry))
                )
            hits.append(hit)
        self._fill_tracebacks(todo, local, stats)
        return AlignmentList(hits=hits, stats=stats)

    def align_pair(
        self,
        query: Query,
        subject: str,
        align_type: AlignType = AlignType.NW,
        mode: ComputeMode = ComputeMode.ALIGNMENT,
    ) -> Alignment:
        """Align one query against one subject (no database): score + traceback.

        ``mode=ComputeMode.SCORE`` skips the traceback and scores each
        strand or frame with the long-pair scorer (``ops.longpair``: K3 on
        the card, any pair size, O(m + n) device memory); for genome-scale
        pairs this is the path to use. ``params.kernel`` "plain" pins the
        plain PyTorch version. ALIGNMENT mode aligns every strand or frame
        in one ``aligner.align_batch``: on the card one launch of the hit
        kernel; above ``aligner.MATRIX_CELL_LIMIT`` cells the linear-space
        Myers-Miller aligner (``search/hirschberg.py``), whose large levels
        run on K2 on the card.
        """
        _own(align_type, AlignType, "align_type")
        _own(mode, ComputeMode, "mode")
        if self.matrix is None:
            raise RuntimeError("init_score_matrix() must be called first")
        local = align_type is AlignType.SW
        stats = SearchStats()
        with span(stats, "api.align_pair"):
            sc = alphabet.encode(subject, self.matrix.symtype)
            q_seqs = self._search_sequences(query, stats)
            if mode is ComputeMode.SCORE:
                from .ops.longpair import longpair_score

                t0 = time.perf_counter()
                best_s = None
                for label, qc in q_seqs:
                    s = longpair_score(
                        qc, sc, self.matrix.padded(), self.gap_open,
                        self.gap_extend, local=local,
                        first_residue_opens=self.params.first_residue_opens,
                        kernel=self.params.kernel, device=self.device,
                        stats=stats,
                    )
                    stats.cells += len(qc) * len(sc)
                    stats.dispatches += 1
                    stats.fetches += 1
                    if best_s is None or s > best_s[1]:
                        best_s = (label, s)
                stats.seconds += time.perf_counter() - t0
                label, score = best_s
                return Alignment(
                    seq_id=-1,
                    header="subject",
                    score=int(score),
                    align_type=align_type,
                    strand=label,
                    stats=stats,
                )
            t0 = time.perf_counter()
            tbs = aligner.align_batch(
                [(qc, sc) for _, qc in q_seqs], self.matrix.scores, self.gap_open,
                self.gap_extend, local, self.params.first_residue_opens,
                stats=stats, device=self.device,
            )
            best = None
            for (label, qc), tb in zip(q_seqs, tbs):
                stats.aligner_cells += len(qc) * len(sc)
                if best is None or tb.score > best[1].score:
                    best = (label, tb, qc)
            stats.aligner_seconds += time.perf_counter() - t0
            label, tb, qc = best
            return Alignment(
                seq_id=-1,
                header="subject",
                score=tb.score,
                align_type=align_type,
                strand=label,
                q_begin=tb.q_begin,
                q_end=tb.q_end,
                s_begin=tb.s_begin,
                s_end=tb.s_end,
                cigar=tb.cigar,
                aligned=self._display(tb, qc, sc, stats),
                stats=stats,
            )

    def align_many(
        self,
        queries: list[Query],
        k: int = 10,
        mode: ComputeMode = ComputeMode.SCORE,
        align_type: AlignType = AlignType.SW,
        bit_width: BitWidth = BitWidth.EXACT,
    ) -> list[AlignmentList]:
        """Batched multi-query search: one device sweep for all queries.

        Plain (untranslated, single-strand) searches ride the engine's
        multi-query sweep; anything needing per-query strand/frame fan-out
        runs per-query ``_align`` calls. Every returned list of the batched
        sweep shares one batch-level ``SearchStats``.
        """
        _own(mode, ComputeMode, "mode")
        _own(align_type, AlignType, "align_type")
        engine = self._get_engine()
        local = align_type is AlignType.SW
        simple = self.db_symtype is self.matrix.symtype and all(
            q.symtype is self.matrix.symtype and len(q.sequences) == 1
            for q in queries
        )
        if not simple:
            return [
                self._align(q, k, bit_width, mode, align_type)
                for q in queries
            ]
        stats = SearchStats()
        with span(stats, "api.align_many"):
            hitlists = engine.search_many(
                [q.sequences[0][1] for q in queries], k, local, stats, bit_width
            )
            out, todo = [], []
            for q, (top_s, top_i) in zip(queries, hitlists):
                hits = []
                for score, sid in zip(top_s, top_i):
                    hit = Alignment(
                        seq_id=int(sid),
                        header=self.db.headers[int(sid)],
                        score=int(score),
                        align_type=align_type,
                        strand=q.sequences[0][0],
                    )
                    if mode is ComputeMode.ALIGNMENT:
                        todo.append(
                            (hit, q.sequences[0][1], self.db.sequence(int(sid)))
                        )
                    hits.append(hit)
                out.append(AlignmentList(hits=hits, stats=stats))
            self._fill_tracebacks(todo, local, stats)
            return out

    def sw_align(
        self,
        query: Query,
        k: int = 10,
        bit_width: BitWidth = BitWidth.EXACT,
        mode: ComputeMode = ComputeMode.SCORE,
    ) -> AlignmentList:
        return self._align(query, k, bit_width, mode, AlignType.SW)

    def nw_align(
        self,
        query: Query,
        k: int = 10,
        bit_width: BitWidth = BitWidth.EXACT,
        mode: ComputeMode = ComputeMode.SCORE,
    ) -> AlignmentList:
        return self._align(query, k, bit_width, mode, AlignType.NW)

    def free_alignment(self, alignment_list: AlignmentList) -> None:
        """Reference parity no-op: results are garbage-collected objects."""

    def ssa_exit(self):
        self.reset()


# -- module-level default context (reference-style global API) -------------

_default: SSAContext | None = None


def init_device(device) -> SSAContext:
    """Start the module-level context afresh on ``device``."""
    global _default
    _default = SSAContext(device)
    return _default


def default_context() -> SSAContext:
    """The module-level context, made on "cuda" at first use."""
    return _default if _default is not None else init_device("cuda")


def _forward(name: str):
    def call(*args, **kwargs):
        return getattr(default_context(), name)(*args, **kwargs)

    call.__name__ = call.__qualname__ = name
    call.__doc__ = getattr(SSAContext, name).__doc__
    return call


init_symbol_translation = _forward("init_symbol_translation")
init_score_matrix = _forward("init_score_matrix")
init_constant_scoring = _forward("init_constant_scoring")
init_gap_penalties = _forward("init_gap_penalties")
init_db_fasta = _forward("init_db_fasta")
init_sequence_fasta = _forward("init_sequence_fasta")
init_sequences_fasta = _forward("init_sequences_fasta")
align_many = _forward("align_many")
set_chunk_size = _forward("set_chunk_size")
set_device_count = _forward("set_device_count")
set_thread_count = _forward("set_thread_count")
set_output_mode = _forward("set_output_mode")
sw_align = _forward("sw_align")
nw_align = _forward("nw_align")
align_pair = _forward("align_pair")
free_alignment = _forward("free_alignment")
ssa_exit = _forward("ssa_exit")
