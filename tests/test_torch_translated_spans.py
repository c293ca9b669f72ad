"""The frame path's spans and the benchmark's readers of the
translated_search cell.

Under a ``torch.profiler`` profile a translated ``align_many`` on the CPU
records, a read, ``translate`` (``frames``) and ``search.reduced``
(``frames``, ``rows``) under the request's root, and a ``device.wait`` for
the sweep's one index upload and for the fetch inside ``search.reduced``;
with no profile recording it records nothing. Each new reader reads a
number from a run that has what it reads, and None from one that has not.

The last test needs a card (marked ``cuda``; it skips without one); the
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_translated_spans.py -q
"""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from libssa_tpu_torch import api
from libssa_tpu_torch.constants import AlignType, BitWidth, ComputeMode, Strand, SymType
from libssa_tpu_torch.io.db import SequenceDB
from libssa_tpu_torch.search import kernels, manager
from libssa_tpu_torch.search.manager import SearchStats
from libssa_tpu_torch.util import profiling
from libssa_tpu_torch.util.profiling import Span
from ssabench import harness, roofline, trace
from ssabench.tests import tiny_translated

torch.set_num_threads(1)

MS = 1_000_000
SEED = 2**31 + 4099
READERS = ("k1_roofline.translated", "device_idle.translated", "reduced_host_ms.translated",
           "reduce_ms.translated")


def read(name, run):
    return harness.load_reader("metrics", name)(run)


@pytest.fixture(scope="module")
def ctx():
    rng = np.random.default_rng(31)
    seqs = [rng.integers(0, 20, int(rng.integers(20, 200))).astype(np.uint8)
            for _ in range(50)]
    c = api.SSAContext("cpu")
    c.init_symbol_translation(SymType.NUCLEOTIDE, Strand.BOTH, q_gencode=1, d_gencode=1,
                              db_symtype=SymType.AMINOACID)
    c.init_score_matrix("BLOSUM62")
    c.init_gap_penalties(11, 1, first_residue_opens=True)
    c.set_chunk_size(16)  # several stack groups, so several index uploads
    c.db = SequenceDB.from_sequences([f"s{i}" for i in range(len(seqs))], seqs,
                                     SymType.AMINOACID)
    c.reads = [c.init_sequence_fasta("".join(rng.choice(list("ACGT"), n)))
               for n in (100, 200)]
    return c


def search(c):
    return c.align_many(c.reads, k=5, mode=ComputeMode.SCORE, align_type=AlignType.SW,
                        bit_width=BitWidth.BIT8)


def test_a_translated_search_records_the_frame_spans(ctx):
    with profile(activities=[ProfilerActivity.CPU]):
        lists = search(ctx)
    for read_, hl in zip(ctx.reads, lists):
        spans = hl.stats.spans
        assert spans[0].name == "api.align" and spans[0].parent is None
        by = {}
        for i, s in enumerate(spans):
            by.setdefault(s.name, []).append(i)
            if s.parent is not None:
                p = spans[s.parent]
                assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        (t,), (r,) = by["translate"], by["search.reduced"]
        assert spans[t].parent == 0 and spans[r].parent == 0
        assert spans[t].counts == {"frames": 6}
        m = len(read_.raw) // 3
        assert spans[r].counts == {"frames": 6, "rows": -(-m // 32) * 32, "local": 1, "wide": 0}
        # one upload of every stack group's indexes, and the fetch
        assert len(ctx._get_engine()._stacks_on_device(ctx.db, 16)[1]) > 2
        assert len(by["device.wait"]) == 2
        assert all(spans[w].parent == r for w in by["device.wait"])


def test_no_spans_without_a_profile(ctx):
    assert all(hl.stats.spans == [] for hl in search(ctx))


def test_the_spans_change_no_hit(ctx):
    plain = [[(h.seq_id, h.score, h.strand) for h in hl] for hl in search(ctx)]
    with profile(activities=[ProfilerActivity.CPU]):
        traced = [[(h.seq_id, h.score, h.strand) for h in hl] for hl in search(ctx)]
    assert traced == plain and all(plain)


def stats_of(*spans_lists):
    out = []
    for spans in spans_lists:
        st = SearchStats()
        st.spans = [Span(*s) for s in spans]
        out.append(st)
    return out


def hand_run(stats, work, summary=None, calls=None):
    return harness.Run({}, {}, {"align_type": "sw", "k": 10},
                       SimpleNamespace(stats=stats, residues=1000), 0.0,
                       calls=[(0.0, 1.0, dict(work)) for _ in range(calls or len(stats))],
                       summary=summary)


def one_read():
    """A read: 20 ms in all, 1 ms translating, 17 ms in search.reduced of
    which 6 ms wait on the device."""
    return [("api.align", None, 0, 20 * MS), ("translate", 0, 1 * MS, 2 * MS, {"frames": 6}),
            ("search.reduced", 0, 2 * MS, 19 * MS, {"frames": 6, "rows": 96}),
            ("device.wait", 2, 5 * MS, 9 * MS), ("device.wait", 2, 10 * MS, 12 * MS)]


def test_host_reader_by_hand():
    run = hand_run(stats_of(one_read(), one_read()), {"queries": 1, "requests": 1})
    assert read("reduced_host_ms.translated", run) == pytest.approx(1 + 17 - 6)


def test_device_readers_by_hand():
    work = {"queries": 32, "requests": 32, "query_residues": 15000, "cells": 15000 * 1000}
    k1 = "void k1::k1_pipe<int, true, true>(k1::Args)"
    summary = trace.Summary(window_s=10.0, busy_s=8.0,
                            kernel_s={k1: 6.0, "Memcpy HtoD (Pageable -> Device)": 0.5,
                                      "void at::native::radixSort": 1.5})
    run = hand_run([], work, summary, calls=2)
    assert read("device_idle.translated", run) == pytest.approx(20.0)
    assert read("reduce_ms.translated", run) == pytest.approx(1e3 * 2.0 / 64)
    least = 2 * roofline.least_seconds(work["cells"], "sw", roofline.search_bytes(
        1000, work["query_residues"], 32, 10))
    assert read("k1_roofline.translated", run) == pytest.approx(100 * least / 6.0)
    # no K1, or no device work at all: nothing to read
    no_k1 = trace.Summary(window_s=10.0, busy_s=2.0, kernel_s={"Memcpy HtoD": 2.0})
    idle = trace.Summary(window_s=10.0, busy_s=0.0)
    for s in (no_k1, idle, None):
        assert read("reduce_ms.translated", hand_run([], work, s, calls=2)) is None
    assert read("k1_roofline.translated", hand_run([], work, idle, calls=2)) is None
    assert read("device_idle.translated", hand_run([], work, idle, calls=2)) is None


def test_host_reader_reads_nothing_where_nothing_was_recorded():
    assert read("reduced_host_ms.translated", hand_run(stats_of([], []), {"queries": 1})) is None
    old = hand_run([SimpleNamespace(seconds=1.0)], {"queries": 1})  # SearchStats without spans
    assert read("reduced_host_ms.translated", old) is None
    # a program with its request roots but without the frame path's spans
    roots = [s for s in one_read() if s[0] == "api.align"]
    assert read("reduced_host_ms.translated", hand_run(stats_of(roots), {"queries": 1})) is None
    assert read("reduced_host_ms.translated", hand_run([], {})) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_translated.make_root(tmp_path_factory.mktemp("tiny_frames"), entries=40,
                                     mean_length=100, read_lengths=(120, 90, 119),
                                     pool_calls=1, per_call=4)


def cell(root, trace_, device="cpu"):
    return harness.run_cell(root, tiny_translated.CELL, SEED, 0.2, trace_, device,
                            time.perf_counter())


def test_traced_tiny_cell_reads_the_host_span(root):
    r = cell(root, True)
    assert r["correct"], r["checks"]
    assert r["metrics"]["reduced_host_ms.translated"]["value"] > 0
    # no device here: its readers find nothing and stay silent
    assert set(r["metrics"]) == {"reduced_host_ms.translated"}


def test_tiny_cell_without_the_frame_spans_reads_none(root, monkeypatch):
    """A port without ``translate`` and ``search.reduced`` spans, as before
    they were added: the cell runs correct and the reader says nothing."""
    def without(stats, name, **counts):
        if name in ("translate", "search.reduced"):
            return profiling.span(None, name)
        return profiling.span(stats, name, **counts)
    monkeypatch.setattr(api, "span", without)
    monkeypatch.setattr(manager, "span", without)
    monkeypatch.setattr(kernels, "span", without)
    r = cell(root, True)
    assert r["correct"] and "reduced_host_ms.translated" not in r["metrics"]


@pytest.mark.cuda
def test_translated_search_on_the_card_against_the_reference(tmp_path):
    """2,000 entries of Swiss-Prot's length spread, reads of 150-250 bases:
    the port's hits and frames equal the reference's, and the traced run
    reads every new metric, each share within 0-100%."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 has no CPU mode)")
    root = tiny_translated.make_root(tmp_path, entries=2000, mean_length=361,
                                     read_lengths=(250, 150, 249), pool_calls=2, per_call=8)
    r = cell(root, True, "cuda")
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert r["device"]["platform"] == "gpu"
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(got) == set(READERS), got
    assert 0 < got["k1_roofline.translated"] <= 100
    assert 0 <= got["device_idle.translated"] < 100
    assert got["reduce_ms.translated"] > 0 and got["reduced_host_ms.translated"] > 0
