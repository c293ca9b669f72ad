"""The port's spans (``libssa_tpu_torch/util/profiling.py``) on the CPU.

Off (no profiler recording), a span records nothing. Under a profiler each
request records one root, every child lies inside its parent, and the
self times sum to the root's duration. ``trace()`` writes the spans into
the profiler's chrome trace on the profiler's own clock.
"""
import json
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from libssa_tpu_torch import alphabet, api
from libssa_tpu_torch.constants import AlignType, BitWidth, ComputeMode, SymType
from libssa_tpu_torch.io.db import SequenceDB
from libssa_tpu_torch.matrices import builtin
from libssa_tpu_torch.search import hirschberg, manager
from libssa_tpu_torch.search.manager import SearchEngine, SearchParams, SearchStats
from libssa_tpu_torch.util import profiling
from libssa_tpu_torch.util.profiling import Span, span

torch.set_num_threads(1)

LENGTHS = (20, 40, 70)  # three profile heights: 32, 64 and 96 rows


def _codes(rng, n):
    return rng.integers(0, 20, n).astype(np.uint8)


@pytest.fixture(scope="module")
def ctx():
    rng = np.random.default_rng(17)
    seqs = [_codes(rng, int(rng.integers(20, 90))) for _ in range(40)]
    c = api.SSAContext("cpu")
    c.init_score_matrix("BLOSUM62")
    c.init_gap_penalties(10, 1)
    c.db = SequenceDB.from_sequences([f"s{i}" for i in range(len(seqs))], seqs,
                                     SymType.AMINOACID)
    c.queries = [c.init_sequence_fasta(alphabet.decode(_codes(rng, n), SymType.AMINOACID))
                 for n in LENGTHS]
    c.subject = alphabet.decode(_codes(rng, 60), SymType.AMINOACID)
    return c


REQUESTS = {  # request -> its SearchStats
    "sw_align": lambda c: c.sw_align(c.queries[1], 3, mode=ComputeMode.ALIGNMENT).stats,
    "align_many": lambda c: c.align_many(c.queries, 3, mode=ComputeMode.ALIGNMENT)[0].stats,
    "align_pair_score": lambda c: c.align_pair(c.queries[2], c.subject, AlignType.SW,
                                               ComputeMode.SCORE).stats,
    "align_pair_alignment": lambda c: c.align_pair(c.queries[2], c.subject, AlignType.NW,
                                                   ComputeMode.ALIGNMENT).stats,
}
ROOTS = {"sw_align": "api.align", "align_many": "api.align_many",
         "align_pair_score": "api.align_pair", "align_pair_alignment": "api.align_pair"}


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


@pytest.mark.parametrize("request_name", sorted(REQUESTS))
def test_no_spans_without_a_profiler(ctx, request_name):
    assert REQUESTS[request_name](ctx).spans == []


@pytest.mark.parametrize("request_name", sorted(REQUESTS))
def test_one_root_children_inside_and_self_times_sum(ctx, request_name):
    spans = _traced(lambda: REQUESTS[request_name](ctx)).spans
    roots = [s for s in spans if s.parent is None]
    assert len(roots) == 1 and spans[0] is roots[0] and roots[0].name == ROOTS[request_name]
    for s in spans:
        assert s.end_ns >= s.start_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    covered = [0] * len(spans)
    for s in spans:
        if s.parent is not None:
            covered[s.parent] += s.end_ns - s.start_ns
    assert all(s.end_ns - s.start_ns >= c for s, c in zip(spans, covered))
    assert profiling.self_seconds(spans, {s.name for s in spans}) == pytest.approx(
        (roots[0].end_ns - roots[0].start_ns) / 1e9, abs=1e-9)


def test_align_many_sweeps_once_a_profile_height(ctx):
    spans = _traced(lambda: REQUESTS["align_many"](ctx)).spans
    groups = [s for s in spans if s.name == "search.group"]
    assert [(g.counts["queries"], g.counts["rows"]) for g in groups] == [(1, 32), (1, 64),
                                                                         (1, 96)]
    many = [i for i, s in enumerate(spans) if s.name == "search.many"]
    assert len(many) == 1 and all(g.parent == many[0] for g in groups)
    # each stack group's index upload and the fetch, in each sweep
    stacks = len(ctx.db.grouped_stacks(ctx.params.batch_size, ctx.params.length_multiple))
    waits = [s for s in spans if s.name == "device.wait"]
    assert len(waits) == 3 * (stacks + 1)
    assert all(spans[w.parent].name == "search.group" for w in waits)
    assert profiling.count(spans, "display") == 3 * 3  # k hits of each query
    assert [s.counts["columns"] > 0 for s in spans if s.name == "display"] == [True] * 9


def test_align_many_traces_every_hit_in_one_batch(ctx):
    """ALIGNMENT mode: the call's hits in one traceback.batch span under the
    request's root, with their count and cells; on the CPU none on the card."""
    lists = _traced(lambda: ctx.align_many(ctx.queries, 3, mode=ComputeMode.ALIGNMENT))
    spans = lists[0].stats.spans
    (batch,) = [s for s in spans if s.name == "traceback.batch"]
    assert batch.parent == 0 and batch.counts["hits"] == 9 and batch.counts["device"] == 0
    assert batch.counts["cells"] == sum(
        len(q.sequences[0][1]) * len(ctx.db.sequence(h.seq_id))
        for q, hl in zip(ctx.queries, lists) for h in hl)
    assert profiling.count(spans, "traceback.fill") == 0


@pytest.mark.parametrize("on_device", [False, True])
def test_linear_aligner_records_its_levels(monkeypatch, on_device):
    """Myers-Miller's divide levels, on host passes or (K2's plain version on
    the CPU) on the device path, each one span with its counts; each pass's
    leaves one mm.leaves span, whose fetch waits on the device path."""
    monkeypatch.setattr(hirschberg, "LEAF_CELLS", 4096)
    if on_device:
        monkeypatch.setattr(hirschberg, "DEVICE_ON_CPU", True)
        monkeypatch.setattr(hirschberg, "DEVICE_MIN_CELLS", 1024)
    rng = np.random.default_rng(5)
    q, s = _codes(rng, 300), _codes(rng, 280)
    stats = SearchStats()
    tb = _traced(lambda: hirschberg.align_pair_linear(
        q, s, builtin("BLOSUM62").scores, 10, 1, local=False, stats=stats, device="cpu"))
    spans = stats.spans
    assert spans[0].name == "mm.align" and spans[0].parent is None
    levels = [x for x in spans if x.name == "mm.level"]
    assert len(levels) >= 2 and all(x.parent == 0 for x in levels)
    assert levels[0].counts == {"nodes": 1, "cells": 300 * 280, "device": on_device,
                                "staged": 0}
    assert all(x.counts["device"] == on_device for x in levels)
    assert all(x.counts["staged"] == 0 for x in levels)  # the level kernels run on a card
    waits = [x for x in spans if x.name == "device.wait"]
    assert bool(waits) == on_device
    assert all(spans[w.parent].name in ("mm.level", "mm.leaves") for w in waits)
    leaves = [x for x in spans if x.name == "mm.leaves"]
    assert leaves and all(x.parent == 0 for x in leaves)
    assert sum(spans[w.parent].name == "mm.leaves" for w in waits) == (
        len(leaves) if on_device else 0)
    assert stats.aligner_levels == (len(levels) if on_device else 0)
    assert tb.score == hirschberg.align_pair_linear(
        q, s, builtin("BLOSUM62").scores, 10, 1, local=False, device="cpu").score


def test_merge_puts_a_nested_request_under_the_open_span():
    outer, inner = SearchStats(), SearchStats()
    with profile(activities=[ProfilerActivity.CPU]):
        with span(outer, "search.many"):
            with span(outer, "search.group"):
                with span(inner, "device.wait"):
                    pass
                with span(inner, "search.many"):
                    with span(inner, "device.wait"):
                        pass
                outer.merge(inner)
    names = [(s.name, s.parent) for s in outer.spans]
    assert names == [("search.many", None), ("search.group", 0), ("device.wait", 1),
                     ("search.many", 1), ("device.wait", 3)]
    assert [s.start_ns for s in outer.spans[2:]] == [s.start_ns for s in inner.spans]


def test_rescue_engines_spans_sit_under_the_outer_request(monkeypatch):
    """A tiny f32 window: the sweep falls back to the full-matrix path,
    whose rescue engines' spans are merged under the outer sweep's group."""
    monkeypatch.setattr(manager, "F32_WINDOW", 90)
    rng = np.random.default_rng(3)
    seqs = [_codes(rng, int(rng.integers(70, 90))) for _ in range(12)]
    seqs += [s.copy() for s in seqs[:4]]
    db = SequenceDB.from_sequences([f"s{i}" for i in range(len(seqs))], seqs,
                                   SymType.AMINOACID)
    eng = SearchEngine(db, builtin("BLOSUM62"), 10, 1, SearchParams(batch_size=8),
                       device="cpu")
    stats = SearchStats()
    hits = _traced(lambda: eng.search(seqs[2], 4, True, BitWidth.EXACT, stats))
    assert 2 in hits[1]
    spans = stats.spans
    assert [s.parent for s in spans].count(None) == 1 and spans[0].name == "search.many"
    group = next(i for i, s in enumerate(spans) if s.name == "search.group")
    under = [s for s in spans if s.parent == group]
    # the sweep's fetch, the full-matrix sweep's fetch and each rescue's
    assert len(under) >= 3 and {s.name for s in under} == {"device.wait"}
    assert stats.dispatches > 2


def test_ladder_search_waits_for_its_fetch():
    """A single-query BIT8 search: one sweep, and its one fetch in a
    ``device.wait`` span."""
    rng = np.random.default_rng(4)
    seqs = [_codes(rng, int(rng.integers(20, 90))) for _ in range(30)]
    db = SequenceDB.from_sequences([f"s{i}" for i in range(len(seqs))], seqs,
                                   SymType.AMINOACID)
    eng = SearchEngine(db, builtin("BLOSUM62"), 10, 1, SearchParams(batch_size=8),
                       device="cpu")
    stats = SearchStats()
    hits = _traced(lambda: eng.search(seqs[5], 4, True, BitWidth.BIT8, stats))
    assert hits[1][0] == 5
    assert [s.name for s in stats.spans] == ["device.wait"]
    assert (stats.dispatches, stats.fetches) == (1, 1)


def test_trace_writes_spans_on_the_profilers_clock(ctx, tmp_path):
    with profiling.trace(str(tmp_path)):
        ctx.align_many(ctx.queries, 3, mode=ComputeMode.ALIGNMENT)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "ssa_span"]
    assert {e["name"] for e in spans} >= {"api.align_many", "search.many", "search.group",
                                           "device.wait", "traceback.batch", "display"}
    assert all(e["ph"] == "X" for e in spans)
    aten = [e for e in events if e.get("name", "").startswith("aten::") and "dur" in e]
    groups = [e for e in spans if e["name"] == "search.group"]
    assert len(groups) == 3
    for g in groups:
        inside = [e for e in aten if g["ts"] <= e["ts"] and e["ts"] + e["dur"] <= g["ts"] + g["dur"]]
        assert inside and all((e["pid"], e["tid"]) == (g["pid"], g["tid"]) for e in inside)
    # requests made outside a trace() block are not kept for a later one
    assert profiling._collecting == []


def test_cli_pair_xprof_writes_the_display_span(tmp_path, capsys):
    from libssa_tpu_torch import cli

    assert cli.main(["pair", "--query", "MKVLAAGWKQTE", "--subject", "MKVIGAGWQQTE",
                     "--device", "cpu", "--xprof", str(tmp_path)]) == 0
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "ssa_span"]
    assert names == ["api.align_pair", "traceback.batch", "display"]
    assert "score=" in capsys.readouterr().out


def test_a_span_off_records_and_allocates_nothing():
    """Off, every span is one shared object, and no memory allocated in the
    tracer's module remains after many of them."""
    stats = SearchStats()
    assert span(stats, "display", columns=3) is span(stats, "search.group")
    assert span(None, "display") is span(stats, "display")

    def spans(n):
        for _ in range(n):
            with span(stats, "display"):
                pass

    spans(10)
    mine = [tracemalloc.Filter(True, profiling.__file__)]
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot().filter_traces(mine)
        spans(10_000)
        after = tracemalloc.take_snapshot().filter_traces(mine)
    finally:
        tracemalloc.stop()
    assert after.compare_to(before, "lineno") == [] or all(
        d.size_diff == 0 for d in after.compare_to(before, "lineno"))
    assert stats.spans == []


def test_self_time_count_and_total_by_hand():
    ms = 1_000_000
    spans = [Span("api.align_pair", None, 0, 10 * ms), Span("longpair.score", 0, 2 * ms, 9 * ms),
             Span("device.wait", 1, 3 * ms, 8 * ms), Span("display", 0, 9 * ms, 10 * ms)]
    assert profiling.self_seconds(spans, ("api.align_pair",)) == pytest.approx(2e-3)
    assert profiling.self_seconds(spans, ("longpair.score",)) == pytest.approx(2e-3)
    assert profiling.self_seconds(spans, ("api.align_pair", "longpair.score")) == pytest.approx(
        4e-3)
    assert profiling.count(spans, "display") == 1 and profiling.count(spans, "mm.level") == 0
    assert profiling.total_seconds(spans, "device.wait") == pytest.approx(5e-3)
    assert profiling.innermost_open(spans) is None
    spans.append(Span("traceback.fill", 0, 11 * ms))
    assert profiling.innermost_open(spans) == 4
