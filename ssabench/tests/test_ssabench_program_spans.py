"""The readers of the port's own spans: by hand, on a program without spans,
on the tiny cells' traced CPU runs, and ``sweeps.search`` against the
profile heights that the traffic file fixes."""
import json
import time
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from libssa_tpu_torch.search.manager import SearchStats
from libssa_tpu_torch.util.profiling import Span
from ssabench import gen, harness
from ssabench.mixes import db_search
from ssabench.tests import tiny

SEED = 2**31 + 977
MS = 1_000_000
READERS = ("sweeps.search", "search_host_ms.search", "display_ms.query", "display_ms.align",
           "mm_host_ms.align", "longpair_host_ms.pair_score", "api_host_ms.pair_score")
CELL_OF = {"sweeps.search": "tiny_batch", "search_host_ms.search": "tiny_batch",
           "display_ms.query": "tiny_single", "display_ms.align": "tiny_align",
           "mm_host_ms.align": "tiny_align", "longpair_host_ms.pair_score": "tiny_score",
           "api_host_ms.pair_score": "tiny_score"}


def read(name, run):
    return harness.load_reader("metrics", name)(run)


def expected_sweeps(config: dict, traffic: dict, calls: int) -> float:
    """Mean distinct profile heights (32-row multiples) of the first
    ``calls`` calls, from the configuration's lengths and the traffic
    file's fixed choice of query entries (a query is as long as its entry)."""
    d = config["database"]
    n = d["entries"]
    canon = gen.lognormal_lengths(gen.rng(d["length_seed"]), n, d["mean_length"],
                                  d["length_sigma"], d["min_length"], d["max_length"])
    per, pool = traffic["queries_per_call"], traffic["pool_calls"]
    sources = gen.rng(traffic["queries"]["source_seed"]).choice(n, (pool + 1) * per,
                                                                replace=False)
    lengths = canon[sources]
    heights = [len({-(-int(x) // 32) for x in lengths[c * per:(c + 1) * per]})
               for c in range(pool)]
    return sum(heights[i % pool] for i in range(calls)) / calls


def stats_of(*spans_lists):
    out = []
    for spans in spans_lists:
        st = SearchStats()
        st.spans = [Span(*s) for s in spans]
        out.append(st)
    return out


def hand_run(stats, work):
    return harness.Run({}, {}, {}, SimpleNamespace(stats=stats), 0.0,
                       calls=[(0.0, 1.0, dict(work)) for _ in stats])


def search_call(groups):
    """One align_many call: ``groups`` height groups of 10 ms, each with a
    4 ms wait, under a 2 ms root and 1 ms of search.many's own."""
    spans = [("api.align_many", None, 0, (3 + 10 * groups) * MS),
             ("search.many", 0, 1 * MS, (2 + 10 * groups) * MS)]
    for g in range(groups):
        at = len(spans)
        spans += [("search.group", 1, (1 + 10 * g) * MS, (11 + 10 * g) * MS),
                  ("device.wait", at, (5 + 10 * g) * MS, (9 + 10 * g) * MS)]
    return spans


def test_search_readers_by_hand():
    run = hand_run(stats_of(search_call(3), search_call(1)), {"queries": 32, "requests": 32})
    assert read("sweeps.search", run) == 2.0
    # a call's host time: 1 ms of search.many's own and 6 ms a group
    assert read("search_host_ms.search", run) == pytest.approx(((1 + 18) + (1 + 6)) / 2)


def test_display_readers_by_hand():
    call = [("api.align", None, 0, 30 * MS), ("traceback.fill", 0, 1 * MS, 10 * MS),
            ("display", 0, 10 * MS, 13 * MS), ("display", 0, 20 * MS, 25 * MS)]
    run = hand_run(stats_of(call, call), {"queries": 1, "pairs": 1})
    assert read("display_ms.query", run) == pytest.approx(8.0)
    assert read("display_ms.align", run) == pytest.approx(8.0)


def test_pair_readers_by_hand():
    score = [("api.align_pair", None, 0, 40 * MS), ("longpair.score", 0, 1 * MS, 39 * MS),
             ("device.wait", 1, 2 * MS, 3 * MS), ("device.wait", 1, 5 * MS, 35 * MS)]
    run = hand_run(stats_of(score, score), {"pairs": 1})
    assert read("api_host_ms.pair_score", run) == pytest.approx(2.0)
    assert read("longpair_host_ms.pair_score", run) == pytest.approx(38 - 31)
    align = [("api.align_pair", None, 0, 300 * MS), ("traceback.fill", 0, 0, 200 * MS),
             ("mm.align", 1, 0, 200 * MS), ("device.wait", 2, 0, 1 * MS),
             ("mm.level", 2, 10 * MS, 20 * MS, {"nodes": 1, "cells": 9, "device": True}),
             ("device.wait", 4, 12 * MS, 19 * MS),
             ("mm.level", 2, 30 * MS, 40 * MS, {"nodes": 2, "cells": 9, "device": False}),
             ("display", 0, 200 * MS, 290 * MS)]
    run = hand_run(stats_of(align), {"pairs": 1})
    assert read("mm_host_ms.align", run) == pytest.approx(200 - 1 - 7)
    assert read("display_ms.align", run) == pytest.approx(90.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_where_nothing_was_recorded(name):
    empty = hand_run(stats_of([], []), {"queries": 1, "pairs": 1, "requests": 1})
    assert read(name, empty) is None
    # a program that keeps no spans (SearchStats without the field)
    old = hand_run([SimpleNamespace(seconds=1.0), SimpleNamespace(seconds=1.0)],
                   {"queries": 1, "pairs": 1, "requests": 1})
    assert read(name, old) is None
    assert read(name, hand_run([], {})) is None


@pytest.mark.parametrize("calls,expected", [(30, 16.43), (31, 16.29), (33, 16.21), (48, 15.96)])
def test_sprot_batch_sweeps_from_its_traffic_file(calls, expected):
    config = json.loads((tiny.REPO / "ssabench/configs/swissprot_blosum62.json").read_text())
    traffic = json.loads((tiny.REPO / "ssabench/traffic/sprot_batch.json").read_text())
    assert expected_sweeps(config, traffic, calls) == pytest.approx(expected, abs=0.005)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny_spans"))


def test_sweeps_equal_the_distinct_heights_of_the_calls(root):
    """The program's search.group spans, counted, equal what the traffic
    file fixes: one sweep a distinct profile height of each call."""
    config = json.loads((root / "ssabench/configs/tiny_swissprot_blosum62.json").read_text())
    traffic = json.loads((root / "ssabench/traffic/tiny_batch.json").read_text())
    mix = db_search.Mix(config, traffic, SEED, "cpu")
    mix.warm()
    run = harness.Run({}, config, traffic, mix, 0.0)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(3):
            run.calls.append((0.0, 1.0, mix.call(i)))
    assert read("sweeps.search", run) == expected_sweeps(config, traffic, 3)
    assert read("sweeps.search", run) > 1


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_traced_tiny_cells_report_the_span_metrics(root, cell):
    r = harness.run_cell(root, cell, SEED, 0.3, True, "cpu", time.perf_counter())
    assert r["correct"]
    got = {name for name in READERS if name in r["metrics"]}
    want = {name for name, c in CELL_OF.items() if c == cell}
    if cell == "tiny_align":  # its pair takes the full-matrix path: no Myers-Miller
        want.discard("mm_host_ms.align")
    assert got == want
    for name in got:
        assert r["metrics"][name]["value"] > 0
