"""The roofline's arithmetic on hand-made inputs."""
import pytest

from ssabench import roofline


def test_rates_come_from_the_phase12_readings():
    # r2_ilp_probe, phase 12: G element-ops a second, a max-add counted 2.
    assert roofline.RATES["add"] == pytest.approx(32_721e9)
    assert roofline.RATES["dpx"] == pytest.approx(52_779e9 / 2)
    # No width the ladder allows showed a faster add or max-add.
    assert roofline.RATES["add"] > max(22_169e9, 28_904e9)
    assert roofline.RATES["dpx"] > max(26_352e9 / 2, 52_744e9 / 2)


@pytest.mark.parametrize("kind,dpx", [("sw", 3.5), ("nw", 3.0)])
def test_least_time_of_cells(kind, dpx):
    cells = 10**12
    t = roofline.least_seconds(cells, kind, 0)
    assert t == pytest.approx(cells * dpx / roofline.RATES["dpx"])
    # the adds, on their own pipe, bound nothing here
    assert cells * 2 / roofline.RATES["add"] < t


def test_bytes_bound_where_they_dominate():
    t = roofline.least_seconds(10, "sw", 3_350_000)
    assert t == pytest.approx(1e-6)


def test_share_never_exceeds_100_for_an_ideal_kernel():
    # A kernel issuing exactly the fewest ops at the fastest rate reads 100%.
    cells = 2 * 10**11
    ideal = cells * 3.5 / roofline.RATES["dpx"]
    assert roofline.share_pct(roofline.least_seconds(cells, "sw", 0), ideal) == pytest.approx(100)
    assert roofline.share_pct(1.0, 0.0) is None


def test_call_bytes():
    assert roofline.search_bytes(1000, 50, 2, 10) == 1000 + 50 + 160
    assert roofline.pair_bytes(3, 4) == 15


def test_search_roofline_reading():
    from types import SimpleNamespace

    from ssabench import readings
    from ssabench.trace import Summary

    calls = [(0, 1, {"cells": 100 * 1000, "query_residues": 100, "queries": 1})]
    run = SimpleNamespace(
        mix=SimpleNamespace(residues=1000), traffic={"align_type": "sw", "k": 10}, calls=calls,
        summary=Summary(window_s=1.0, busy_s=0.5, kernel_s={"void k1_lanes<1>(Args)": 2e-8}))
    least = roofline.least_seconds(100_000, "sw", 1000 + 100 + 80)
    assert readings.search_roofline_pct(run) == pytest.approx(100 * least / 2e-8)
