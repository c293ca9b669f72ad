"""The trace sums on hand-made intervals."""
import pytest

from ssabench import trace


def test_union_and_idle_by_innermost_span():
    window = (0, 100)
    device = [(10, 20, "k1"), (15, 30, "k1"), (50, 60, "k3"), (95, 120, "k3")]
    spans = [(0, 100, "ssabench.align_many"), (40, 90, "ssabench.aligner")]
    s = trace.summarize(window, device, spans)
    assert s.busy_s == pytest.approx((20 + 10 + 5) / 1e9)
    assert s.window_s == pytest.approx(100 / 1e9)
    assert s.kernel_s["k1"] == pytest.approx(25 / 1e9)
    assert s.kernel_s["k3"] == pytest.approx(15 / 1e9)
    # gaps 0-10, 30-50 and 60-95, cut where the aligner opens (40) and closes (90)
    assert s.idle_s["ssabench.align_many"] == pytest.approx((10 + 10 + 5) / 1e9)
    assert s.idle_s["ssabench.aligner"] == pytest.approx((10 + 30) / 1e9)
    assert s.device_s("k1", "k3") == pytest.approx(40 / 1e9)
    b = s.breakdown()
    assert b["device_ops"][0][0] == "k1" and b["idle_gaps"][0][0] == "ssabench.aligner"


def test_gap_outside_every_span_goes_to_the_window():
    s = trace.summarize((0, 10), [], [])
    assert s.idle_s == {trace.WINDOW: pytest.approx(1e-8)} and s.busy_s == 0


def test_innermost_pieces_cover_the_window():
    spans = [(10, 50, "a"), (20, 30, "b"), (25, 28, "c"), (40, 60, "d")]
    pieces = trace.innermost((0, 70), sorted(spans))
    assert pieces == [(0, 10, trace.WINDOW), (10, 20, "a"), (20, 25, "b"), (25, 28, "c"),
                      (28, 30, "b"), (30, 40, "a"), (40, 60, "d"), (60, 70, trace.WINDOW)]
