"""``leaf_ms.align``: the time of the port's mm.leaves spans a pair, by
hand, and nothing where a program records no such span."""
from types import SimpleNamespace

import pytest

from ssabench.tests.test_ssabench_program_spans import MS, hand_run, read, stats_of


def test_leaf_ms_by_hand():
    pair = [("mm.align", None, 0, 100 * MS),
            ("mm.level", 0, 1 * MS, 40 * MS, {"nodes": 1, "cells": 9, "device": True}),
            ("mm.leaves", 0, 40 * MS, 43 * MS, {"leaves": 32, "cells": 9}),
            ("device.wait", 2, 41 * MS, 42 * MS),
            ("mm.leaves", 0, 50 * MS, 51 * MS, {"leaves": 2, "cells": 9})]
    run = hand_run(stats_of(pair, pair), {"pairs": 1})
    assert read("leaf_ms.align", run) == pytest.approx(4.0)


def test_leaf_ms_reads_nothing_without_the_span():
    parent = [("mm.align", None, 0, 100 * MS),
              ("mm.level", 0, 1 * MS, 40 * MS, {"nodes": 1, "cells": 9, "device": True})]
    assert read("leaf_ms.align", hand_run(stats_of(parent), {"pairs": 1})) is None
    old = hand_run([SimpleNamespace(seconds=1.0)], {"pairs": 1})
    assert read("leaf_ms.align", old) is None
