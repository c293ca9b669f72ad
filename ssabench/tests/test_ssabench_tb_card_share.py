"""``tb_card_share.query``: the share of hits traced on the card, by hand
from the port's traceback.batch and traceback.fill spans, and nothing where
a program records no traceback.batch span."""
from types import SimpleNamespace

import pytest

from ssabench.tests.test_ssabench_program_spans import MS, hand_run, read, stats_of


def query(device, alone=0):
    spans = [("api.align", None, 0, 100 * MS),
             ("traceback.batch", 0, 50 * MS, 53 * MS, {"hits": 10, "cells": 9, "device": device}),
             ("device.wait", 1, 51 * MS, 52 * MS)]
    return spans + [("traceback.fill", 0, (60 + k) * MS, (61 + k) * MS) for k in range(alone)]


@pytest.mark.parametrize("calls,share", [((query(10), query(10)), 100.0),
                                          ((query(10), query(0)), 50.0),
                                          ((query(10, alone=2), query(10, alone=2)), 100 * 10 / 12),
                                          ((query(0), query(0)), 0.0)])
def test_tb_card_share_by_hand(calls, share):
    run = hand_run(stats_of(*calls), {"queries": 1})
    assert read("tb_card_share.query", run) == pytest.approx(share)


def test_tb_card_share_reads_nothing_without_the_span():
    parent = [("api.align", None, 0, 100 * MS), ("traceback.fill", 0, 50 * MS, 60 * MS)]
    assert read("tb_card_share.query", hand_run(stats_of(parent), {"queries": 1})) is None
    old = hand_run([SimpleNamespace(seconds=1.0)], {"queries": 1})
    assert read("tb_card_share.query", old) is None
    assert read("tb_card_share.query", hand_run([], {})) is None
