"""The harness and the reference on the card (marked ``cuda``; they skip
without one). On a card:

    python -m pytest -m cuda ssabench/tests/test_ssabench_cuda.py -q
"""
import time

import numpy as np
import pytest

from ssabench import harness
from ssabench.reference import dp, scoring
from ssabench.tests import tiny

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_tiny_cell_on_the_card(card, root, cell):
    r = harness.run_cell(root, cell, 2**31 + 3, 0.5, True, card, time.perf_counter(), True)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    # below 16M cells the alignment is the host's alone: no device work
    assert (r["device"]["busy_s"] > 0) == (cell != "tiny_align")
    assert any(c["value"] > c["limit"] for c in r["control"].values())
    for name, m in r["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, (name, m)


@pytest.mark.parametrize("local", [True, False])
def test_graphed_blocked_sweep_equals_the_plain_one(card, local):
    rng = np.random.default_rng(4 + local)
    sub = scoring.substitution({"match": 10, "mismatch": -8})
    q = rng.integers(0, 4, 3001).astype(np.uint8)
    s = rng.integers(0, 4, 20000).astype(np.uint8)
    plain = dp.pair_score(q, s, sub, 20, 1, local, "cpu", blocks=1)
    assert dp.pair_score(q, s, sub, 20, 1, local, card) == plain
    assert dp.pair_score(q, s, sub, 20, 1, local, card, graph_rows=0, blocks=1) == plain
