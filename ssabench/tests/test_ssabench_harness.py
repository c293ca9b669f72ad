"""The harness end to end on the CPU: a data-only cell is found and runs,
and each fault the cells can have, planted under the timed path, and the
control, turn ``correct`` false."""
import json
import subprocess
import sys
import time

import pytest

from ssabench import harness
from ssabench.tests import tiny

SEED = 2**31 + 101
CELLS = sorted(tiny.CELLS)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


def run(root, cell, trace=False, control=False):
    return harness.run_cell(root, cell, SEED, 0.3, trace, "cpu", time.perf_counter(), control)


@pytest.mark.parametrize("cell", CELLS)
def test_data_only_cell_runs_correct(root, cell):
    r = run(root, cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks" and all(c["value"] == 0 for c in r["checks"].values())
    assert "setup_s" in r["metrics"] and len(r["metrics"]) == 2
    assert r["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_trace(root, cell):
    r = run(root, cell, trace=True)
    assert r["correct"] and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device here: the device readers find nothing and stay silent
    assert not any(k.startswith(("device_idle", "k1_", "k2_", "k3_")) for k in r["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_number(root, cell):
    r = run(root, cell, control=True)
    assert r["correct"]
    assert any(c["value"] > c["limit"] for c in r["control"].values()), r["control"]


def _altered_lists(orig):
    def call(self, *a, **k):
        out = orig(self, *a, **k)
        for hl in out if isinstance(out, list) else [out]:
            hl.hits[-1].score += 1
        return out
    return call


@pytest.fixture
def faults(monkeypatch):
    from libssa_tpu_torch import api
    from libssa_tpu_torch.ops import longpair
    from libssa_tpu_torch.search import manager

    def answer_altered(cell):
        if cell in ("tiny_batch", "tiny_single"):
            monkeypatch.setattr(api.SSAContext, "_align", _altered_lists(api.SSAContext._align))
            monkeypatch.setattr(api.SSAContext, "align_many",
                                _altered_lists(api.SSAContext.align_many))
        else:
            orig = api.SSAContext.align_pair

            def altered(self, *a, **k):
                out = orig(self, *a, **k)
                out.score += 2
                return out
            monkeypatch.setattr(api.SSAContext, "align_pair", altered)

    def half_left_out(cell):
        orig = manager.SearchEngine.search_many
        depth = []  # the engine calls itself once a profile height: halve the outer call

        def half(self, queries, k, *a, **kw):
            if depth:
                return orig(self, queries, k, *a, **kw)
            depth.append(1)
            try:
                keep = max(1, len(queries) // 2)
                out = orig(self, queries[:keep], k, *a, **kw)
            finally:
                depth.pop()
            if len(queries) > 1:
                return out + out[: len(queries) - keep]
            s, i = out[0]
            return [(s[: max(1, len(s) // 2)], i[: max(1, len(i) // 2)])]
        monkeypatch.setattr(manager.SearchEngine, "search_many", half)

    def state_unchanged(cell):
        monkeypatch.setattr(longpair, "longpair_score", lambda *a, **k: 0)
        monkeypatch.setattr(manager.SearchEngine, "search_many",
                            lambda self, queries, *a, **k: [([], [])] * len(queries))
        from libssa_tpu_torch.search import aligner
        orig = aligner.align_pair

        def unchanged(q, s, *a, **k):
            tb = orig(q, s, *a, **k)
            return type(tb)(0, tb.q_begin, tb.q_end, tb.s_begin, tb.s_end, tb.cigar)
        monkeypatch.setattr(aligner, "align_pair", unchanged)

    return {"answer_altered": answer_altered, "half_left_out": half_left_out,
            "state_unchanged": state_unchanged}


@pytest.mark.parametrize("fault,cell", [
    ("answer_altered", c) for c in CELLS] + [
    ("half_left_out", "tiny_batch"), ("half_left_out", "tiny_single")] + [
    ("state_unchanged", c) for c in CELLS])
def test_fault_turns_correct_false(root, faults, fault, cell):
    faults[fault](cell)
    r = run(root, cell)
    assert not r["correct"], r["checks"]


def test_a_request_that_raises_counts_as_failed(root, monkeypatch):
    from libssa_tpu_torch import api
    orig, seen = api.SSAContext._align, []

    def once(self, *a, **k):
        seen.append(1)
        if len(seen) == 3:  # a call inside the window
            raise RuntimeError("planted")
        return orig(self, *a, **k)
    monkeypatch.setattr(api.SSAContext, "_align", once)
    r = run(root, "tiny_single")
    assert not r["correct"] and r["failed"] == 1 and r["attempted"] > 1
    assert all(c["value"] == 0 for c in r["checks"].values())


def test_a_check_that_raises_still_reports(root, monkeypatch):
    from ssabench.mixes import db_search

    def broken(self, done, saturate=None):
        raise RuntimeError("planted")
    monkeypatch.setattr(db_search.Mix, "check", broken)
    r = run(root, "tiny_single")
    assert not r["correct"] and r["failed"] == 0 and r["checks"] == {}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("state", ["missing", "a_file"])
def test_tmpdir_is_made_usable(tmp_path, monkeypatch, state):
    from ssabench import run as run_module
    given = tmp_path / "given" / "tmp"
    if state == "a_file":
        given.parent.mkdir()
        given.write_text("")
    monkeypatch.setenv("TMPDIR", str(given))
    run_module.usable_tmpdir(tmp_path / "fallback")
    want = given if state == "missing" else tmp_path / "fallback"
    assert run_module.os.environ["TMPDIR"] == str(want) and want.is_dir()


def test_command_without_a_card_prints_no_result(tmp_path):
    p = subprocess.run([sys.executable, "-m", "ssabench.run", "--workload", "sprot_batch",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tiny.REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_manifest_from_a_data_only_root_lists_the_new_cells(root):
    m = json.loads((root / "BENCHMARK.json").read_text())
    assert {w["name"] for w in m["workloads"]} == set(tiny.CELLS)
