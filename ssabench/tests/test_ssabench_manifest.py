"""BENCHMARK.json against the benchmark's contract, and the files it names."""
import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_and_names(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for key in ("why", "layer"):
            if key in e:
                assert one_line(e[key]), e
        if section == "configs":
            assert one_line(e["source"]) and e["source"].startswith("https://")


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert 1 <= len(configs) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    for c in configs.values():
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert "assumed" in cfg and cfg["name"] == c["name"]
    assert len({c["file"] for c in configs.values()}) == len(configs)
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and one_line(w["why"])
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((REPO / "ssabench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (REPO / "ssabench" / "mixes" / f"{traffic['kind']}.py").is_file()
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics_cover_every_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}

    def cells_of(m):
        return set(m.get("workloads", cells))

    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert cells_of(m) <= cells
        assert (REPO / "ssabench" / "e2e" / f"{m['name']}.py").is_file()
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert cells_of(m) <= cells_of(e2e[m["moves"]]), m["name"]
        assert (REPO / "ssabench" / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"], set()).add(m["name"])
    for cell in cells:
        reported = [m["name"] for m in BENCH["end_to_end"] if cell in cells_of(m)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in cells_of(m) for m in BENCH["per_layer"])


def test_files_under_paths_are_named_plainly():
    for p in BENCH["paths"]:
        for f in (REPO / p).rglob("*"):
            if "__pycache__" in f.parts or f.is_dir():
                continue
            rel = f.relative_to(REPO).as_posix()
            assert PATH.match(rel), rel


def test_manifest_size():
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
