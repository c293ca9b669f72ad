"""A checkout root holding the amplicon_v4 cell at a test's size.

The cell keeps the configuration's scoring, strands and generator, and the
traffic file's shares and rates; only the sizes change: 1,200 entries of
about 120 bases (six lengths, so every family finds its nine members of its
source's length) and calls of 8 reads. It is found by the harness from this
root's ``BENCHMARK.json`` alone, with every metric the benchmark reports in
``amplicon_v4``.
"""
from __future__ import annotations

from ssabench.tests import tiny

CELL = "tiny_amplicon"
CONFIG = "ssabench/configs/tiny_silva138_v4_vsearch.json"


def make_root(root, entries: int = 1200, mean_length: int = 120, pool_calls: int = 2,
              per_call: int = 8, reads: dict | None = None):
    """Write the cell's BENCHMARK.json, configuration and traffic file under
    ``root``; ``reads`` changes the traffic file's read parameters. Return
    ``root``."""
    bench = tiny.load("BENCHMARK.json")
    cfg = tiny.load("ssabench/configs/silva138_v4_vsearch.json")
    cfg["database"].update(entries=entries, mean_length=mean_length,
                           min_length=mean_length - 10, max_length=mean_length + 10)
    tiny.write(root, CONFIG, cfg)
    traffic = tiny.load("ssabench/traffic/amplicon_v4.json")
    traffic.update(pool_calls=pool_calls, queries_per_call=per_call)
    traffic["reads"].update(reads or {})
    tiny.write(root, f"ssabench/traffic/{CELL}.json", traffic)
    config = dict(next(c for c in bench["configs"] if c["name"] == "silva138_v4_vsearch"),
                  name="tiny_silva138_v4_vsearch", file=CONFIG)
    manifest = {"configs": [config],
                "workloads": [{"name": CELL, "config": config["name"], "traffic": CELL,
                               "chips": 1, "why": "test"}],
                "end_to_end": [], "per_layer": []}
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            if "amplicon_v4" in m.get("workloads", ["amplicon_v4"]):
                manifest[section].append(dict(m, workloads=[CELL]) if "workloads" in m else m)
    tiny.write(root, "BENCHMARK.json", manifest)
    return root
