"""A checkout root holding the translated_search cell at a test's size.

The cell keeps the configuration's scoring, query translation and
generator, and the traffic file's shares and rates; only the sizes change.
It is found by the harness from this root's ``BENCHMARK.json`` alone, with
every metric the benchmark reports in ``translated_search``.
"""
from __future__ import annotations

from ssabench.tests import tiny

CELL = "tiny_translated"
CONFIG = "ssabench/configs/tiny_swissprot_blastx.json"


def make_root(root, entries: int = 100, mean_length: int = 120,
              read_lengths: tuple = (150, 90, 149), pool_calls: int = 2,
              per_call: int = 32):
    """Write the cell's BENCHMARK.json, configuration and traffic file under
    ``root``; ``read_lengths`` is (full length, shortest and longest
    trimmed). Return ``root``."""
    bench = tiny.load("BENCHMARK.json")
    cfg = tiny.load("ssabench/configs/swissprot_blastx.json")
    cfg["database"].update(entries=entries, mean_length=mean_length, min_length=60,
                           max_length=3 * mean_length)
    tiny.write(root, CONFIG, cfg)
    traffic = tiny.load("ssabench/traffic/translated_search.json")
    traffic.update(pool_calls=pool_calls, queries_per_call=per_call)
    full, lo, hi = read_lengths
    traffic["reads"].update(full_length=full, trimmed_min=lo, trimmed_max=hi)
    tiny.write(root, f"ssabench/traffic/{CELL}.json", traffic)
    config = dict(next(c for c in bench["configs"] if c["name"] == "swissprot_blastx"),
                  name="tiny_swissprot_blastx", file=CONFIG)
    manifest = {"configs": [config],
                "workloads": [{"name": CELL, "config": config["name"], "traffic": CELL,
                               "chips": 1, "why": "test"}],
                "end_to_end": [], "per_layer": []}
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            if "translated_search" in m.get("workloads", ["translated_search"]):
                manifest[section].append(
                    dict(m, workloads=[CELL]) if "workloads" in m else m)
    tiny.write(root, "BENCHMARK.json", manifest)
    return root
