"""A checkout root holding four data-only cells at sizes a CPU test can run.

Each cell reuses a traffic kind and a configuration of the benchmark, cut
to a few hundred residues, and is found by the harness from its entries in
this root's ``BENCHMARK.json`` alone.
"""
from __future__ import annotations

import copy
import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

CELLS = {  # cell: (configuration, traffic of the benchmark, changes)
    # Queries of about 120 residues: a homolog scores above 8 bits. A call
    # holds the cell's own 32 queries.
    "tiny_batch": ("swissprot_blosum62", "sprot_batch", {"pool_calls": 2}),
    "tiny_single": ("swissprot_blosum62", "sprot_single", {"pool_calls": 4}),
    # A pair this short scores under 16 bits: its control saturates at 8.
    "tiny_score": ("dna_pair_ednafull", "viral_score",
                   {"query_length": 300, "subject_length": 320, "control": "sat8"}),
    "tiny_align": ("dna_pair_ednafull", "mito_align",
                   {"query_length": 260, "subject_length": 250, "control": "sat8"}),
}


def load(rel: str) -> dict:
    with open(REPO / rel) as fh:
        return json.load(fh)


def write(root: Path, rel: str, obj: dict) -> None:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_root(root: Path, entries: int = 100, mean_length: int = 120) -> Path:
    """Write the tiny cells' BENCHMARK.json, configurations and traffic
    files under ``root``; return it."""
    bench = load("BENCHMARK.json")
    manifest = {"configs": [], "workloads": [],
                "end_to_end": copy.deepcopy(bench["end_to_end"]),
                "per_layer": copy.deepcopy(bench["per_layer"])}
    for c in bench["configs"]:
        cfg = load(c["file"])
        if "database" in cfg:
            cfg["database"].update(entries=entries, mean_length=mean_length,
                                  min_length=60, max_length=300)
        rel = f"ssabench/configs/tiny_{c['name']}.json"
        write(root, rel, cfg)
        manifest["configs"].append(dict(c, name=f"tiny_{c['name']}", file=rel))
    for cell, (config, traffic, changes) in CELLS.items():
        t = dict(load(f"ssabench/traffic/{traffic}.json"), **changes)
        write(root, f"ssabench/traffic/{cell}.json", t)
        manifest["workloads"].append({"name": cell, "config": f"tiny_{config}",
                                      "traffic": cell, "chips": 1, "why": "CPU test"})
        for section in ("end_to_end", "per_layer"):
            for m in manifest[section]:
                if traffic in m.get("workloads", []):
                    m["workloads"].append(cell)
    write(root, "BENCHMARK.json", manifest)
    return root
