"""The control's readings and the program's, at a cell's own size, many
seeds in one process.

    python3 -m ssabench.control --workload NAME --seconds S SEED ...

For each seed: the cell's set-up, a window of ``--seconds`` (long enough to
finish the mix's longest requests), then the comparison twice: of what the
timed path produced, and of the plain reference computed at the traffic
file's ``control`` precision, put in the program's place. One JSON line a
seed on standard output. The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("seeds", nargs="+", type=int)
    args = p.parse_args(argv)
    import torch

    from .harness import run_cell

    if not torch.cuda.is_available():
        print("ssabench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = run_cell(Path.cwd(), args.workload, seed, args.seconds, False, "cuda",
                     time.perf_counter(), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "checks": r["checks"],
                          "control": r["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
