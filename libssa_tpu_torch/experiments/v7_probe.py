"""The v7 design of K1 on Hopper: scan passes on narrowing row ranges.

The counterpart of ``experiments/v7_probe.py`` (its ``build``, at m = 256,
B = 2048, n = 512, Q 11, R 1), on ``csrc/interseq_variants.cu``: the full
in-strip scan where pass d touches rows >= d only, as v7's aligned slice
updates D[d:] = max(D[d:], D[:-d] - d R) do. In registers every pass is
such a slice, so the rolls it keeps for d < 8 are slices too.

    python -m libssa_tpu_torch.experiments.v7_probe
"""
from __future__ import annotations

import sys

from ._interseq_variants import Probe, Variant

VARIANTS = {"v7": Variant("scan", narrow=True)}
PROBE = Probe("v7_probe", VARIANTS, B=2048, Q=11, R=1)

if __name__ == "__main__":
    sys.exit(PROBE.main())
