"""Round-2 kernel golf on Hopper: variants of the JAX kernel's design.

The counterpart of ``experiments/r2_kernel_golf.py`` (its ``build_var``, at
m = 256, B = 8192, n = 512, Q 12, R 1), on ``csrc/interseq_variants.cu``,
all with 8-row chunks (CH = 8) and the exact chunk carry:

* u4: 4 columns a loop trip (the JAX kernel's is 2), the running max of H;
* fw, fw4: the full-width restructure, whose running max reads Hnof. In a
  thread's registers the full-width form and the chunked loop are one
  dataflow, so fw is the chunked loop with the running max of Hnof, 2 and 4
  columns a trip;
* a8: the accumulator squeezed to 8 rows: 8 independent running-max
  registers. a8_bt is a8 at a larger TPU tile (b_tile 2816), which has no
  meaning here: it is a8;
* a8nof, a8nof4: a8 reading Hnof, 2 and 4 columns a trip.

The TPU's full (m, B) accumulator maps to one running-max register (u4,
fw, fw4).

    python -m libssa_tpu_torch.experiments.r2_kernel_golf
"""
from __future__ import annotations

import sys

from ._interseq_variants import Probe, Variant

VARIANTS = {
    "u4": Variant("chunk", unroll=4),
    "fw": Variant("chunk", a_hnof=True, unroll=2),
    "fw4": Variant("chunk", a_hnof=True, unroll=4),
    "a8": Variant("chunk", a_rows=8, unroll=2),
    "a8_bt": Variant("chunk", a_rows=8, unroll=2),
    "a8nof": Variant("chunk", a_hnof=True, a_rows=8, unroll=2),
    "a8nof4": Variant("chunk", a_hnof=True, a_rows=8, unroll=4),
}
PROBE = Probe("r2_kernel_golf", VARIANTS, B=8192, Q=12, R=1)

if __name__ == "__main__":
    sys.exit(PROBE.main())
