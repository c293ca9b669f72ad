"""The v8 design of K1 on Hopper: chunked-sequential F.

The counterpart of ``experiments/v8_probe.py`` (its ``build``, at m = 256,
B = 2048, n = 512, Q 11, R 1), on ``csrc/interseq_variants.cu``: inside each
chunk of CH rows a confined scan, between chunks the exact carry
max(D[CH-1] - Q, carry - CH R), for CH in {8, 16, 32}. v8 seeds the carry
into the chunk's scan; the carry written apart, as the JAX kernel does
(``libssa_tpu/ops/interseq_pallas.py:212``), gives the same F. CH = 32 is
one chunk a strip.

    python -m libssa_tpu_torch.experiments.v8_probe
"""
from __future__ import annotations

import sys

from ._interseq_variants import Probe, Variant

VARIANTS = {f"CH{ch}": Variant("chunk", ch=ch) for ch in (8, 16, 32)}
PROBE = Probe("v8_probe", VARIANTS, B=2048, Q=11, R=1)

if __name__ == "__main__":
    sys.exit(PROBE.main())
