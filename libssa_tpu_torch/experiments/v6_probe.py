"""The v6 design of K1 on Hopper: folded masks, the running min, the
T-batched gather and IL independent lane groups.

The counterpart of ``experiments/v6_probe.py`` (its ``build``, at m = 256,
B = 2048, n = 512, Q 11, R 1), on ``csrc/interseq_variants.cu``: the full
scan with -d R folded into pass d (every scan of the source folds it), for
T in {1, 8} (with T = 8 the codes are laid out (n / 8, B, 8), one 8-byte
load for 8 columns, as the JAX probe lays out (n / T, T B)), ``lo`` on and
off, and IL in {1, 2} subjects a thread. T 1, lo off, IL 1 is f_scan's v1.

    python -m libssa_tpu_torch.experiments.v6_probe
"""
from __future__ import annotations

import sys

from ._interseq_variants import Probe, Variant

VARIANTS = {
    f"T{t}{'_lo' if lo else ''}{'_IL2' if il == 2 else ''}": Variant("scan", t=t, lo=lo, il=il)
    for il in (1, 2) for lo in (False, True) for t in (1, 8)
}
PROBE = Probe("v6_probe", VARIANTS, B=2048, Q=11, R=1)

if __name__ == "__main__":
    sys.exit(PROBE.main())
