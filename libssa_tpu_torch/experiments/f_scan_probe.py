"""F prefix-max variants of K1 on Hopper.

The counterpart of ``experiments/f_scan_probe.py`` (its ``build``, at m =
256, B = 2048, n = 512, Q 11, R 1), on ``csrc/interseq_variants.cu``. Each
JAX variant maps to a ``Variant``:

* v0, v1: the full Hillis-Steele scan with select or additive masks. A
  thread's registers have no mask layout, so both are one instantiation: the
  masked form, every row of every pass.
* v2, v4: the two-level scan (8-row blocks, a scan of the block maxima);
  the MXU extract of v2 and the reshape of v4 are one instantiation. v4s:
  its 8-row part as a serial chain.
* v3: no F (the compute ceiling), wrong by design.
* p0-p8, small3, big5, one1, one8, one128: some passes only, timed only.
  Passes of 32 rows or more have no in-strip form (the strip-edge carry
  stands in for them), so p8 is v1 and exact, and one128 is p0.

    python -m libssa_tpu_torch.experiments.f_scan_probe
"""
from __future__ import annotations

import sys

from ._interseq_variants import Probe, Variant

SCAN = Variant("scan")
VARIANTS = {
    "v0": SCAN,
    "v1": SCAN,
    "v2": Variant("twolevel"),
    "v3": Variant("none"),
    "v4": Variant("twolevel"),
    "v4s": Variant("twolevel", serial=True),
    **{f"p{k}": Variant("scan", passes=tuple(1 << i for i in range(k))) for k in (0, 1, 2, 4, 8)},
    "small3": Variant("scan", passes=(1, 2, 4)),
    "big5": Variant("scan", passes=(8, 16, 32, 64, 128)),
    "one1": Variant("scan", passes=(1,)),
    "one8": Variant("scan", passes=(8,)),
    "one128": Variant("scan", passes=(128,)),
}
PROBE = Probe("f_scan_probe", VARIANTS, B=2048, Q=11, R=1)

if __name__ == "__main__":
    sys.exit(PROBE.main())
