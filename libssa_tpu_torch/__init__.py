"""libssa_tpu_torch — the PyTorch/CUDA port of libssa_tpu.

Smith-Waterman and Needleman-Wunsch database search with affine gaps, the
8->16->64-bit precision ladder and top-k hit lists, on PyTorch tensors, with
the inter-sequence scoring kernel written by hand in CUDA C++ for Hopper
(``csrc/interseq.cu``). The framework-neutral modules (alphabets, matrices,
the packed database, the NumPy oracle and traceback aligner) are imported
from ``libssa_tpu``, never copied; nothing here imports JAX.
"""

from libssa_tpu.constants import (
    AlignType,
    BitWidth,
    ComputeMode,
    OutputMode,
    Strand,
    SymType,
)

__version__ = "0.1.0"

__all__ = [
    "AlignType",
    "BitWidth",
    "ComputeMode",
    "OutputMode",
    "Strand",
    "SymType",
    "__version__",
]
