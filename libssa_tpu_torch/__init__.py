"""libssa_tpu_torch — the PyTorch/CUDA port of libssa_tpu.

Smith-Waterman and Needleman-Wunsch database search with affine gaps, the
8->16->64-bit precision ladder and top-k hit lists, on PyTorch tensors, with
the inter-sequence scoring kernel written by hand in CUDA C++ for Hopper
(``csrc/interseq.cu``), the one-pair scorer (``csrc/longpair.cu``) and the
tile kernel under the linear-space traceback (``csrc/ring_block.cu``). The
package stands alone: it keeps its own copies of the reference's
framework-neutral modules (constants, alphabets, matrices, the packed
database, the NumPy oracle and aligners) and imports nothing of
``libssa_tpu`` and nothing of JAX.
"""

from .constants import (
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
