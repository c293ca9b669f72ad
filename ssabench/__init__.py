"""ssabench: the benchmark of the PyTorch and CUDA port (``libssa_tpu_torch``).

``python3 -m ssabench.run --workload NAME --seed N --seconds S --trace 0|1``
from the root of a checkout; see ``ssabench/README.md``.
"""
