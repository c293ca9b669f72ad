"""The CPU tests drive the port's many small operations: one thread a test
process keeps parallel workers from starving each other."""
import torch

torch.set_num_threads(1)
