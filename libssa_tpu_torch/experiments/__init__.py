"""Hopper counterparts of the TPU probes in ``experiments/``.

Each module runs on the card: ``python -m libssa_tpu_torch.experiments.<name>``.
Its plain PyTorch functions also run on the CPU, where the tests hold them
against the JAX probes; its kernels need CUDA and raise without it.
"""
