"""The cost of one loop trip by carry shape, on Hopper.

The counterpart of ``experiments/r3_carry_probe.py`` (its ``build``): an
(8, 2048) f32 tile carried through ``T`` = 16,384 trips of
``one_chain(h, n)`` (n times ``h = max(h, h * 0.5 - 1)``), with the carry
shaped as in the JAX variants: single, tuple3, with1b, slice78, subroll,
laneroll1b and iota_t. The carry lives in registers (two columns of 8
rows a thread, 1024 threads a tile, ``csrc/probes.cu``'s carry_kernel); a
row carried across lanes (laneroll1b) rolls by ``__shfl_up_sync`` and
shared memory. Reports ns a trip.

    python -m libssa_tpu_torch.experiments.r3_carry_probe
"""
from __future__ import annotations

import sys

import torch

from . import _common as C

K = 2048
T = 16384
VARIANTS = ("single", "tuple3", "with1b", "slice78", "subroll", "laneroll1b", "iota_t")

launches = 0


def _chain(h, n):
    half, one = torch.tensor(0.5), torch.tensor(1.0)
    for _ in range(n):
        h = torch.maximum(h, h * half.to(h.device) - one.to(h.device))
    return h


def plain(x: torch.Tensor, variant: str, trips: int = T) -> torch.Tensor:
    """The JAX kernel's output tile for (..., 8, K) f32 ``x`` (the JAX
    probe returns its max)."""
    if variant == "single":
        h = x
        for _ in range(trips):
            h = _chain(h, 12)
        return h
    if variant == "tuple3":
        a, b, d = x, x + 1.0, x + 2.0
        for _ in range(trips):
            a, b, d = _chain(a, 4), _chain(b, 4), _chain(d, 4)
        return a + b + d
    if variant in ("with1b", "slice78", "laneroll1b"):
        a, v = x, x[..., 0:1, :]
        n = 8 if variant == "laneroll1b" else 10
        row = 0 if variant == "with1b" else 7
        for _ in range(trips):
            a = _chain(a, n)
            if variant == "laneroll1b":
                v = torch.maximum(torch.roll(v, 1, dims=-1), a[..., 7:8, :])
            else:
                v = torch.maximum(v, a[..., row:row + 1, :])
        return a + v
    if variant == "subroll":
        h = x
        for _ in range(trips):
            for d in (1, 2, 4):
                h = torch.maximum(h, torch.roll(h, d, dims=-2) - 1.0)
            h = _chain(h, 6)
        return h
    if variant == "iota_t":
        h = x
        lane = torch.arange(x.shape[-1], device=x.device)
        for t in range(trips):
            h = torch.where(t < lane, torch.zeros((), device=x.device), _chain(h, 10))
        return h
    raise ValueError(f"unknown variant {variant!r}")


def stage(x: torch.Tensor, variant: str, trips: int = T):
    """``launch()`` of carry_kernel on (copies, 8, 2048) f32 on the card."""
    if x.device.type != "cuda":
        raise ValueError("the probes' kernels take CUDA tensors")
    if x.dtype != torch.float32 or x.dim() != 3 or tuple(x.shape[1:]) != (8, K):
        raise TypeError("x must be (copies, 8, 2048) float32")
    x = x.contiguous()
    out = torch.empty_like(x)
    dev, lb, code = x.device, C.lib("tile"), VARIANTS.index(variant)

    def launch():
        global launches
        with torch.cuda.device(dev):
            rc = lb.probe_carry(code, x.data_ptr(), out.data_ptr(), x.shape[0], trips,
                                C.stream(dev))
        C.check(rc, f"carry {variant}")
        launches += 1
        return out

    return launch


def tile_input(copies: int, device, seed: int = 0) -> torch.Tensor:
    """The JAX probe's input: uniform [0, 1) less 2."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((copies, 8, K), generator=g) - 2.0).to(device)


def measure(variant: str, dev, copies: int | None = None) -> dict:
    """ns a trip for one tile alone (one block) and for the card full of tiles."""
    copies = copies or 2 * C.sm_count(dev)
    one = C.events_ms(stage(tile_input(1, dev), variant), 3)
    full = C.events_ms(stage(tile_input(copies, dev), variant), 3)
    return {"variant": variant, "ns_trip": one * 1e6 / T, "ns_trip_card": full * 1e6 / T,
            "copies": copies, "ms_one": one, "ms_card": full}


def main() -> int:
    dev = C.require_cuda("cuda")
    print(C.card(), flush=True)
    for v in VARIANTS:
        m = measure(v, dev)
        print(f"{v:10s}: {m['ms_one']:8.2f} ms = {m['ns_trip']:7.1f} ns/iter one tile; "
              f"{m['copies']} tiles {m['ms_card']:8.2f} ms", flush=True)
    print(C.sample(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
