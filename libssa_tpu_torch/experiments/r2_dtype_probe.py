"""Which ops Hopper computes exactly in each narrow type, and at what rate.

The counterpart of ``experiments/r2_dtype_probe.py``. Part A
(``probe_op``, and its interpret-mode reference, which becomes ``plain``
here): each op of ``OPS`` applied once to a (32, 256) tile, per type,
held against the plain version: EXACT, WRONG or FAIL (no instantiation,
or a launch error). The types are those Hopper computes in one
instruction a word: f32, bf16x2, int32, int16x2, int8x4 and uint8x4
(``__vadd4``, ``__vmaxs4``, ``__vmaxu4``), plus the DPX ops on int32 and
int16x2. Part B (``rate_kernel``): a chain of add, maximum or max_roll over
a (256, 2048) tile, the slope between reps 256 and 16, per type.

    python -m libssa_tpu_torch.experiments.r2_dtype_probe
"""
from __future__ import annotations

import sys

import torch

from . import _common as C

SHAPE_A = (32, 256)
SHAPE_B = (256, 2048)
TYPES = ("f32", "bf16x2", "i32", "i16x2", "i8x4", "u8x4")
SAT = 120  # satadd_u8_style's ceiling
# name -> (probes.cu op, shift of a roll along axis 0, or 0)
OPS = {
    "add": ("add", 0), "sub": ("sub", 0), "maximum": ("max", 0),
    "where_gt": ("where_gt", 0), "select_gt": ("where_gt", 0),
    "roll1": ("roll_addb", 1), "roll2": ("roll_addb", 2), "max_roll": ("max_roll_b", 1),
    "satadd_u8_style": ("satadd", 0),
}
DPX_OPS = {"max_add_dpx": ("max_add_dpx", 0), "max3_dpx": ("max3_dpx", 0),
           "max3_relu_dpx": ("max3_relu_dpx", 0)}
DPX_TYPES = ("i32", "i16x2")
RATE_OPS = ("add", "maximum", "max_roll")
LO, HI = 16, 256
COPIES_B = 32  # part B's tiles a launch: one (256, 2048) tile fills 4 warps an SM

launches = 0


def _count():
    global launches
    launches += 1


def ops_of(type_name: str) -> dict:
    return {**OPS, **(DPX_OPS if type_name in DPX_TYPES else {})}


def inputs_a(type_name: str, device, seed: int = 0):
    """Part A's inputs: integers in [-50, 50) ([0, 50) for uint8)."""
    dt = C.TYPES[type_name][1]
    g = torch.Generator().manual_seed(seed)
    lo = 0 if dt == torch.uint8 else -50
    a = torch.randint(lo, 50, SHAPE_A, generator=g).to(dt)
    b = torch.randint(lo, 50, SHAPE_A, generator=g).to(dt)
    return a.to(device), b.to(device)


def plain(name: str, a, b, reps: int = 1):
    """``reps`` applications of op ``name``, x = op(x, b), on (..., rows,
    cols) elements (part A's reference, part B's function)."""
    op, shift = ops_of(C.inv_type(a.dtype))[name]
    k1, k2 = C.consts(a, SAT if op == "satadd" else 1)
    x = a
    for _ in range(reps):
        x = C.plain_apply(op, x, b, k1, k2, roll_dim=-2, shift=shift)
    return x


def stage(name: str, type_name: str, a, b, reps: int = 1):
    """``launch()`` of op ``name`` on (rows, cols) elements on the card: the
    chain kernel, or the tile kernel with lines along axis 0 for a roll."""
    op, shift = ops_of(type_name)[name]
    c1 = SAT if op == "satadd" else 1
    if shift:
        rows = a.shape[0]
        G, R = (1, rows) if rows <= 32 else (rows // 32, 32)
        launch = C.stage_tile(op, type_name, a[None], reps, 1, G, R, shift, b=b[None],
                              c1=c1, count=_count)
        return lambda: launch()[0]
    return C.stage_chain(op, type_name, a, b, reps, 1, c1=c1, count=_count)


def probe_op(type_name: str, name: str, dev) -> tuple[str, str]:
    """(EXACT | WRONG | FAIL, message) for one op in one type, on the card."""
    a, b = inputs_a(type_name, dev)
    try:
        got = stage(name, type_name, a, b)()
        torch.cuda.synchronize()
    except (ValueError, RuntimeError) as e:
        return "FAIL", str(e)[:140]
    want = plain(name, a, b)
    return ("EXACT" if torch.equal(got, want) else "WRONG"), ""


def inputs_b(type_name: str, device, seed: int = 1, copies: int = 1):
    """Part B's inputs: ``copies`` tiles side by side along the columns, so
    a roll along axis 0 stays within each tile."""
    dt = C.TYPES[type_name][1]
    g = torch.Generator().manual_seed(seed)
    lo = 0 if dt == torch.uint8 else -3
    shape = (SHAPE_B[0], SHAPE_B[1] * copies)
    a = torch.randint(lo, 3, shape, generator=g).to(dt)
    b = torch.randint(lo, 3, shape, generator=g).to(dt)
    return a.to(device), b.to(device)


def measure_rate(type_name: str, name: str, dev, copies: int = COPIES_B) -> dict:
    """G elements a second for one op application, by slope (reps 256 vs
    16), over ``copies`` (256, 2048) tiles side by side."""
    a, b = inputs_b(type_name, dev, copies=copies)
    t_lo, t_hi = C.slope_ms(stage(name, type_name, a, b, LO), stage(name, type_name, a, b, HI))
    per = (t_hi - t_lo) * 1e-3 / (HI - LO)
    n = a.numel()
    return {"type": type_name, "op": name, "gelem_s": n / per / 1e9,
            "gelem_s_sm": n / per / 1e9 / C.sm_count(dev), "t_lo_ms": t_lo, "t_hi_ms": t_hi}


def main() -> int:
    dev = C.require_cuda("cuda")
    print(C.card(), flush=True)
    print("\n== part A: exactness matrix ==", flush=True)
    results = {}
    for ty in TYPES:
        for name in ops_of(ty):
            st, msg = probe_op(ty, name, dev)
            results[(ty, name)] = st
            print(f"  {ty:6s} {name:16s} {st}{'   <-- ' + msg if msg else ''}", flush=True)
    print("\n== part B: op throughput (Gelem/s per op) ==", flush=True)
    for ty in TYPES:
        for name in RATE_OPS:
            if results.get((ty, name)) == "EXACT":
                r = measure_rate(ty, name, dev)
                print(f"  {ty:6s} {name:16s} {r['gelem_s']:9.1f} Gelem/s "
                      f"({r['gelem_s_sm']:.2f} a SM)", flush=True)
    print(C.sample(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
