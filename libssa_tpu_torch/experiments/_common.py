"""What the Hopper probes share: the build of ``csrc/probes.cu``, the word
and line layouts, the plain version of each op, slope timing and the card.

A probe's data is 32-bit words (``csrc/probes.cu``): f32 and int32 one to a
word, bf16 and int16 two (``bf16x2``, ``i16x2``), int8 and uint8 four
(``i8x4``, ``u8x4``), element 0 in the low bits. A tile that a probe rolls
is laid out as lines along the rolled axis, packed along the other.
"""
from __future__ import annotations

import ctypes
import functools
import subprocess

import torch

SOURCE = "probes.cu"
# name -> (code in csrc/probes.cu, element dtype, elements a word)
TYPES = {
    "f32": (0, torch.float32, 1),
    "bf16x2": (1, torch.bfloat16, 2),
    "i32": (2, torch.int32, 1),
    "i16x2": (3, torch.int16, 2),
    "i8x4": (4, torch.int8, 4),
    "u8x4": (5, torch.uint8, 4),
}
OPS = {name: code for code, name in enumerate((
    "add", "sub", "max", "where_gt", "max_add", "max_add_dpx", "satadd", "max3",
    "max3_dpx", "max3_relu", "max3_relu_dpx", "dpmix", "dpmix_dpx", "addc", "maxmulc",
    "select", "max3mul", "maxc", "max3add", "max3add_dpx", "roll", "roll_addc",
    "max_roll_addc", "roll_addb", "max_roll_b", "scan_masked",
))}
ROLLS = {"roll", "roll_addc", "max_roll_addc", "roll_addb", "max_roll_b", "scan_masked"}
# Plain int32 (or f32) operations one application of an op stands for.
OP_COUNT = {"add": 1, "sub": 1, "max": 1, "where_gt": 1, "max_add": 2, "max_add_dpx": 2,
            "satadd": 2, "max3": 2, "max3_dpx": 2, "max3_relu": 3, "max3_relu_dpx": 3,
            "dpmix": 5, "dpmix_dpx": 5, "addc": 1, "maxmulc": 2, "select": 3, "max3mul": 4,
            "maxc": 1, "max3add": 4, "max3add_dpx": 4}


def inv_type(dtype: torch.dtype) -> str:
    """The word type whose elements are ``dtype``."""
    return next(name for name, (_, dt, _) in TYPES.items() if dt == dtype)


def require_cuda(device) -> torch.device:
    """The device a probe runs on: CUDA, unless the caller asks for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probes run on an NVIDIA GPU: CUDA is not available")
    return dev


@functools.cache
def lib(part: str) -> ctypes.CDLL:
    """``csrc/probes.cu``'s library ``part``: "chain" (``probe_chain``) or
    "tile" (``probe_tile``, ``probe_carry``), each its own nvcc build."""
    from ..util import cudabuild

    lib = cudabuild.load(SOURCE, ({"chain": "PROBES_CHAIN", "tile": "PROBES_TILE"}[part],))
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    if part == "chain":
        lib.probe_chain.argtypes = [i, i, i, p, p, p, ll, ll, u, u, i, i, p]
        lib.probe_chain.restype = i
    else:
        lib.probe_tile.argtypes = [i, i, i, i, i, p, p, p, ll, ll, u, u, i, i, p]
        lib.probe_tile.restype = i
        lib.probe_carry.argtypes = [i, p, p, i, i, p]
        lib.probe_carry.restype = i
    return lib


def stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def check(rc: int, what: str):
    if rc == -1:
        raise ValueError(f"{what}: no such instantiation in csrc/probes.cu")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


# -- layouts ---------------------------------------------------------------


def words(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit words of ``x``'s elements, in order (int32, 1-d)."""
    return x.contiguous().reshape(-1).view(torch.int32)


def unwords(w: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    return w.contiguous().view(dtype).reshape(shape)


def to_lines(x: torch.Tensor, axis: int, per_word: int) -> torch.Tensor:
    """(copies, rows, cols) -> (lines, L) words: lines along ``axis`` (1 or
    2), ``per_word`` neighbours across it packed into one word."""
    y = x.movedim(axis, -1)
    c, o, L = y.shape
    if o % per_word:
        raise ValueError(f"{o} lines do not pack {per_word} to a word")
    y = y.reshape(c, o // per_word, per_word, L).transpose(2, 3)
    return y.contiguous().view(torch.int32).reshape(c * o // per_word, L)


def from_lines(w: torch.Tensor, shape, dtype: torch.dtype, axis: int, per_word: int):
    c = shape[0]
    other = shape[3 - axis]
    L = shape[axis]
    y = w.contiguous().view(dtype).reshape(c, other // per_word, L, per_word)
    y = y.transpose(2, 3).reshape(c, other, L)
    return y.movedim(-1, axis).contiguous()


def const_word(value, type_name: str) -> int:
    """``value`` in the element type, in every element of a word."""
    _, dt, pw = TYPES[type_name]
    return int(torch.full((pw,), value, dtype=dt).view(torch.int32)) & 0xFFFFFFFF


# -- the plain versions --------------------------------------------------------


def plain_apply(op: str, x, b, c1, c2, roll_dim=None, shift=1):
    """One application of ``op`` on element tensors (the plain version of
    ``csrc/probes.cu``'s ``apply`` and ``tile_step``); ``c1``, ``c2`` are
    0-dim tensors of x's dtype, so a constant is rounded to it first, as
    JAX rounds a weakly typed constant. DPX ops are the same function as the
    op they fuse; integer adds wrap."""
    mx = torch.maximum
    if op in ROLLS:
        o = torch.roll(x, shifts=shift, dims=roll_dim)
        if op == "roll":
            return o
        if op == "roll_addc":
            return o + c1
        if op == "max_roll_addc":
            return mx(x, o + c1)
        if op == "roll_addb":
            return o + b
        if op == "max_roll_b":
            return mx(o, b)
        j = torch.arange(x.shape[roll_dim], device=x.device)
        j = j.view([-1 if d == roll_dim % x.dim() else 1 for d in range(x.dim())])
        return mx(x, torch.where(j >= shift, o + c1, c2))
    if op == "add":
        return x + b
    if op == "sub":
        return x - b
    if op == "max":
        return mx(x, b)
    if op == "where_gt":
        return torch.where(x > b, x, b)
    if op in ("max_add", "max_add_dpx"):
        return mx(x + b, b)
    if op == "satadd":
        return torch.minimum(x + b, c1)
    if op in ("max3", "max3_dpx"):
        return mx(mx(x, b), c1)
    if op in ("max3_relu", "max3_relu_dpx"):
        return mx(mx(x, b), c1).clamp_min(0)
    if op in ("dpmix", "dpmix_dpx"):
        return mx(x + b, mx(x - c1, x - c2))
    if op == "addc":
        return x + c1
    if op == "maxmulc":
        return mx(x, x * c1)
    if op == "select":
        return torch.where(x > 0, x, x * c1)
    if op == "max3mul":
        return mx(x, mx(x * c1, x * c2))
    if op == "maxc":
        return mx(x, c1)
    if op in ("max3add", "max3add_dpx"):
        return mx(x, mx(x + c1, x + c2))
    raise ValueError(f"unknown op {op!r}")


def consts(x: torch.Tensor, c1=0, c2=0):
    return (torch.tensor(c1, dtype=x.dtype, device=x.device),
            torch.tensor(c2, dtype=x.dtype, device=x.device))


def plain_chain(op: str, a, b, reps: int, streams: int = 1, c1=0, c2=0):
    """chain_kernel's function: ``op`` applied ``reps`` times to each
    element, with one accumulator, or four (x, x + b, x, x + b) reduced by
    max."""
    k1, k2 = consts(a, c1, c2)
    if streams == 1:
        x = a
        for _ in range(reps):
            x = plain_apply(op, x, b, k1, k2)
        return x
    xs = [a, a + b, a, a + b]
    for _ in range(reps):
        xs = [plain_apply(op, x, b, k1, k2) for x in xs]
    return torch.maximum(torch.maximum(xs[0], xs[1]), torch.maximum(xs[2], xs[3]))


def plain_tile(op: str, x, apps: int, axis: int, shift: int = 1, b=None, c1=0, c2=0):
    """tile_kernel's function on (..., rows, cols) elements: ``op`` applied
    ``apps`` times, rolls along ``axis`` (-2 rows, -1 columns)."""
    k1, k2 = consts(x, c1, c2)
    for _ in range(apps):
        x = plain_apply(op, x, b, k1, k2, roll_dim=axis, shift=shift)
    return x


# -- the kernels ---------------------------------------------------------------


def stage_chain(op: str, type_name: str, a, b, reps: int, streams: int = 1,
                c1=0, c2=0, blocks=None, threads=256, count=None):
    """chain_kernel on element tensors ``a``, ``b`` (same shape, on the
    card): returns ``launch()``, which enqueues one launch and returns the
    output as elements. ``count`` is called at each launch."""
    code, dt, _ = TYPES[type_name]
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("the probes' kernels take CUDA tensors")
    if a.dtype != dt or b.dtype != dt or a.shape != b.shape:
        raise TypeError(f"{type_name}: a and b must be {dt} of one shape")
    wa, wb = words(a), words(b)
    out = torch.empty_like(wa)
    n = wa.numel()
    if blocks is None:
        blocks = -(-n // threads)
    w1, w2 = const_word(c1, type_name), const_word(c2, type_name)
    dev, lb = a.device, lib("chain")

    def launch():
        with torch.cuda.device(dev):
            rc = lb.probe_chain(code, OPS[op], streams, wa.data_ptr(), wb.data_ptr(),
                                out.data_ptr(), n, reps, w1, w2, blocks, threads, stream(dev))
        check(rc, f"chain {op} {type_name} x{streams}")
        if count:
            count()
        return unwords(out, dt, a.shape)

    return launch


def stage_tile(op: str, type_name: str, x, apps: int, axis: int, G: int, R: int, shift: int = 1,
               b=None, c1=0, c2=0, threads=256, count=None):
    """tile_kernel on (copies, rows, cols) elements on the card, lines along
    ``axis`` (1 rows' axis, 2 columns'), each ``G`` lanes of ``R`` words:
    returns ``launch()``, which enqueues one launch and returns the output."""
    code, dt, pw = TYPES[type_name]
    if x.device.type != "cuda" or (b is not None and b.device != x.device):
        raise ValueError("the probes' kernels take CUDA tensors")
    if x.dim() != 3 or x.dtype != dt or (b is not None and (b.dtype != dt or b.shape != x.shape)):
        raise TypeError(f"{type_name}: x (and b) must be (copies, rows, cols) {dt}")
    if x.shape[axis] != G * R:
        raise ValueError(f"lines of {x.shape[axis]} elements, not G * R = {G * R}")
    wx = to_lines(x, axis, pw)
    wb = to_lines(b, axis, pw) if b is not None else wx
    lines = wx.shape[0]
    if lines * G % 32:
        raise ValueError(f"{lines} lines of {G} lanes do not fill whole warps")
    out = torch.empty_like(wx)
    blocks = -(-lines * G // threads)
    w1, w2 = const_word(c1, type_name), const_word(c2, type_name)
    dev, lb = x.device, lib("tile")

    def launch():
        with torch.cuda.device(dev):
            rc = lb.probe_tile(code, G, R, shift, OPS[op], wx.data_ptr(), wb.data_ptr(),
                               out.data_ptr(), lines, apps, w1, w2, blocks, threads,
                               stream(dev))
        check(rc, f"tile {op} {type_name} G={G} R={R} D={shift}")
        if count:
            count()
        return from_lines(out, x.shape, dt, axis, pw)

    return launch


# -- timing and the card -------------------------------------------------------


def events_ms(fn, reps: int = 3) -> float:
    """Min over ``reps`` of one call's time on CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def slope_ms(fn_lo, fn_hi, reps: int = 3) -> tuple[float, float]:
    """(t_lo, t_hi), each the min of ``reps`` timings: the JAX probes' slope
    method, whose difference cancels launch and load costs."""
    return events_ms(fn_lo, reps), events_ms(fn_hi, reps)


def smi(fields: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return smi("name,power.limit")


def sample() -> str:
    """SM clock, power draw and power limit now."""
    return smi("clocks.sm,power.draw,power.limit")


def sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count
