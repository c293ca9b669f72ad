"""K1's lazy-F design variants on Hopper: the wrapper of ``csrc/interseq_variants.cu``.

The counterparts of the TPU probes ``experiments/f_scan_probe.py``,
``v6_probe.py``, ``v7_probe.py``, ``v8_probe.py`` and ``r2_kernel_golf.py``
(``f_scan_probe``, ``v6_probe``, ... in this package) share this module. Each
variant computes K1's own SW function, ``(scores, hi, lo)`` of one query
profile against B subjects, and differs only in how F runs down the query
axis (the source's header says how each mode works). A ``Variant`` names the
template arguments; ``INSTANCES`` lists the instantiations in the source's
order, each with the part (``-DK1V_PART``) whose library holds it.

``stage`` launches on CUDA tensors and raises on CPU tensors; ``plain``
computes the variant's own F strategy in PyTorch, in the kernel's strip
structure (S rows, the carry across strips, the passes named), so it computes
exactly what the kernel computes, timed-only cuts included. Nothing falls
back. Lazy F is exact only for Q >= R, so both raise on Q < R.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..ops import interseq_cuda
from . import _common as C

SOURCE = "interseq_variants.cu"
ALPHA = 32
NEG = -(1 << 30)  # the source's NEG: E's start, the masked rows, rows past m
LIMIT = 1 << 30  # every |H| must stay below it (rows past m score NEG)
PAD_CODE = ALPHA - 1
FMODES = ("seq", "scan", "chunk", "twolevel", "none")  # the source's enum order


@dataclasses.dataclass(frozen=True)
class Variant:
    """Template arguments of one instantiation.

    ``passes``: the scan's shifts (SCAN only); None is every d < S, and
    shifts of S or more have no in-strip form (the strip-edge carry stands in
    for them). ``serial``: CHUNK's and TWOLEVEL's confined part as a serial
    max chain instead of a scan.
    """

    fmode: str = "scan"
    S: int = 32
    passes: tuple[int, ...] | None = None
    narrow: bool = False
    ch: int = 8
    serial: bool = False
    a_hnof: bool = False
    a_rows: int = 1
    unroll: int = 1
    il: int = 1
    t: int = 1
    lo: bool = False

    @property
    def full_mask(self) -> int:
        return self.S - 1  # d = 1, 2, 4, ... < S

    @property
    def mask(self) -> int:
        if self.passes is None:
            return self.full_mask
        return sum({d for d in self.passes if d < self.S})

    @property
    def exact(self) -> bool:
        """Whether the scores are K1's: every mode but NONE, and a scan
        only with every in-strip pass."""
        if self.fmode == "none":
            return False
        return self.fmode != "scan" or self.mask == self.full_mask

    def key(self) -> tuple[int, ...]:
        """The source's list row but index and part."""
        scan, chunk = self.fmode == "scan", self.fmode == "chunk"
        return (self.S, FMODES.index(self.fmode), self.mask if scan else 0,
                int(self.narrow) if scan else 0, self.ch if chunk else 0,
                int(self.serial) if self.fmode in ("chunk", "twolevel") else 0,
                int(self.a_hnof), self.a_rows, self.unroll, self.il, self.t, int(self.lo))


V = Variant
# The source's K1V_VARIANTS, in order: (part, variant).
INSTANCES = [
    (0, V("seq")),
    (0, V("scan")),
    (0, V("twolevel")),
    (0, V("twolevel", serial=True)),
    (0, V("none")),
    (0, V("scan", passes=())),
    (0, V("scan", passes=(1,))),
    (0, V("scan", passes=(1, 2))),
    (0, V("scan", passes=(1, 2, 4, 8))),
    (0, V("scan", passes=(1, 2, 4))),
    (0, V("scan", passes=(8, 16))),
    (0, V("scan", passes=(8,))),
    (1, V("scan", t=8)),
    (1, V("scan", lo=True)),
    (1, V("scan", t=8, lo=True)),
    (2, V("scan", il=2)),
    (2, V("scan", il=2, t=8)),
    (3, V("scan", il=2, lo=True)),
    (3, V("scan", il=2, t=8, lo=True)),
    (1, V("scan", narrow=True)),
    (4, V("chunk", ch=8)),
    (4, V("chunk", ch=16)),
    (4, V("chunk", ch=32)),
    (4, V("chunk", unroll=4)),
    (4, V("chunk", a_hnof=True, unroll=2)),
    (4, V("chunk", a_hnof=True, unroll=4)),
    (4, V("chunk", a_rows=8, unroll=2)),
    (4, V("chunk", a_hnof=True, a_rows=8, unroll=2)),
    (4, V("chunk", a_hnof=True, a_rows=8, unroll=4)),
]
PARTS = 1 + max(p for p, _ in INSTANCES)
BASELINE = Variant("seq")  # K1's own chain in this harness


def index(variant: Variant) -> int:
    """The instantiation that computes ``variant``."""
    key = variant.key()
    for i, (_, v) in enumerate(INSTANCES):
        if v.key() == key:
            return i
    raise ValueError(f"no instantiation of {variant} in csrc/{SOURCE}")


@functools.cache
def lib(part: int) -> ctypes.CDLL:
    """The library of part ``part`` (``-DK1V_PART=part``), its own nvcc build."""
    from ..util import cudabuild

    if not 0 <= part < PARTS:
        raise ValueError(f"part {part} not in 0..{PARTS - 1}")
    lb = cudabuild.load(SOURCE, (f"K1V_PART={part}",))
    p, i = ctypes.c_void_p, ctypes.c_int
    lb.k1v_run.argtypes = [i, p, i, p, p, i, i, i, i, p, p, p, p, p]
    lb.k1v_run.restype = i
    lb.k1v_attrs.argtypes = [i, p]
    lb.k1v_attrs.restype = i
    return lb


def check_gaps(Q: int, R: int, profile: torch.Tensor, n: int):
    """Lazy F needs Q >= R; rows past m need every |H| below 2**30."""
    interseq_cuda.check_gaps(Q, R)
    m = profile.shape[0]
    max_abs = int(profile.abs().max()) if profile.numel() else 0
    if min(m, n) * max_abs + Q + max(m, n) * R >= LIMIT:
        raise ValueError("scores may reach 2**30: outside the variants' int32 range")


def _check(name, t, dtype, dim, dev):
    if t.dtype != dtype or t.dim() != dim:
        raise TypeError(f"{name}: expected a {dim}-d {dtype} tensor, got {t.dim()}-d {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name}: expected device {dev}, got {t.device}")


def stage(profile: torch.Tensor, subjects_T: torch.Tensor, lengths: torch.Tensor, Q, R,
          variant: Variant, count=None):
    """One variant's kernel on the card: returns ``launch()``, which enqueues
    one launch and returns ``(scores, hi, lo)``, each (B,) int32. ``profile``
    (m, 32) int32, ``subjects_T`` (n_pad, B) int8 codes, ``lengths`` (B,)
    int32. ``count`` is called at each launch."""
    dev = profile.device
    if dev.type != "cuda":
        raise ValueError(f"K1's variants take CUDA tensors, got {dev}")
    _check("profile", profile, torch.int32, 2, dev)
    _check("subjects_T", subjects_T, torch.int8, 2, dev)
    _check("lengths", lengths, torch.int32, 1, dev)
    m, n_pad, B = profile.shape[0], subjects_T.shape[0], subjects_T.shape[1]
    if profile.shape[1] != ALPHA or m == 0 or lengths.shape[0] != B:
        raise ValueError("profile must be (m >= 1, 32) and lengths (B,)")
    Q, R = int(Q), int(R)
    check_gaps(Q, R, profile, n_pad)
    if B and not 0 <= int(lengths.min()) <= int(lengths.max()) <= n_pad:
        raise ValueError(f"lengths must lie in 0..{n_pad}")
    idx = index(variant)
    lb = lib(INSTANCES[idx][0])
    profile, lengths = profile.contiguous(), lengths.contiguous()
    codes = subjects_T.contiguous()
    if variant.t == 8:  # (n8, B, 8): a lane's 8 columns in one 8-byte word
        n8 = -(-n_pad // 8)
        codes = torch.nn.functional.pad(codes, (0, 0, 0, 8 * n8 - n_pad), value=PAD_CODE)
        codes = codes.view(n8, 8, B).permute(0, 2, 1).contiguous()
        n_pad = 8 * n8
    scratch = None
    if m > variant.S:
        scratch = torch.empty(2 * n_pad * B, dtype=torch.int32, device=dev)
    out = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)]

    def launch():
        with torch.cuda.device(dev):
            rc = lb.k1v_run(idx, profile.data_ptr(), m, codes.data_ptr(), lengths.data_ptr(),
                            n_pad, B, Q, R, *(o.data_ptr() for o in out),
                            None if scratch is None else scratch.data_ptr(), C.stream(dev))
        if rc == -1:
            raise ValueError(f"instantiation {idx} is not in part {INSTANCES[idx][0]}'s library")
        if rc != 0:
            raise RuntimeError(f"K1 variant {idx} launch failed: CUDA error {rc}")
        if count:
            count()
        return tuple(out)

    return launch


def attrs(variant: Variant) -> tuple[int, int]:
    """(registers a thread, local bytes a thread) of the variant's kernel."""
    idx = index(variant)
    out = (ctypes.c_int * 2)()
    rc = lib(INSTANCES[idx][0]).k1v_attrs(idx, out)
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes of variant {idx}: error {rc}")
    return out[0], out[1]


# -- the plain version ----------------------------------------------------------


def _confined(D: torch.Tensor, blk: int, mask: int, R: int) -> torch.Tensor:
    """Passes d in ``mask`` (d < blk), each confined to blocks of ``blk`` rows."""
    S, B = D.shape
    X = D.reshape(S // blk, blk, B).clone()
    d = 1
    while d < blk:
        if mask & d:
            Y = X.clone()
            Y[:, d:] = torch.maximum(X[:, d:], X[:, :-d] - d * R)
            X = Y
        d *= 2
    return X.reshape(S, B)


def _serial(D: torch.Tensor, blk: int, R: int) -> torch.Tensor:
    S, B = D.shape
    X = D.reshape(S // blk, blk, B).clone()
    for j in range(1, blk):
        X[:, j] = torch.maximum(X[:, j - 1] - R, X[:, j])
    return X.reshape(S, B)


def _apply_f(Hn, D, carry, Q: int, R: int):
    """F = max(D[j-1] - Q, carry - j R), F[0] = carry; (H, F out)."""
    N = Hn.shape[0]
    jR = torch.arange(N, device=Hn.device, dtype=Hn.dtype).view(N, 1) * R
    F = torch.maximum(D[:-1] - Q, carry - jR[1:])
    H = torch.maximum(Hn, torch.cat([carry.view(1, -1), F]))
    return H, torch.maximum(D[-1] - Q, carry - N * R)


def _column(v: Variant, H, E, sc, diag0, carry, Q: int, R: int):
    """One column of one strip: (H, E, Hnof, F out)."""
    S = v.S
    E = torch.maximum(E - R, H - Q)
    diag = torch.cat([diag0.view(1, -1), H[:-1]])
    if v.fmode == "seq":
        f, rows = carry, []
        for s in range(S):
            h = torch.maximum(torch.maximum(diag[s] + sc[s], E[s]), f).clamp_min(0)
            rows.append(h)
            f = torch.maximum(f - R, h - Q)
        Hs = torch.stack(rows)
        return Hs, E, Hs, f
    Hn = torch.maximum(diag + sc, E).clamp_min(0)
    if v.fmode == "none":
        return Hn, E, Hn, torch.zeros_like(carry)
    if v.fmode == "scan":
        if v.narrow:
            D = _confined(Hn, S, v.mask, R)
        else:  # every row, NEG below d
            D = Hn
            d = 1
            while d < S:
                if v.mask & d:
                    shifted = torch.cat([torch.full_like(D[:d], NEG), D[:-d]])
                    D = torch.maximum(D, shifted - d * R)
                d *= 2
        Hs, f = _apply_f(Hn, D, carry, Q, R)
        return Hs, E, Hn, f
    if v.fmode == "chunk":
        D = _serial(Hn, v.ch, R) if v.serial else _confined(Hn, v.ch, v.ch - 1, R)
        parts, f = [], carry
        for k in range(0, S, v.ch):
            h, f = _apply_f(Hn[k:k + v.ch], D[k:k + v.ch], f, Q, R)
            parts.append(h)
        return torch.cat(parts), E, Hn, f
    # twolevel: 8-row blocks, an exclusive scan of the block maxima, combine
    D = _serial(Hn, 8, R) if v.serial else _confined(Hn, 8, 7, R)
    NB = S // 8
    P = torch.cat([torch.full_like(D[:1], NEG), D[7:S - 1:8]])  # (NB, B)
    d = 1
    while d < NB:
        P = torch.cat([P[:d], torch.maximum(P[d:], P[:-d] - 8 * d * R)])
        d *= 2
    j1R = (torch.arange(8, device=D.device, dtype=D.dtype).view(8, 1) + 1) * R
    blocks = [D[:8]] + [torch.maximum(D[8 * b:8 * b + 8], P[b] - j1R) for b in range(1, NB)]
    Hs, f = _apply_f(Hn, torch.cat(blocks), carry, Q, R)
    return Hs, E, Hn, f


def plain(profile: torch.Tensor, subjects_T: torch.Tensor, lengths: torch.Tensor, Q, R,
          variant: Variant):
    """The variant's function in PyTorch, on any device: ``(scores, hi,
    lo)``, each (B,) int32, strip by strip as the kernel runs it."""
    v = variant
    Q, R = int(Q), int(R)
    m, (n_pad, B) = profile.shape[0], subjects_T.shape
    check_gaps(Q, R, profile, n_pad)
    dev, dt, S = profile.device, torch.int32, v.S
    strips = -(-m // S)
    prof = torch.full((strips * S, ALPHA), NEG, dtype=dt, device=dev)
    prof[:m] = profile.to(dt)
    codes = subjects_T.to(dev).long()
    lengths = lengths.to(dev)
    acc = torch.zeros((v.a_rows, B), dtype=dt, device=dev)
    lo = torch.zeros(B, dtype=dt, device=dev)
    scr = None  # the previous strip's (last-row H, next-row F) per column
    for k in range(strips):
        p = prof[k * S:(k + 1) * S]
        H = torch.zeros((S, B), dtype=dt, device=dev)
        E = torch.full((S, B), NEG, dtype=dt, device=dev)
        diag_top = torch.zeros(B, dtype=dt, device=dev)
        edge = []
        for t in range(n_pad):
            if scr is None:
                htop = torch.zeros(B, dtype=dt, device=dev)
                carry = torch.full((B,), -Q, dtype=dt, device=dev)
            else:
                htop, carry = scr[t]
            H, E, Hn, f = _column(v, H, E, p[:, codes[t]], diag_top, carry, Q, R)
            diag_top = htop
            x = Hn if v.a_hnof else H
            x = x.reshape(S // v.a_rows, v.a_rows, B).amax(0)
            valid = t < lengths
            acc = torch.where(valid, torch.maximum(acc, x), acc)
            if v.lo:
                lo = torch.where(valid, torch.minimum(lo, H.amin(0)), lo)
            edge.append((H[S - 1], f))
        scr = edge
    best = acc.amax(0)
    return best, best.clone(), lo


def probe_inputs(m: int, B: int, n: int, seed: int = 0):
    """The JAX probes' inputs (``f_scan_probe.main``, ``r2_kernel_golf.main``):
    a query of ``m`` codes and B subjects of ``n`` codes, all from
    ``rng.integers(0, 20)``, BLOSUM62 padded, full lengths. Returns
    (profile (m, 32) int32, subjects_T (n, B) int8, lengths (B,) int32) as
    numpy arrays."""
    from .. import matrices
    from ..ops.scoring import make_profile

    rng = np.random.default_rng(seed)
    padded = matrices.builtin("BLOSUM62").padded()
    q = rng.integers(0, 20, m).astype(np.uint8)
    profile = make_profile(q, padded).astype(np.int32)
    subjects = rng.integers(0, 20, (n, B)).astype(np.int8)
    return profile, subjects, np.full(B, n, np.int32)


def measure(launch, cells: int, variant: Variant) -> dict:
    """ms (CUDA events, min of 3 after a warm-up), GCUPS, and the
    instantiation's registers and local bytes."""
    ms = C.events_ms(launch, 3)
    regs, local = attrs(variant)
    return {"ms": ms, "gcups": cells / ms / 1e6, "regs": regs, "local": local}


# -- what the five probe modules share -------------------------------------------

M, N = 256, 512  # every probe's query and subject lengths
B_FILLED = 65_536  # 512 blocks: about 3.9 an SM, where the strategies compare


class Probe:
    """One JAX probe's counterpart: its variants by their JAX names, its
    shape and gaps, and its launch count (``launches``)."""

    def __init__(self, name: str, variants: dict, B: int, Q: int, R: int):
        self.name, self.variants, self.B, self.Q, self.R = name, variants, B, Q, R
        self.launches = 0

    def _count(self):
        self.launches += 1

    def stage(self, profile, subjects_T, lengths, name: str):
        """``stage`` of variant ``name``, counted on this probe."""
        return stage(profile, subjects_T, lengths, self.Q, self.R, self.variants[name],
                     count=self._count)

    def plain(self, profile, subjects_T, lengths, name: str):
        return plain(profile, subjects_T, lengths, self.Q, self.R, self.variants[name])

    def inputs(self, B: int, dev, n: int = N):
        return tuple(torch.as_tensor(a).to(dev) for a in probe_inputs(M, B, n))

    def measure_all(self, B: int, dev) -> tuple[dict, float]:
        """Every variant at (M, B, N): ms, GCUPS, registers, local bytes and,
        for an exact variant, whether its scores equal the production K1's;
        and the production K1's ms at the same shape."""
        from ..ops import interseq_cuda

        prof, codes, lens = self.inputs(B, dev)
        z = torch.zeros(1, dtype=torch.int32, device=dev)
        mr = torch.tensor([prof.shape[0]], dtype=torch.int32, device=dev)
        mx = int(prof.abs().max())  # as the engine passes it: no sync a call

        def k1():
            return interseq_cuda.interseq_pairs_cuda(
                prof[None], codes[None], lens[None], z, z, mr, self.Q, self.R, max_abs=mx)

        k1_ms = C.events_ms(k1, 3)
        ref = k1()[0][0]
        rows = {}
        for name, v in self.variants.items():
            launch = self.stage(prof, codes, lens, name)
            row = measure(launch, M * B * N, v)
            row["equal_k1"] = torch.equal(launch()[0], ref) if v.exact else None
            rows[name] = row
        return rows, k1_ms

    def check_plain(self, dev, n: int) -> list[str]:
        """The variants that differ from their plain version at the probe's
        M and B, subjects cut to ``n`` columns (each instantiation once)."""
        prof, codes, lens = self.inputs(self.B, dev, n)
        bad, seen = [], set()
        for name, v in self.variants.items():
            if v.key() in seen:
                continue
            seen.add(v.key())
            got = self.stage(prof, codes, lens, name)()
            want = self.plain(prof, codes, lens, name)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                bad.append(name)
        return bad

    def report(self, B: int, rows: dict, k1_ms: float) -> str:
        cells = M * B * N
        parts = [f"{name} {r['ms']:.3f} ms {r['gcups']:.1f} GCUPS {r['regs']} regs "
                 f"{r['local']} B local"
                 + ("" if r["equal_k1"] is None else (" =K1" if r["equal_k1"] else " !=K1"))
                 + ("" if self.variants[name].exact else " [timed only]")
                 for name, r in rows.items()]
        return (f"{self.name} m={M} B={B} n={N} Q {self.Q} R {self.R}: production K1 "
                f"{k1_ms:.3f} ms ({cells / k1_ms / 1e6:.1f} GCUPS); " + "; ".join(parts))

    def main(self) -> int:
        """Every variant at the probe's shape and at B = 65,536, on the card."""
        dev = C.require_cuda("cuda")
        print(C.card(), flush=True)
        for B in (self.B, B_FILLED):
            print(self.report(B, *self.measure_all(B, dev)), flush=True)
        print(C.sample(), flush=True)
        return 0
