"""The Hopper probes' plain versions against the TPU probes in ``experiments/``.

Each JAX probe runs as the JAX package's own tests run Pallas on the CPU:
its module's ``pl.pallas_call`` is patched to ``interpret=True`` and its
trip counts and widths are shrunk through its module globals; nothing in
``experiments/`` changes. The same numpy inputs go through the port's plain
version (``libssa_tpu_torch/experiments/``). Where a probe's bodies are
local to its ``main`` (``r3_roll_probe``, ``r3_longpair_probe``), they are
taken from its source as written.

Tolerance: exact equality for every type, f32 and bf16 included, except
op_rate's f32 add (stated there: XLA reassociates the JAX side). No body
contracts a product into a sum (the bodies that multiply add nothing to
the product, or scale by 0.5, which is exact), and each bf16 op is rounded
to bf16 on both sides, so the two sides round alike.

``csrc/probes.cu``'s per-word ops (with host stand-ins for the DPX and
SIMD-in-word intrinsics) are built by the host C++ compiler and held
against the plain version here; ``tests/test_torch_cuda.py`` holds the
kernels themselves on the card.
"""
import ast
import ctypes
import functools
import importlib.util
import inspect
import os
import shutil
import subprocess
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libssa_tpu import matrices, oracle
from libssa_tpu_torch.experiments import _common as C
from libssa_tpu_torch.experiments import (
    op_rate_probe,
    r2_dtype_probe,
    r2_ilp_probe,
    r2_rate_probe,
    r3_banded_bisect,
    r3_carry_probe,
    r3_longpair_probe,
    r3_lp_bisect,
    r3_roll_probe,
)
from libssa_tpu_torch.util import cudabuild

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JAX_NAME = {"f32": "float32", "bf16x2": "bfloat16", "i32": "int32", "i16x2": "int16",
            "i8x4": "int8", "u8x4": "uint8"}
B62 = matrices.builtin("BLOSUM62")


@functools.cache
def _tpu_probe(name: str):
    """``experiments/<name>.py``, imported by path (it is not a package)."""
    os.environ.setdefault("LIBSSA_NO_COMPILE_CACHE", "1")
    spec = importlib.util.spec_from_file_location(f"tpu_probe_{name}",
                                                  ROOT / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Every pl.pallas_call in interpret mode while the test runs."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    return monkeypatch


def _np(x) -> np.ndarray:
    """A JAX or torch array as numpy, bf16 widened to f32 (exactly)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _to_torch(a: np.ndarray, type_name: str) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)).to(C.TYPES[type_name][1])


# -- row 4: op_rate_probe -------------------------------------------------------


@pytest.mark.parametrize("type_name", ["f32", "bf16x2"])
@pytest.mark.parametrize("op", op_rate_probe.OPS)
def test_op_rate_plain_matches_jax(interpret, op, type_name):
    mod = _tpu_probe("op_rate_probe")
    interpret.setattr(mod, "ITERS", 3)
    mod.build.cache_clear()
    x = np.random.default_rng(4).random((8, 128)).astype(np.float32)
    dtype_name = {"f32": "f32", "bf16x2": "bf16"}[type_name]
    want = np.asarray(mod.build(op, 4, dtype_name, 8, 128)(jnp.asarray(x)))
    mod.build.cache_clear()
    got = op_rate_probe.plain(_to_torch(x, type_name), op, 4, iters=3).float()
    if op == "add" and type_name == "f32":
        # XLA folds a trip's four constant adds into one (a + 4c), which the
        # probe as written (and the plain version) round four times: 12
        # adds of 0.001 to [0, 1) differ by at most a few ulps.
        np.testing.assert_allclose(got.numpy(), want, rtol=4e-7 * 12, atol=0)
        return
    np.testing.assert_array_equal(got.numpy(), want)


# -- row 5: r2_rate_probe -------------------------------------------------------

RATE_CASES = [("float32", "add"), ("float32", "maximum"), ("float32", "max_add"),
              ("bfloat16", "add"), ("bfloat16", "maximum"), ("bfloat16", "max_add"),
              ("int32", "add"), ("int32", "maximum"), ("int16", "add")]
PORT_TYPE = {v: k for k, v in JAX_NAME.items()}
PORT_OP = {"add": "add", "maximum": "max", "max_add": "max_add", "dpmix": "dpmix"}


def _small_ints(seed, shape, lo=-3, hi=4):
    return np.random.default_rng(seed).integers(lo, hi, shape)


@pytest.mark.parametrize("dtype_name,op", RATE_CASES)
def test_r2_rate_plain_matches_jax(interpret, dtype_name, op):
    mod = _tpu_probe("r2_rate_probe")
    a = _small_ints(1, (8, 128)).astype(np.float32)
    b = _small_ints(2, (8, 128)).astype(np.float32)
    want = mod.chain_kernel(dtype_name, 8, 128, 5, op)(
        jnp.asarray(a, dtype_name), jnp.asarray(b, dtype_name))
    ty = PORT_TYPE[dtype_name]
    got = r2_rate_probe.plain(_to_torch(a, ty), _to_torch(b, ty), PORT_OP[op], 5)
    np.testing.assert_array_equal(_np(got), _np(want))


# -- row 6: r2_ilp_probe --------------------------------------------------------


@pytest.mark.parametrize("op", ["add", "maximum", "dpmix"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_r2_ilp_plain_matches_jax(interpret, dtype_name, op):
    mod = _tpu_probe("r2_ilp_probe")
    a = _small_ints(3, (8, 128)).astype(np.float32)
    b = _small_ints(4, (8, 128)).astype(np.float32)
    want = mod.streams_kernel(dtype_name, 8, 128, 6, op)(
        jnp.asarray(a, dtype_name), jnp.asarray(b, dtype_name))
    ty = PORT_TYPE[dtype_name]
    got = r2_ilp_probe.plain(_to_torch(a, ty), _to_torch(b, ty), PORT_OP[op], 6)
    np.testing.assert_array_equal(_np(got), _np(want))


# -- rows 7-9: r2_dtype_probe ---------------------------------------------------


@pytest.mark.parametrize("type_name", list(JAX_NAME))
def test_r2_dtype_part_a_plain_matches_jax(type_name):
    """Every op of the JAX probe's ``OPS`` on its (32, 256) tile and inputs."""
    from jax.experimental import pallas as pl

    mod = _tpu_probe("r2_dtype_probe")
    dt = JAX_NAME[type_name]
    rng = np.random.default_rng(0)
    lo = 0 if dt == "uint8" else -50
    a = rng.integers(lo, 50, mod.SHAPES[dt])
    b = rng.integers(lo, 50, mod.SHAPES[dt])
    for name, fn in mod.OPS.items():
        def kernel(a_ref, b_ref, o_ref, fn=fn):
            o_ref[:] = fn(a_ref[:], b_ref[:])

        want = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(a.shape, dt),
                              interpret=True)(jnp.asarray(a, dt), jnp.asarray(b, dt))
        got = r2_dtype_probe.plain(name, _to_torch(a, type_name), _to_torch(b, type_name))
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=name)
    assert mod.probe_op(dt, "add", interpret=True) == ("EXACT", "")


@pytest.mark.parametrize("type_name", list(JAX_NAME))
def test_r2_dtype_part_b_plain_matches_jax(interpret, type_name):
    mod = _tpu_probe("r2_dtype_probe")
    dt = JAX_NAME[type_name]
    lo = 0 if dt == "uint8" else -3
    a, b = _small_ints(5, (16, 128), lo, 3), _small_ints(6, (16, 128), lo, 3)
    for name in r2_dtype_probe.RATE_OPS:
        want = mod.rate_kernel(dt, 16, 128, 3, name)(jnp.asarray(a, dt), jnp.asarray(b, dt))
        got = r2_dtype_probe.plain(name, _to_torch(a, type_name), _to_torch(b, type_name), 3)
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=name)


# -- row 10: r3_carry_probe -----------------------------------------------------


@pytest.mark.parametrize("variant", r3_carry_probe.VARIANTS)
def test_r3_carry_plain_matches_jax(interpret, variant):
    mod = _tpu_probe("r3_carry_probe")
    interpret.setattr(mod, "K", 128)
    interpret.setattr(mod, "T", 5)
    x = (np.random.default_rng(0).random((8, 128)).astype(np.float32) - 2.0)
    want = float(mod.build(variant)(jnp.asarray(x)))
    tile = r3_carry_probe.plain(torch.as_tensor(x), variant, trips=5)
    assert float(tile.max()) == want


# -- rows 11 and 12: r3_roll_probe, r3_longpair_probe probe 2 ----------------------


def _probes_dict(mod) -> dict:
    """The ``probes = {...}`` literal of ``mod.main``, evaluated with the
    module's names in scope."""
    for node in ast.walk(ast.parse(inspect.getsource(mod.main))):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "probes":
            expr = compile(ast.Expression(node.value), mod.__name__, "eval")
            return eval(expr, dict(vars(mod)))
    raise AssertionError("no probes dict")


@pytest.mark.parametrize("name", list(r3_roll_probe.PROBES))
def test_r3_roll_plain_matches_jax(interpret, name):
    mod = _tpu_probe("r3_roll_probe")
    interpret.setattr(mod, "K", 128)
    probes = _probes_dict(mod)
    spec = r3_roll_probe.PROBES[name]
    if spec[1] == "i32":  # Hopper's int32 form of max3: against the f32 body's shape
        x = np.random.default_rng(7).integers(-1000, 1000, (8, 128)).astype(np.int32)
        got = r3_roll_probe.plain(torch.as_tensor(x), spec, 3)
        want = np.maximum(x, np.maximum(x - 1, x - 2))
        np.testing.assert_array_equal(got.numpy(), want)
        return
    x = (np.random.default_rng(0).random((8, 128)) * 0.5).astype(np.float32)
    want = np.asarray(mod.mk(probes[name], 3)(jnp.asarray(x)))
    got = r3_roll_probe.plain(torch.as_tensor(x), spec, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def _longpair_probe2(mod, iters: int, K: int):
    """r3_longpair_probe's probe 2 (``mk`` and ``probes``, local to its
    main), with ITERS and K replaced."""
    src = inspect.getsource(mod.main)
    fn = ast.parse(src[:src.index("    for name, body in probes.items()")]).body[0]
    keep = [s for s in fn.body if not (isinstance(s, ast.Expr)) and not (
        isinstance(s, ast.Assign) and getattr(s.targets[0], "id", "") == "x")]
    ns = dict(vars(mod))
    exec(compile(ast.Module(keep, []), "r3_longpair_probe.main", "exec"), ns)
    ns["ITERS"], ns["K"] = iters, K
    return ns


@pytest.mark.parametrize("name", list(r3_longpair_probe.PROBES))
def test_r3_longpair_probe2_plain_matches_jax(interpret, name):
    mod = _tpu_probe("r3_longpair_probe")
    ns = _longpair_probe2(mod, 3, 2048)
    x = np.random.default_rng(0).random((8, 2048)).astype(np.float32)
    want = np.asarray(ns["mk"](ns["probes"][name])(jnp.asarray(x)))
    got = r3_longpair_probe.plain(torch.as_tensor(x), name, iters=3)
    np.testing.assert_array_equal(got.numpy(), want)


# -- row 14: r3_lp_bisect -------------------------------------------------------


@pytest.mark.parametrize("variant", ["c_full", "c_noscan", "c_empty"])
def test_r3_lp_bisect_plain_matches_jax(interpret, variant):
    """The JAX probe's own inputs (``main``) at N = 1024; c_full is the SW
    score, equal to the oracle's."""
    mod = _tpu_probe("r3_lp_bisect")
    N, RB = 1024, 128
    q, s, mat = r3_lp_bisect.pair(N)
    W = N // 8
    P = np.asarray(B62.padded())[:, s].astype(np.float32)
    p_spans = np.transpose(P.reshape(32, 8, W), (1, 0, 2)).copy()
    qoh = np.zeros((N, 32), np.float32)
    qoh[np.arange(N), q] = 1.0
    want = float(mod.build(N, N, RB, 11, 1, variant)(jnp.asarray(qoh), jnp.asarray(p_spans)))
    got = r3_lp_bisect.plain(torch.as_tensor(q), torch.as_tensor(s), torch.as_tensor(mat),
                             11, 1, variant[2:])
    assert got == want
    if variant == "c_full":
        assert got == oracle.sw_score(q, s, B62.scores, 10, 1)


# -- row 13: r3_banded_bisect ---------------------------------------------------


def test_r3_banded_full_matches_jax_and_oracle(interpret):
    """The JAX probe's ``full`` variant on a profile built from a real query
    (symbol k + 1 is residue k; symbols 0 and 21-31 score -1000, so the
    warm-up lanes and the tail past the subject add nothing): its score is
    the SW score, equal to the oracle's and to K3's plain version (the
    port's ``full``)."""
    mod = _tpu_probe("r3_banded_bisect")
    interpret.setattr(mod, "UNROLL", 4)  # T = 9 N / 8 steps, a multiple of UNROLL
    N = 64
    B, T = N // 8, N + N // 8
    rng = np.random.default_rng(9)
    q = rng.integers(0, 20, N).astype(np.uint8)
    s = rng.integers(0, 20, N).astype(np.uint8)
    sym = np.zeros(T, np.int32)
    sym[:N] = s.astype(np.int32) + 1
    sym[N:] = 31
    scores = np.asarray(B62.scores, np.float32)
    pq = np.full((32, 8, B), -1000.0, np.float32)
    rows = q.reshape(B, 8).T  # query row 8 b + r at (r, b)
    for k in range(20):
        pq[k + 1] = scores[rows, k]
    f1, _ = mod.build(B, T, 12, 1, "full")
    want = int(np.asarray(f1(jnp.asarray(sym), jnp.asarray(pq)))[0])
    padded = torch.as_tensor(np.asarray(B62.padded(), np.int32))
    got = int(r3_banded_bisect.plain(torch.as_tensor(q), torch.as_tensor(s), padded, 12, 1))
    assert got == want == oracle.sw_score(q, s, B62.scores, 11, 1)


# -- csrc/probes.cu's per-word ops, host-built ----------------------------------------


@functools.cache
def _host_probes(tmp: str):
    cxx = shutil.which("g++") or shutil.which("c++")
    out = Path(tmp) / "probes_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(out), str(cudabuild.CSRC / C.SOURCE)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    lib.probe_chain_host.argtypes = [i, i, i, p, p, p, ll, ll, u, u]
    lib.probe_chain_host.restype = i
    return lib


FLOAT_OPS = ["add", "sub", "max", "where_gt", "max_add", "satadd", "dpmix", "addc", "maxc",
             "maxmulc", "select", "max3mul"]
INT_OPS = ["add", "sub", "max", "where_gt", "max_add", "satadd", "max3", "max3_relu", "dpmix"]
DPX_OPS = ["max_add_dpx", "max3_dpx", "max3_relu_dpx", "dpmix_dpx", "max3add", "max3add_dpx"]


@pytest.mark.parametrize("type_name", list(JAX_NAME))
def test_probe_ops_host_build_matches_plain(tmp_path_factory, type_name):
    """chain_kernel's arithmetic (one and four accumulators), every op the
    type instantiates, on random words: integers over their whole range,
    so adds wrap; floats small, with ties and signs."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    lib = _host_probes(str(tmp_path_factory.mktemp("probes")))
    code, dt, pw = C.TYPES[type_name]
    rng = np.random.default_rng(11 + code)
    n = 512
    if dt.is_floating_point:
        a = torch.as_tensor(rng.integers(-40, 40, n * pw) / 8.0).to(dt)
        b = torch.as_tensor(rng.integers(-40, 40, n * pw) / 8.0).to(dt)
        ops, c1, c2 = FLOAT_OPS, 0.75, -1.5
    else:
        info = torch.iinfo(dt)
        a = torch.as_tensor(rng.integers(info.min, info.max + 1, n * pw)).to(dt)
        b = torch.as_tensor(rng.integers(info.min, info.max + 1, n * pw)).to(dt)
        ops = INT_OPS + (DPX_OPS if type_name in ("i32", "i16x2") else [])
        c1, c2 = 5, -7
    wa, wb = C.words(a), C.words(b)
    for op in ops:
        for ns in (1, 4):
            out = torch.empty_like(wa)
            rc = lib.probe_chain_host(code, C.OPS[op], ns, wa.data_ptr(), wb.data_ptr(),
                                      out.data_ptr(), n, 3, C.const_word(c1, type_name),
                                      C.const_word(c2, type_name))
            assert rc == 0, op
            want = C.plain_chain(op, a, b, 3, ns, c1=c1, c2=c2)
            got = C.unwords(out, dt, a.shape)
            assert torch.equal(got, want), (op, ns)


def test_layouts_round_trip():
    """to_lines / from_lines for each packing and both axes."""
    for type_name, (_, dt, pw) in C.TYPES.items():
        x = torch.arange(3 * 8 * 16).reshape(3, 8, 16).to(dt)
        for axis in (1, 2):
            w = C.to_lines(x, axis, pw)
            assert w.shape == (3 * x.shape[3 - axis] // pw, x.shape[axis])
            assert torch.equal(C.from_lines(w, x.shape, dt, axis, pw), x)


def test_stage_cut_builds_are_their_own_libraries(monkeypatch):
    """``cudabuild.load(source, defines)`` passes each macro as ``-D`` and
    keys the library on it; the production K3 builds with none."""
    built = []
    monkeypatch.setattr(cudabuild, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(cudabuild, "_build", lambda src, cc, flags: built.append(flags) or src)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: path)
    for cuts in r3_banded_bisect.CUTS.values():
        cudabuild.load.__wrapped__("longpair.cu", cuts)
    defines = [tuple(f for f in flags if f.startswith("-D")) for flags in built]
    assert defines[0] == ()  # "full": the production build
    cuts = list(r3_banded_bisect.CUTS.values())[1:]
    assert defines[1:] == [tuple(f"-D{m}" for m in c) for c in cuts]
    paths = {cudabuild.library_path("longpair.cu", "nvcc", flags) for flags in built}
    assert len(paths) == len(r3_banded_bisect.CUTS)



def test_probe_library_builds_in_two_parts(monkeypatch):
    """``csrc/probes.cu`` builds as two libraries, one a macro: the chain
    kernels (``probe_chain``) and the tile and carry kernels, each bound to
    its own entry points."""
    built = []
    monkeypatch.setattr(cudabuild, "load", cudabuild.load.__wrapped__)
    monkeypatch.setattr(cudabuild, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(cudabuild, "_build", lambda src, cc, flags: built.append(flags) or src)

    class Lib:
        def __init__(self, path):
            self.probe_chain, self.probe_tile, self.probe_carry = (
                types.SimpleNamespace() for _ in range(3))

    monkeypatch.setattr(ctypes, "CDLL", Lib)
    chain, tile = C.lib.__wrapped__("chain"), C.lib.__wrapped__("tile")
    assert [tuple(f for f in flags if f.startswith("-D")) for flags in built] == [
        ("-DPROBES_CHAIN",), ("-DPROBES_TILE",)]
    assert len({cudabuild.library_path(C.SOURCE, "nvcc", flags) for flags in built}) == 2
    assert chain.probe_chain.restype is ctypes.c_int and not vars(chain.probe_tile)
    assert tile.probe_tile.restype is ctypes.c_int and not vars(tile.probe_chain)
    assert len(tile.probe_carry.argtypes) == 6
    with pytest.raises(KeyError):
        C.lib.__wrapped__("both")
