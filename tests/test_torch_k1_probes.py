"""K1's lazy-F variants: their plain versions against the TPU probes
``experiments/f_scan_probe.py``, ``v6_probe.py``, ``v7_probe.py``,
``v8_probe.py`` and ``r2_kernel_golf.py``, and ``csrc/interseq_variants.cu``
built by the host C++ compiler against the plain versions.

Each JAX probe runs as the JAX package's own tests run Pallas on the CPU:
imported by path, its ``pl.pallas_call`` patched to ``interpret=True``, at a
small size (m = 32 and 64, B = 128 in one tile, n = 16); nothing in
``experiments/`` changes. The JAX probes mask no lengths (v6, v7, v8, golf)
and need m to be a multiple of their chunk, so they get full lengths; the
checks against ``ops/interseq.interseq_scores`` add m = 1 and 40 (not a
multiple of the strip), a profile with pad rows, lengths below n and
Q == R. Tolerance: exact equality (integer scores; the JAX probes' f32 is
exact inside +-2**24).
"""
import ctypes
import functools
import importlib.util
import os
import shutil
import subprocess
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libssa_tpu_torch import matrices
from libssa_tpu_torch.experiments import _interseq_variants as IV
from libssa_tpu_torch.experiments import (
    f_scan_probe,
    r2_kernel_golf,
    v6_probe,
    v7_probe,
    v8_probe,
)
from libssa_tpu_torch.ops import interseq
from libssa_tpu_torch.ops.scoring import make_padded_profile
from libssa_tpu_torch.util import cudabuild

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B, N = 128, 16


@functools.cache
def _tpu_probe(name: str):
    """``experiments/<name>.py``, imported by path (it is not a package)."""
    os.environ.setdefault("LIBSSA_NO_COMPILE_CACHE", "1")
    spec = importlib.util.spec_from_file_location(f"tpu_k1_probe_{name}",
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


def _inputs(m: int, seed: int = 0):
    return IV.probe_inputs(m, B, N, seed=seed)


def _plain(probe, name, prof, subj, lens):
    return probe.plain(torch.as_tensor(prof), torch.as_tensor(subj), torch.as_tensor(lens), name)


def _reference(prof, subj, lens, Q, R):
    return interseq.interseq_scores(torch.as_tensor(prof), torch.as_tensor(subj),
                                    torch.as_tensor(lens), Q, R, local=True)[0].numpy()


def _check(probe, name, m, want):
    """The plain version of ``name`` equals the JAX probe's ``want`` and, if
    the variant is exact, ``interseq_scores``."""
    prof, subj, lens = _inputs(m)
    got = _plain(probe, name, prof, subj, lens)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want).reshape(-1).astype(np.int64))
    if probe.variants[name].exact:
        np.testing.assert_array_equal(got[0].numpy(), _reference(prof, subj, lens,
                                                                 probe.Q, probe.R))
    return got


# -- row 15: f_scan_probe ----------------------------------------------------------


@pytest.mark.parametrize("name", list(f_scan_probe.VARIANTS))
def test_f_scan_plain_matches_jax(interpret, name):
    """At m = 32 (one strip) every variant, timed-only cuts included, is the
    JAX probe's function; at m = 64 (a strip edge) the exact ones."""
    mod = _tpu_probe("f_scan_probe")
    p = f_scan_probe.PROBE
    for m in (32, 64) if p.variants[name].exact else (32,):
        prof, subj, lens = _inputs(m)
        want = mod.build(name, m, N, B, p.Q, p.R, b_tile=B)(
            jnp.asarray(prof), jnp.asarray(subj, jnp.int32), jnp.asarray(lens))
        _check(p, name, m, want)


# -- row 16: v6_probe -------------------------------------------------------------


@pytest.mark.parametrize("name", list(v6_probe.VARIANTS))
def test_v6_plain_matches_jax(interpret, name):
    mod = _tpu_probe("v6_probe")
    p = v6_probe.PROBE
    v = p.variants[name]
    for m in (32, 64):
        prof, subj, _ = _inputs(m)
        s, hi, lo = mod.build(m, N, B, p.Q, p.R, v.t, B, v.lo, v.il)(
            jnp.asarray(prof), jnp.asarray(subj, jnp.int32))
        got = _check(p, name, m, s)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(hi).reshape(-1))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(lo).reshape(-1))


# -- rows 17 and 18: v7_probe, v8_probe ---------------------------------------------


def test_v7_plain_matches_jax(interpret):
    mod = _tpu_probe("v7_probe")
    p = v7_probe.PROBE
    for m in (32, 64):
        prof, subj, lens = _inputs(m)
        s, _, _ = mod.build(m, N, B, p.Q, p.R, B)(
            jnp.asarray(prof), jnp.asarray(subj, jnp.int32), jnp.asarray(lens))
        _check(p, "v7", m, s)


@pytest.mark.parametrize("name", list(v8_probe.VARIANTS))
def test_v8_plain_matches_jax(interpret, name):
    mod = _tpu_probe("v8_probe")
    p = v8_probe.PROBE
    for m in (32, 64):
        prof, subj, lens = _inputs(m)
        s, _, _ = mod.build(m, N, B, p.Q, p.R, p.variants[name].ch, B)(
            jnp.asarray(prof), jnp.asarray(subj, jnp.int32), jnp.asarray(lens))
        _check(p, name, m, s)


# -- row 19: r2_kernel_golf -------------------------------------------------------------

GOLF_CFG = {"u4": (4, False, False), "fw": (2, True, False), "fw4": (4, True, False),
            "a8": (2, False, True), "a8_bt": (2, False, True), "a8nof": (2, False, 2),
            "a8nof4": (4, False, 2)}  # the JAX probe's (unroll, fullwidth, a8)


@pytest.mark.parametrize("name", list(r2_kernel_golf.VARIANTS))
def test_golf_plain_matches_jax(interpret, name):
    mod = _tpu_probe("r2_kernel_golf")
    p = r2_kernel_golf.PROBE
    unroll, fullwidth, a8 = GOLF_CFG[name]
    b_tile = 2816 if name == "a8_bt" else 2048
    for m in (32, 64):
        prof, subj, lens = _inputs(m)
        want = mod.build_var(m, N, B, p.Q, p.R, b_tile, unroll, fullwidth, a8)(
            jnp.asarray(prof), jnp.asarray(subj), jnp.asarray(lens))
        _check(p, name, m, want)


# -- csrc/interseq_variants.cu, host-built ------------------------------------------------


@functools.cache
def _host_lib(tmp: str):
    cxx = shutil.which("g++") or shutil.which("c++")
    out = Path(tmp) / "k1v_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC", "-o", str(out),
         str(cudabuild.CSRC / IV.SOURCE)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.k1v_run_host.argtypes = [i, p, i, p, p, i, i, i, i, p, p, p, p]
    lib.k1v_run_host.restype = i
    lib.k1v_describe.argtypes = [i, p]
    lib.k1v_describe.restype = i
    return lib


@pytest.fixture
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    return _host_lib(str(tmp_path_factory.mktemp("k1v")))


def _run_host(lib, idx, prof, codes, lens, Q, R, t):
    m, (n_pad, nb) = prof.shape[0], codes.shape
    if t == 8:  # the wrapper's (n_pad / 8, B, 8) layout
        n8 = -(-n_pad // 8)
        c = np.full((8 * n8, nb), IV.PAD_CODE, np.int8)
        c[:n_pad] = codes
        codes, n_pad = np.ascontiguousarray(c.reshape(n8, 8, nb).transpose(0, 2, 1)), 8 * n8
    out = [np.zeros(nb, np.int32) for _ in range(3)]
    scratch = np.zeros(2 * n_pad * nb, np.int32)
    prof, lens = np.ascontiguousarray(prof, np.int32), np.ascontiguousarray(lens, np.int32)
    rc = lib.k1v_run_host(idx, prof.ctypes.data, m, codes.ctypes.data, lens.ctypes.data,
                          n_pad, nb, Q, R, *(o.ctypes.data for o in out), scratch.ctypes.data)
    assert rc == 0
    return out


def _host_cases(seed: int):
    """(profile, codes, lengths, Q, R): m = 1, 8, 40 (not a multiple of the
    strip), 64 and 70; B = 300 (IL = 2 leaves a lane group half empty); a
    profile with pad rows; lengths 0, below n and n; Q > R and Q == R."""
    rng = np.random.default_rng(seed)
    padded = matrices.builtin("BLOSUM62").padded()
    for k, m in enumerate((1, 8, 40, 64, 70)):
        n = 19
        q = rng.integers(0, 20, m).astype(np.uint8)
        prof = (make_padded_profile(q, padded) if m == 40 else padded[q]).astype(np.int32)
        codes = rng.integers(0, 20, (n, 300)).astype(np.int8)
        lens = rng.integers(0, n + 1, 300).astype(np.int32)
        lens[:3], lens[3] = 0, n
        codes[np.arange(n)[:, None] >= lens[None, :]] = IV.PAD_CODE
        yield prof, codes, lens, *((11, 1), (3, 3), (12, 2))[k % 3]


def test_host_instance_table_matches_python(host_lib):
    """``k1v_describe`` (the source's list) equals ``INSTANCES``."""
    lib = host_lib
    assert lib.k1v_count() == len(IV.INSTANCES)
    for idx, (part, v) in enumerate(IV.INSTANCES):
        out = (ctypes.c_int * 13)()
        assert lib.k1v_describe(idx, out) == 0
        assert tuple(out) == (part, *v.key()), idx
    assert lib.k1v_describe(len(IV.INSTANCES), (ctypes.c_int * 13)()) == -1


@pytest.mark.parametrize("idx", range(len(IV.INSTANCES)))
def test_host_build_matches_plain(host_lib, idx):
    """Every instantiation, timed-only cuts included, equals its plain
    version (scores, hi, lo) across strip edges; exact ones equal
    ``interseq_scores``."""
    v = IV.INSTANCES[idx][1]
    for prof, codes, lens, Q, R in _host_cases(idx):
        got = _run_host(host_lib, idx, prof, codes, lens, Q, R, v.t)
        want = IV.plain(torch.as_tensor(prof), torch.as_tensor(codes), torch.as_tensor(lens),
                        Q, R, v)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())
        if v.exact:
            np.testing.assert_array_equal(got[0], _reference(prof, codes, lens, Q, R))


def test_variant_mapping():
    """Every probe variant has an instantiation; collapsed TPU variants share
    one; exactness follows the passes that exist in a strip."""
    probes = [f_scan_probe, v6_probe, v7_probe, v8_probe, r2_kernel_golf]
    used = {IV.index(v) for mod in probes for v in mod.VARIANTS.values()}
    assert used | {IV.index(IV.BASELINE)} == set(range(len(IV.INSTANCES)))
    fs = f_scan_probe.VARIANTS
    assert IV.index(fs["v0"]) == IV.index(fs["v1"]) == IV.index(fs["p8"])
    assert IV.index(fs["v2"]) == IV.index(fs["v4"])
    assert IV.index(fs["one128"]) == IV.index(fs["p0"])
    assert IV.index(fs["one1"]) == IV.index(fs["p1"])
    assert fs["p8"].exact and not fs["p4"].exact and not fs["v3"].exact
    assert IV.index(r2_kernel_golf.VARIANTS["a8_bt"]) == IV.index(r2_kernel_golf.VARIANTS["a8"])
    assert IV.index(v6_probe.VARIANTS["T1"]) == IV.index(fs["v1"])
    with pytest.raises(ValueError, match="no instantiation"):
        IV.index(IV.Variant("chunk", ch=4))


def test_stage_refuses_cpu_tensors_and_q_below_r():
    prof, subj, lens = (torch.as_tensor(a) for a in _inputs(32))
    with pytest.raises(ValueError, match="CUDA"):
        IV.stage(prof, subj, lens, 11, 1, IV.Variant("scan"))
    with pytest.raises(ValueError, match="Q >= R"):
        IV.check_gaps(1, 2, prof, N)
    with pytest.raises(ValueError, match="Q >= R"):
        IV.plain(prof, subj, lens, 1, 2, IV.Variant("scan"))
    with pytest.raises(ValueError, match="2\\*\\*30"):
        IV.check_gaps(11, 1, torch.full((64, 32), 2**25, dtype=torch.int32), 64)


def test_variant_parts_build_as_their_own_libraries(monkeypatch):
    """``lib(part)`` builds the source with ``-DK1V_PART=part``, each part
    keyed apart, and binds its entry points."""
    built = []
    monkeypatch.setattr(cudabuild, "load", cudabuild.load.__wrapped__)
    monkeypatch.setattr(cudabuild, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(cudabuild, "_build", lambda src, cc, flags: built.append(flags) or src)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: types.SimpleNamespace(
        k1v_run=types.SimpleNamespace(), k1v_attrs=types.SimpleNamespace()))
    libs = [IV.lib.__wrapped__(p) for p in range(IV.PARTS)]
    assert [tuple(f for f in flags if f.startswith("-D")) for flags in built] == [
        (f"-DK1V_PART={p}",) for p in range(IV.PARTS)]
    assert len({cudabuild.library_path(IV.SOURCE, "nvcc", f) for f in built}) == IV.PARTS
    assert all(lb.k1v_run.restype is ctypes.c_int for lb in libs)
    with pytest.raises(ValueError, match="part"):
        IV.lib.__wrapped__(IV.PARTS)
