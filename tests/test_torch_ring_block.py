"""K2's plain version and CUDA source against the JAX package, on the CPU.

``ring_block_plain`` must equal the Pallas tile kernel (``banded_tile`` in
interpret mode) on tiles of a real DP, once the TPU layouts are converted:
band-major (CH, B) edges, the corner-first top stream, the re-based bottom
stream and ``track_pos`` steps. Tiles chained into whole pairs must equal
``libssa_tpu.oracle``. K2's CUDA source, built by the host C++ compiler,
must equal the plain version, one tile or a batch of mixed tiles at a time,
at every warps count a block (W stripes of one tile, their edges through the
shared ring) and band height; ``tests/test_torch_cuda.py`` holds the kernel
itself on the card. Tolerance: exact equality, since every value is an
integer.
"""
import ctypes
import functools
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libssa_tpu import oracle as jax_oracle
from libssa_tpu.ops.ring_block_pallas import banded_tile, tile_shapes
from libssa_tpu_torch import matrices, oracle
from libssa_tpu_torch.ops import ring_block, ring_block_cuda
from libssa_tpu_torch.util import cudabuild

torch.set_num_threads(1)

B62 = matrices.builtin("BLOSUM62")
PADDED = torch.as_tensor(B62.padded().astype(np.int32))
NEG_F32 = float(-(2.0**24))


def dp_bounds(m, n, Q, R, local, dt=torch.int32):
    """A whole pair's boundaries as K2 takes them: leftH (m + 1,) corner
    first, leftE (m,), topH (n,), topF (n,); no gap state on either."""
    if local:
        leftH, topH = torch.zeros(m + 1, dtype=dt), torch.zeros(n, dtype=dt)
    else:
        leftH = torch.cat([torch.zeros(1, dtype=dt), -(Q + R * torch.arange(m, dtype=dt))])
        topH = -(Q + R * torch.arange(n, dtype=dt))
    return leftH, leftH[1:] - Q + R, topH, topH - Q + R


def real_bounds(q, s, Q, R, local, r0, c0, RB, W, dt=torch.int32):
    """Tile (r0, c0, RB, W)'s boundaries in the pair's real DP, from the
    plain version over the strips to its left and above it."""
    lH, lE, tH, tF = dp_bounds(len(q), len(s), Q, R, local, dt)
    colH, colE = lH, lE  # H, E at column c0 - 1 for rows -1 .. r0 + RB - 1
    if c0 > 0:
        left = ring_block.ring_block_plain(q[:r0 + RB], s[:c0], PADDED, Q, R, local,
                                           lH[:r0 + RB + 1], lE[:r0 + RB], tH[:c0], tF[:c0])
        colH, colE = torch.cat([tH[c0 - 1:c0], left.rightH]), left.rightE
    topH, topF = tH[c0:c0 + W], tF[c0:c0 + W]
    if r0 > 0:
        top = ring_block.ring_block_plain(q[:r0], s[:c0 + W], PADDED, Q, R, local,
                                          lH[:r0 + 1], lE[:r0], tH[:c0 + W], tF[:c0 + W])
        topH, topF = top.botH[c0:], top.botF[c0:]
    return colH[r0:r0 + RB + 1], colE[r0:r0 + RB], topH, topF


def _codes(rng, k, hi=20):
    return torch.as_tensor(rng.integers(0, hi, k).astype(np.uint8))


def _jax_tile(q, s, Q, R, local, leftH, leftE, topH, topF, ch=8):
    """``banded_tile`` (interpret mode) on the port's boundaries, its
    outputs converted to the port's layout."""
    RB, W = len(q), len(s)
    T, B = tile_shapes(RB, W, True, ch)
    pad = 31
    pq = np.asarray(PADDED)[np.asarray(q)].reshape(B, ch, 32).transpose(2, 1, 0)
    s_codes = np.full(T, pad, np.int32)
    s_codes[:W] = np.asarray(s)
    top_h = np.full(T + 1, NEG_F32, np.float32)
    top_h[0] = int(leftH[0])
    top_h[1:W + 1] = topH.numpy()
    top_f = np.full(T, NEG_F32, np.float32)
    top_f[:W] = topF.numpy()
    band = lambda x: np.asarray(x, np.float32).reshape(B, ch).T  # [r, b] = x[ch*b + r]
    left_d = np.asarray(leftH[:-1], np.float32)[::ch].reshape(1, B)
    tile = banded_tile(RB, W, Q, R, local, True, track_pos=local, ch=ch)
    out = tile(jnp.asarray(s_codes), jnp.asarray(top_h), jnp.asarray(top_f),
               jnp.asarray(pq, jnp.bfloat16), jnp.asarray(band(leftH[1:])),
               jnp.asarray(band(leftE)), jnp.asarray(left_d), 0, -(2**30))
    acc, _, rH, rE, bH, bF = (np.asarray(x) for x in out[:6])
    flat = lambda x: x.T.reshape(-1).astype(np.int64)  # back to row order
    res = {"rightH": flat(rH), "rightE": flat(rE), "botH": bH.astype(np.int64),
           "botF": bF.astype(np.int64)}
    if local:
        res["rowmax"] = flat(acc)
        steps = np.asarray(out[6]).astype(np.int64)  # earliest argmax step per row
        res["rowarg"] = flat(steps - np.arange(B)[None, :])  # step t - band b = column
    return res


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
@pytest.mark.parametrize("RB,W,r0,c0", [(8, 1, 3, 5), (16, 37, 0, 0), (64, 50, 9, 20),
                                        (24, 90, 30, 0), (40, 13, 0, 44)])
def test_plain_matches_pallas_interpret(local, RB, W, r0, c0):
    rng = np.random.default_rng(RB * 100 + W + local)
    q, s = _codes(rng, r0 + RB + 2), _codes(rng, c0 + W + 3)
    Q, R = oracle.gap_qr(10, 1)
    bounds = real_bounds(q, s, Q, R, local, r0, c0, RB, W)
    got = ring_block.ring_block_plain(q[r0:r0 + RB], s[c0:c0 + W], PADDED, Q, R, local,
                                      *bounds)
    want = _jax_tile(q[r0:r0 + RB], s[c0:c0 + W], Q, R, local, *bounds)
    for name in ("rightH", "rightE", "botH", "botF"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name], err_msg=name)
    if local:
        np.testing.assert_array_equal(got.rowmax.numpy(), want["rowmax"])
        # A row whose maximum is 0 has no argmax step in the TPU kernel
        # (its track stays -1); in the port every SW cell is >= 0, so the
        # earliest column reaching 0 is column 0.
        hit = want["rowmax"] > 0
        np.testing.assert_array_equal(got.rowarg.numpy()[hit], want["rowarg"][hit])
        assert (got.rowarg.numpy()[~hit] == 0).all()
    else:
        assert got.rowmax is None and got.rowarg is None


def chained(q, s, Q, R, local, RB, W, run):
    """The pair's score from its RB x W tiles, chained through ``run``."""
    m, n = len(q), len(s)
    lH, lE, tH, tF = dp_bounds(m, n, Q, R, local)
    best = 0
    for r0 in range(0, m, RB):
        rb = min(RB, m - r0)
        left_H, left_E = lH[r0:r0 + rb + 1], lE[r0:r0 + rb]
        rowH, rowF = [], []
        for c0 in range(0, n, W):
            w = min(W, n - c0)
            out = run(q[r0:r0 + rb], s[c0:c0 + w], left_H, left_E, tH[c0:c0 + w],
                      tF[c0:c0 + w])
            left_H, left_E = torch.cat([tH[c0 + w - 1:c0 + w], out.rightH]), out.rightE
            rowH.append(out.botH)
            rowF.append(out.botF)
            if local:
                best = max(best, int(out.rowmax.max()))
        tH, tF = torch.cat(rowH), torch.cat(rowF)
    return best if local else int(tH[-1])


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_chained_tiles_match_oracle(local):
    rng = np.random.default_rng(40 + local)
    for m, n, RB, W, go, ge in ((1, 1, 4, 4, 10, 1), (50, 70, 7, 9, 10, 1),
                                (90, 40, 90, 1, 5, 2), (33, 120, 1, 50, 20, 3),
                                (120, 110, 32, 33, 11, 1)):
        q, s = _codes(rng, m), _codes(rng, n)
        Q, R = oracle.gap_qr(go, ge)

        def run(*args):
            return ring_block.ring_block_plain(args[0], args[1], PADDED, Q, R, local,
                                               *args[2:])

        want = (jax_oracle.sw_score if local else jax_oracle.nw_score)(
            q.numpy(), s.numpy(), B62.scores, go, ge)
        assert chained(q, s, Q, R, local, RB, W, run) == want, (m, n, RB, W)


def test_plain_rejects_what_it_cannot_take():
    q = torch.zeros(4, dtype=torch.uint8)
    b = dp_bounds(4, 4, 11, 1, False)
    with pytest.raises(ValueError, match="dtype"):
        ring_block.ring_block_plain(q, q, PADDED, 11, 1, False, *(x.float() for x in b))
    with pytest.raises(ValueError, match="leftH"):
        ring_block.ring_block_plain(q, q, PADDED, 11, 1, False, b[0][:-1], *b[1:])
    with pytest.raises(ValueError, match="at least one"):
        ring_block_cuda.ring_block_cuda(q, q, [[0, 0, 0, 4]], PADDED, 11, 1, False, *b)
    with pytest.raises(ValueError, match="outside"):
        ring_block_cuda.ring_block_cuda(q, q, [[1, 4, 0, 4]], PADDED, 11, 1, False, *b)


def _batch(rng, local, dt, n_jobs):
    """``n_jobs`` tiles of one pair's real DP, windows into shared code buffers."""
    q, s = _codes(rng, 700), _codes(rng, 400)
    Q, R = oracle.gap_qr(10, 1)
    jobs, parts = [], []
    for k in range(n_jobs):
        RB = int(rng.choice([1, 2, 31, 33, 255, 257, 300]))
        W = int(rng.choice([1, 5, 32, 33, 150]))
        r0, c0 = int(rng.integers(0, 700 - RB + 1)), int(rng.integers(0, 400 - W + 1))
        jobs.append([r0, RB, c0, W])
        parts.append(real_bounds(q, s, Q, R, local, r0, c0, RB, W, dt))
    flat = [torch.cat(x) for x in zip(*parts)]
    return q, s, np.array(jobs, np.int64), flat, Q, R


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_wrapper_on_cpu_runs_plain_without_launch(local):
    rng = np.random.default_rng(7 + local)
    q, s, jobs, flat, Q, R = _batch(rng, local, torch.int64, 3)
    before = ring_block_cuda.launches
    got = ring_block_cuda.ring_block_cuda(q, s, jobs, PADDED, Q, R, local, *flat)
    assert ring_block_cuda.launches == before
    off = ring_block.offsets(jobs)
    for k, (r0, RB, c0, W) in enumerate(jobs.tolist()):
        lr, ll, lc = off["rows"][k], off["left"][k], off["cols"][k]
        want = ring_block.ring_block_plain(
            q[r0:r0 + RB], s[c0:c0 + W], PADDED, Q, R, local, flat[0][ll:ll + RB + 1],
            flat[1][lr:lr + RB], flat[2][lc:lc + W], flat[3][lc:lc + W])
        for name, w in zip(ring_block.Tiles._fields, want):
            g = getattr(got, name)
            if w is None:
                assert g is None
            else:
                seg = slice(lc, lc + W) if name in ("botH", "botF") else slice(lr, lr + RB)
                assert g.dtype == w.dtype and torch.equal(g[seg], w), name


def _host_k2(tmp_path):
    """K2's column routine and stripe pipeline, built by the C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path / "k2_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
         str(out), str(cudabuild.CSRC / ring_block_cuda.SOURCE)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.k2_ring_block_host.argtypes = [p, p, i, i, p, ll, ll, i, i, i]
    lib.k2_ring_block_host.restype = i
    ring_block_cuda.bind_layout(lib)  # raises if the layouts differ
    return lib


def _run_host(lib, q, s, jobs, flat, Q, R, local, ch, warps=1):
    """One host 'launch' of K2's source over the batch, ``warps`` stripes a
    block; outputs as Tiles."""
    dt = flat[0].numpy().dtype
    n_rows, n_cols = int(jobs[:, 1].sum()), int(jobs[:, 3].sum())
    ins = [np.ascontiguousarray(x.numpy()) for x in flat]
    outs = [np.zeros(n_rows, dt), np.zeros(n_rows, dt), np.zeros(n_cols, dt),
            np.zeros(n_cols, dt), np.zeros(n_rows, dt), np.zeros(n_rows, np.int32)]
    ring = np.zeros(2 * lib.k2_ring_slots() * n_cols, dt)
    qn, sn = np.ascontiguousarray(q.numpy()), np.ascontiguousarray(s.numpy())
    addr = dict(zip(("leftH", "leftE", "topH", "topF", *ring_block.Tiles._fields),
                    (a.ctypes.data for a in (*ins, *outs))))
    if not local:
        addr["rowmax"] = addr["rowarg"] = 0
    addr["ring"] = ring.ctypes.data
    table, group_job = ring_block_cuda.job_table(
        jobs, ch, warps, qn.ctypes.data, sn.ctypes.data, addr, dt.itemsize,
        lib.k2_ring_slots())
    mat = np.ascontiguousarray(PADDED.numpy())
    rc = lib.k2_ring_block_host(table.ctypes.data, group_job.ctypes.data, len(group_job),
                                warps, mat.ctypes.data, Q, R, int(local),
                                int(dt == np.int64), ch)
    assert rc == 0  # -2: a handoff between warps would race on the card
    outs = [torch.as_tensor(o) for o in outs]
    return ring_block.Tiles(*outs[:4], *(outs[4:] if local else (None, None)))


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_k2_stripe_routine_matches_plain(tmp_path, local):
    """K2's source, host-built: both types and band heights, one batch of
    mixed tiles (RB or W = 1, stripe edges crossed, partial last stripes),
    and a pair chained from tiles of one launch each."""
    lib = _host_k2(tmp_path)
    rng = np.random.default_rng(21 + local)
    for dt in (torch.int32, torch.int64):
        q, s, jobs, flat, Q, R = _batch(rng, local, dt, 7)
        want = ring_block_cuda.ring_block_cuda(q, s, jobs, PADDED, Q, R, local, *flat)
        for ch in ring_block_cuda.BAND_ROWS:
            got = _run_host(lib, q, s, jobs, flat, Q, R, local, ch)
            for name, g, w in zip(ring_block.Tiles._fields, got, want):
                assert (g is None) == (w is None), name
                if w is not None:
                    assert torch.equal(g, w), (name, dt, ch)
    q, s = _codes(rng, 300), _codes(rng, 260)
    Q, R = oracle.gap_qr(11, 1)

    def run(qt, st, *bounds):
        return _run_host(lib, qt, st, np.array([[0, len(qt), 0, len(st)]]),
                         [b.contiguous() for b in bounds], Q, R, local, 4)

    want = (jax_oracle.sw_score if local else jax_oracle.nw_score)(
        q.numpy(), s.numpy(), B62.scores, 11, 1)
    assert chained(q, s, Q, R, local, 200, 100, run) == want
    assert lib.k2_ring_block_host(None, None, 0, 1, None, 11, 1, 1, 0, 2) == -1


@pytest.fixture(scope="module")
def k2_host(tmp_path_factory):
    return _host_k2(tmp_path_factory.mktemp("k2"))


@functools.cache
def _warps_batch(local, dt):
    """One launch's tiles of a pair's real DP, and the plain version's
    outputs: rows = 1, cols = 1, 2,100 rows (17 stripes of 128 rows, 9 of
    256: more groups than the global ring's slots at every warps count, and
    a stripe count no warps count divides), 300 rows (3 stripes of 128, 2 of
    256: fewer stripes than warps), 700 rows (6 and 3 stripes), and two
    more, all at offsets in both sequences."""
    rng = np.random.default_rng(90 + local)
    q, s = _codes(rng, 2200), _codes(rng, 300)
    Q, R = oracle.gap_qr(10, 1)
    jobs = np.array([[0, 2100, 0, 40], [5, 1, 7, 90], [300, 300, 250, 1], [40, 700, 3, 57],
                     [1000, 257, 100, 200], [1500, 33, 290, 10]], np.int64)
    parts = [real_bounds(q, s, Q, R, local, r0, c0, RB, W, dt) for r0, RB, c0, W in jobs]
    flat = [torch.cat(x).contiguous() for x in zip(*parts)]
    want = ring_block_cuda.ring_block_cuda(q, s, jobs, PADDED, Q, R, local, *flat)
    return q, s, jobs, flat, Q, R, want


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
@pytest.mark.parametrize("ch", ring_block_cuda.BAND_ROWS)
@pytest.mark.parametrize("dt", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_k2_warps_match_plain(k2_host, local, dt, ch, warps):
    """K2's source, host-built, with ``warps`` stripes a block: every group
    runs warp by warp through the shared-ring handoff in the kernel's
    segment order, and equals the plain version on one launch of mixed
    tiles. A block past the shared memory is refused."""
    q, s, jobs, flat, Q, R, want = _warps_batch(local, dt)
    wide = int(dt == torch.int64)
    if ring_block_cuda.smem_bytes(warps, ch, 8 if wide else 4) > ring_block_cuda.MAX_SMEM:
        assert k2_host.k2_ring_block_host(None, None, 0, warps, None, Q, R, int(local), wide,
                                          ch) == -1
        return
    got = _run_host(k2_host, q, s, jobs, flat, Q, R, local, ch, warps)
    for name, g, w in zip(ring_block.Tiles._fields, got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert torch.equal(g, w), name


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_k2_warps_match_pallas_interpret(k2_host, local):
    """K2's source, host-built at 2 warps a block (3 stripes of 128 rows in
    2 groups, so one edge through the shared ring and one through the
    global ring), equals the JAX package's tile kernel in interpret mode."""
    rng = np.random.default_rng(95 + local)
    RB, W, r0, c0 = 264, 40, 9, 20
    q, s = _codes(rng, r0 + RB + 2), _codes(rng, c0 + W + 3)
    Q, R = oracle.gap_qr(10, 1)
    bounds = [b.contiguous() for b in real_bounds(q, s, Q, R, local, r0, c0, RB, W)]
    got = _run_host(k2_host, q, s, np.array([[r0, RB, c0, W]], np.int64), bounds, Q, R,
                    local, 4, warps=2)
    want = _jax_tile(q[r0:r0 + RB], s[c0:c0 + W], Q, R, local, *bounds)
    for name in ("rightH", "rightE", "botH", "botF"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name], err_msg=name)
    if local:
        np.testing.assert_array_equal(got.rowmax.numpy(), want["rowmax"])
        hit = want["rowmax"] > 0
        np.testing.assert_array_equal(got.rowarg.numpy()[hit], want["rowarg"][hit])
        assert (got.rowarg.numpy()[~hit] == 0).all()


@pytest.mark.parametrize("rows,ch,n_tiles,want", [
    (8192, 4, 2, 4),      # 11a's first level: 64 stripes a tile
    (100_000, 8, 1, 4),   # 11b's SW end scan: 391 stripes
    (781, 8, 128, 4),     # 11b NW's widest level: 4 stripes a tile
    (300, 4, 40, 4),      # 3 stripes a tile: a quarter of W = 4 idle
    (200, 4, 40, 2),      # 2 stripes a tile: half of W = 4 idle
    (100, 4, 40, 1),      # 1 stripe a tile
    (1024, 8, 150, 2),    # W = 4's 150 groups exceed the card at 1 block an SM
    (1024, 8, 1000, 4),   # neither fits at once: the fewest idle warps
])
def test_choose_warps(rows, ch, n_tiles, want):
    """K2's warps a block: 4, else 2, else 1, by the idle warps the tiles'
    stripe counts leave and by the groups a 132-SM card holds at once."""
    jobs = np.array([[0, rows, 0, 50]] * n_tiles, np.int64)
    assert ring_block_cuda.choose_warps(jobs, ch, 132) == want
    for w in (1, 2, 4):
        assert ring_block_cuda.smem_bytes(w, ch, 8) <= ring_block_cuda.MAX_SMEM
