"""K1 and the flagship search of one checkout, for comparing two K1 designs.

    python libssa_tpu_torch/experiments/k1_ab.py ROOT LABEL [--profile]

Imports ``libssa_tpu_torch`` and ``chip_smoke`` from the checkout at ROOT
(another commit unpacked with ``git archive``, or this one) and prints one
line, ``RESULT {json}``:

- ``k1_ms``: K1 alone at bench.py's kernel shape (SW, m = 256, B = 8192, n =
  512, track_range), a filled launch (SW, B = 65,536) and
  ``pair_scores_batch``'s shape (NW, m = n = 512, P = 2048), through
  ``interseq_pairs_cuda`` as the engine calls it (max_abs given, one
  scratch): two CUDA-event timings, each the min of 3 after a warm-up;
- the flagship: 100 queries of 256 residues against ``chip_smoke``'s
  500,000-subject database through ``search_many`` (SW, k = 10), twice
  after a warm-up, with q·subj/s, wall and K1's launches; one SW and one NW
  query through ``search``, min of 3;
- with ``--profile``: ``torch.profiler``'s device time over one more
  ``search_many``, K1's share of the wall and the top kernels.

Run two checkouts in one call on one card, in the order A, B, B, A, so that
the host's and the card's drift falls on both.
"""
from __future__ import annotations

import json
import os
import sys
import time


def kernel_ms(c, dev) -> dict:
    import numpy as np
    import torch

    from libssa_tpu_torch import matrices
    from libssa_tpu_torch.ops import interseq_cuda
    from libssa_tpu_torch.ops.scoring import make_profile

    rng = np.random.default_rng(0)
    padded = matrices.builtin("BLOSUM62").padded()
    scratch = torch.empty(interseq_cuda.SCRATCH_BUDGET, dtype=torch.uint8, device=dev)
    out = {}
    for key, m, B, n, local, track in (("kernel", 256, 8192, 512, True, True),
                                       ("filled", 256, 65536, 512, True, False),
                                       ("pairs", 512, 2048, 512, False, False)):
        prof = make_profile(rng.integers(0, 20, m).astype(np.uint8), padded)
        prof = torch.as_tensor(prof).to(dev)[None]
        codes = torch.as_tensor(rng.integers(0, 20, (1, n, B)).astype(np.int8)).to(dev)
        lens = torch.full((1, B), n, dtype=torch.int32, device=dev)
        z = torch.zeros(1, dtype=torch.int32, device=dev)
        mr = torch.tensor([m], dtype=torch.int32, device=dev)
        kw = dict(local=local, track_range=track, max_abs=int(prof.abs().max()),
                  scratch=scratch)

        def k1():
            return interseq_cuda.interseq_pairs_cuda(prof, codes, lens, z, z, mr, 12, 1, **kw)

        out[key] = [c.cuda_ms(k1)[0] for _ in range(2)]
    return out


def flagship(c, dev, profile: bool) -> dict:
    import numpy as np
    import torch

    from libssa_tpu_torch import matrices
    from libssa_tpu_torch.ops import interseq_cuda
    from libssa_tpu_torch.search.manager import SearchEngine, SearchStats

    db = c.flagship_db()
    eng = SearchEngine(db, matrices.builtin("BLOSUM62"), 11, 1, device=dev)
    eng.prepare()
    rng = np.random.default_rng(7)
    queries = [rng.integers(0, 20, 256).astype(np.uint8) for _ in range(100)]
    eng.search_many(queries[:8], 10, local=True)  # warm-up
    res = {"q_subj_per_s": [], "wall_s": []}
    for _ in range(2):
        st = SearchStats()
        interseq_cuda.launches = 0
        t0 = time.perf_counter()
        hits = eng.search_many(queries, 10, local=True, stats=st)
        res["wall_s"].append(time.perf_counter() - t0)
        res["q_subj_per_s"].append(st.subjects / st.seconds)
    res["k1_launches"] = interseq_cuda.launches
    res["top_scores_q0"] = [int(x) for x in hits[0][0][:3]]
    for name, local in (("sw1_s", True), ("nw1_s", False)):
        times = []
        for _ in range(3):
            st = SearchStats()
            eng.search(queries[1], 10, local=local, stats=st)
            times.append(st.seconds)
        res[name] = min(times)
    res["sw1_gcups"] = 256 * db.total_residues / res["sw1_s"] / 1e9
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as trace

        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            eng.search_many(queries, 10, local=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        us: dict[str, float] = {}
        for e in p.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us[e.name] = us.get(e.name, 0.0) + e.device_time
        k1 = sum(v for k, v in us.items() if "k1" in k) / 1e6
        res["profile"] = {
            "wall_s": wall, "device_s": sum(us.values()) / 1e6, "k1_s": k1,
            "k1_share_of_wall": k1 / wall,
            "top_ms": sorted(((v / 1e3, k[:60]) for k, v in us.items()), reverse=True)[:6],
        }
    return res


def main(argv: list[str]) -> int:
    root = os.path.abspath(argv[0])
    sys.modules["jax"] = None
    sys.modules["libssa_tpu"] = None
    sys.path.insert(0, root)
    import torch

    import chip_smoke as c
    import libssa_tpu_torch

    if not libssa_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"imported {libssa_tpu_torch.__file__}, not the checkout at {root}")
    if not torch.cuda.is_available():
        raise SystemExit("k1_ab: CUDA is not available")
    dev = torch.device("cuda", 0)
    res = {"label": argv[1], "card": c.card_line(), "k1_ms": kernel_ms(c, dev)}
    res.update(flagship(c, dev, "--profile" in argv[2:]))
    print("RESULT", json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
