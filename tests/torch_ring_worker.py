"""Worker of tests/test_torch_multiproc.py: one rank of a gloo ring job.

    python torch_ring_worker.py <rank> <world> <port>

Each rank owns CPU shards of ``make_db_mesh`` meshes spanning every rank
(rank-major): 2 shards a rank, and 1 on rank 0 with 3 on the others. In
every rank, ``ring_score`` (SW and NW, with empty shards and n < D among
the shapes) must equal the NumPy oracle and the same call on a mesh of one
process, and ``ring_align_pair`` (SW and NW, ring divides on levels 0 and
1) must equal ``align_pair_linear`` field for field. Prints ``[rank]
TORCH_RING_OK`` on success.
"""
import sys


def main() -> int:
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    sys.modules["jax"] = None  # the port runs without JAX
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    from libssa_tpu_torch import matrices, oracle
    from libssa_tpu_torch.parallel import ring
    from libssa_tpu_torch.parallel.ring import ring_score
    from libssa_tpu_torch.parallel.ring_mm import ring_align_pair
    from libssa_tpu_torch.parallel.sharded import DBMesh, make_db_mesh
    from libssa_tpu_torch.search import hirschberg
    from libssa_tpu_torch.search.manager import SearchStats

    B62 = matrices.builtin("BLOSUM62")
    rng = np.random.default_rng(131)  # the same stream in every rank
    even = make_db_mesh(devices=["cpu", "cpu"])
    uneven = make_db_mesh(devices=["cpu"] * (1 if rank == 0 else 3))
    assert even.size == 2 * world and even.rank_shards == (2,) * world
    assert uneven.rank_shards == (1,) + (3,) * (world - 1)
    for mesh in (even, uneven):
        one = DBMesh(mesh.size, {d: torch.device("cpu") for d in range(mesh.size)},
                     None, (mesh.size,))
        D = mesh.size
        W = 3
        for m, n, RB in ((70, 250, 16), (33, (D - 1) * W, 8), (20, D - 1, 32), (5, 1, 2)):
            q = rng.integers(0, 20, m).astype(np.uint8)
            s = rng.integers(0, 20, n).astype(np.uint8)
            for local in (True, False):
                want = (oracle.sw_score if local else oracle.nw_score)(q, s, B62.scores, 10, 1)
                ring.phases = 0
                got = ring_score(q, s, B62.padded(), 10, 1, local, mesh, RB)
                assert got == want, (mesh.rank_shards, m, n, local, got, want)
                assert ring.phases == -(-m // RB) + D - 1
                assert ring_score(q, s, B62.padded(), 10, 1, local, one, RB) == want

    hirschberg.LEAF_CELLS = 512  # every ring node is a divide in align_pair_linear too
    q = rng.integers(0, 20, 200).astype(np.uint8)
    s = rng.integers(0, 20, 333).astype(np.uint8)
    s[40:180] = q[30:170]
    for mesh in (even, uneven):
        for local in (True, False):
            st = SearchStats()
            # SW aligns the homologous block, about 140 x 140: level 1's
            # nodes are about 4,900 cells, NW's about 16,600.
            got = ring_align_pair(q, s, B62.padded(), 11, 1, local, mesh=mesh, RB=24,
                                  ring_min_cells=4_000 if local else 10_000, stats=st)
            want = hirschberg.align_pair_linear(q, s, B62.padded(), 11, 1, local,
                                                device="cpu")
            assert got == want, (mesh.rank_shards, local)
            assert st.aligner_dispatches >= 3 + 2 * local  # levels 0 and 1 on the ring

    dist.destroy_process_group()
    print(f"[{rank}] TORCH_RING_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
