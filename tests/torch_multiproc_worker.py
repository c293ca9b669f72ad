"""Worker of tests/test_torch_multiproc.py: one rank of a gloo job.

    python torch_multiproc_worker.py <rank> <world> <port>

Each rank owns 2 CPU shards of one ``make_db_mesh`` spanning every rank
(rank-major, 2 x world shards). Every check runs in every rank: the
port's sharded engine must give the hits of the per-rank single-device
engine on ``search`` (SW, NW, the BIT8 ladder with a real overflow, the
BIT64 lane), ``search_many`` (mixed heights, and with a fault injected in
one rank only), ``search_reduced`` (translated DB) and the API's
``set_device_count``. Prints ``[rank] TORCH_MULTIPROC_OK`` on success.
"""
import os
import sys
import tempfile


def _same(a, b):
    import numpy as np

    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def main() -> int:
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    sys.modules["jax"] = None  # the port runs without JAX
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    from libssa_tpu_torch import alphabet, matrices
    from libssa_tpu_torch.api import SSAContext
    from libssa_tpu_torch.constants import BitWidth, SymType
    from libssa_tpu_torch.io import fasta
    from libssa_tpu_torch.io.db import SequenceDB
    from libssa_tpu_torch.parallel.sharded import ShardedSearchEngine, make_db_mesh
    from libssa_tpu_torch.search.manager import SearchEngine, SearchParams

    B62 = matrices.builtin("BLOSUM62")
    rng = np.random.default_rng(101)  # the same stream in every rank
    seqs = [rng.integers(0, 20, int(rng.integers(5, 70))).astype(np.uint8) for _ in range(61)]
    db = SequenceDB.from_sequences([f"s{i}" for i in range(61)], seqs, SymType.AMINOACID)
    params = SearchParams(batch_size=16)
    single = SearchEngine(db, B62, 10, 1, params, device="cpu")
    mesh = make_db_mesh(devices=["cpu", "cpu"])
    assert mesh.size == 2 * world and sorted(mesh.local) == [2 * rank, 2 * rank + 1]
    sharded = ShardedSearchEngine(db, B62, 10, 1, mesh, params)

    q = rng.integers(0, 20, 23).astype(np.uint8)
    for local in (True, False):
        for bw in (BitWidth.EXACT, BitWidth.BIT64):
            _same(sharded.search(q, 9, local, bw), single.search(q, 9, local, bw))

    # BIT8 with a real overflow (a 70+-residue self-hit scores > 255).
    long_seqs = [rng.integers(0, 20, int(rng.integers(70, 90))).astype(np.uint8)
                 for _ in range(12)]
    ldb = SequenceDB.from_sequences([f"l{i}" for i in range(12)], long_seqs, SymType.AMINOACID)
    lq = ldb.sequence(4).copy()
    got = ShardedSearchEngine(ldb, B62, 10, 1, mesh, params).search(lq, 5, True, BitWidth.BIT8)
    _same(got, SearchEngine(ldb, B62, 10, 1, params, device="cpu").search(
        lq, 5, True, BitWidth.BIT8))
    assert got[1][0] == 4 and got[0][0] > 255

    queries = [rng.integers(0, 20, int(n)).astype(np.uint8) for n in (21, 40, 33)]
    want = single.search_many(queries, 7, True)
    for g, w in zip(sharded.search_many(queries, 7, True), want):
        _same(g, w)

    # A fault in this rank only: its chunks re-queue, the collectives
    # stay in step with the other ranks, and the hits do not change.
    def boom(idx):
        if rank == 1 and idx == 0:
            raise RuntimeError("injected device failure")

    sharded.fault_injector = boom
    for g, w in zip(sharded.search_many(queries, 7, True), want):
        _same(g, w)
    _same(sharded.search(q, 9, True), single.search(q, 9, True))
    assert (sharded.requeued_chunks > 0) == (rank == 1)
    sharded.fault_injector = None

    nt = [rng.integers(0, 4, int(n)).astype(np.uint8) for n in rng.integers(12, 120, size=20)]
    ntdb = SequenceDB.from_sequences([f"nt{i}" for i in range(20)], nt, SymType.NUCLEOTIDE)
    tdb, orig, _ = ntdb.translated(1)
    frames = [rng.integers(0, 20, int(n)).astype(np.uint8) for n in (14, 21)]
    got = ShardedSearchEngine(tdb, B62, 10, 1, mesh, params).search_reduced(frames, orig, 6, True)
    assert got is not None
    _same(got, SearchEngine(tdb, B62, 10, 1, params, device="cpu").search_reduced(
        frames, orig, 6, True))

    # The API: set_device_count(2 x world) puts two shards on each rank.
    path = os.path.join(tempfile.mkdtemp(), "db.fas")
    fasta.write_fasta(path, [(f"s{i}", alphabet.decode(s, SymType.AMINOACID))
                             for i, s in enumerate(seqs)])
    hits = []
    for n in (None, 2 * world):
        ctx = SSAContext(device="cpu")
        ctx.init_score_matrix("BLOSUM62")
        ctx.init_gap_penalties(10, 1)
        ctx.init_db_fasta(path)
        ctx.set_device_count(n)
        qq = ctx.init_sequence_fasta(alphabet.decode(q, SymType.AMINOACID))
        hits.append([(h.seq_id, h.score) for h in ctx.sw_align(qq, 5)])
        assert isinstance(ctx._engine, ShardedSearchEngine) == (n is not None)
    assert hits[0] == hits[1]

    dist.destroy_process_group()
    print(f"[{rank}] TORCH_MULTIPROC_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
