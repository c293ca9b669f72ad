"""End-to-end walkthrough of the PyTorch/CUDA port: every capability in one script.

Runs on the card by default; ``--device cpu`` runs it on the CPU (the
kernels' plain PyTorch versions):

    python examples/torch_database_search.py [--device cpu]

The counterpart of ``examples/database_search.py``, in the same order and
on the same fixtures: configuration, protein SW search with the adaptive
precision ladder and tracebacks, NW search, constant-scoring nucleotide
search on both strands, a translated (blastx-style) search, multi-query
batching, the sharded engine, and a long pair (linear-space traceback and
the ring score with the subject sharded over a mesh). Database search runs
on K1 (``csrc/interseq.cu``), the linear-space traceback's large levels
and the ring on K2 (``csrc/ring_block.cu``). Exits non-zero where the
ring's score differs from the traceback's.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import libssa_tpu_torch.api as ssa
from libssa_tpu_torch.constants import BitWidth, ComputeMode, Strand, SymType

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests", "testdata")


def banner(t):
    print(f"\n=== {t} " + "=" * max(0, 60 - len(t)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--devices", type=int, default=None,
                    help="devices of the mesh in sections 6 and 7 (default: every "
                         "device; the CPU counts as one a core)")
    args = ap.parse_args(argv)
    device = args.device
    ssa.init_device(device)

    # -- 1. Protein database search (SW, 8-bit ladder, tracebacks) ---------
    banner("SW protein search, BIT8 ladder, top-5 with alignments")
    ssa.init_symbol_translation(SymType.AMINOACID, Strand.FORWARD, 1, 1)
    ssa.init_score_matrix("BLOSUM62")
    ssa.init_gap_penalties(11, 1)
    ssa.init_db_fasta(os.path.join(DATA, "proteins.fas"))
    query = ssa.init_sequence_fasta(os.path.join(DATA, "query_prot.fas"))
    hits = ssa.sw_align(query, k=5, bit_width=BitWidth.BIT8, mode=ComputeMode.ALIGNMENT)
    for h in hits:
        print(f"  #{h.seq_id:<3d} score={h.score:<5d} {h.cigar[:40]:40s} {h.header}")
    print(f"  stats: {hits.stats.cells/1e6:.1f} Mcells, rescored={hits.stats.rescored}")

    # -- 2. Global alignment search (NW) -----------------------------------
    banner("NW global search, top-3 scores")
    for h in ssa.nw_align(query, k=3, bit_width=BitWidth.BIT16):
        print(f"  #{h.seq_id:<3d} score={h.score:<6d} {h.header}")

    # -- 3. Nucleotide search, constant scoring, both strands --------------
    banner("Nucleotide search, match/mismatch scoring, both strands")
    ssa.init_symbol_translation(SymType.NUCLEOTIDE, Strand.BOTH, 1, 1)
    ssa.init_constant_scoring(5, -4)
    ssa.init_gap_penalties(10, 2)
    ssa.init_db_fasta(os.path.join(DATA, "nucleotides.fas"))
    ntq = ssa.init_sequence_fasta(os.path.join(DATA, "query_nt.fas"))
    for h in ssa.sw_align(ntq, k=3):
        print(f"  #{h.seq_id:<3d} score={h.score:<5d} strand={h.strand} {h.header}")

    # -- 4. Translated search (nucleotide query vs protein DB) -------------
    banner("Translated search: 6-frame nucleotide query vs protein matrix")
    ssa.init_symbol_translation(SymType.NUCLEOTIDE, Strand.BOTH, 1, 1,
                                db_symtype=SymType.AMINOACID)
    ssa.init_score_matrix("BLOSUM62")
    ssa.init_gap_penalties(11, 1)
    ssa.init_db_fasta(os.path.join(DATA, "proteins.fas"))
    tq = ssa.init_sequence_fasta(os.path.join(DATA, "query_nt.fas"))
    for h in ssa.sw_align(tq, k=3):
        print(f"  #{h.seq_id:<3d} score={h.score:<5d} frame={h.strand} {h.header}")

    # -- 5. Multi-query batched sweep --------------------------------------
    banner("Multi-query batched search (one device sweep)")
    ssa.init_symbol_translation(SymType.AMINOACID, Strand.FORWARD, 1, 1)
    ssa.init_score_matrix("BLOSUM62")
    ssa.init_gap_penalties(11, 1)
    ssa.init_db_fasta(os.path.join(DATA, "proteins.fas"))
    queries = ssa.init_sequences_fasta(os.path.join(DATA, "proteins.fas"))[:4]
    for q, hl in zip(queries, ssa.align_many(queries, k=1)):
        h = hl[0]
        print(f"  {q.header[:28]:28s} -> #{h.seq_id} score={h.score}")

    # -- 6. Sharded engine --------------------------------------------------
    banner("Sharded mesh search (all attached devices)")
    from libssa_tpu_torch import matrices
    from libssa_tpu_torch.io.db import SequenceDB
    from libssa_tpu_torch.parallel.sharded import (
        ShardedSearchEngine, local_devices, make_db_mesh)

    db = SequenceDB.from_fasta(os.path.join(DATA, "proteins.fas"), SymType.AMINOACID)
    mesh = make_db_mesh(args.devices, devices=local_devices(device))
    eng = ShardedSearchEngine(db, matrices.builtin("BLOSUM62"), 11, 1, mesh=mesh)
    top_s, top_i = eng.search(queries[0].sequences[0][1], 3)
    print(f"  mesh devices: {mesh.size}; top-3: {list(zip(top_i.tolist(), top_s.tolist()))}")

    # -- 7. Long pairs: linear-space traceback + mesh-spanning score -------
    banner("Long-pair alignment (O(m+n) traceback; ring score across mesh)")
    rng = np.random.default_rng(0)
    qc = rng.integers(0, 20, 3000).astype(np.uint8)
    sc = rng.integers(0, 20, 8000).astype(np.uint8)
    sc[2000:2600] = qc[1000:1600]  # planted homologous region
    from libssa_tpu_torch.parallel.ring import ring_score
    from libssa_tpu_torch.search.aligner import align_pair

    tb = align_pair(qc, sc, matrices.builtin("BLOSUM62").scores, 11, 1, local=True,
                    device=device)
    print(f"  Myers-Miller SW: score={tb.score} q[{tb.q_begin}:{tb.q_end}] "
          f"s[{tb.s_begin}:{tb.s_end}] ({len(tb.cigar)} ops)")
    rs = ring_score(qc, sc, matrices.builtin("BLOSUM62").padded(), 11, 1, local=True,
                    mesh=mesh)
    print(f"  ring (subject sharded over {mesh.size} device(s)): score={rs} "
          f"{'== traceback' if rs == tb.score else 'MISMATCH!'}")
    if rs != tb.score:
        print(f"ring score {rs} != traceback score {tb.score}", file=sys.stderr)
        return 1

    ssa.ssa_exit()
    print("\nAll sections completed.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
