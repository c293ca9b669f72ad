"""Genome-scale pairwise alignment on the PyTorch/CUDA port: one enormous pair.

The classic long-pair workload is two DNA sequences (contigs,
mitochondrial genomes, viral isolates) scored and aligned as ONE optimal
Gotoh alignment: no database, no chunking. This walks the port's
machinery for it:

  * the score alone on K3 (``csrc/longpair.cu`` through
    ``ops/longpair_cuda.py``): W stripes of 32 x 4 query rows a block,
    their edges through shared memory, and a reader and a writer warp
    passing the edge between blocks in global memory, so any m and n run
    in one launch with O(n) device memory;
  * the full traceback in O(m + n) memory: Myers-Miller divide and conquer
    (``search/hirschberg.py``) whose large levels run their forward and
    reverse row passes as tiles on K2 (``csrc/ring_block.cu``) through
    ``ops/mm_device.DevicePair``, with small leaves on the host.

Runs on the card by default:

    python examples/torch_genome_pair.py [--device cpu] [length]

(length defaults to 16384; ``--device cpu`` runs the kernels' plain
PyTorch versions, which take seconds at that length.)
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import libssa_tpu_torch.api as ssa
from libssa_tpu_torch.constants import AlignType, ComputeMode, SymType


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("length", type=int, nargs="?", default=16384)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    N = args.length

    # Two related "genomes": a sequence and a mutated copy (5% substitutions,
    # a handful of indels): enough homology for a long central alignment.
    rng = np.random.default_rng(0)
    a = rng.choice(list("ACGT"), N)
    b = a.copy()
    sub = rng.random(N) < 0.05
    b[sub] = rng.choice(list("ACGT"), int(sub.sum()))
    cut = rng.integers(0, N - 50, 8)
    keep = np.ones(N, bool)
    for c in cut:
        keep[c : c + int(rng.integers(3, 30))] = False
    qs, ss = "".join(a), "".join(b[keep])

    ssa.init_device(args.device)
    ssa.init_symbol_translation(SymType.NUCLEOTIDE)
    ssa.init_constant_scoring(2, -3)  # classic megablast-style scoring
    ssa.init_gap_penalties(5, 2)
    q = ssa.init_sequence_fasta(">genomeA\n" + qs)

    # -- 1. Score only: K3 -------------------------------------------------
    t0 = time.perf_counter()
    hit = ssa.align_pair(q, ss, align_type=AlignType.SW, mode=ComputeMode.SCORE)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    hit = ssa.align_pair(q, ss, align_type=AlignType.SW, mode=ComputeMode.SCORE)
    dt = time.perf_counter() - t0
    cells = len(qs) * len(ss)
    print(f"SW score {hit.score}  ({len(qs)} x {len(ss)} = {cells/1e9:.2f} Gcells; "
          f"warm {dt*1e3:.0f} ms = {cells/dt/1e9:.1f} GCUPS incl. dispatch, "
          f"first call {warm:.1f}s with the build)")

    # -- 2. Full optimal traceback in O(m+n) memory ------------------------
    t0 = time.perf_counter()
    aln = ssa.align_pair(q, ss, align_type=AlignType.SW, mode=ComputeMode.ALIGNMENT)
    dt = time.perf_counter() - t0
    ident = aln.aligned[1].count("|") / max(1, len(aln.aligned[1]))
    print(f"traceback: score {aln.score} q[{aln.q_begin}:{aln.q_end}] "
          f"s[{aln.s_begin}:{aln.s_end}] identity {ident:.1%} "
          f"cigar {len(aln.cigar)} chars  ({dt:.1f}s)")
    assert aln.score == hit.score, "traceback score must equal the kernel score"

    ssa.ssa_exit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
