"""The port runs with JAX and the JAX package absent.

Each check runs in a fresh interpreter: ``tests/conftest.py`` imports JAX
into every test process, so only a subprocess can show that the port
never needs it. ``sys.modules["jax"] = None`` and
``sys.modules["libssa_tpu"] = None`` make any import of either raise, and
the child also asserts that no ``jax`` module was loaded. An AST scan of
the port's sources and ``chip_smoke.py`` refuses any import of
``libssa_tpu`` at all, even of a module that would not import JAX.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TESTDATA = ROOT / "tests" / "testdata"

_PRELUDE = """
import sys
sys.modules["jax"] = None
sys.modules["libssa_tpu"] = None
sys.path.insert(0, {root!r})
"""

_EPILOGUE = """
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not [m for m in loaded if sys.modules[m] is not None], loaded
"""

_API = """
import json
import torch
torch.set_num_threads(1)
from libssa_tpu_torch.constants import BitWidth, ComputeMode
import libssa_tpu_torch.api as ssa

ctx = ssa.SSAContext(device="cpu")
ctx.init_score_matrix("BLOSUM62")
ctx.init_gap_penalties(10, 1)
ctx.init_db_fasta({db!r})
q = ctx.init_sequence_fasta({query!r})
hits = ctx.sw_align(q, 5, BitWidth.BIT8, ComputeMode.ALIGNMENT)
print(json.dumps([[h.seq_id, h.score, h.cigar] for h in hits]))
"""

_CLI = """
import torch
torch.set_num_threads(1)
from libssa_tpu_torch import cli
rc = cli.main(["search", "--db", {db!r}, "--query", {query!r}, "-k", "3",
               "--json", "--device", "cpu"])
assert rc == 0, rc
"""

_SCORE = """
import json
import numpy as np
import torch
torch.set_num_threads(1)
from libssa_tpu_torch import matrices
from libssa_tpu_torch.constants import AlignType, ComputeMode
from libssa_tpu_torch.ops.scoring import make_profile
import libssa_tpu_torch.api as ssa
from libssa_tpu_torch import cli
from libssa_tpu_torch.ops import interseq

ctx = ssa.SSAContext(device="cpu")
ctx.init_score_matrix("BLOSUM62")
ctx.init_gap_penalties(10, 1)
q = ctx.init_sequence_fasta("MKVLAAGIVGWKQTE")
a = ctx.align_pair(q, "MKVIGAGWKQTE", AlignType.SW, ComputeMode.SCORE)
rc = cli.main(["pair", "--query", "MKVLAAGW", "--subject", "MKVIGAGW",
               "--device", "cpu", "--score-only"])
assert rc == 0, rc
prof = make_profile(np.arange(8, dtype=np.uint8), matrices.builtin("BLOSUM62").padded())
s = interseq.pair_scores_batch(
    torch.as_tensor(prof), torch.arange(24, dtype=torch.uint8).view(3, 8) % 20,
    torch.tensor([8, 5, 0], dtype=torch.int32), 11, 1)
print(json.dumps({{"hits": [a.score, *s.tolist()]}}))
"""


_TRACEBACK = """
import json
import torch
torch.set_num_threads(1)
from libssa_tpu_torch.constants import AlignType, ComputeMode
import libssa_tpu_torch.api as ssa
from libssa_tpu_torch.search import aligner, hirschberg

aligner.MATRIX_CELL_LIMIT = 100  # the linear-space aligner
hirschberg.LEAF_CELLS = 256
hirschberg.DEVICE_ON_CPU = True  # its levels on K2's plain version
hirschberg.DEVICE_MIN_CELLS = 1024
ctx = ssa.SSAContext(device="cpu")
ctx.init_score_matrix("BLOSUM62")
ctx.init_gap_penalties(10, 1)
q = ctx.init_sequence_fasta("MKVLAAGIVGWKQTERNDCFYHHWWKVLAAG" * 3)
hits = [ctx.align_pair(q, "AAGIVGWKQTEWWKVLAAGPPPRNDCFYH" * 2, at) for at in AlignType]
assert all(h.stats.aligner_dispatches > 0 for h in hits)
print(json.dumps({{"hits": [[h.score, h.cigar] for h in hits] * 2}}))
"""


_PROBES = """
import json
import torch
torch.set_num_threads(1)
from libssa_tpu_torch.experiments import op_rate_probe, r2_ilp_probe, r3_lp_bisect
from libssa_tpu_torch.experiments import (
    f_scan_probe, r2_kernel_golf, v6_probe, v7_probe, v8_probe)

q, s, mat = (torch.as_tensor(a) for a in r3_lp_bisect.pair(1024))
sw = r3_lp_bisect.plain(q[:300], s, mat, 11, 1, "full")
x = op_rate_probe.tile_input("bf16x2", 1, "cpu")[:, :16, :64]
tile = op_rate_probe.plain(x, "scanpass", 4, iters=2)
a, b = r2_ilp_probe.inputs("i16x2", 8, 64, "cpu")
chain = r2_ilp_probe.plain(a, b + 1, "dpmix_dpx", 5)
k1v = [int(mod.PROBE.plain(*mod.PROBE.inputs(40, "cpu", 6), next(iter(mod.VARIANTS)))[0].max())
       for mod in (f_scan_probe, v6_probe, v7_probe, v8_probe, r2_kernel_golf)]
print(json.dumps({{"hits": [sw, float(tile.max()), int(chain.max()), *k1v]}}))
"""


_SHARDED = """
import json
import torch
torch.set_num_threads(1)
import libssa_tpu_torch.api as ssa
from libssa_tpu_torch import cli
from libssa_tpu_torch.parallel.sharded import ShardedSearchEngine

ctx = ssa.SSAContext(device="cpu")
ctx.init_score_matrix("BLOSUM62")
ctx.init_gap_penalties(10, 1)
ctx.init_db_fasta({db!r})
ctx.set_device_count(2)
q = ctx.init_sequence_fasta({query!r})
hits = ctx.sw_align(q, 5)
assert isinstance(ctx._engine, ShardedSearchEngine)
rc = cli.main(["search", "--db", {db!r}, "--query", {query!r}, "-k", "3",
               "--devices", "2", "--device", "cpu"])
assert rc == 0, rc
print(json.dumps({{"hits": [[h.seq_id, h.score] for h in hits]}}))
"""


_RING = """
import json
import numpy as np
import torch
torch.set_num_threads(1)
from libssa_tpu_torch import matrices
from libssa_tpu_torch.parallel.ring import ring_score
from libssa_tpu_torch.parallel.ring_mm import ring_align_pair
from libssa_tpu_torch.parallel.sharded import make_db_mesh

b62 = matrices.builtin("BLOSUM62").padded()
rng = np.random.default_rng(7)
q = rng.integers(0, 20, 60).astype(np.uint8)
s = rng.integers(0, 20, 90).astype(np.uint8)
mesh = make_db_mesh(devices=["cpu"] * 3)
scores = [ring_score(q, s, b62, 10, 1, local, mesh, RB=16) for local in (True, False)]
tb = [ring_align_pair(q, s, b62, 10, 1, local, mesh=mesh, RB=16, ring_min_cells=1000)
      for local in (True, False)]
print(json.dumps({{"hits": [*scores, *[[t.score, t.cigar] for t in tb]]}}))
"""


def _run(body: str, tmp_path) -> subprocess.CompletedProcess:
    db = tmp_path / "proteins.fas"  # a private copy: packed-DB caches never race
    query = tmp_path / "query_prot.fas"
    shutil.copy(TESTDATA / db.name, db)
    shutil.copy(TESTDATA / query.name, query)
    code = (_PRELUDE.format(root=str(ROOT))
            + body.format(db=str(db), query=str(query)) + _EPILOGUE)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=tmp_path, env=env,
    )


@pytest.mark.parametrize("entry", ["api", "cli", "score", "traceback", "probes", "sharded",
                                   "ring"])
def test_port_runs_without_jax(tmp_path, entry):
    """Search (API, CLI), the 1-vs-1 score path (align_pair SCORE,
    ``pair --score-only``, pair_scores_batch), the linear-space traceback
    (ALIGNMENT-mode align_pair above MATRIX_CELL_LIMIT), the probes' plain
    versions, sharded search (API and CLI over 2 CPU shards) and the ring
    (``ring_score`` and ``ring_align_pair`` over 3 CPU shards)."""
    bodies = {"api": _API, "cli": _CLI, "score": _SCORE, "traceback": _TRACEBACK,
              "probes": _PROBES, "sharded": _SHARDED, "ring": _RING}
    proc = _run(bodies[entry], tmp_path)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    hits = out if entry == "api" else out["hits"]
    assert len(hits) >= 3
    if entry == "api":
        assert all(cigar for _, _, cigar in hits)


def _imports_of_reference(path: Path) -> list[str]:
    """Every module name ``path`` imports from the JAX package."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names if n == "libssa_tpu" or n.startswith("libssa_tpu.")]
    return found


def test_port_sources_never_import_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports libssa_tpu."""
    sources = sorted((ROOT / "libssa_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 20
    bad = {str(p.relative_to(ROOT)): names for p in sources
           if (names := _imports_of_reference(p))}
    assert not bad, bad


def _smoke(script: Path, cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        timeout=300, cwd=cwd, env=env,
    )


@pytest.mark.parametrize("alone", [False, True], ids=["in-repo", "alone"])
def test_chip_smoke_fails_without_card_or_port(tmp_path, alone):
    """No CUDA, or no port beside the script: non-zero exit, no result."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = _smoke(script, tmp_path)
    assert proc.returncode != 0
    assert proc.stdout == ""
