"""The port's sharded search and ring across two processes (gloo on the CPU).

Mirrors tests/test_multiproc.py: two OS processes, each owning 2 CPU
shards, join one 4-shard mesh through ``torch.distributed``; each worker
(tests/torch_multiproc_worker.py) asserts that ``search``, ``search_many``,
``search_reduced``, the BIT64 lane and ``set_device_count`` give the
single-device engine's hits. The ring's workers
(tests/torch_ring_worker.py) assert that ``ring_score`` and
``ring_align_pair`` over meshes spanning both processes give the oracle's
score and ``align_pair_linear``'s alignment. Each worker has 180 s and is
killed after.
"""
import os
import socket
import subprocess
import sys


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(name: str, marker: str):
    """Two ranks of ``tests/<name>``; each must exit 0 and print ``marker``."""
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), name)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(worker))))
    procs = [
        subprocess.Popen([sys.executable, worker, str(i), "2", str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"[{i}] {marker}" in out, f"worker {i} output:\n{out}"


def test_two_process_sharded_search():
    _run_workers("torch_multiproc_worker.py", "TORCH_MULTIPROC_OK")


def test_two_process_ring():
    _run_workers("torch_ring_worker.py", "TORCH_RING_OK")
