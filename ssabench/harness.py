"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell needs is found by name from its ``BENCHMARK.json``
entry: the configuration's file, the traffic file
``ssabench/traffic/<traffic>.json``, the generator
``ssabench/mixes/<kind>.py`` that file names, and one module a metric,
``ssabench/e2e/<metric>.py`` (end to end, ``--trace 0``) or
``ssabench/metrics/<metric>.py`` (per layer, ``--trace 1``), each with
``read(run) -> float | None``.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
MANIFEST = "BENCHMARK.json"


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_manifest(root: Path) -> dict:
    with open(root / MANIFEST) as fh:
        return json.load(fh)


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in {MANIFEST}")


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_reader(kind: str, name: str):
    """The ``read`` function of ``ssabench/<kind>/<name>.py``."""
    path = PACKAGE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"ssabench.{kind}.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What a metric reads: the cell's entries, the window's calls, the
    mix (its inputs and the port's counters) and, traced, the summary."""

    cell: dict
    config: dict
    traffic: dict
    mix: object
    setup_s: float
    start: float = 0.0
    end: float = 0.0
    calls: list = field(default_factory=list)  # (t0, t1, work or None)
    summary: object = None

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def total(self, key: str) -> int:
        return sum(w.get(key, 0) for _, _, w in self.calls if w)

    def latencies_ms(self, key: str = "requests") -> list[float]:
        """One latency a unit of ``key`` (a call of 32 queries gives 32)."""
        out = []
        for t0, t1, w in self.calls:
            if w:
                out += [(t1 - t0) * 1e3] * w.get(key, 0)
        return out


def last_line(tb: str) -> str:
    """The exception's own line of a formatted traceback."""
    return tb.strip().splitlines()[-1]


def card_line() -> str:
    """The card's name, clocks and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, control: bool = False) -> dict:
    """The result object of one run (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, traced ``breakdown``, and ``checks`` last).
    ``control`` also reads the control's numbers (``control``)."""
    import torch

    manifest = load_manifest(root)
    cell = find(manifest["workloads"], name, "workload")
    config_entry = find(manifest["configs"], cell["config"], "config")
    with open(root / config_entry["file"]) as fh:
        config = json.load(fh)
    with open(root / "ssabench" / "traffic" / f"{cell['traffic']}.json") as fh:
        traffic = json.load(fh)
    section = "per_layer" if trace else "end_to_end"
    wanted = [m for m in manifest[section] if applies(m, name)]
    readers = {m["name"]: load_reader("metrics" if trace else "e2e", m["name"]) for m in wanted}
    cuda = device != "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    mix = importlib.import_module(f"ssabench.mixes.{traffic['kind']}").Mix(
        config, traffic, seed, device)
    mix.warm()
    sync()
    run = Run(cell, config, traffic, mix, setup_s=time.perf_counter() - t_start)
    say(f"{name}: seed {seed}, set-up {run.setup_s:.3f} s")

    prof = None
    failed, done, first_error = 0, [], None
    with contextlib.ExitStack() as stack:
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            from . import spans

            say(f"card: {card_line()}")
            stack.enter_context(spans.installed())
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = stack.enter_context(profile(activities=acts))
            torch.zeros(1, device=device).add_(1)
            sync()
            stack.enter_context(record_function("ssabench.window"))
        run.start = time.perf_counter()
        i = 0
        while True:
            t0 = time.perf_counter()
            try:
                with (record_function(f"ssabench.{traffic['entry']}") if trace
                      else contextlib.nullcontext()):
                    work = mix.call(i)
                sync()
                done += mix.requests(i)
            except Exception:  # a request that fails counts as failed; the loop goes on
                work = None
                failed += len(mix.requests(i))
                first_error = first_error or traceback.format_exc()
            t1 = time.perf_counter()
            run.calls.append((t0, t1, work))
            i += 1
            if t1 - run.start >= seconds:
                break
        run.end = time.perf_counter()
    if prof is not None:
        from .trace import from_profiler

        run.summary = from_profiler(prof)
    if first_error:
        say(f"first failed request:\n{first_error}")

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)) if cuda else 0}
    if run.summary is not None:
        dev["busy_s"] = run.summary.busy_s
        dev["window_s"] = run.summary.window_s

    metrics = {}
    for m in wanted:
        value = readers[m["name"]](run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    for key in ("queries", "pairs"):
        if run.total(key):
            say(f"window {run.window_s:.3f} s: {len(run.calls)} calls, {run.total(key)} {key}")

    checks, check_error = {}, None
    try:  # a fault of the program can leave the device unusable: the run still reports
        mix.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = mix.check(done) if done else {}
        say(f"check: {time.perf_counter() - t_check:.3f} s")
    except Exception:
        check_error = traceback.format_exc()
        say(f"the check did not run:\n{check_error}")
    attempted = failed + len(done)
    if first_error or check_error:
        say(f"failed {failed} of {attempted} requests"
            + (f"; the first: {last_line(first_error)}" if first_error else "")
            + (f"; the check: {last_line(check_error)}" if check_error else ""))
    correct = bool(done) and failed == 0 and check_error is None and all(
        c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if run.summary is not None:
        result["breakdown"] = run.summary.breakdown()
    if control:  # the reference at the control's precision in the program's place
        result["control"] = mix.check(done, saturate=traffic["control"]) if done else {}
    result["checks"] = checks
    return result
