"""One run of one cell: the registry that finds a cell's files by name, and
the run that sets up, measures, checks and assembles the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name that BENCHMARK.json gives it:

  configs: the configuration entry's "file"
  port_bench/traffic/<traffic>.json    a mix: its driver ("kind") and parameters
  port_bench/limits/<workload>.json    a cell's compared numbers and their limits
  port_bench/metrics/<metric>.py       a metric's reader: read(run) → number or None
  port_bench/drivers/<kind>.py         the loop and check of a kind of traffic

so a later cell, configuration or metric is added by adding files and
entries, never by editing one.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

import torch

from port_bench import devtrace

BENCH_DIR = "port_bench"
BANNED = ("jax", "jaxlib", "flax", "parakeet_tpu")  # never loaded: top-level module names, compared whole


@dataclass
class Cell:
    name: str
    entry: dict  # the workload entry
    config: dict  # the configuration file
    traffic: dict  # the mix file
    limits: dict  # {number: {"limit": ..., ...}}


class Registry:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, rel: str) -> dict:
        return json.loads((self.root / rel).read_text())

    def cell(self, workload: str) -> Cell:
        entry = next((w for w in self.bench["workloads"] if w["name"] == workload), None)
        if entry is None:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        conf = next(c for c in self.bench["configs"] if c["name"] == entry["config"])
        limits = self.root / BENCH_DIR / "limits" / f"{workload}.json"
        return Cell(workload, entry, self._json(conf["file"]),
                    self._json(f"{BENCH_DIR}/traffic/{entry['traffic']}.json"),
                    json.loads(limits.read_text()) if limits.exists() else {})

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The cell's metrics of one kind: end to end untraced, per layer traced."""
        group = self.bench["per_layer"] if trace else self.bench["end_to_end"]
        return [m for m in group if workload in m.get("workloads", [workload])]

    def _module(self, kind: str, name: str):
        path = self.root / BENCH_DIR / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"port_bench_{kind}_{name}".replace(".", "_").replace("-", "_"),
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str):
        return self._module("metrics", metric).read

    def driver(self, kind: str):
        return self._module("drivers", kind)


@dataclass
class RunView:
    """What a metric's reader sees of one run."""

    cell: Cell
    setup_s: float
    window_s: float
    calls: list  # probe.CallRecord, every call of the window
    trace: devtrace.TraceSummary | None
    driver: object  # the driver instance (flops, failed)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown (nvidia-smi did not answer)"


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, started: float, *,
        device: str = "cuda", system: str = "program") -> dict:
    """Set up, warm, measure and check one run of a cell; the result line's
    object. `started` is the process's start on the perf_counter clock."""
    reg = Registry(root)
    cell = reg.cell(workload)
    kind = cell.traffic["kind"]  # a mix's driver: drivers/<kind>.py, whose Driver runs it
    drv = reg.driver(kind).Driver(cell, seed, device, system=system, trace=trace, log=log)
    drv.setup()
    drv.warm()
    window = None
    if trace:
        devtrace.warm_profiler()
        window = devtrace.TraceWindow()
    calls, t_start, summary = drv.window(seconds, window)
    setup_s = t_start - started - drv.reference_s  # the reference's seconds in set-up are not the program's
    window_s = calls[-1].t1 - t_start
    on_card = torch.device(device).type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    view = RunView(cell, setup_s, window_s, calls, summary, drv)
    metrics = {}
    for m in reg.metrics(workload, trace):
        value = reg.reader(m["name"])(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = sum(len(r.clips) for r in calls)
    failed = sum(len(r.clips) for r in calls if drv.failed(r))
    log(f"{workload} seed {seed}: {len(calls)} calls, {attempted} clips, {failed} failed; set-up {setup_s:.3f} s, "
        f"window {window_s:.3f} s; {drv.tokens_per_audio_s(calls):.3f} tokens per audio second; "
        f"the reference's blank-bias scoring {drv.reference_s:.3f} s, outside set-up")
    drv.release()
    numbers = drv.check(calls)
    checks, correct = {}, failed == 0
    for name, value in numbers.items():
        limit = cell.limits.get(name, {}).get("limit")
        checks[name] = {"value": value, "limit": limit}
        correct = correct and value is not None and limit is not None and value <= limit
    card = card_line() if on_card else "cpu"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak, "card": card}
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    log(f"card: {card}")
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    return result
