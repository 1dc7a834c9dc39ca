"""The run contract: one cell, one seed, one window, one result line.

``run`` loads the cell (``workloads/<cell>.json``) and its
configuration (``configs/<config>.json``), checks the card, hands both
to the cell's driver (``drivers/<driver>.py``), reads each per-layer
metric of the cell with its reader (``metrics/<metric>.py``) in a traced
run, checks that no JAX module was loaded by then (in this process; a
data-parallel driver checks its rank processes), and prints the
comparisons that decided ``correct`` (last on standard error) and the result (last
on standard output). Which metrics a cell reports comes from
``BENCHMARK.json``: the end-to-end metrics (``--trace 0``) or per-layer
metrics (``--trace 1``) whose ``workloads`` list the cell, or that have
no such list.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from .trace import DeviceTrace, Spans, TraceSummary

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded in a benchmark process
BANNED = ("jax", "jaxlib", "flax", "optax", "musicgeneration_tpu")


class RunFailure(Exception):
    """The run cannot give a result (no card, the program missing, a JAX
    module loaded): exit non-zero, print no result."""


def read_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> Dict:
    """The cell's file with its configuration under ``"config_data"``."""
    path = os.path.join(HERE, "workloads", f"{name}.json")
    if not os.path.exists(path):
        raise RunFailure(f"no cell {name!r} ({path})")
    cell = read_json(path)
    cell["config_data"] = read_json(
        os.path.join(HERE, "configs", f"{cell['config']}.json"))
    return cell


def loaded_banned() -> List[str]:
    """The banned top-level module names in ``sys.modules``, compared
    whole (``musicgeneration_tpu_torch`` is not ``musicgeneration_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(BANNED))


def check_program() -> None:
    """The program (the PyTorch port) is importable from this checkout."""
    try:
        import musicgeneration_tpu_torch as pkg
    except ImportError as e:
        raise RunFailure(f"the program is not in this checkout: {e}")
    where = os.path.dirname(os.path.abspath(pkg.__file__))
    if os.path.dirname(where) != ROOT:
        raise RunFailure(f"musicgeneration_tpu_torch was imported from "
                         f"{where}, not from this checkout ({ROOT})")


def gpu_power_limit() -> Optional[str]:
    """The first card's name and power limit, as nvidia-smi gives them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


@dataclasses.dataclass
class Run:
    """What a driver gets, and what it fills in."""
    cell: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float                          # process start (perf_counter)
    spans: Spans = dataclasses.field(default_factory=Spans)
    counters: Dict[str, Any] = dataclasses.field(default_factory=dict)
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    checks: List[Dict] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    setup_s: float = 0.0
    window_lo_ns: int = 0
    window_hi_ns: int = 0
    trace_summary: Optional[TraceSummary] = None
    device_busy_s: Optional[float] = None   # mean over cards, if several
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def config(self) -> Dict:
        return self.cell["config_data"]

    @contextlib.contextmanager
    def phase(self, label: str):
        """A span of the run's own set-up, named ``label``."""
        a = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.add(label, a, time.perf_counter_ns())

    def set_up_done(self) -> None:
        """Set-up ends here: ``setup_s`` is process start to now."""
        self.setup_s = time.perf_counter() - self.t0

    def open_window(self, tracer: DeviceTrace) -> None:
        if self.trace:
            tracer.start()
        self.window_lo_ns = time.perf_counter_ns()

    def close_window(self, tracer: DeviceTrace) -> None:
        """The window ends now; with ``trace`` the device's events are
        read, and in any case the peak memory."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.window_hi_ns = time.perf_counter_ns()
        if self.trace:
            tracer.stop()
            self.trace_summary = tracer.summary(
                self.window_lo_ns, self.window_hi_ns, self.spans)
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    @property
    def window_s(self) -> float:
        return (self.window_hi_ns - self.window_lo_ns) / 1e9

    def check(self, name: str, value: float, limit: float) -> None:
        """One number compared with its limit (correct if value <=
        limit)."""
        self.checks.append({"name": name, "value": float(value),
                            "limit": float(limit)})


def _load_path(path: str):
    name = "port_bench_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_for(cell: Dict):
    """The cell's driver module, imported by name (a data-parallel
    driver's rank processes import it again)."""
    return importlib.import_module(f"port_bench.drivers.{cell['driver']}")


def metric_reader(name: str):
    return _load_path(os.path.join(HERE, "metrics", f"{name}.py"))


def cell_metrics(bench: Dict, cell: str, key: str) -> List[Dict]:
    """The entries of ``bench[key]`` that cell ``cell`` reports."""
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


def execute(run: Run) -> Run:
    """Drive the cell once, in this process."""
    driver_for(run.cell).run(run)
    return run


def result_line(run: Run, bench: Dict) -> Dict:
    """The result object; per-layer metrics read from the run with
    ``trace``, end-to-end ones from the driver otherwise."""
    name = run.cell["name"]
    metrics: Dict[str, Dict] = {}
    if run.trace:
        for m in cell_metrics(bench, name, "per_layer"):
            value = metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, name, "end_to_end"):
            # a name split by cell (``train_tokens_per_s.dp4``) reads the
            # quantity the driver gives under the name before the dot
            value = (run.setup_s if m["name"] == "setup_s"
                     else run.e2e.get(m["name"],
                                      run.e2e.get(m["name"].split(".")[0])))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(run.device)
                       if run.device.type == "cuda" else "cpu"),
              "count": int(run.cell["chips"]),
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": bool(run.checks) and all(
        c["value"] <= c["limit"] for c in run.checks),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.trace and run.trace_summary is not None:
        s = run.trace_summary
        device["busy_s"] = (run.device_busy_s if run.device_busy_s
                            is not None else s.busy_s())
        device["window_s"] = s.window_s
        out["breakdown"] = {"device_ops": s.device_ops(),
                            "idle_gaps": s.idle_gaps()}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in run.checks}
    phases = [(n, (b - a) / 1e9) for n, a, b in run.spans.items
              if n.startswith("setup.")]
    if phases:
        print("set-up: " + ", ".join(f"{n[6:]} {s:.3f} s" for n, s in phases)
              + f"; process start to window {run.setup_s:.3f} s",
              file=sys.stderr)
    return out


def run(name: str, seed: int, seconds: float, trace: bool,
        t0: float) -> Dict:
    """One run of cell ``name`` on the card; raises RunFailure where no
    result may be printed."""
    cell = load_cell(name)
    bench = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    check_program()
    if not torch.cuda.is_available():
        raise RunFailure("no CUDA device")
    if torch.cuda.device_count() < int(cell["chips"]):
        raise RunFailure(f"{name} needs {cell['chips']} cards; "
                         f"{torch.cuda.device_count()} present")
    r = Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
            device=torch.device("cuda", 0), t0=t0)
    r.spans.add("setup.imports", int(t0 * 1e9), time.perf_counter_ns())
    execute(r)
    return finish(r, bench)


def finish(run: Run, bench: Dict) -> Dict:
    """The result line, once the metric readers have run; raises
    RunFailure if a JAX module is loaded in this process by then."""
    out = result_line(run, bench)
    bad = loaded_banned()
    if bad:
        raise RunFailure(f"JAX modules loaded in the benchmark process: "
                         f"{bad}")
    return out


def emit(result: Dict) -> None:
    """The comparisons as the last lines of standard error, the result
    as the last line of standard output."""
    lim = gpu_power_limit()
    if lim:
        print(f"card: {lim}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
