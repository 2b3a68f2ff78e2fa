"""Finding a cell's files by name, and the state one run carries."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from h100_bench.common.trace import Spans

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def traffic(name: str) -> dict:
    """``workloads/<name>.json``: the cell's driver and traffic parameters."""
    return load_json(BENCH_DIR / "workloads" / f"{name}.json")


def cell(name: str) -> Tuple[dict, dict, dict]:
    """(the cell's entry in BENCHMARK.json, its configuration file, its
    traffic file ``workloads/<name>.json``)."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return entry, load_json(ROOT / conf["file"]), traffic(name)


def driver(name: str):
    return importlib.import_module(f"h100_bench.drivers.{name}")


def metric_reader(name: str):
    """``metrics/<name>.py``, loaded from its path (metric names hold dots)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(name: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries that cell ``name`` reports:
    those that list it, and those without a list whose end-to-end metric the
    cell reports."""
    bench = benchmark()
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


@dataclasses.dataclass
class Run:
    """One run of one cell: its inputs, what the window measured, and the checks."""

    workload: str
    entry: dict
    config: dict
    params: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    tmp: Path
    state: Dict[str, Any] = dataclasses.field(default_factory=dict)
    spans: Spans = dataclasses.field(default_factory=Spans)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernels: list = dataclasses.field(default_factory=list)
    trace_t0_ns: int = 0
    trace_t1_ns: int = 0
    window_s: float = 0.0
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    checks: List[Tuple[str, float, float]] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: Optional[int] = None
    forbidden: List[str] = dataclasses.field(default_factory=list)  # found loaded in the ranks

    @property
    def chips(self) -> int:
        return int(self.entry.get("chips", 1))

    @property
    def trace_window_s(self) -> float:
        return (self.trace_t1_ns - self.trace_t0_ns) / 1e9
