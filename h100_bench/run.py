"""Run one cell of the benchmark once and print its result line.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (inputs from the seed, the program built and warmed up on the cell's
own shapes) is timed from the start of the process to the first timed unit
of work (``setup_s``).  The window then drives the port for ``--seconds``;
``--trace 1`` records the card's timeline in it and reports the per-layer
metrics instead of the end-to-end ones.  Once the window has closed and the
memory peak is read, the program's state is freed and the plain reference
decides ``correct``.  The numbers it compared, each beside its limit, are the
last lines on standard error and the last key of the result line.

Exit codes: 0 with a result line; 3 without a card (or with fewer cards than
the cell asks for); 4 if JAX or the JAX package was loaded, in this process
or in a rank it spawned; any other code is a failure of the run itself.
"""

from __future__ import annotations

import os

from h100_bench.common.clock import process_start_wall

START_WALL = process_start_wall()
# a library that can load JAX by itself is told not to
for _flag in ("USE_FLAX", "USE_JAX", "USE_TF"):
    os.environ.setdefault(_flag, "0")

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

from h100_bench.common.guard import forbidden_modules  # noqa: E402


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the tests and the tools: run on the CPU, change traffic parameters (never a limit)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--set", action="append", default=[], metavar="KEY=JSON", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for item in args.set:
        if item.startswith("limit_"):
            p.error(f"--set {item}: a limit of correct is not set from the command line")
    return args


def build_run(args):
    from h100_bench.common import spec

    entry, config, params = spec.cell(args.workload)
    for item in args.set:
        key, value = item.split("=", 1)
        params[key] = json.loads(value)
    base = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    tmp = base / "h100_bench" / args.workload
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True, exist_ok=True)
    import torch

    return spec.Run(workload=args.workload, entry=entry, config=config, params=params,
                    seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                    device=torch.device(args.device), tmp=tmp)


def measure(run, drv) -> None:
    """Set-up, window, memory peak, release, reference check."""
    import torch

    drv.setup(run)
    run.counters["setup_s"] = time.time() - START_WALL
    drv.window(run)
    if run.device.type == "cuda" and run.memory_peak_bytes is None:
        run.memory_peak_bytes = max(torch.cuda.max_memory_allocated(d) for d in range(run.chips))
    drv.release(run)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    drv.check(run)


def metric_values(run, trace: bool) -> dict:
    from h100_bench.common import spec

    out = {}
    if not trace:
        for m in spec.metrics_for(run.workload, "end_to_end"):
            value = run.counters["setup_s"] if m["name"] == "setup_s" else run.e2e.get(m["name"])
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
    for m in spec.metrics_for(run.workload, "per_layer"):
        value = spec.metric_reader(m["name"]).read(run)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judged(run) -> bool:
    return (run.failed == 0 and bool(run.checks)
            and all(math.isfinite(v) and v <= lim for _, v, lim in run.checks))


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from h100_bench.common import spec
    from h100_bench.common.trace import breakdown, busy_s, kernel_table

    if args.device == "cuda":
        chips = int(spec.cell(args.workload)[0].get("chips", 1))
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"[h100_bench] needs {chips} CUDA device(s), found {n}", file=sys.stderr)
            return 3

    run = build_run(args)
    drv = spec.driver(run.params["driver"])
    measure(run, drv)
    metrics = metric_values(run, run.trace)
    found = sorted(set(forbidden_modules()) | set(run.forbidden))
    if found:
        print(f"[h100_bench] loaded in this process or its ranks: {', '.join(found)}", file=sys.stderr)
        return 4
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": torch.cuda.get_device_name(0) if run.device.type == "cuda" else "cpu",
              "count": run.chips, "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": judged(run), "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    if run.trace:
        device["busy_s"] = run.counters.get("busy_s", busy_s(run.kernels))
        device["window_s"] = run.trace_window_s
        for name, n, sec in kernel_table(run.kernels)[:15]:
            print(f"[trace] {n} x {sec:.6f} s  {name[:150]}", file=sys.stderr)
        bd = breakdown(run.kernels, run.spans.items, run.trace_t0_ns, run.trace_t1_ns)
        if bd is not None:
            line["breakdown"] = bd
    line["power_limit_w"] = power_limit_w() if run.device.type == "cuda" else None
    line["window_s"] = run.window_s
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run.checks}
    for name, v, lim in run.checks:
        print(f"check {name} = {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
