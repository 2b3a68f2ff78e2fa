"""Whole joint runs back to back: a researcher's experiment, repeated.

The window drives ``engine/protocols.py::run_zero_joint`` again and again,
each run a fresh ``Trainer`` with its own seed whose whole training (all
epochs, each with its val and test pass through K1) is the fused
``fused-joint-run`` call, figures off, events written under the run's
temporary directory.  A run that starts before the window's length is up is
finished; the rate is every completed run's training rows over the whole
time from the window's start to the last run's end.

On more than one chip the ranks are spawned once (``parallel/mesh.py::
spawn_ranks``, one NCCL rank a card) and each rank runs set-up and the
window, as the drivers run by default on a machine with several cards; the
global batch stays the configuration's.

Set-up makes the cached embeddings and the prompt bank on the card from the
seed and runs one joint run.  ``correct``: the plain replay of the window's
first run (its seed, its data, its epoch orders) against the losses it
logged and the parameters it ended with.
"""

from __future__ import annotations

import shutil
import sys
import time

import torch

from h100_bench.common.weights import joint_data, prompt_bank
from h100_bench.reference import joint as ref


def run_seed(seed: int, k: int) -> int:
    """The k-th joint run's seed (k = -1 is set-up's)."""
    return (int(seed) * 7919 + 17 + k) % (2**31 - 1)


def _program():
    from incremental_multimodal_medical_learning_ii_torch.data.store import EmbeddingDataset
    from incremental_multimodal_medical_learning_ii_torch.engine import protocols
    from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer
    from incremental_multimodal_medical_learning_ii_torch.objectives.scorer import PromptBank
    from incremental_multimodal_medical_learning_ii_torch.utils.config import ExperimentConfig

    return EmbeddingDataset, protocols, Trainer, PromptBank, ExperimentConfig


def experiment(p: dict, seed: int):
    *_, config_cls = _program()
    return config_cls(mode="joint", adapter="mlp", shared=False, image_adapter=True, text_adapter=True,
                      prompt_mode="mean", optim="adam", lr=p["lr"], epochs=p["epochs"],
                      batch_size=p["batch"], eval_batch_size=p["eval_batch"], fused_unit=True,
                      plot_figures="off", seed=seed)


def _inputs(seed: int, p: dict, device):
    dataset_cls, protocols, _, bank_cls, _ = _program()
    parts = joint_data(seed, device, p["rows"])
    bank = prompt_bank(seed, device)
    host = [dataset_cls(x.cpu().numpy(), y.cpu().numpy()) for x, y in parts]
    return parts, bank, protocols.DataBundle(*host), bank_cls(*bank)


class _SpanOnFusedRun:
    """A span around each ``Trainer.train_joint_run`` (the ``fused-joint-run`` call)."""

    def __init__(self, spans: list):
        _, _, self.cls, _, _ = _program()
        self.spans = spans

    def __enter__(self):
        self.orig = orig = self.cls.train_joint_run
        spans = self.spans

        def timed(trainer, *a, **k):
            t0 = time.time_ns()
            try:
                return orig(trainer, *a, **k)
            finally:
                spans.append(("fused-joint-run", t0, time.time_ns()))

        self.cls.train_joint_run = timed
        return self

    def __exit__(self, *exc):
        self.cls.train_joint_run = self.orig
        return False


def _loop(job: dict, device, mesh=None) -> dict:
    """Set-up and window on one rank (or the one process): returns what the
    window measured, the first run's final parameters on the host, and
    (traced) this rank's kernels."""
    from h100_bench.common.trace import DeviceTrace

    _, protocols, _, _, _ = _program()
    p, seed = job["params"], job["seed"]
    tmp = job["tmp"]
    _, _, bundle, bank = _inputs(seed, p, device)
    spans: list = []
    with _SpanOnFusedRun(spans):
        protocols.run_zero_joint(experiment(p, run_seed(seed, -1)), bundle, bank, log_dir=None,
                                 device=device, mesh=mesh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        spans.clear()
        start_wall = time.time()
        trace = DeviceTrace(job["trace"], device)
        trace.__enter__()
        tracing = True
        t0 = time.perf_counter()
        walls, first = [], None
        k = 0
        while k == 0 or _more(mesh, time.perf_counter() - t0 < job["seconds"], device):
            log_dir = f"{tmp}/runs/{k}"  # every rank passes it; rank 0 alone writes
            r0 = time.time_ns()
            res = protocols.run_zero_joint(experiment(p, run_seed(seed, k)), bundle, bank,
                                           log_dir=log_dir, device=device, mesh=mesh)
            spans.append(("joint_run", r0, time.time_ns()))
            if k == 0:
                first = {n: v.detach().cpu() for n, v in res["trainer"].state.params.items()}
            del res
            walls.append((time.time_ns() - r0) / 1e9)
            k += 1
            if tracing and k >= p["trace_runs"]:
                trace.__exit__(None, None, None)
                tracing = False
        window_s = time.perf_counter() - t0
        if tracing:
            trace.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {"runs": k, "window_s": window_s, "walls": walls, "spans": spans, "first": first,
            "start_wall": start_wall, "kernels": trace.kernels, "trace_t0_ns": trace.t0_ns,
            "trace_t1_ns": trace.t1_ns, "peak": peak}


def _more(mesh, more: bool, device) -> bool:
    """Rank 0's decision to start another run, the same on every rank."""
    if mesh is None:
        return more
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import replicate

    return bool(replicate(mesh, torch.tensor([int(more)], device=device))[0])


def rank(job: dict) -> dict:
    """One rank of the multi-chip cell (importable: the ranks are spawned)."""
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import create_mesh

    from h100_bench.common.guard import forbidden_modules

    mesh = create_mesh(job["chips"])
    torch.backends.cuda.matmul.allow_tf32 = False
    out = _loop(job, mesh.device, mesh)
    # numpy, not tensors: a tensor crosses processes as a shared handle that dies with the rank
    out["first"] = {k: v.numpy() for k, v in out["first"].items()} if mesh.rank == 0 else None
    out["forbidden"] = forbidden_modules()  # what the rank loaded, read after its window
    return out


rank_fn = rank  # what each spawned rank runs (importable by name)


def setup(run) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    run.state["job"] = {"params": run.params, "seed": run.seed, "seconds": run.seconds,
                        "trace": run.trace, "tmp": str(run.tmp), "chips": run.chips}


def window(run) -> None:
    from h100_bench.common.trace import busy_s

    from h100_bench.common.clock import process_start_wall

    job = run.state["job"]
    started = process_start_wall()
    if run.chips == 1:
        outs = [_loop(job, run.device)]
    else:
        from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import spawn_ranks

        outs = spawn_ranks(rank_fn, run.chips, run.device.type, job)
        if run.device.type == "cuda":
            run.memory_peak_bytes = max(o["peak"] for o in outs)
    # set-up ran inside the loop (on each rank): from this process's start to the window's
    run.counters["setup_s"] = outs[0]["start_wall"] - started
    run.forbidden = sorted({m for o in outs for m in o.get("forbidden", [])})
    o = outs[0]
    p = run.params
    run.window_s = o["window_s"]
    run.attempted = o["runs"]
    run.failed = 0
    run.kernels, run.trace_t0_ns, run.trace_t1_ns = o["kernels"], o["trace_t0_ns"], o["trace_t1_ns"]
    if run.trace:
        run.counters["busy_s"] = sum(busy_s(x["kernels"]) for x in outs) / len(outs)
        run.counters["traced_runs"] = min(o["runs"], p["trace_runs"])
    for s in o["spans"]:
        run.spans.add(*s)
    run.counters.update(runs=o["runs"], rows=o["runs"] * p["rows"][0] * p["epochs"])
    run.state["first"] = {k: torch.as_tensor(v) for k, v in o["first"].items()}
    run.e2e["train_samples_per_s"] = run.counters["rows"] / run.window_s
    print(f"[train] {o['runs']} joint runs in {run.window_s:.3f} s on {run.chips} chip(s); run walls "
          f"{[round(w, 4) for w in o['walls']]}", file=sys.stderr)


def release(run) -> None:
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def check(run) -> None:
    from h100_bench.common.tbread import scalars

    p = run.params
    logged = scalars(run.tmp / "runs" / "0")
    got = {"losses": torch.tensor([v for _, v in sorted(logged.get("train/Loss", []))], dtype=torch.float64),
           "val_losses": torch.tensor([v for _, v in sorted(logged.get("val/Loss", []))], dtype=torch.float64),
           "final": run.state.pop("first")}
    dev = run.device
    parts = joint_data(run.seed, dev, p["rows"])
    bank = prompt_bank(run.seed, dev)
    want = ref.replay(run_seed(run.seed, 0), parts, bank, p, dev)
    numbers = ref.compare(got, want)
    # the worst leaf swings from seed to seed over a whole run (PERF.md): reported, not held
    print(f"[train] worst leaf's change gap {numbers.pop('delta_worst_leaf_gap')!r}; per leaf "
          f"{ {k: round(v, 9) for k, v in ref.leaf_gaps(got, want).items()} }", file=sys.stderr)
    for name, value in numbers.items():
        run.checks.append((name, value, p[f"limit_{name}"]))
    shutil.rmtree(run.tmp / "runs", ignore_errors=True)
