"""Whole class-incremental runs back to back: RE-tune's class-incremental
protocol with myCL, repeated over seeds.

The window drives ``engine/protocols.py::run_class_incremental`` again and
again, each run a fresh ``Trainer`` with its own seed whose units (one
disease each, ``split_by_label``, in ``tasks_order``) and their post-unit
val and test passes are the one fused ``fused-incremental-run`` call,
figures off, events under the run's temporary directory, as
``joint_runs.py`` drives joint runs (its seeds, cached embeddings and
prompt bank).  The rate is the rows trained, the sum over units of the
unit's rows times the epochs, of every completed run over the whole time
from the window's start to the last run's end.  The window opens the
program's recorder, so its spans name the card's idle gaps.

Set-up makes the embeddings and the bank on the card from the seed and runs
one run.  ``correct``: the plain replay of the window's first run
(``reference/incremental.py``), each unit from the state the program
handed on to it, against the losses it logged (the val losses of its own
parameters at each unit's end) and the whole state it ended each unit
with: parameters, Adam moments and update count.  Only that run's unit
states are copied to the host.
"""

from __future__ import annotations

import contextlib
import shutil
import sys
import time

import torch

from h100_bench.common.weights import joint_data, prompt_bank
from h100_bench.drivers.joint_runs import _inputs, _program, run_seed
from h100_bench.reference import incremental as ref


def experiment(p: dict, seed: int):
    *_, config_cls = _program()
    return config_cls(mode=p["mode"], adapter="mlp", shared=False, image_adapter=True, text_adapter=True,
                      prompt_mode=p["prompt_mode"], optim="adam", lr=p["lr"], epochs=p["epochs"],
                      batch_size=p["batch"], eval_batch_size=p["eval_batch"], fused_unit=True,
                      plot_figures="off", seed=seed, more_labels=p["more_labels"],
                      tasks_order=tuple(p["tasks_order"]), continual_learning=p["continual_learning"],
                      threshold=p["threshold"], adder=p["adder"])


def rows_trained(bundle, p: dict) -> int:
    """The rows a run trains: each unit's rows (the train rows positive for
    its disease) times the epochs."""
    labels = bundle.train.labels
    return sum(int((labels[:, c] == 1).sum()) for c in p["tasks_order"][:p["units"]]) * p["epochs"]


class _UnitStates:
    """Records the program's state after each unit of a run (the state
    ``Trainer.emit_incremental_unit`` restores), on the host."""

    def __init__(self, states: list):
        _, _, self.cls, _, _ = _program()
        self.states = states

    def __enter__(self):
        self.orig = orig = self.cls.emit_incremental_unit
        states = self.states

        def recorded(trainer, *a, **k):
            out = orig(trainer, *a, **k)
            st = trainer.state
            states.append({**{n: {k: v.detach().cpu() for k, v in getattr(st, n).items()}
                              for n in ("params", "mu", "nu")}, "count": int(st.count)})
            return out

        self.cls.emit_incremental_unit = recorded
        return self

    def __exit__(self, *exc):
        self.cls.emit_incremental_unit = self.orig
        return False


def setup(run) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    p = run.params
    _, protocols, _, _, _ = _program()
    _, _, bundle, bank = _inputs(run.seed, p, run.device)
    run.state.update(bundle=bundle, bank=bank)
    protocols.run_class_incremental(experiment(p, run_seed(run.seed, -1)), bundle, bank, log_dir=None,
                                    device=run.device, n_tasks=p["units"])
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def window(run) -> None:
    from incremental_multimodal_medical_learning_ii_torch.utils.profiling import recording

    from h100_bench.common.trace import DeviceTrace

    p = run.params
    _, protocols, _, _, _ = _program()
    bundle, bank = run.state["bundle"], run.state["bank"]
    trace = DeviceTrace(run.trace, run.device)
    walls, k = [], 0
    with recording() as rec:
        trace.__enter__()
        tracing = True
        t0 = time.perf_counter()
        while k == 0 or time.perf_counter() - t0 < run.seconds:
            r0 = time.time_ns()
            states: list = []
            # the first run's unit states are kept for the check; no later run copies anything
            with _UnitStates(states) if k == 0 else contextlib.nullcontext():
                protocols.run_class_incremental(experiment(p, run_seed(run.seed, k)), bundle, bank,
                                                log_dir=f"{run.tmp}/runs/{k}", device=run.device,
                                                n_tasks=p["units"])
            run.spans.add("incremental_run", r0, time.time_ns())
            if k == 0:
                run.state["unit_states"] = states
            walls.append((time.time_ns() - r0) / 1e9)
            k += 1
            if tracing and k >= p["trace_runs"]:
                trace.__exit__(None, None, None)
                tracing = False
        run.window_s = time.perf_counter() - t0
        if tracing:
            trace.__exit__(None, None, None)
    for s in rec.spans:
        run.spans.add(s.name, s.t0_ns, s.t1_ns)
    run.kernels, run.trace_t0_ns, run.trace_t1_ns = trace.kernels, trace.t0_ns, trace.t1_ns
    run.attempted, run.failed = k, 0
    run.counters.update(runs=k, rows=k * rows_trained(bundle, p))
    if run.trace:
        run.counters["traced_runs"] = min(k, p["trace_runs"])
    run.e2e["train_samples_per_s"] = run.counters["rows"] / run.window_s
    print(f"[train] {k} class-incremental runs in {run.window_s:.3f} s; run walls "
          f"{[round(w, 4) for w in walls]}", file=sys.stderr)


def release(run) -> None:
    run.state.pop("bundle", None)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def _cut(values: list, lengths) -> list:
    """``values`` in consecutive pieces of ``lengths``; [] if they do not add up."""
    out, start = [], 0
    for n in lengths:
        out.append(values[start:start + n])
        start += n
    return out if start == len(values) else []


def check(run) -> None:
    from h100_bench.common.tbread import scalars

    p = run.params
    logged = scalars(run.tmp / "runs" / "0")
    states = run.state.pop("unit_states")
    dev = run.device
    parts = joint_data(run.seed, dev, p["rows"])
    bank = prompt_bank(run.seed, dev)
    want = ref.replay(run_seed(run.seed, 0), parts, bank, p, dev, starts=states[:-1], scored=states)

    def tag(name):
        return [v for _, v in sorted(logged.get(name, []))]

    losses = _cut(tag("train/Loss"), [len(w) for w in want["unit_losses"]])
    vals = _cut(tag("val/Loss"), [len(w) for w in want["unit_val_losses"]])
    resets = _cut([int(v) for v in tag("monitor-resets/resets")], [len(w) for w in want["unit_resets"]])
    got = {"unit_losses": [torch.tensor(x, dtype=torch.float64) for x in losses],
           "unit_val_losses": [torch.tensor(x, dtype=torch.float64) for x in vals],
           "unit_resets": resets, "unit_states": states}
    numbers = ref.compare(got, want)
    # the worst leaf swings from seed to seed over a whole run (PERF.md): reported, not held
    print(f"[train] worst leaf's change gap {numbers.pop('delta_worst_leaf_gap')!r}; per unit, the "
          f"first three losses' gap {ref.unit_loss3_gaps(got, want)}; resets {resets} against "
          f"{want['unit_resets']}", file=sys.stderr)
    for name, value in numbers.items():
        run.checks.append((name, value, p[f"limit_{name}"]))
    shutil.rmtree(run.tmp / "runs", ignore_errors=True)
