"""The three experiment protocols as library functions (counterpart of the
JAX package's ``engine/protocols.py``):

* :func:`run_zero_joint`        — ``ZERO_JOINT_BOUNDS.py:16-72``
* :func:`run_data_incremental`  — ``DATA_INCREMENTAL.py:44-97``
* :func:`run_class_incremental` — ``CLASS_INCREMENTAL.py:32-97``

with threshold scheduling (``threshold += adder`` before every epoch, in
the same floating-point order as the JAX package), profCL's snapshot and
reset, per-unit checkpoints and the final save.  Exceptions propagate.

Every ``run_*`` takes ``mesh=`` (``parallel/mesh.py``) and then runs on
each rank of a data-parallel group: rank 0 alone writes the event file,
checkpoints and ``progress.json``, every rank waits for it at a barrier,
and a restored state is broadcast from rank 0.

Crash contract of the incremental protocols: the final save runs only on
success; on a crash the partial-unit TB events are discarded and the last
unit-boundary checkpoint (``_save_unit``) stays the durable state, so
``resume=True`` re-trains the interrupted unit from clean weights.
"""

from __future__ import annotations

import dataclasses
import shutil
from pathlib import Path
from typing import Dict, Optional

from incremental_multimodal_medical_learning_ii_torch.data.store import (
    EmbeddingDataset,
    filter_multiclass,
    filter_sani_malati,
    split_by_label,
    split_contiguous,
)
from incremental_multimodal_medical_learning_ii_torch.engine.checkpoint import (
    load_aux,
    load_progress,
    restore_checkpoint,
    save_checkpoint,
    save_progress,
)
from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer
from incremental_multimodal_medical_learning_ii_torch.evaluation.tb import TBWriter
from incremental_multimodal_medical_learning_ii_torch.objectives.scorer import PromptBank
from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import replicate
from incremental_multimodal_medical_learning_ii_torch.utils.config import (
    ContinualLearning,
    ExperimentConfig,
)
from incremental_multimodal_medical_learning_ii_torch.utils.profiling import annotate, maybe_trace


@dataclasses.dataclass
class DataBundle:
    """The train / val / test embeddings of a run, and optionally the
    train set's two t-SNE subsets."""

    train: EmbeddingDataset
    val: EmbeddingDataset
    test: EmbeddingDataset
    tsne_multiclass: Optional[EmbeddingDataset] = None
    tsne_sani_malati: Optional[EmbeddingDataset] = None

    def with_tsne_subsets(self) -> "DataBundle":
        """The t-SNE subsets the reference extracts from the train set
        (Trainer.py:249-250)."""
        return dataclasses.replace(self, tsne_multiclass=filter_multiclass(self.train),
                                   tsne_sani_malati=filter_sani_malati(self.train))

    @property
    def tsne_datasets(self):
        if self.tsne_multiclass is None or self.tsne_sani_malati is None:
            return None
        return (self.tsne_multiclass, self.tsne_sani_malati)


def _make_writer(cfg: ExperimentConfig, log_dir: Optional[str]) -> TBWriter:
    if log_dir is None:
        return TBWriter(None)
    return TBWriter(str(Path(log_dir) / cfg.run_name()))


def _rank_writer(cfg: ExperimentConfig, log_dir: Optional[str], mesh) -> TBWriter:
    """The run's writer; on a rank above 0 it writes nothing (one stream)."""
    writer = _make_writer(cfg, log_dir)
    if mesh is not None:
        writer.rank = mesh.rank
    return writer


def _save_final(trainer: Trainer, writer: TBWriter) -> None:
    if trainer.cfg.trains_anything and writer.log_dir is not None:
        save_checkpoint(writer.log_dir, trainer.state, mesh=trainer.mesh)


def _maybe_resume(trainer: Trainer, writer: TBWriter, resume: bool):
    """Restore the state, the completed-unit count and the trainer's
    host-side stream state, so the resumed run's batch order and TB output
    equal an uninterrupted run's.  Returns (completed_units, aux_or_None)."""
    if not resume or writer.log_dir is None:
        return 0, None
    completed = load_progress(writer.log_dir)
    aux = load_aux(writer.log_dir)
    if completed > 0:
        name = (aux or {}).get("state_name", "train_state")
        try:
            trainer.state = restore_checkpoint(writer.log_dir, trainer.state, name=name)
        except Exception:
            if name == "train_state":
                raise
            # old-format progress pointing at a since-cleaned staged dir
            trainer.state = restore_checkpoint(writer.log_dir, trainer.state)
        if trainer.mesh is not None:
            trainer.state = replicate(trainer.mesh, trainer.state)
        if aux is not None:
            try:
                trainer.load_aux_state(aux)
            except Exception as e:  # old/partial progress file: resume anyway
                print(f"[resume] aux state unreadable ({e}); resuming without "
                      "bit-reproducibility")
                aux = None
        if aux is None:
            # the optimiser count came back with the checkpoint: reseed the
            # host-side step mirror so train/LR continues from it
            trainer._py_step = int(trainer.state.step)
        print(f"[resume] restored checkpoint; skipping {completed} completed unit(s)")
    return completed, aux


def _save_unit(trainer: Trainer, writer: TBWriter, completed: int, extra: Optional[dict] = None) -> None:
    """Durably commit one finished unit: the checkpoint under a per-unit
    name first, then the TB events, then the atomic progress.json that
    points at it (a crash between leaves unit N-1 intact)."""
    if trainer.cfg.trains_anything and writer.log_dir is not None:
        name = f"train_state_unit{completed}"
        save_checkpoint(writer.log_dir, trainer.state, name=name, mesh=trainer.mesh)
        writer.commit()
        aux = trainer.aux_state()
        if extra:
            aux.update(extra)
        aux["state_name"] = name
        # the atomic commit point
        save_progress(writer.log_dir, completed, aux, mesh=trainer.mesh)
        if trainer.mesh is None or trainer.mesh.rank == 0:
            for stale in Path(writer.log_dir).glob("train_state_unit*"):
                if stale.name != name:
                    shutil.rmtree(stale, ignore_errors=True)
    else:
        writer.commit()


def run_zero_joint(
    cfg: ExperimentConfig,
    data: DataBundle,
    bank: PromptBank,
    log_dir: Optional[str] = None,
    device=None,
    trace_dir: Optional[str] = None,
    mesh=None,
) -> Dict[str, Dict[str, float]]:
    """Zero-shot (epochs=0) or joint-train upper bound.  ``trace_dir``
    captures a ``torch.profiler`` trace of the whole train/eval loop (as
    ``trace_dir`` does in the other two protocols; ``utils/profiling.py``)."""
    with annotate("joint-run"):
        with annotate("trainer-init"):
            writer = _rank_writer(cfg, log_dir, mesh)
            trainer = Trainer(cfg, bank, writer, device, mesh)
        results: Dict[str, Dict[str, float]] = {}
        try:
            with maybe_trace(trace_dir, trainer.device):
                if cfg.epochs > 0:
                    _joint_epochs(cfg, data, trainer, writer, results)
                else:
                    results["val_zero"] = trainer.validate(data.val, 0, 0, mode="zero")
                    results["test_zero"] = trainer.test(data.test, 0, 0, mode="zero",
                                                        tsne_datasets=data.tsne_datasets)
        except BaseException:
            writer.discard()
            raise
        finally:
            # the reference saves its adapters in a finally, crash or not
            with annotate("save"):
                _save_final(trainer, writer)
            writer.close()
    results["trainer"] = trainer  # type: ignore[assignment]
    return results


def _joint_epochs(cfg: ExperimentConfig, data: DataBundle, trainer: Trainer, writer: TBWriter,
                  results: dict) -> None:
    """The joint run's epochs: with ``cfg.fused_unit``, all epochs and their
    per-epoch val/test in one call, whose logging each epoch then replays
    and whose staged evals it consumes (``emit-epoch``)."""
    fuse_run = trainer.joint_run_fusible(data.train, (data.val, data.test))
    if cfg.fused_unit and not fuse_run:
        print("[warn] --fused-unit: joint whole-run fusion disabled (train or "
              "val/test data is not a device-residentable EmbeddingDataset, or "
              "the fused eval machinery is off); running per-epoch")
    if fuse_run:
        trainer.train_joint_run(data.train, cfg.threshold, (data.val, data.test))
    for epoch in range(1, cfg.epochs + 1):
        with annotate("emit-epoch"):
            if fuse_run:
                trainer.emit_joint_epoch(epoch)
            else:
                trainer.train(data.train, epoch, threshold=cfg.threshold, actual_task=epoch)
            results[f"val_ep{epoch}"] = trainer.validate(data.val, epoch, cfg.epochs, mode="joint")
            results[f"test_ep{epoch}"] = trainer.test(data.test, epoch, cfg.epochs, mode="joint",
                                                      tsne_datasets=data.tsne_datasets)
            writer.commit()


def _schedule(cfg: ExperimentConfig, skip: int, remaining) -> list:
    """The per-unit threshold schedules, advanced host-side in the one
    sequential floating-point order an uninterrupted run uses (the skipped
    units are replayed, not multiplied)."""
    threshold = cfg.threshold
    for _ in range(skip * cfg.epochs):
        threshold += cfg.adder
    schedule = []
    for _ in remaining:
        unit_thr = []
        for _ in range(cfg.epochs):
            threshold += cfg.adder
            unit_thr.append(threshold)
        schedule.append(unit_thr)
    return schedule


def _log_schedule(cfg, writer, schedule_i, count):
    for thr in schedule_i:
        count += 1
        if cfg.threshold_scheduling and cfg.continual_learning is not None:
            writer.add_scalar("monitor-resets/threshold-scheduling", thr, count)
    return count


def run_data_incremental(
    cfg: ExperimentConfig,
    data: DataBundle,
    bank: PromptBank,
    log_dir: Optional[str] = None,
    device=None,
    resume: bool = False,
    trace_dir: Optional[str] = None,
    mesh=None,
) -> Dict[str, Dict[str, float]]:
    writer = _rank_writer(cfg, log_dir, mesh)
    trainer = Trainer(cfg, bank, writer, device, mesh)
    parts = split_contiguous(data.train, cfg.parts)
    results: Dict[str, Dict[str, float]] = {}
    skip, _ = _maybe_resume(trainer, writer, resume)
    count = skip * cfg.epochs
    remaining = list(range(1 + skip, cfg.parts + 1))
    schedule = _schedule(cfg, skip, remaining)
    use_prof = cfg.continual_learning == ContinualLearning.PROF_CL
    try:
        with maybe_trace(trace_dir, trainer.device):
            units = [parts[p - 1] for p in remaining]
            fold = trainer.incremental_run_fusible(units, (data.val, data.test))
            if cfg.fused_unit and not fold and units:
                print("[info] --fused-unit: whole-run fold unavailable (an empty unit, "
                      "eval/train data not device-residentable, or epochs=0); one call per unit")
            if fold:
                trainer.train_incremental_run(
                    units, schedule,
                    use_my_cl_units=[cfg.continual_learning == ContinualLearning.MY_CL and p > 1
                                     for p in remaining],
                    use_prof_units=[use_prof] * len(units),
                    eval_data=(data.val, data.test),
                )
            for i, part in enumerate(remaining):
                count = _log_schedule(cfg, writer, schedule[i], count)
                if fold:
                    trainer.emit_incremental_unit(i, part=part, actual_task=part)
                elif trainer.unit_fusible(parts[part - 1]):
                    trainer.train_unit(
                        parts[part - 1], schedule[i], part=part, actual_task=part,
                        use_prof=use_prof, eval_data=(data.val, data.test),
                    )
                else:
                    for epoch, thr in enumerate(schedule[i], start=1):
                        if use_prof:
                            trainer.model_copy()
                        trainer.train(parts[part - 1], epoch, threshold=thr, part=part,
                                      epochs=cfg.epochs, actual_task=part)
                        if use_prof:
                            trainer.prof_incremental(epoch, cfg.epochs, part, thr)
                results[f"val_part{part}"] = trainer.validate(
                    data.val, part, cfg.parts, mode="data-inc", tasks_order=part)
                results[f"test_part{part}"] = trainer.test(
                    data.test, part, cfg.parts, mode="data-inc", tasks_order=part,
                    tsne_datasets=data.tsne_datasets)
                _save_unit(trainer, writer, part)
            _save_final(trainer, writer)
    except BaseException:
        writer.discard()
        raise
    finally:
        writer.close()
    results["trainer"] = trainer  # type: ignore[assignment]
    return results


def run_class_incremental(
    cfg: ExperimentConfig,
    data: DataBundle,
    bank: PromptBank,
    log_dir: Optional[str] = None,
    device=None,
    n_tasks: int = 5,
    resume: bool = False,
    trace_dir: Optional[str] = None,
    mesh=None,
) -> Dict[str, Dict[str, float]]:
    writer = _rank_writer(cfg, log_dir, mesh)
    trainer = Trainer(cfg, bank, writer, device, mesh)
    if cfg.mode == "class-pos-neg":
        tasks = split_contiguous(data.train, 5)  # Trainer.py:350-351
    elif cfg.mode == "class-pos":
        tasks = split_by_label(data.train)  # Trainer.py:353-354
    else:
        raise ValueError(f"not a class-incremental mode: {cfg.mode}")
    tasks_order = list(cfg.tasks_order)
    if n_tasks > min(len(tasks), len(tasks_order)):
        raise ValueError(
            f"n_tasks={n_tasks} exceeds the {len(tasks)} task splits / "
            f"{len(tasks_order)}-entry tasks_order (5 disease classes)"
        )
    results: Dict[str, Dict[str, float]] = {}
    skip, aux = _maybe_resume(trainer, writer, resume)
    if aux is not None:
        last_batch = int(aux.get("last_batch", 0))
    else:
        # no aux: rebuild the train-iteration counter from the finished tasks
        last_batch = sum(-(-len(tasks[t]) // cfg.batch_size) * cfg.epochs for t in range(skip))
        if skip:
            print(f"[resume] no aux state; reconstructed last_batch={last_batch} "
                  "from completed tasks' batch counts")
    count = skip * cfg.epochs
    remaining = list(range(1 + skip, n_tasks + 1))
    schedule = _schedule(cfg, skip, remaining)
    try:
        with maybe_trace(trace_dir, trainer.device):
            units = [tasks[t - 1] for t in remaining]
            fold = trainer.incremental_run_fusible(units, (data.val, data.test))
            if cfg.fused_unit and not fold and units:
                print("[info] --fused-unit: whole-run fold unavailable (an empty unit, "
                      "eval/train data not device-residentable, or epochs=0); one call per unit")
            if fold:
                trainer.train_incremental_run(
                    units, schedule,
                    use_my_cl_units=[cfg.continual_learning == ContinualLearning.MY_CL and t > 1
                                     for t in remaining],
                    use_prof_units=[cfg.continual_learning == ContinualLearning.PROF_CL and t > 1
                                    for t in remaining],
                    current_tasks=[tasks_order[t - 1] for t in remaining],
                    more_labels=cfg.more_labels,
                    eval_data=(data.val, data.test),
                )
            for i, actual_task in enumerate(remaining):
                count = _log_schedule(cfg, writer, schedule[i], count)
                use_prof = cfg.continual_learning == ContinualLearning.PROF_CL and actual_task > 1
                if fold:
                    last_batch = trainer.emit_incremental_unit(
                        i, actual_task=actual_task, last_batch=last_batch)
                elif trainer.unit_fusible(tasks[actual_task - 1]):
                    last_batch = trainer.train_unit(
                        tasks[actual_task - 1], schedule[i], actual_task=actual_task,
                        last_batch=last_batch, current_task=tasks_order[actual_task - 1],
                        more_labels=cfg.more_labels, use_prof=use_prof,
                        eval_data=(data.val, data.test),
                    )
                else:
                    for epoch, thr in enumerate(schedule[i], start=1):
                        if use_prof:
                            trainer.model_copy()
                        last_batch = trainer.train_class_incremental(
                            tasks[actual_task - 1], epoch,
                            current_task=tasks_order[actual_task - 1], last_batch=last_batch,
                            threshold=thr, actual_task=actual_task, more_labels=cfg.more_labels,
                        )
                        if use_prof:
                            trainer.prof_incremental(epoch, cfg.epochs, actual_task, thr)
                results[f"val_task{actual_task}"] = trainer.validate(
                    data.val, actual_task, cfg.epochs, mode=cfg.mode, tasks_order=tasks_order,
                    final_unit=n_tasks)
                results[f"test_task{actual_task}"] = trainer.test(
                    data.test, actual_task, cfg.epochs, mode=cfg.mode, tasks_order=tasks_order,
                    tsne_datasets=data.tsne_datasets, final_unit=n_tasks)
                _save_unit(trainer, writer, actual_task, extra={"last_batch": last_batch})
            _save_final(trainer, writer)
    except BaseException:
        writer.discard()
        raise
    finally:
        writer.close()
    results["trainer"] = trainer  # type: ignore[assignment]
    return results
