"""Training / evaluation engine (counterpart of the JAX package's
``engine/trainer.py``).

Drives :mod:`engine.steps` through the reference's three regimes with its
iteration bookkeeping and TensorBoard schema:

* ``train``                   — joint & data-incremental epochs (``Trainer.py:526-605``)
* ``train_class_incremental`` — one class per task or a growing class set
                                (``Trainer.py:608-756``)
* ``validate`` / ``test``     — full-label-set evaluation with the sklearn
                                metric set (``Trainer.py:772-1072``)
* ``model_copy`` / ``prof_incremental`` — profCL's epoch-level reset
                                (``Trainer.py:1589-1641``)

Three engine paths, as in the JAX package: batch by batch (host batches,
any ``iterate_batches`` source), one call per epoch over device-resident
data (``cfg.fused_epoch``), and with ``cfg.fused_unit`` one call per unit
or per whole run (joint: all epochs with their evals; incremental: every
unit with its evals).  All three draw the epoch orders from the same
counters (:meth:`Trainer._epoch_perm`) and log the same streams; metrics
are read back once per epoch, unit or run.  Each fused call and each eval
pass runs inside a named span of a profiler trace (``utils/profiling.py``:
``fused-train-epoch``, ``fused-train-unit``, ``fused-joint-run``,
``fused-incremental-run``, ``eval-pass``, the JAX trainer's names); so do
a dataset's padding and upload on its first use (``upload``; ``upload_bytes``
counts them), the draw and upload of a fused call's epoch orders
(``epoch-orders``), the replay of a fused call's train logging
(``train-logs``) and the host metrics of each eval (``eval-metrics``).

``mesh=`` (``parallel/mesh.py``) runs the trainer on each rank of a
data-parallel group, as the JAX ``Trainer(mesh=)`` runs on a device mesh:
every rank holds the replicated state, bank and data, draws the same epoch
orders (nothing is seeded by rank) and trains on its rows of every batch;
batches are padded to a multiple of the mesh size, and the eval passes
gather their scores before any metric, so every rank computes the same
metrics.  Events are written by rank 0 only (the protocols give the other
ranks' writers ``rank``).

Figures (``cfg.plot_figures``, ``Trainer.py:1074-1554``): the ROC, PR and
class-metric figures of every eval, the epoch x class / task x class
heatmaps at the run's last epoch or task, the prompt embeddings' cosine
heatmap, PCA and t-SNE and (``tsne_datasets``) the image embeddings'
t-SNE after each test eval, with the JAX trainer's tags, steps and order,
drawn by ``evaluation/plots.py`` (PIL; the projections on the trainer's
device).  The folded paths restore each epoch's or unit's own state
before its evals, so their figures are the per-epoch path's.  They are
drawn only for a writer that writes (``TBWriter.writes``: rank 0).
"""

from __future__ import annotations

import weakref
from typing import List, Optional, Sequence

import numpy as np
import torch

from incremental_multimodal_medical_learning_ii_torch.data.store import (
    EmbeddingDataset,
    iterate_batches,
    num_batches,
)
from incremental_multimodal_medical_learning_ii_torch.engine.steps import (
    adapt_bank,
    build_embed_fn,
    build_epoch_reset,
    build_eval_step,
    build_fused_epoch,
    build_fused_eval,
    build_fused_run,
    build_fused_unit,
    build_train_step,
    epoch_permutation,
    init_train_state,
    lr_at_host,
    params_from_modules,
    unstack,
)
from incremental_multimodal_medical_learning_ii_torch.evaluation import plots
from incremental_multimodal_medical_learning_ii_torch.evaluation.metrics import (
    compute_metrics,
    per_class_metrics,
)
from incremental_multimodal_medical_learning_ii_torch.evaluation.tb import TBWriter
from incremental_multimodal_medical_learning_ii_torch.models.adapters import AdapterPair
from incremental_multimodal_medical_learning_ii_torch.objectives.scorer import PromptBank
from incremental_multimodal_medical_learning_ii_torch.ops.cosine import masked_mean
from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import replicate
from incremental_multimodal_medical_learning_ii_torch.utils.config import (
    NUM_CLASSES,
    ContinualLearning,
    ExperimentConfig,
)
from incremental_multimodal_medical_learning_ii_torch.utils.device import (
    readback,
    resolve_device,
    upload,
)
from incremental_multimodal_medical_learning_ii_torch.utils.profiling import annotate, count


def _unit_class_mask(current_task: Optional[int], more_labels: bool) -> np.ndarray:
    """The (C,) class mask one incremental unit trains: all classes
    (joint/data-inc), labels[:, :task+1] (MORE_LABELS, Trainer.py:701) or
    labels[:, task] (class-incremental, Trainer.py:625)."""
    if current_task is None:
        return np.ones(NUM_CLASSES, np.float32)
    mask = np.zeros(NUM_CLASSES, np.float32)
    if more_labels:
        mask[: current_task + 1] = 1.0
    else:
        mask[current_task] = 1.0
    return mask


class Trainer:
    def __init__(
        self,
        cfg: ExperimentConfig,
        bank: PromptBank,
        writer: Optional[TBWriter] = None,
        device=None,
        mesh=None,
    ):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None and device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not this rank's {mesh.device}")
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.writer = writer or TBWriter(None)
        self.class_names = list(cfg.class_names)

        self.pair = AdapterPair(
            kind=cfg.adapter,
            shared=cfg.shared,
            use_image=cfg.image_adapter,
            use_text=cfg.text_adapter,
        )
        modules = self.pair.init(torch.Generator().manual_seed(cfg.seed))
        self.state = init_train_state(params_from_modules(modules, self.device), cfg, self.device)
        self._train_step = build_train_step(self.pair, cfg, mesh) if cfg.trains_anything else None
        self._eval_step = build_eval_step(self.pair, cfg, mesh)
        self._embed = build_embed_fn(self.pair, cfg)
        self._epoch_reset = build_epoch_reset(cfg)
        self.bank = bank.to(self.device)
        if mesh is not None:
            self.state = replicate(mesh, self.state)
            self.bank = replicate(mesh, self.bank)
        self._pad_multiple = 1 if mesh is None else mesh.size

        self._snapshot = None  # profCL epoch snapshot
        self._shuffle_rng = np.random.default_rng(cfg.seed)
        # Optional injected epoch order: callable (epoch_index, n_rows) ->
        # permutation of range(n_rows), fed through every engine path;
        # None draws the trainer's own orders
        self.permutation_source = None
        self._perm_counter = 0  # epochs begun with shuffling (all paths)

        # heatmap accumulators (Trainer.py:187-190)
        self.val_f1_rows: List[np.ndarray] = []
        self.val_auroc_rows: List[np.ndarray] = []
        self.test_f1_rows: List[np.ndarray] = []
        self.test_auroc_rows: List[np.ndarray] = []
        self._gap_counter = 0
        self._py_step = 0  # host-side mirror of state.step (for LR logging)

        self._fused_epoch = (
            build_fused_epoch(self.pair, cfg, mesh) if cfg.trains_anything and cfg.fused_epoch
            else None
        )
        self._fused_eval = build_fused_eval(self.pair, cfg, mesh) if cfg.fused_epoch else None
        # device data, keyed by (id(dataset), batch size) and evicted by a
        # weakref finaliser when the dataset dies (a reused id never hits)
        self._device_data_cache: dict = {}
        self._cache_refs: dict = {}
        self._epoch_counter = 0
        self._fused_unit_cache: dict = {}
        # eval results of an eval-folded unit call, consumed by the next
        # validate/test in order: [(dataset, (losses, scores, preds)), ...]
        self._pending_eval: list = []
        # fused joint-run staging (train_joint_run -> emit_joint_epoch)
        self._joint_fetched = None
        self._joint_evals = None
        self._joint_eval_data = None
        self._joint_states = None
        # fused incremental-run staging (train_incremental_run -> emit_incremental_unit)
        self._fused_run_cache: dict = {}
        self._run_staging = None

    # ------------------------------------------------------------------
    # Host-side stream state (for bit-reproducible resume)
    # ------------------------------------------------------------------
    def aux_state(self) -> dict:
        """JSON-serialisable snapshot of everything host-side that advances
        during training besides ``state``: the shuffle-rng stream, the TB
        iteration counters, the epoch-order counters and the heatmap rows."""
        return {
            "shuffle_rng": self._shuffle_rng.bit_generator.state,
            "py_step": self._py_step,
            "gap_counter": self._gap_counter,
            "epoch_counter": self._epoch_counter,
            "perm_counter": self._perm_counter,
            "val_f1_rows": [r.tolist() for r in self.val_f1_rows],
            "val_auroc_rows": [r.tolist() for r in self.val_auroc_rows],
            "test_f1_rows": [r.tolist() for r in self.test_f1_rows],
            "test_auroc_rows": [r.tolist() for r in self.test_auroc_rows],
        }

    def load_aux_state(self, aux: dict) -> None:
        # parse everything before assigning anything: a partly valid aux
        # must not leave the trainer half restored
        rng_state = aux["shuffle_rng"]
        py_step = int(aux["py_step"])
        gap_counter = int(aux["gap_counter"])
        epoch_counter = int(aux["epoch_counter"])
        rows = {
            key: [np.asarray(r, np.float64) for r in aux[key]]
            for key in ("val_f1_rows", "val_auroc_rows", "test_f1_rows", "test_auroc_rows")
        }
        self._shuffle_rng.bit_generator.state = rng_state
        self._py_step = py_step
        self._gap_counter = gap_counter
        self._epoch_counter = epoch_counter
        self._perm_counter = int(aux.get("perm_counter", epoch_counter))
        self.val_f1_rows = rows["val_f1_rows"]
        self.val_auroc_rows = rows["val_auroc_rows"]
        self.test_f1_rows = rows["test_f1_rows"]
        self.test_auroc_rows = rows["test_auroc_rows"]

    # ------------------------------------------------------------------
    # Shared internals
    # ------------------------------------------------------------------
    @property
    def params(self):
        return self.state.params

    def _up(self, array) -> torch.Tensor:
        return upload(np.asarray(array), self.device)

    def _scalar(self, value) -> torch.Tensor:
        return torch.full((), float(value), dtype=torch.float32, device=self.device)

    def _batches(self, dataset, batch_size: int, shuffle: bool):
        """Batch iterator over an :class:`EmbeddingDataset` or anything
        exposing ``iterate_batches`` (e.g. a native mmap store)."""
        if hasattr(dataset, "iterate_batches"):
            if shuffle and self.permutation_source is not None:
                raise ValueError(
                    "permutation_source injection is not supported for "
                    "native batch sources (their shuffle lives in C++)"
                )
            # a per-epoch seed from the persistent shuffle stream, so every
            # epoch reshuffles and resume stays bit-reproducible
            seed = int(self._shuffle_rng.integers(2**31)) if shuffle else self.cfg.seed
            return dataset.iterate_batches(batch_size, shuffle=shuffle, seed=seed,
                                           pad_multiple=self._pad_multiple)
        order = None
        if shuffle and self.permutation_source is not None:
            order = self._injected_permutation(len(dataset))
        return iterate_batches(
            dataset, batch_size, shuffle=shuffle,
            rng=self._shuffle_rng if shuffle else None, order=order,
            pad_multiple=self._pad_multiple,
        )

    def _injected_permutation(self, n: int) -> np.ndarray:
        self._perm_counter += 1
        order = np.asarray(self.permutation_source(self._perm_counter - 1, n))
        if order.shape != (n,):
            raise ValueError(f"permutation_source returned shape {order.shape}, expected ({n},)")
        return order

    def _invalidate_folds(self) -> None:
        """Params are about to change outside a fold: staged eval results and
        staged fused-run state are stale now."""
        self._pending_eval = []
        self._run_staging = None
        self._joint_fetched = self._joint_evals = None
        self._joint_eval_data = self._joint_states = None

    def _flush_train_logs(self, pending, trained_classes=None) -> Optional[dict]:
        """One readback for all pending batches' metrics; logs train/Loss,
        the post-step LR and the MAX-gap stream; returns the last batch's
        metrics (host values)."""
        if not pending:
            return None
        fetched = readback([m for _, m in pending])
        last = None
        scheduled = self.cfg.lr_schedule is not None
        for (iteration, _), metrics in zip(pending, fetched):
            self.writer.add_scalar("train/Loss", float(metrics["loss"]), iteration)
            if scheduled:
                # the reference logs after scheduler.step(): the rate the
                # next update uses
                self.writer.add_scalar("train/LR", lr_at_host(self.cfg, metrics["_step"] + 1),
                                       iteration)
            if "max_mean_gap_pos" in metrics and self.writer.enabled:
                self._gap_counter += 1
                self.writer.add_scalar("max-mean-comparison/pos",
                                       float(metrics["max_mean_gap_pos"]), self._gap_counter)
                self.writer.add_scalar("max-mean-comparison/neg",
                                       float(metrics["max_mean_gap_neg"]), self._gap_counter)
            if "max_mean_gap_pos_vec" in metrics and self.writer.enabled:
                # one pair per trained class per batch, ascending class index
                for ci in (trained_classes if trained_classes is not None
                           else range(len(metrics["max_mean_gap_pos_vec"]))):
                    self._gap_counter += 1
                    self.writer.add_scalar("max-mean-comparison/pos",
                                           float(metrics["max_mean_gap_pos_vec"][ci]),
                                           self._gap_counter)
                    self.writer.add_scalar("max-mean-comparison/neg",
                                           float(metrics["max_mean_gap_neg_vec"][ci]),
                                           self._gap_counter)
            last = metrics
        return last

    def _log_reset_counts(self, metrics, iteration):
        """monitor-resets/* scalars (Trainer.py:758-770)."""
        n_reset, n_updated = readback((metrics["n_reset"], metrics["n_updated"]))
        n_reset, n_updated = int(n_reset), int(n_updated)
        total = max(n_reset + n_updated, 1)
        self.writer.add_scalar("monitor-resets/resets", n_reset, iteration)
        self.writer.add_scalar("monitor-resets/updates", n_updated, iteration)
        self.writer.add_scalar("monitor-resets/percentage resets", n_reset / total, iteration)

    # ------------------------------------------------------------------
    # Training (joint / data-incremental)  —  Trainer.py:526-605
    # ------------------------------------------------------------------
    def train(
        self,
        dataset: EmbeddingDataset,
        epoch: int,
        threshold: Optional[float] = None,
        part: Optional[int] = None,
        epochs: Optional[int] = None,
        actual_task: Optional[int] = None,
    ) -> None:
        cfg = self.cfg
        self._invalidate_folds()
        use_my_cl = (
            cfg.continual_learning == ContinualLearning.MY_CL
            and actual_task is not None
            and actual_task > 1
        )
        class_mask = np.ones(NUM_CLASSES, np.float32)
        thr = threshold if use_my_cl else 0.0
        n_b = num_batches(len(dataset), cfg.batch_size)
        if part is None:
            iteration_of = lambda i: (epoch - 1) * n_b + i + 1  # noqa: E731
        else:
            iteration_of = (  # noqa: E731
                lambda i: (part - 1) * (epochs or 0) * n_b + (epoch - 1) * n_b + i + 1
            )
        if self._fused_epoch is not None and isinstance(dataset, EmbeddingDataset):
            self._train_fused(dataset, class_mask, thr, use_my_cl, iteration_of)
            return
        self._train_batches(dataset, class_mask, thr, use_my_cl, iteration_of)

    def _train_batches(self, dataset, class_mask, threshold, use_my_cl, iteration_of) -> int:
        """The per-batch path: host batches, one step call each, one
        readback at the end.  Returns the number of batches run."""
        d_mask, d_thr = self._up(class_mask), self._scalar(threshold)
        pending = []
        for i, (embs, labels, mask) in enumerate(
            self._batches(dataset, self.cfg.batch_size, shuffle=self.cfg.shuffle_train)
        ):
            self.state, metrics = self._train_step(
                self.state, self._up(embs), self._up(labels), self._up(mask), d_mask,
                self.bank, d_thr,
            )
            metrics = dict(metrics, _step=self._py_step)
            self._py_step += 1
            pending.append((iteration_of(i), metrics))
        last = self._flush_train_logs(pending, trained_classes=np.nonzero(class_mask)[0])
        if use_my_cl and last is not None:
            # counts of the LAST batch, as the reference logs them
            self._log_reset_counts(last, pending[-1][0])
        return len(pending)

    def _device_data(self, dataset: EmbeddingDataset, bs: Optional[int] = None):
        """Upload a dataset once, padded to whole batches with a validity
        mask; reused by every epoch and eval pass that touches it.  On a
        mesh every rank holds all of it (see ``parallel/mesh.py``)."""
        bs = bs or self.cfg.batch_size
        did = id(dataset)
        key = (did, bs)
        cached = self._device_data_cache.get(key)
        if cached is not None:
            return cached
        with annotate("upload"):
            n = len(dataset)
            n_pad = num_batches(n, bs) * bs
            embs = np.zeros((n_pad, dataset.embeddings.shape[1]), np.float32)
            labels = np.zeros((n_pad, dataset.labels.shape[1]), np.float32)
            valid = np.zeros(n_pad, np.float32)
            embs[:n] = dataset.embeddings
            labels[:n] = dataset.labels
            valid[:n] = 1.0
            cached = (self._up(embs), self._up(labels), self._up(valid))
        count("upload_bytes", embs.nbytes + labels.nbytes + valid.nbytes)
        try:
            if did not in self._cache_refs:
                wself = weakref.ref(self)

                def _evict(_ref, did=did, wself=wself):
                    s = wself()
                    if s is None:
                        return
                    s._cache_refs.pop(did, None)
                    for k in [k for k in s._device_data_cache if k[0] == did]:
                        del s._device_data_cache[k]

                self._cache_refs[did] = weakref.ref(dataset, _evict)
            self._device_data_cache[key] = cached
        except TypeError:
            pass  # not weakref-able: skip caching rather than risk a stale hit
        return cached

    def _epoch_perm(self, n: int, n_pad: int) -> np.ndarray:
        """One epoch's (n_pad,) row order, consuming the shared counters.
        Resume and the parity tests depend on every path consuming
        ``_epoch_counter`` / ``_perm_counter`` / the injected source in the
        same order, so this is the one place that does it."""
        cfg = self.cfg
        self._epoch_counter += 1
        if not cfg.shuffle_train:
            return np.zeros(0, np.int64)  # ignored operand
        if self.permutation_source is not None:
            real = self._injected_permutation(n)
            return np.concatenate([real.astype(np.int64), np.arange(n, n_pad, dtype=np.int64)])
        self._perm_counter += 1
        return epoch_permutation(cfg.seed + 1, self._epoch_counter, n, n_pad).numpy()

    def _flush_epoch_metrics(self, fetched, class_mask, use_my_cl, iteration_of) -> None:
        """One epoch's stacked host metrics ({k: (n_batches,)}) into the
        per-batch logging of :meth:`_flush_train_logs`."""
        n_b = len(fetched["loss"])
        if n_b == 0:
            return  # an empty unit: nothing trained, nothing to log
        with annotate("train-logs"):
            pending = []
            for i in range(n_b):
                metrics = {k: v[i] for k, v in fetched.items()}
                metrics["_step"] = self._py_step
                self._py_step += 1
                pending.append((iteration_of(i), metrics))
            last = self._flush_train_logs(pending,
                                          trained_classes=np.nonzero(np.asarray(class_mask))[0])
            if use_my_cl and last is not None and "n_reset" in last:
                self._log_reset_counts(last, pending[-1][0])

    def _train_fused(self, dataset, class_mask, threshold, use_my_cl, iteration_of) -> int:
        """One epoch in one call (steps.build_fused_epoch); returns the
        number of batches run."""
        d_embs, d_labels, d_valid = self._device_data(dataset)
        perm = self._up(self._epoch_perm(len(dataset), int(d_embs.shape[0])))
        with annotate("fused-train-epoch"):
            self.state, stacked = self._fused_epoch(
                self.state, d_embs, d_labels, d_valid, self.bank, self._up(class_mask),
                self._scalar(threshold), perm,
            )
            fetched = readback(stacked)
        self._flush_epoch_metrics(fetched, class_mask, use_my_cl, iteration_of)
        return len(fetched["loss"])

    # ------------------------------------------------------------------
    # Fused unit: all E epochs of one incremental unit in one call
    # ------------------------------------------------------------------
    def unit_fusible(self, dataset) -> bool:
        """Whether :meth:`train_unit` can run this dataset: the flag is set,
        the fused-epoch machinery exists, and the data is a device-residentable
        :class:`EmbeddingDataset`."""
        return (
            self.cfg.fused_unit
            and self._fused_epoch is not None
            and isinstance(dataset, EmbeddingDataset)
        )

    def train_unit(
        self,
        dataset: EmbeddingDataset,
        thresholds: Sequence[float],
        *,
        part: Optional[int] = None,
        actual_task: Optional[int] = None,
        last_batch: int = 0,
        current_task: Optional[int] = None,
        more_labels: bool = False,
        use_prof: bool = False,
        eval_data: Optional[tuple] = None,
    ) -> int:
        """All ``len(thresholds)`` epochs of one unit in one call
        (steps.build_fused_unit); streams, counters and order consumption
        equal ``len(thresholds)`` calls of :meth:`train` /
        :meth:`train_class_incremental`.  ``eval_data=(val, test)`` folds the
        post-unit eval passes in, for the next ``validate``/``test`` to
        consume.  Returns ``last_batch + E * n_b``."""
        cfg = self.cfg
        self._invalidate_folds()
        n_epochs = len(thresholds)
        if n_epochs == 0:
            return last_batch
        use_my_cl = (
            cfg.continual_learning == ContinualLearning.MY_CL
            and actual_task is not None
            and actual_task > 1
        )
        class_mask = _unit_class_mask(current_task, more_labels)
        # zero thresholds make both resets exact no-ops
        eff = list(thresholds) if (use_my_cl or use_prof) else [0.0] * n_epochs
        fold_eval = (
            eval_data is not None
            and self._fused_eval is not None
            and all(isinstance(d, EmbeddingDataset) for d in eval_data)
        )
        fetched, evals, _ = self._dispatch_fused_unit(
            dataset, eff, use_prof, "final" if fold_eval else None,
            eval_data if fold_eval else None, class_mask, "fused-train-unit",
        )
        if fold_eval:
            self._pending_eval = [(eval_data[0], evals[0]), (eval_data[1], evals[1])]
        prof_nr = fetched.pop("prof_n_reset", None)
        prof_nu = fetched.pop("prof_n_updated", None)
        n_b = fetched["loss"].shape[1]
        for e in range(n_epochs):
            base = (part - 1) * cfg.epochs * n_b + e * n_b if part is not None else last_batch + e * n_b
            self._flush_epoch_metrics(
                {k: v[e] for k, v in fetched.items()}, class_mask, use_my_cl,
                lambda i, base=base: base + i + 1,
            )
            if use_prof:
                # prof_incremental's stream position (Trainer.py:1589-1632)
                step = ((actual_task or 1) - 1) * cfg.epochs + e + 1
                self._log_reset_counts({"n_reset": prof_nr[e], "n_updated": prof_nu[e]}, step)
        return last_batch + n_epochs * n_b

    def _get_fused_unit(self, use_prof: bool, eval_mode):
        key = (use_prof, eval_mode)
        if key not in self._fused_unit_cache:
            self._fused_unit_cache[key] = build_fused_unit(
                self.pair, self.cfg, use_prof=use_prof, eval_mode=eval_mode, mesh=self.mesh)
        return self._fused_unit_cache[key]

    def _dispatch_fused_unit(self, dataset, eff_thresholds, use_prof, eval_mode, eval_data,
                             class_mask, tag):
        """Upload one fused-unit call's operands (the (E, n_pad) orders
        drawn through :meth:`_epoch_perm`, the (E,) thresholds, the eval
        data), run it and read its metrics and evals back once, inside a
        trace span named ``tag``.  Returns
        ``(train_metrics, evals_or_None, device_epoch_states_or_None)``."""
        cfg = self.cfg
        n_epochs = len(eff_thresholds)
        d_embs, d_labels, d_valid = self._device_data(dataset)
        n, n_pad = len(dataset), int(d_embs.shape[0])
        with annotate("epoch-orders"):
            d_perms = self._up(np.stack([self._epoch_perm(n, n_pad) for _ in range(n_epochs)]))
            d_thresholds = self._up(np.asarray(eff_thresholds, np.float32))
        eval_ops = ()
        if eval_mode is not None:
            eval_ops = (*self._device_data(eval_data[0], cfg.eval_batch_size),
                        *self._device_data(eval_data[1], cfg.eval_batch_size))
        fused = self._get_fused_unit(use_prof, eval_mode)
        with annotate(tag):
            out = fused(self.state, d_embs, d_labels, d_valid, self.bank, self._up(class_mask),
                        d_thresholds, d_perms, *eval_ops)
            self.state = out[0]
            if eval_mode == "per_epoch":
                return (*readback((out[1], out[2])), out[3])  # epoch states stay on the device
            if eval_mode is not None:
                return (*readback((out[1], out[2])), None)
            return readback(out[1]), None, None

    # ------------------------------------------------------------------
    # Fused joint run: all epochs + per-epoch val/test in one call
    # ------------------------------------------------------------------
    def joint_run_fusible(self, train_ds, eval_data) -> bool:
        return (
            self.unit_fusible(train_ds)
            and self._fused_eval is not None
            and all(isinstance(d, EmbeddingDataset) for d in eval_data)
        )

    def train_joint_run(self, dataset: EmbeddingDataset, threshold, eval_data) -> None:
        """All ``cfg.epochs`` epochs of a joint run and each epoch's val and
        test passes in one call; :meth:`emit_joint_epoch` then replays one
        epoch's logging and stages its evals.  myCL's epoch-1 guard rides
        in as a zero first threshold."""
        cfg = self.cfg
        self._pending_eval = []
        use_my_cl = cfg.continual_learning == ContinualLearning.MY_CL
        eff = [(threshold if (use_my_cl and ep > 1) else 0.0) for ep in range(1, cfg.epochs + 1)]
        fetched, evals, epoch_states = self._dispatch_fused_unit(
            dataset, eff, False, "per_epoch", eval_data, np.ones(NUM_CLASSES, np.float32),
            "fused-joint-run",
        )
        self._joint_fetched = fetched
        self._joint_evals = evals
        self._joint_eval_data = eval_data
        self._joint_states = epoch_states  # device TrainState, (E, ...) tensors

    def emit_joint_epoch(self, epoch: int) -> None:
        """Replay epoch ``epoch``'s logging from the fused joint run, stage
        its eval results and restore its post-epoch state.  Call in order."""
        e = epoch - 1
        fetched = self._joint_fetched
        if fetched is None:
            raise RuntimeError(
                "emit_joint_epoch without a staged train_joint_run (the "
                "staging is dropped whenever params change outside the fold)"
            )
        n_b = fetched["loss"].shape[1]
        use_my_cl = self.cfg.continual_learning == ContinualLearning.MY_CL and epoch > 1
        self._flush_epoch_metrics(
            {k: v[e] for k, v in fetched.items()}, np.ones(NUM_CLASSES, np.float32), use_my_cl,
            lambda i: e * n_b + i + 1,
        )
        val_out, test_out = self._joint_evals
        self._pending_eval = [
            (self._joint_eval_data[0], tuple(x[e] for x in val_out)),
            (self._joint_eval_data[1], tuple(x[e] for x in test_out)),
        ]
        self.state = unstack(self._joint_states, e)
        if epoch == self.cfg.epochs:
            self._joint_fetched = self._joint_evals = None
            self._joint_eval_data = self._joint_states = None

    # ------------------------------------------------------------------
    # Fused incremental run: all units + their post-unit evals, one call
    # ------------------------------------------------------------------
    def incremental_run_fusible(self, units, eval_data) -> bool:
        """Whether :meth:`train_incremental_run` can fold a whole run: units
        of uneven length fold too (padded with fully masked batches, which
        the step guard makes exact no-ops)."""
        return (
            self.cfg.fused_unit
            and self.cfg.epochs > 0
            and self._fused_epoch is not None
            and self._fused_eval is not None
            and len(units) > 0
            and all(isinstance(u, EmbeddingDataset) and len(u) > 0 for u in units)
            and eval_data is not None
            and all(isinstance(d, EmbeddingDataset) for d in eval_data)
        )

    def _get_fused_run(self, use_prof: bool):
        if use_prof not in self._fused_run_cache:
            self._fused_run_cache[use_prof] = build_fused_run(self.pair, self.cfg, use_prof=use_prof,
                                                              mesh=self.mesh)
        return self._fused_run_cache[use_prof]

    def train_incremental_run(
        self,
        units: Sequence[EmbeddingDataset],
        schedules: Sequence[Sequence[float]],
        *,
        use_my_cl_units: Sequence[bool],
        use_prof_units: Sequence[bool],
        current_tasks: Optional[Sequence[Optional[int]]] = None,
        more_labels: bool = False,
        eval_data: tuple,
    ) -> None:
        """All remaining units of an incremental run, each unit's epochs and
        its post-unit val/test passes, in one call (steps.build_fused_run);
        :meth:`emit_incremental_unit` then replays one unit's logging,
        stages its evals and restores its post-unit state.  Units whose
        resets are off ride in with zero thresholds."""
        cfg = self.cfg
        self._invalidate_folds()
        n_units = len(units)
        n_epochs = len(schedules[0])
        if current_tasks is None:
            current_tasks = [None] * n_units
        bs = cfg.batch_size
        n_bs = [num_batches(len(u), bs) for u in units]
        n_pad = max(n_bs) * bs
        dim, n_cls = units[0].embeddings.shape[1], units[0].labels.shape[1]
        embs = np.zeros((n_units, n_pad, dim), np.float32)
        labels = np.zeros((n_units, n_pad, n_cls), np.float32)
        valid = np.zeros((n_units, n_pad), np.float32)
        for i, u in enumerate(units):
            embs[i, :len(u)] = u.embeddings
            labels[i, :len(u)] = u.labels
            valid[i, :len(u)] = 1.0
        class_masks = np.stack([_unit_class_mask(ct, more_labels) for ct in current_tasks])
        eff = np.asarray(
            [list(s) if (mc or up) else [0.0] * n_epochs
             for s, mc, up in zip(schedules, use_my_cl_units, use_prof_units)],
            np.float32,
        )
        # the orders in the same unit-major order as per-unit calls would
        # draw them; the counters before the fold let each emit rewind the
        # aux state to its unit boundary
        counters0 = (self._epoch_counter, self._perm_counter)
        perms = np.stack([np.stack([self._epoch_perm(len(u), n_pad) for _ in range(n_epochs)])
                          for u in units])
        val_ops = self._device_data(eval_data[0], cfg.eval_batch_size)
        test_ops = self._device_data(eval_data[1], cfg.eval_batch_size)
        fused = self._get_fused_run(any(use_prof_units))
        with annotate("fused-incremental-run"):
            self.state, stacked, evals, unit_states = fused(
                self.state, self._up(embs), self._up(labels), self._up(valid), self.bank,
                self._up(class_masks), self._up(eff), self._up(perms), *val_ops, *test_ops,
            )
            fetched, evals = readback((stacked, evals))
        self._run_staging = {
            "fetched": fetched,            # {k: (U, E, n_b)} host arrays
            "evals": evals,                # ((U, ...) val, (U, ...) test), host
            "eval_data": eval_data,
            "unit_states": unit_states,    # device TrainState, (U, ...) tensors
            "class_masks": class_masks,
            "use_my_cl": list(use_my_cl_units),
            "use_prof": list(use_prof_units),
            "counters0": counters0,
            "n_units": n_units,
            "n_bs": n_bs,  # per-unit real batch counts (emit trims to these)
        }

    def emit_incremental_unit(
        self,
        idx: int,
        *,
        part: Optional[int] = None,
        actual_task: Optional[int] = None,
        last_batch: int = 0,
    ) -> int:
        """Replay unit ``idx``'s logging from the fused run, stage its eval
        results and restore its post-unit state.  Call in unit order.
        Returns the class-incremental ``last_batch`` threading value."""
        staging = self._run_staging
        if staging is None:
            raise RuntimeError("emit_incremental_unit without a staged train_incremental_run")
        fetched = {k: v[idx] for k, v in staging["fetched"].items()}
        prof_nr = fetched.pop("prof_n_reset", None)
        prof_nu = fetched.pop("prof_n_updated", None)
        n_b = staging["n_bs"][idx]
        fetched = {k: v[:, :n_b] for k, v in fetched.items()}
        class_mask = staging["class_masks"][idx]
        use_my_cl = staging["use_my_cl"][idx]
        n_epochs = fetched["loss"].shape[0]
        epochs = self.cfg.epochs
        for e in range(n_epochs):
            base = (part - 1) * epochs * n_b + e * n_b if part is not None else last_batch + e * n_b
            self._flush_epoch_metrics(
                {k: v[e] for k, v in fetched.items()}, class_mask, use_my_cl,
                lambda i, base=base: base + i + 1,
            )
            if staging["use_prof"][idx]:
                step = ((actual_task or 1) - 1) * epochs + e + 1
                self._log_reset_counts({"n_reset": prof_nr[e], "n_updated": prof_nu[e]}, step)
        val_out, test_out = staging["evals"]
        self._pending_eval = [
            (staging["eval_data"][0], tuple(x[idx] for x in val_out)),
            (staging["eval_data"][1], tuple(x[idx] for x in test_out)),
        ]
        self.state = unstack(staging["unit_states"], idx)
        # rewind the order counters to this unit's boundary (aux_state saved
        # here must equal the per-unit path's)
        c_epoch, c_perm = staging["counters0"]
        self._epoch_counter = c_epoch + (idx + 1) * n_epochs
        if self.cfg.shuffle_train:
            self._perm_counter = c_perm + (idx + 1) * n_epochs
        if idx + 1 == staging["n_units"]:
            self._run_staging = None
        return last_batch + n_epochs * n_b

    # ------------------------------------------------------------------
    # Class-incremental  —  Trainer.py:608-756
    # ------------------------------------------------------------------
    def train_class_incremental(
        self,
        dataset: EmbeddingDataset,
        epoch: int,
        current_task: int,
        last_batch: int = 0,
        threshold: Optional[float] = None,
        actual_task: Optional[int] = None,
        more_labels: bool = False,
    ) -> int:
        cfg = self.cfg
        self._invalidate_folds()
        use_my_cl = (
            cfg.continual_learning == ContinualLearning.MY_CL
            and actual_task is not None
            and actual_task > 1
        )
        class_mask = _unit_class_mask(current_task, more_labels)
        thr = threshold if use_my_cl else 0.0
        iteration_of = lambda i: last_batch + i + 1  # noqa: E731
        if self._fused_epoch is not None and isinstance(dataset, EmbeddingDataset):
            return last_batch + self._train_fused(dataset, class_mask, thr, use_my_cl, iteration_of)
        return last_batch + self._train_batches(dataset, class_mask, thr, use_my_cl, iteration_of)

    # ------------------------------------------------------------------
    # profCL  —  Trainer.py:1589-1641
    # ------------------------------------------------------------------
    def model_copy(self) -> None:
        # no step writes into a state's tensors, so holding them is a snapshot
        self._snapshot = dict(self.state.params)

    def prof_incremental(self, epoch: int, epochs: int, actual_task: int, threshold: float) -> None:
        if self._snapshot is None:
            raise RuntimeError("prof_incremental requires a prior model_copy()")
        self._invalidate_folds()
        params, n_reset, n_updated = self._epoch_reset(
            self.state.params, self._snapshot, self._scalar(threshold))
        self.state = self.state._replace(params=params)
        step = (actual_task - 1) * epochs + epoch
        self._log_reset_counts({"n_reset": n_reset, "n_updated": n_updated}, step)

    # ------------------------------------------------------------------
    # Evaluation  —  Trainer.py:772-1072
    # ------------------------------------------------------------------
    def _eval_pass(self, dataset: EmbeddingDataset, epoch: int, log_loss_prefix: Optional[str]):
        with annotate("eval-pass"):
            return self._eval_pass_inner(dataset, epoch, log_loss_prefix)

    def _eval_pass_inner(self, dataset: EmbeddingDataset, epoch: int,
                         log_loss_prefix: Optional[str]):
        cfg = self.cfg
        n_b = num_batches(len(dataset), cfg.eval_batch_size)
        precomputed = None
        if self._pending_eval:
            if self._pending_eval[0][0] is dataset:
                # an eval-folded call already ran this pass with the current params
                precomputed = self._pending_eval.pop(0)[1]
            else:
                self._pending_eval = []  # out of order: recompute
        if precomputed is None and self._fused_eval is not None and isinstance(dataset, EmbeddingDataset):
            d_embs, d_labels, d_valid = self._device_data(dataset, cfg.eval_batch_size)
            precomputed = readback(
                self._fused_eval(self.state.params, d_embs, d_labels, d_valid, self.bank))
        if precomputed is not None:
            losses, scores, preds = precomputed
            if log_loss_prefix is not None:
                for i, loss in enumerate(losses, start=1):
                    self.writer.add_scalar(f"{log_loss_prefix}/Loss", float(loss),
                                           (epoch - 1) * n_b + i)
            n = len(dataset)
            return dataset.labels, preds[:n], scores[:n]
        device_out, host_labels, host_masks = [], [], []
        for embs, labels, mask in self._batches(dataset, cfg.eval_batch_size, shuffle=False):
            loss, scores, preds, _ = self._eval_step(
                self.state.params, self._up(embs), self._up(labels), self._up(mask), self.bank)
            device_out.append((loss, scores, preds))
            host_labels.append(labels)
            host_masks.append(mask)
        fetched = readback(device_out)
        y_true, y_pred, y_score = [], [], []
        for batch_idx, ((loss, scores, preds), labels, mask) in enumerate(
            zip(fetched, host_labels, host_masks), start=1
        ):
            if log_loss_prefix is not None:
                self.writer.add_scalar(f"{log_loss_prefix}/Loss", float(loss),
                                       (epoch - 1) * n_b + batch_idx)
            valid = mask > 0
            y_true.append(labels[valid])
            y_pred.append(preds[valid])
            y_score.append(scores[valid])
        return np.concatenate(y_true), np.concatenate(y_pred), np.concatenate(y_score)

    def _emit_heatmaps_if_due(self, val_test, mode, epoch, epochs, tasks_order,
                              f1_rows, auroc_rows, final_unit=None):
        """Epoch x class (joint/data-inc) and task x class (class-inc)
        forgetting heatmaps (Trainer.py:944-984).  The reference hardcodes
        the class-incremental milestone at task 5 (Trainer.py:965);
        ``final_unit`` makes it follow the run's task count."""
        if epoch == epochs and mode in ("joint", "zero", "data-inc"):
            # only the rows accumulated (fewer after a mid-run resume)
            rows = [str(i) for i in range(epochs - len(f1_rows) + 1, epochs + 1)]
            cols = self.class_names
            tag = f"{val_test}/joint train/"
        elif (epoch == (final_unit if final_unit is not None else 5)
              and mode in ("class-pos-neg", "class-pos")):
            order = list(tasks_order or range(NUM_CLASSES))
            unit = final_unit if final_unit is not None else 5
            # row i is the eval after task i (class order[i-1]); only the
            # first `unit` classes are trained, and a resume keeps the
            # trailing rows: the tail of the first `unit` trained classes
            rows = [self.class_names[i] for i in order][:unit][-len(f1_rows):]
            cols = [self.class_names[i] for i in order]
            tag = f"{val_test}/{mode} incremental/"
        else:
            return
        f1_map = np.stack(f1_rows)
        auroc_map = np.stack(auroc_rows)
        self.writer.add_figure(tag + "F1 score Heatmap",
                               plots.heatmap_figure(f1_map, rows, cols, "F1 score", "F1"))
        self.writer.add_figure(tag + "AUROC score Heatmap",
                               plots.heatmap_figure(auroc_map, rows, cols, "AUROC score", "AUROC"))

    def _plot_now(self, mode, epoch, epochs, final_unit) -> bool:
        """The figure cadence: every eval ("reference") or the last epoch,
        part or task ("final"; class-incremental evals carry the task in
        ``epoch`` and its milestone is the last task)."""
        last = final_unit if (
            final_unit is not None and mode in ("class-pos-neg", "class-pos")
        ) else epochs
        return (
            self.cfg.plot_figures == "reference"
            or (self.cfg.plot_figures == "final" and epoch == last)
        ) and self.writer.writes

    def evaluate_model(self, y_true, y_pred, y_score, mode, epoch, val_test, epochs, tasks_order,
                       final_unit=None):
        metrics = compute_metrics(y_true, y_pred, y_score)
        w = self.writer
        w.add_scalar(f"{val_test}/Accuracy", metrics["accuracy"], epoch)
        w.add_scalar(f"{val_test}/F1-macro score", metrics["f1_macro"], epoch)
        w.add_scalar(f"{val_test}/F1-weighted score", metrics["f1_weighted"], epoch)
        w.add_scalar(f"{val_test}/AUROC-macro", metrics["auroc_macro"], epoch)
        w.add_scalar(f"{val_test}/AUROC-weighted", metrics["auroc_weighted"], epoch)
        pc = per_class_metrics(y_true, y_pred, y_score)
        if self._plot_now(mode, epoch, epochs, final_unit):
            for i in range(y_true.shape[1]):
                w.add_figure(f"{val_test} ROC Curve/Curve for Class {i}",
                             plots.roc_curve_figure(y_true[:, i], y_score[:, i], i), epoch)
                w.add_figure(f"{val_test} Precision-Recall Curve/Curve for Class {i}",
                             plots.pr_curve_figure(y_true[:, i], y_score[:, i], i), epoch)
            for name, key in (("Accuracy", "accuracy"), ("Precision", "precision"),
                              ("Recall", "recall")):
                w.add_figure(f"{val_test} Class-metric/Class {name}",
                             plots.class_scatter_figure(pc[key], name), epoch)
        if val_test == "val":
            self.val_f1_rows.append(pc["f1"])
            self.val_auroc_rows.append(pc["auroc"])
            rows = (self.val_f1_rows, self.val_auroc_rows)
        else:
            self.test_f1_rows.append(pc["f1"])
            self.test_auroc_rows.append(pc["auroc"])
            rows = (self.test_f1_rows, self.test_auroc_rows)
        if self.cfg.plot_figures != "off" and self.writer.writes:
            self._emit_heatmaps_if_due(val_test, mode, epoch, epochs, tasks_order, *rows,
                                       final_unit=final_unit)
        return metrics

    def quick_auroc(self, dataset: EmbeddingDataset) -> np.ndarray:
        """Per-class AUROC computed on the device (rank statistic), for
        in-loop monitoring; NaN for a class with no valid positive or
        negative."""
        from incremental_multimodal_medical_learning_ii_torch.evaluation.metrics import (
            auroc_device,
        )

        if self._fused_eval is None:
            y_true, _, y_score = self._eval_pass(dataset, 1, log_loss_prefix=None)
            return readback(auroc_device(torch.from_numpy(np.asarray(y_score)),
                                         torch.from_numpy(y_true),
                                         torch.ones(len(y_true))))
        d_embs, d_labels, d_valid = self._device_data(dataset, self.cfg.eval_batch_size)
        _, scores, _ = self._fused_eval(self.state.params, d_embs, d_labels, d_valid, self.bank)
        return readback(auroc_device(scores, d_labels, d_valid))

    def validate(self, dataset, epoch, epochs, mode="joint", tasks_order=None, final_unit=None):
        y_true, y_pred, y_score = self._eval_pass(dataset, epoch, log_loss_prefix="val")
        with annotate("eval-metrics"):
            return self.evaluate_model(y_true, y_pred, y_score, mode, epoch, "val",
                                       epochs, tasks_order, final_unit=final_unit)

    def test(self, dataset, epoch, epochs, mode="joint", tasks_order=None,
             tsne_datasets: Optional[Sequence[EmbeddingDataset]] = None, final_unit=None):
        y_true, y_pred, y_score = self._eval_pass(dataset, epoch, log_loss_prefix=None)
        with annotate("eval-metrics"):
            metrics = self.evaluate_model(y_true, y_pred, y_score, mode, epoch, "test", epochs,
                                          tasks_order, final_unit=final_unit)
        if self._plot_now(mode, epoch, epochs, final_unit):
            self._plot_text_embedding_figures(epoch)
            if tsne_datasets is not None:
                self._plot_image_tsne(tsne_datasets, epoch)
        return metrics

    # ------------------------------------------------------------------
    # Analysis plots (Trainer.py:1074-1554)
    # ------------------------------------------------------------------
    def adapted_mean_prompt_embeddings(self):
        """(C, D) pos / neg adapted mean prompt embeddings on the trainer's
        device (the 'to_plot' path of bert_forward_mean: the mean even in
        MAX mode)."""
        with torch.no_grad():
            bank = adapt_bank(self.pair, self.state.params, self.bank)
            return masked_mean(bank.pos, bank.pos_count), masked_mean(bank.neg, bank.neg_count)

    def _plot_text_embedding_figures(self, epoch: int) -> None:
        pos, neg = self.adapted_mean_prompt_embeddings()
        fig = plots.prompt_cosine_heatmap_figure(pos, neg if self.cfg.train_logit_diff else None,
                                                 self.cfg.single_prompt)
        self.writer.add_figure("visual-embeddings/cosine-similarity Heatmap text-embs", fig, epoch)
        pca_fig, tsne_fig = plots.prompt_projection_figures(pos, neg, seed=self.cfg.seed)
        self.writer.add_figure("visual-embeddings/PCA text-embs", pca_fig, epoch)
        self.writer.add_figure("visual-embeddings/t-SNE text-embs", tsne_fig, epoch)

    def _plot_image_tsne(self, tsne_datasets: Sequence[EmbeddingDataset], epoch: int) -> None:
        multiclass, sani_malati = tsne_datasets
        for ds, kind, tag in (
            (sani_malati, "sani-malati", "tsne-chexpert/t-SNE sani-malati"),
            (multiclass, "multiclass", "tsne-chexpert/t-SNE 5x1000"),
        ):
            if len(ds) == 0:
                continue
            adapted = self._embed(self.state.params, self._up(ds.embeddings))
            fig = plots.embedding_tsne_figure(adapted, ds.labels, kind, seed=self.cfg.seed)
            self.writer.add_figure(tag, fig, epoch)
