"""Vmapped hyperparameter sweeps (counterpart of the JAX package's
``engine/sweep.py``).

K sweep points that differ only in learning rate and seed share one
program: the learning rate is a tensor in the ``TrainState``
(``engine/steps.py::init_train_state``) and each seed stacks its own init
and epoch orders.  Stacking the K states and ``torch.func.vmap``-ing the
training (``engine/steps.py::build_vmapped_sweep``) trains all K at once as
batched products instead of K runs of small ones.  The reference's drivers
run one configuration a process (``ZERO_JOINT_BOUNDS.py:16-31``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from incremental_multimodal_medical_learning_ii_torch.data.store import (
    EmbeddingDataset,
    num_batches,
)
from incremental_multimodal_medical_learning_ii_torch.engine.steps import (
    _stack,
    build_vmapped_sweep,
    epoch_permutation,
    init_train_state,
    params_from_modules,
)
from incremental_multimodal_medical_learning_ii_torch.models.adapters import AdapterPair
from incremental_multimodal_medical_learning_ii_torch.objectives.scorer import PromptBank
from incremental_multimodal_medical_learning_ii_torch.utils.config import ExperimentConfig
from incremental_multimodal_medical_learning_ii_torch.utils.device import (
    readback,
    resolve_device,
    upload,
)


def _pad_whole_batches(ds: EmbeddingDataset, bs: int):
    """Zero-pad to whole batches with a validity mask: the layout
    ``Trainer._device_data`` uploads (numpy)."""
    n = len(ds)
    n_pad = num_batches(n, bs) * bs
    embs = np.zeros((n_pad, ds.embeddings.shape[1]), np.float32)
    labels = np.zeros((n_pad, ds.labels.shape[1]), np.float32)
    valid = np.zeros(n_pad, np.float32)
    embs[:n] = ds.embeddings
    labels[:n] = ds.labels
    valid[:n] = 1.0
    return embs, labels, valid


def epoch_orders(cfg: ExperimentConfig, n_real: int, n_pad: int,
                 permutation_source: Optional[Callable] = None) -> np.ndarray:
    """One point's (E, n_pad) epoch orders: those a fresh ``Trainer`` at
    ``cfg.seed`` draws (``Trainer._epoch_perm``: counters 1..E), or the
    ``permutation_source(cfg, epoch_index, n_real)`` permutations of the
    real rows with the padding at the tail (how the parity tests inject the
    JAX package's orders)."""
    orders = []
    for e in range(cfg.epochs):
        if permutation_source is None:
            orders.append(epoch_permutation(cfg.seed + 1, e + 1, n_real, n_pad).numpy())
        else:
            real = np.asarray(permutation_source(cfg, e, n_real), np.int64)
            orders.append(np.concatenate([real, np.arange(n_real, n_pad, dtype=np.int64)]))
    return np.stack(orders) if orders else np.zeros((0, n_pad), np.int64)


def run_vmapped_sweep(
    cfgs: Sequence[ExperimentConfig],
    train: EmbeddingDataset,
    val: EmbeddingDataset,
    bank: PromptBank,
    device=None,
    permutation_source: Optional[Callable] = None,
) -> np.ndarray:
    """Train every config in ``cfgs`` (one program: they differ in lr and
    seed only) for ``cfg.epochs`` fused epochs and return the (K, C)
    per-class val AUROCs, read back once.

    The sequential path's math: each point's init from its own seed and
    the epoch orders a fresh ``Trainer`` at that seed draws
    (:func:`epoch_orders`), the fused epoch's body, and the scoring of
    ``Trainer.quick_auroc``; batching reorders the sums of the products, so
    a point agrees with its sequential run within fp32 reassociation
    (``tests/test_torch_sweep.py``).  Runs on CUDA unless ``device="cpu"``.
    Raises ValueError for point sets one program cannot serve (the CLI then
    runs them sequentially, loudly)."""
    cfg0 = cfgs[0]
    for c in cfgs[1:]:
        if dataclasses.replace(c, lr=cfg0.lr, seed=cfg0.seed) != cfg0:
            raise ValueError(
                "vmapped sweep points must differ only in lr/seed (adapter/"
                "optim/prompt knobs change the compiled program — group them)"
            )
    if cfg0.lr_schedule is not None:
        raise ValueError(
            "vmapped sweep needs a constant lr (the dynamic optax "
            "hyperparam); an lr schedule bakes the rate into the program"
        )
    pair = AdapterPair(kind=cfg0.adapter, shared=cfg0.shared,
                       use_image=cfg0.image_adapter, use_text=cfg0.text_adapter)
    if not cfg0.trains_anything:
        raise ValueError("nothing to sweep: the config trains no adapter")
    sweep = build_vmapped_sweep(pair, cfg0)
    device = resolve_device(device)
    states = _stack([
        init_train_state(params_from_modules(pair.init(torch.Generator().manual_seed(c.seed)),
                                             device), c, device)
        for c in cfgs
    ])
    train_ops = _pad_whole_batches(train, cfg0.batch_size)
    val_ops = _pad_whole_batches(val, cfg0.eval_batch_size)
    n_pad = train_ops[0].shape[0]
    if cfg0.shuffle_train:
        perms = np.stack([epoch_orders(c, len(train), n_pad, permutation_source) for c in cfgs])
    else:
        perms = np.zeros((len(cfgs), cfg0.epochs, 0), np.int64)
    # from here to the readback nothing waits on the card
    t_embs, t_labels, t_valid = (upload(a, device) for a in train_ops)
    v_embs, v_labels, v_valid = (upload(a, device) for a in val_ops)
    d_bank = PromptBank(*(upload(t.cpu().numpy(), device) for t in bank))
    _, aurocs = sweep(states, t_embs, t_labels, t_valid, d_bank, upload(perms, device),
                      v_embs, v_labels, v_valid)
    return readback(aurocs)
