"""Train and eval steps over device-resident cached embeddings
(counterpart of the JAX package's ``engine/steps.py``).

One train step is the reference's per-batch work (``Trainer.py:537-601``):
image adapter, text adapter over the cached prompt bank, cosine scores of
all classes, masked BCE, ``torch.autograd.grad``, the optimiser update,
optionally the myCL reset, and the monitor metrics.  Class subsets and
ragged final batches are masks over static shapes, as in the JAX package.

Parameters are a dict of tensors (``"image.dense1.weight"``, ... as the
adapters' ``nn.ModuleDict`` names them) and the state a
:class:`TrainState` of tensors; every function here returns new tensors
and never writes into its inputs, so a state that was handed out stays
valid.  The optimiser follows optax's order of operations (``adam`` under
``inject_hyperparams``, ``sgd``, ``exponential_decay``), with the learning
rate a tensor in the state.

The fused functions (:func:`build_fused_epoch`, :func:`build_fused_unit`,
:func:`build_fused_run`, :func:`build_fused_eval`) are Python loops over
epochs and batches on tensors already on the device.  Their metrics stay
on the device and come back stacked in the JAX functions' shapes; nothing
in them reads a value back to the host, so on CUDA the host queues the
whole epoch, unit or run ahead of the card and the caller reads back once.
Each eval batch runs in an ``eval-batch`` span (``utils/profiling.py``),
counted as ``eval_batches``.

On one card the host could not keep up with it: an epoch is ``n_pad / B``
steps of about a hundred small eager kernels each (forward,
``torch.autograd.grad``, Adam, the guard's select), and the card idled
while Python dispatched them.  So where the operands are CUDA tensors and
there is no mesh, an epoch (the row gather by ``perm`` and every step) is
a CUDA graph (:class:`EpochGraph`): captured once per signature of its
operands' shapes and dtypes, in a cache each fused callable keeps (so a
``Trainer`` holds its graphs and their memory pools, and frees them with
itself), then replayed once an epoch, after the state, the threshold and
the order are copied into its static buffers (the unit's data when a unit
begins).  A capture costs an epoch's dispatch once, plus a few warm-up
steps.  The graph runs the same ``core`` as the eager loop, and the fused
calls return clones of its outputs, never its buffers.  The eager loop
runs every other call: CPU operands, any mesh (NCCL or gloo), and a call
made while a capture is under way (an enclosing graph captures the eager
loop).  An eager step runs in a ``train-step`` span, counted as
``train_steps``; a capture runs in ``train-graph-capture``
(``train_graph_captures``), a replay in ``train-epoch-replay``
(``train_graph_replays``, and ``train_steps`` by the epoch's steps).  The
eval passes, profCL's reset between epochs and :func:`build_train_step`
stay eager.

:func:`build_vmapped_sweep` trains K sweep points of one program at once:
``torch.func.vmap`` of the fused epoch's body over (K, ...)-stacked states,
the gradient from ``torch.func.grad_and_value`` of the loss factored out as
:func:`_loss` (the train step above keeps ``torch.autograd.grad`` and its
bits); each point is then scored outside the vmap by the eval pass.

Train steps score through ``ops/cosine.py`` (gradients flow there); eval
passes run under ``torch.no_grad()`` and score through
``score_embeddings(use_kernel=True)``: on CUDA tensors that is the fused
cosine kernel (one launch a batch in MEAN/SINGLE, two in MAX), on CPU
tensors its plain version.  The device decides, as ``_eval_uses_pallas``
does in the JAX package.

Every builder takes ``mesh=`` (``parallel/mesh.py``): the functions then
run on each rank of a data-parallel group, with the same replicated
operands everywhere.  A train step takes the rank's rows of the global
batch; its loss, the MAX-gap averages and the empty-batch guard divide by
or test the global batch's mask counts, which every rank reads off the
replicated batch; one ``all_reduce`` sums the gradients, the loss and the
gap sums, so every rank applies the same update.  An eval batch is scored
on the rank's rows through the mesh variant of the kernel
(``pairwise_cosine_sharded``) and gathered before its loss, so every
output is the whole batch's.  The JAX package's mesh eval turns its Pallas
kernel off (``pallas_call`` under whole-array ``jit`` rejects sharded
operands); here each rank holds plain local tensors, so the kernel runs.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map

from incremental_multimodal_medical_learning_ii_torch.engine.cl import weight_reset
from incremental_multimodal_medical_learning_ii_torch.models.adapters import AdapterPair
from incremental_multimodal_medical_learning_ii_torch.objectives.losses import (
    bce_with_logits,
    change_labels,
)
from incremental_multimodal_medical_learning_ii_torch.objectives.scorer import (
    PromptBank,
    apply_text_adapter_to_bank,
    score_embeddings,
)
from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import (
    all_reduce_sum,
    batch_rows,
)
from incremental_multimodal_medical_learning_ii_torch.utils.config import (
    ContinualLearning,
    ExperimentConfig,
    Optim,
)
from incremental_multimodal_medical_learning_ii_torch.utils.profiling import annotate, count

Params = Dict[str, torch.Tensor]
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # torch / optax defaults (Trainer.py:172-186)


class TrainState(NamedTuple):
    params: Params
    mu: Params  # Adam's first moments ({} for SGD)
    nu: Params  # Adam's second moments ({} for SGD)
    count: torch.Tensor  # int32 (): updates made (optax's count)
    lr: torch.Tensor  # float32 (): the base learning rate
    step: torch.Tensor  # int32 ()


# ----------------------------------------------------------------------
# Parameters and the functional adapters
# ----------------------------------------------------------------------
def params_from_modules(modules: nn.ModuleDict, device) -> Params:
    """The adapters' weights as a dict of float32 tensors on ``device``."""
    return {k: v.detach().to(device=device, dtype=torch.float32).clone()
            for k, v in modules.state_dict().items()}


def _adapter(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """MLPAdapter / LinearAdapter forward with the weights from ``params``."""
    h = F.linear(x, params[f"{name}.dense1.weight"], params[f"{name}.dense1.bias"])
    w2 = params.get(f"{name}.dense2.weight")
    if w2 is None:
        return h
    return F.linear(torch.relu(h), w2, params[f"{name}.dense2.bias"])


def apply_image(pair: AdapterPair, params: Params, x: torch.Tensor) -> torch.Tensor:
    return _adapter(params, "shared" if pair.shared else "image", x) if pair.use_image else x


def apply_text(pair: AdapterPair, params: Params, x: torch.Tensor) -> torch.Tensor:
    return _adapter(params, "shared" if pair.shared else "text", x) if pair.use_text else x


def adapt_bank(pair: AdapterPair, params: Params, bank: PromptBank) -> PromptBank:
    if not pair.use_text:
        return bank
    return apply_text_adapter_to_bank(lambda p, x: apply_text(pair, p, x), params, bank)


# ----------------------------------------------------------------------
# Optimiser (optax's order of operations)
# ----------------------------------------------------------------------
def init_train_state(params: Params, cfg: ExperimentConfig, device) -> TrainState:
    if cfg.lr_schedule not in (None, "exponential"):
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    moments = cfg.optim == Optim.ADAM
    zeros = (lambda: {k: torch.zeros_like(v) for k, v in params.items()}) if moments else dict
    return TrainState(
        params=params, mu=zeros(), nu=zeros(),
        count=torch.zeros((), dtype=torch.int32, device=device),
        lr=torch.full((), cfg.lr, dtype=torch.float32, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def learning_rate(cfg: ExperimentConfig, lr: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The rate of the next update: ``lr``, or ``lr * gamma^count`` for the
    per-step exponential schedule (``count`` updates already made)."""
    if cfg.lr_schedule is None:
        return lr
    return lr * cfg.lr_gamma ** count


def lr_at_host(cfg: ExperimentConfig, count: int) -> float:
    """The scheduled rate after ``count`` updates, on the host (the
    ``train/LR`` scalar; float32 as optax computes it)."""
    if cfg.lr_schedule is None:
        return float(np.float32(cfg.lr))
    return float(np.float32(cfg.lr) * np.power(np.float32(cfg.lr_gamma), np.float32(count)))


def optimizer_update(cfg: ExperimentConfig, state: TrainState, grads: Params):
    """(params, mu, nu, count) after one Adam / SGD update."""
    neg_lr = -learning_rate(cfg, state.lr, state.count)
    count = state.count + 1
    if cfg.optim == Optim.SGD:
        return ({k: p + neg_lr * grads[k] for k, p in state.params.items()},
                state.mu, state.nu, count)
    bc1, bc2 = 1 - ADAM_B1 ** count, 1 - ADAM_B2 ** count
    params, mu, nu = {}, {}, {}
    for k, p in state.params.items():
        g = grads[k]
        mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * state.mu[k]
        nu[k] = (1 - ADAM_B2) * (g ** 2) + ADAM_B2 * state.nu[k]
        params[k] = p + neg_lr * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS))
    return params, mu, nu, count


def _select(keep: torch.Tensor, new, old):
    """``torch.where(keep, new, old)`` over every tensor of a state."""
    if isinstance(new, torch.Tensor):
        return torch.where(keep, new, old)
    if isinstance(new, dict):
        return {k: _select(keep, v, old[k]) for k, v in new.items()}
    return type(new)(*(_select(keep, a, b) for a, b in zip(new, old)))


# ----------------------------------------------------------------------
# The train step
# ----------------------------------------------------------------------
def _forward(pair, params, embs, bank, cfg, use_kernel: bool = False):
    return score_embeddings(
        apply_image(pair, params, embs), adapt_bank(pair, params, bank), cfg.prompt_mode,
        cfg.train_logit_diff, cfg.pred_logit_diff, use_kernel=use_kernel,
    )


def _loss(pair, cfg, params, embs, labels, elem_mask, class_mask, bank, mask_sum=None):
    """One batch's masked BCE, a pure function of ``params``, and the
    scorer's outputs."""
    out = _forward(pair, params, embs, bank, cfg)
    lbl = change_labels(labels) if cfg.change_labels else labels
    loss = bce_with_logits(out.logits, lbl, elem_mask[:, None] * class_mask[None, :],
                           mask_sum=mask_sum)
    return loss, out


def _sum_over_ranks(mesh, grads: Params, parts: List[torch.Tensor]):
    """The gradients and the other per-rank partial sums, summed over the
    ranks with one all_reduce of one flat buffer."""
    names = list(grads)
    flat = torch.cat([grads[k].reshape(-1) for k in names] + [p.reshape(-1) for p in parts])
    all_reduce_sum(mesh, flat)
    out, start = [], 0
    for t in [grads[k] for k in names] + parts:
        out.append(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return dict(zip(names, out[:len(names)])), out[len(names):]


def _train_core(pair: AdapterPair, cfg: ExperimentConfig, guard_empty: bool = False,
                mesh=None) -> Callable:
    """``core(state, embs, labels, elem_mask, class_mask, bank, threshold)
    -> (state, metrics)``: forward, masked BCE, backward, update, optional
    myCL reset, monitor metrics (device tensors).

    ``guard_empty`` makes a fully masked batch an exact no-op on the whole
    state (params, moments, count, step): a zero-grad Adam step is not one
    (its moments decay and stale momentum moves the weights).  The select
    is ``torch.where`` on a device predicate, so no value is read back; for
    a real batch it is the identity, bit for bit.

    On a ``mesh`` the batch operands are the global batch and the step
    trains on this rank's rows of it (see the module's docstring)."""
    use_cl = cfg.continual_learning == ContinualLearning.MY_CL
    applications = 2 if cfg.shared else 1  # SHARED: the reference resets its aliased module twice

    def core(state: TrainState, embs, labels, elem_mask, class_mask, bank, threshold):
        names = list(state.params)
        n_rows = mask_sum = None  # the global batch's counts, on a mesh
        if mesh is not None:
            n_rows = torch.sum(elem_mask)
            mask_sum = torch.sum(elem_mask[:, None] * class_mask[None, :])
            embs, labels, elem_mask = (batch_rows(mesh, t) for t in (embs, labels, elem_mask))
        leaves = [state.params[k].detach().requires_grad_(True) for k in names]
        with torch.enable_grad():
            loss, out = _loss(pair, cfg, dict(zip(names, leaves)), embs, labels, elem_mask,
                              class_mask, bank, mask_sum)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            grads = {k: torch.zeros_like(p) if g is None else g for k, p, g in zip(names, leaves, grads)}
            loss = loss.detach()
            gap_sums = []
            if out.max_mean_gap is not None:
                # summed over the real rows; either the (C,) per-class gaps
                # or their mean over the trained classes
                gaps = out.max_mean_gap.detach()
                row_w = elem_mask[:, None]
                gap_sums = [torch.sum(gaps[0] * row_w, dim=0), torch.sum(gaps[1] * row_w, dim=0)]
            if mesh is not None:
                grads, (loss, *gap_sums) = _sum_over_ranks(mesh, grads, [loss, *gap_sums])
            else:
                n_rows = torch.sum(elem_mask)
            params, mu, nu, count = optimizer_update(cfg, state, grads)
            metrics: Dict[str, torch.Tensor] = {"loss": loss}
            if use_cl:
                params, n_reset, n_updated = weight_reset(
                    params, state.params, threshold, applications=applications)
                metrics["n_reset"] = n_reset
                metrics["n_updated"] = n_updated
            if gap_sums:
                denom_c = torch.clamp(torch.sum(class_mask), min=1.0)
                denom_r = torch.clamp(n_rows, min=1.0)
                gap_pos = gap_sums[0] / denom_r
                gap_neg = gap_sums[1] / denom_r
                if cfg.max_gap_per_class:
                    metrics["max_mean_gap_pos_vec"] = gap_pos
                    metrics["max_mean_gap_neg_vec"] = gap_neg
                else:
                    metrics["max_mean_gap_pos"] = torch.sum(gap_pos * class_mask) / denom_c
                    metrics["max_mean_gap_neg"] = torch.sum(gap_neg * class_mask) / denom_c
            out_state = TrainState(params, mu, nu, count, state.lr, state.step + 1)
            if guard_empty:
                out_state = _select(n_rows > 0, out_state, state)
        return out_state, metrics

    return core


def build_train_step(pair: AdapterPair, cfg: ExperimentConfig, mesh=None) -> Callable:
    """step(state, embs, labels, elem_mask, class_mask, bank, threshold)
    -> (state, metrics dict)."""
    return _train_core(pair, cfg, mesh=mesh)


def _stack(items: Sequence):
    """Stack a list of equally shaped dicts / tuples / states of tensors
    along a new leading axis (no items: an epoch of no batches, whose
    metrics are an empty loss stream)."""
    if not items:
        return {"loss": torch.zeros(0)}
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(list(items))
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    if hasattr(first, "_fields"):
        return type(first)(*(_stack([it[i] for it in items]) for i in range(len(first))))
    return tuple(_stack([it[i] for it in items]) for i in range(len(first)))


def unstack(tree, index: int):
    """Slice ``index`` off the leading axis of every tensor (a stacked
    TrainState or eval output), as ``tree_map(lambda x: x[index])``."""
    if isinstance(tree, torch.Tensor):
        return tree[index]
    if isinstance(tree, dict):
        return {k: unstack(v, index) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(unstack(v, index) for v in tree))
    return tuple(unstack(v, index) for v in tree)


def _epoch_scan(core, cfg, state, embs, labels, valid, bank, class_mask, threshold, perm,
                step_spans: bool = True):
    """One epoch over ``(n_pad / B)`` batch slabs; the shuffled order is one
    gather of the whole epoch first (``perm`` has the padding rows at its
    tail), then contiguous slabs.  Returns (state, stacked metrics).
    ``step_spans=False`` opens no ``train-step`` span and counts no step
    (a capture: the replays count them)."""
    b = cfg.batch_size
    if cfg.shuffle_train:
        embs, labels, valid = (t.index_select(0, perm) for t in (embs, labels, valid))
    embs = embs.reshape(-1, b, embs.shape[-1])
    labels = labels.reshape(-1, b, labels.shape[-1])
    valid = valid.reshape(-1, b)
    per_batch = []
    for i in range(embs.shape[0]):
        with annotate("train-step") if step_spans else contextlib.nullcontext():
            state, metrics = core(state, embs[i], labels[i], valid[i], class_mask, bank, threshold)
        if step_spans:
            count("train_steps")
        per_batch.append(metrics)
    return state, _stack(per_batch)


# ----------------------------------------------------------------------
# An epoch as a CUDA graph (see the module's docstring)
# ----------------------------------------------------------------------
WARMUP_STEPS = 3  # eager steps on the capture's stream before it (library handles, workspaces)


def _graphs_epoch(mesh, embs) -> bool:
    """Whether a fused call's epochs over ``embs`` replay a graph: CUDA
    operands, no mesh, rows to train, and no capture already under way on
    the current stream."""
    return (mesh is None and embs.is_cuda and embs.shape[0] > 0
            and not torch.cuda.is_current_stream_capturing())


# one side stream a device for every capture, as ``torch.cuda.graph`` keeps
# one: cuBLAS gets a workspace for each (handle, stream) pair and keeps it
# for the life of the process, so a new stream a capture would grow memory
# run after run
_side_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


class CudaGraph:
    """The capture and replay of one CUDA graph on the side stream of
    ``device``: what :class:`EpochGraph` needs of ``torch.cuda``."""

    def __init__(self, device):
        self.graph = torch.cuda.CUDAGraph()
        device = torch.device(device)
        if device not in _side_streams:
            _side_streams[device] = torch.cuda.Stream(device)
        self.stream = _side_streams[device]

    @contextlib.contextmanager
    def _on_side_stream(self):
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            yield
        current.wait_stream(self.stream)

    def warm_up(self, fn) -> None:
        with self._on_side_stream():
            fn()

    def capture(self, fn):
        """``fn()`` captured; returns its outputs, the graph's static outputs.
        ``capture_begin``/``capture_end`` directly: ``torch.cuda.graph``
        would synchronise the device and empty the allocator's cache on
        every capture."""
        with self._on_side_stream():
            self.graph.capture_begin()
            try:
                out = fn()
            except BaseException:
                with contextlib.suppress(RuntimeError):  # the body's error is the one to raise
                    self.graph.capture_end()
                raise
            self.graph.capture_end()
        return out

    def replay(self) -> None:
        self.graph.replay()


def _signature(tree) -> tuple:
    leaves, spec = tree_flatten(tree)
    return spec, tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)


class EpochGraph:
    """One epoch of :func:`_epoch_scan` over static buffers: copies of the
    state, the unit's operands (embs, labels, valid, bank, class_mask), the
    threshold and the order.  :meth:`body` is the epoch on the buffers; on
    the card :meth:`capture` records it as a graph (``graph`` a
    :class:`CudaGraph`) and :meth:`replay` runs it again on new inputs."""

    def __init__(self, core, cfg, state, embs, labels, valid, bank, class_mask, threshold, perm):
        self._core, self._cfg = core, cfg
        self.state, self.unit, self.threshold, self.perm = tree_map(
            torch.clone, (state, (embs, labels, valid, bank, class_mask), threshold, perm))
        self.n_steps = embs.shape[0] // cfg.batch_size
        self.graph = None
        self.outputs = None  # (state, stacked metrics): the body's outputs at the capture

    def body(self):
        embs, labels, valid, bank, class_mask = self.unit
        return _epoch_scan(self._core, self._cfg, self.state, embs, labels, valid, bank,
                           class_mask, self.threshold, self.perm, step_spans=False)

    def capture(self, graph) -> None:
        """A few eager steps on clones of the state (discarded), then the
        body captured into ``graph``."""
        embs, labels, valid, bank, class_mask = self.unit
        b = self._cfg.batch_size

        def warm():
            state = tree_map(torch.clone, self.state)
            for _ in range(WARMUP_STEPS):
                state, _ = self._core(state, embs[:b], labels[:b], valid[:b], class_mask, bank,
                                      self.threshold)

        with annotate("train-graph-capture"):
            graph.warm_up(warm)
            self.outputs = graph.capture(self.body)
            self.graph = graph
        count("train_graph_captures")

    def load(self, embs, labels, valid, bank, class_mask) -> None:
        """A unit's operands into the buffers."""
        for dst, src in zip(tree_leaves(self.unit),
                            tree_leaves((embs, labels, valid, bank, class_mask))):
            dst.copy_(src)

    def replay(self, state, threshold, perm):
        """One epoch from ``state``: (state, stacked metrics), clones of the
        graph's outputs."""
        with annotate("train-epoch-replay"):
            for dst, src in zip(tree_leaves((self.state, self.threshold, self.perm)),
                                tree_leaves((state, threshold, perm))):
                dst.copy_(src)
            self.graph.replay()
            out = tree_map(torch.clone, self.outputs)
        count("train_graph_replays")
        count("train_steps", self.n_steps)
        return out


class _Epochs:
    """The epochs of a fused callable: ``epochs.of(embs, labels, valid,
    bank, class_mask)`` is one unit's ``epoch(state, threshold, perm) ->
    (state, stacked metrics)``, the eager loop or the replay of a graph
    from ``graphs``, the callable's cache keyed by the operands' signature."""

    def __init__(self, core, cfg, mesh):
        self._core, self._cfg, self._mesh = core, cfg, mesh
        self.graphs: Dict[tuple, EpochGraph] = {}

    def of(self, embs, labels, valid, bank, class_mask) -> Callable:
        unit = (embs, labels, valid, bank, class_mask)
        if not _graphs_epoch(self._mesh, embs):
            return lambda state, threshold, perm: _epoch_scan(
                self._core, self._cfg, state, *unit, threshold, perm)
        graph = None

        def epoch(state, threshold, perm):
            nonlocal graph
            if graph is None:  # the unit's first epoch
                graph = self._graph(state, unit, threshold, perm)
            return graph.replay(state, threshold, perm)

        return epoch

    def _graph(self, state, unit, threshold, perm) -> EpochGraph:
        """The cached graph of this signature, the unit's operands loaded;
        captured on its first use."""
        key = _signature((state, unit, threshold, perm))
        graph = self.graphs.get(key)
        if graph is None:
            graph = EpochGraph(self._core, self._cfg, state, *unit, threshold, perm)
            graph.capture(CudaGraph(unit[0].device))
            self.graphs[key] = graph
        else:
            graph.load(*unit)
        return graph


def build_fused_epoch(pair: AdapterPair, cfg: ExperimentConfig, mesh=None) -> Callable:
    """A whole training epoch over device-resident data:
    ``epoch(state, embs, labels, valid, bank, class_mask, threshold, perm)
    -> (state, stacked metrics)``, the data padded to whole batches and
    ``perm`` the epoch's (N_pad,) row order (ignored, and may be empty,
    with ``shuffle_train=False``)."""
    epochs = _Epochs(_train_core(pair, cfg, mesh=mesh), cfg, mesh)

    def epoch(state, embs, labels, valid, bank, class_mask, threshold, perm):
        return epochs.of(embs, labels, valid, bank, class_mask)(state, threshold, perm)

    return epoch


def _prof_reset(cfg, state, snapshot, threshold, stacked):
    params, n_reset, n_updated = weight_reset(
        state.params, snapshot, threshold, applications=2 if cfg.shared else 1)
    return state._replace(params=params), dict(stacked, prof_n_reset=n_reset,
                                               prof_n_updated=n_updated)


def build_fused_unit(
    pair: AdapterPair,
    cfg: ExperimentConfig,
    use_prof: bool = False,
    eval_mode: Optional[str] = None,
    mesh=None,
) -> Callable:
    """A whole incremental unit (all E epochs of a data-inc part or a
    class-inc task) as one call: ``unit(state, embs, labels, valid, bank,
    class_mask, thresholds (E,), perms (E, n_pad) or (E, 0), *eval_ops)``.

    The per-epoch myCL thresholds, the per-epoch orders and the profCL
    snapshot/reset between epochs are operands and steps of the call, as in
    the JAX ``build_fused_unit``; every metric comes back with a leading
    (E, n_batches) shape (profCL's counts as ``prof_n_reset`` /
    ``prof_n_updated``, (E,)).  ``eval_mode`` adds the val/test operands
    (embs, labels, valid of each, padded to whole eval batches) and folds
    the eval passes in: ``"final"`` once after the last epoch, returning
    ``(state, stacked, (val_out, test_out))``; ``"per_epoch"`` after every
    epoch (the joint driver), returning ``(state, stacked, evals,
    epoch_states)`` with (E, ...) eval outputs and the post-epoch states
    stacked the same way."""
    epochs = _Epochs(_train_core(pair, cfg, mesh=mesh), cfg, mesh)
    if eval_mode not in (None, "final", "per_epoch"):
        raise ValueError(f"unknown eval_mode {eval_mode!r}")

    def _eval_both(params, bank, val_ops, test_ops):
        return (_fused_eval_pass(pair, cfg, params, *val_ops, bank, mesh=mesh),
                _fused_eval_pass(pair, cfg, params, *test_ops, bank, mesh=mesh))

    def unit(state, embs, labels, valid, bank, class_mask, thresholds, perms, *eval_ops):
        if len(eval_ops) != (6 if eval_mode else 0):
            raise TypeError(
                f"eval_mode={eval_mode!r} expects {6 if eval_mode else 0} trailing eval "
                f"operands (val embs/labels/valid, test embs/labels/valid); got {len(eval_ops)}")
        val_ops, test_ops = (eval_ops[:3], eval_ops[3:]) if eval_mode else (None, None)
        per_epoch, evals, states = [], [], []
        epoch = epochs.of(embs, labels, valid, bank, class_mask)
        for e in range(thresholds.shape[0]):
            snapshot = state.params
            state, stacked = epoch(state, thresholds[e], perms[e])
            if use_prof:
                state, stacked = _prof_reset(cfg, state, snapshot, thresholds[e], stacked)
            per_epoch.append(stacked)
            if eval_mode == "per_epoch":
                evals.append(_eval_both(state.params, bank, val_ops, test_ops))
                states.append(state)
        stacked = _stack(per_epoch)
        if eval_mode is None:
            return state, stacked
        if eval_mode == "final":
            return state, stacked, _eval_both(state.params, bank, val_ops, test_ops)
        return state, stacked, _stack(evals), _stack(states)

    return unit


def build_fused_run(pair: AdapterPair, cfg: ExperimentConfig, use_prof: bool = False,
                    mesh=None) -> Callable:
    """A whole incremental run, every unit's epochs and its post-unit
    val/test eval passes, as one call: ``run(state, embs (U,n_pad,D),
    labels (U,n_pad,C), valid (U,n_pad), bank, class_masks (U,C),
    thresholds (U,E), perms (U,E,n_pad) or (U,E,0), val_embs, val_labels,
    val_valid, test_embs, test_labels, test_valid) -> (state, stacked,
    (val_out, test_out), unit_states)``: metrics lead with (U, E,
    n_batches), eval outputs with (U,), ``unit_states`` is a TrainState of
    (U, ...) tensors.  Units of uneven length are padded to the largest
    with fully masked batches, which the step guard makes exact no-ops; a
    unit whose resets are off rides in with zero thresholds."""
    epochs = _Epochs(_train_core(pair, cfg, guard_empty=True, mesh=mesh), cfg, mesh)

    def run(state, embs, labels, valid, bank, class_masks, thresholds, perms,
            val_embs, val_labels, val_valid, test_embs, test_labels, test_valid):
        unit_stacked, unit_evals, unit_states = [], [], []
        for u in range(embs.shape[0]):
            per_epoch = []
            epoch = epochs.of(embs[u], labels[u], valid[u], bank, class_masks[u])
            for e in range(thresholds.shape[1]):
                snapshot = state.params
                state, stacked = epoch(state, thresholds[u, e], perms[u, e])
                if use_prof:
                    state, stacked = _prof_reset(cfg, state, snapshot, thresholds[u, e], stacked)
                per_epoch.append(stacked)
            unit_stacked.append(_stack(per_epoch))
            unit_evals.append((
                _fused_eval_pass(pair, cfg, state.params, val_embs, val_labels, val_valid, bank,
                                 mesh=mesh),
                _fused_eval_pass(pair, cfg, state.params, test_embs, test_labels, test_valid, bank,
                                 mesh=mesh),
            ))
            unit_states.append(state)
        return state, _stack(unit_stacked), _stack(unit_evals), _stack(unit_states)

    return run


def _sweep_core(pair: AdapterPair, cfg: ExperimentConfig) -> Callable:
    """The train step as ``torch.func.vmap`` can run it: the gradient from
    ``torch.func.grad_and_value`` of :func:`_loss` (``torch.autograd.grad``
    does not vmap), then the update; no myCL, no metrics but the loss."""
    grad_and_loss = torch.func.grad_and_value(lambda params, *batch: _loss(pair, cfg, params,
                                                                           *batch)[0])

    def core(state: TrainState, embs, labels, elem_mask, class_mask, bank, threshold):
        grads, loss = grad_and_loss(state.params, embs, labels, elem_mask, class_mask, bank)
        params, mu, nu, count = optimizer_update(cfg, state, grads)
        return TrainState(params, mu, nu, count, state.lr, state.step + 1), {"loss": loss}

    return core


def build_vmapped_sweep(pair: AdapterPair, cfg: ExperimentConfig) -> Callable:
    """K whole joint-training runs of one program (the points differ in
    ``lr`` and seed only) and their val scoring: the sweep CLI's ``--vmap``
    engine (``cli/sweep.py``, ``engine/sweep.py``).

    ``sweep(states, embs, labels, valid, bank, perms, val_embs, val_labels,
    val_valid) -> (states, (K, C) per-class val AUROC)``: ``states`` is a
    :class:`TrainState` of (K, ...)-stacked tensors (each point's ``lr`` in
    it), the train data padded to whole batches, ``perms`` the (K, E,
    n_pad) per-point epoch orders ((K, E, 0) unshuffled).  The training is
    one ``torch.func.vmap`` over the points of the fused epoch's body, so K
    adapter problems run as batched products.  Scoring runs per point
    outside the vmap through :func:`_fused_eval_pass` and ``auroc_device``,
    what ``Trainer.quick_auroc`` runs: on CUDA the fused cosine kernel
    scores every eval batch of every point (the JAX package scores with the
    plain scorer here only because ``pallas_call`` does not vmap)."""
    from incremental_multimodal_medical_learning_ii_torch.evaluation.metrics import auroc_device

    if cfg.continual_learning is not None:
        raise ValueError("--vmap sweeps train without CL resets "
                         "(the joint sweep grid never sets them)")
    core = _sweep_core(pair, cfg)

    def one(state, embs, labels, valid, bank, perms):
        class_mask = torch.ones(labels.shape[1], device=labels.device)
        threshold = torch.zeros((), device=labels.device)
        for e in range(perms.shape[0]):
            state, _ = _epoch_scan(core, cfg, state, embs, labels, valid, bank, class_mask,
                                   threshold, perms[e])
        return state

    train = torch.func.vmap(one, in_dims=(0, None, None, None, None, 0))

    def sweep(states, embs, labels, valid, bank, perms, val_embs, val_labels, val_valid):
        states = train(states, embs, labels, valid, bank, perms)
        aurocs = []
        for k in range(perms.shape[0]):
            _, scores, _ = _fused_eval_pass(pair, cfg, unstack(states.params, k), val_embs,
                                            val_labels, val_valid, bank)
            aurocs.append(auroc_device(scores, val_labels, val_valid))
        return states, torch.stack(aurocs)

    return sweep


def epoch_permutation(seed: int, counter: int, n_real: int, n_pad: int) -> torch.Tensor:
    """One epoch's (n_pad,) row order on the host: the ``n_real`` real rows
    permuted, the padding indices at the tail (the batch composition of the
    per-batch path and of the reference's reshuffling DataLoader).
    ``torch.randperm`` from a CPU generator seeded by ``(seed, counter)``,
    so a CUDA run and a CPU run draw the same orders; it cannot reproduce
    the JAX package's ``jax.random`` stream (parity tests inject orders
    through ``Trainer.permutation_source``)."""
    state = np.random.SeedSequence([seed, counter]).generate_state(2, np.uint32)
    g = torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))
    p = torch.randperm(n_real, generator=g)
    if n_pad > n_real:
        p = torch.cat([p, torch.arange(n_real, n_pad)])
    return p


def build_epoch_reset(cfg: ExperimentConfig) -> Callable:
    """profCL per-epoch reset: (params, snapshot, threshold) -> (params, nr, nu)."""
    applications = 2 if cfg.shared else 1
    return lambda params, snapshot, threshold: weight_reset(
        params, snapshot, threshold, applications=applications)


def build_eval_step(pair: AdapterPair, cfg: ExperimentConfig, mesh=None) -> Callable:
    """step(params, embs, labels, elem_mask, bank) -> (loss, scores, preds,
    logits), all five classes scored (the reference evaluates the full
    label set in every regime, ``Trainer.py:772-866``)."""

    @torch.no_grad()
    def step(params, embs, labels, elem_mask, bank):
        out = _score_batch(pair, cfg, params, embs, adapt_bank(pair, params, bank), mesh)
        lbl = change_labels(labels) if cfg.change_labels else labels
        loss = bce_with_logits(out.logits, lbl, elem_mask[:, None].expand_as(lbl))
        return loss, out.scores, out.preds, out.logits

    return step


def build_fused_eval(pair: AdapterPair, cfg: ExperimentConfig, mesh=None) -> Callable:
    """The whole eval pass over device-resident data: (params, embs (Npad,D),
    labels, valid, bank) -> (losses (n_b,), scores (Npad,C), preds
    (Npad,C)), in the reference's fixed eval batches (Trainer.py:241-246)."""
    return lambda params, embs, labels, valid, bank: _fused_eval_pass(
        pair, cfg, params, embs, labels, valid, bank, mesh=mesh)


def _score_batch(pair, cfg, params, embs, adapted, mesh):
    """One eval batch through the kernel; on a mesh, this rank's rows
    through its mesh variant, the outputs gathered to the whole batch."""
    rows = embs.shape[0]
    if mesh is not None:
        embs = batch_rows(mesh, embs)
    return score_embeddings(apply_image(pair, params, embs), adapted, cfg.prompt_mode,
                            cfg.train_logit_diff, cfg.pred_logit_diff, use_kernel=True,
                            mesh=mesh, rows=rows)


@torch.no_grad()
def _fused_eval_pass(pair, cfg, params, embs, labels, valid, bank, mesh=None):
    bs = cfg.eval_batch_size
    if embs.shape[0] % bs:
        raise ValueError(f"{embs.shape[0]} rows not a multiple of eval batch {bs}; "
                         "pad the dataset first")
    # the text-adapted bank is the same for every batch: adapt it once
    adapted = adapt_bank(pair, params, bank)
    losses: List[torch.Tensor] = []
    scores, preds = [], []
    for start in range(0, embs.shape[0], bs):
        with annotate("eval-batch"):
            out = _score_batch(pair, cfg, params, embs[start:start + bs], adapted, mesh)
            lbl = labels[start:start + bs]
            lbl = change_labels(lbl) if cfg.change_labels else lbl
            losses.append(bce_with_logits(out.logits, lbl,
                                          valid[start:start + bs, None].expand_as(lbl)))
        count("eval_batches")
        scores.append(out.scores)
        preds.append(out.preds)
    c = labels.shape[1]
    if not losses:
        empty = embs.new_zeros((0, c))
        return embs.new_zeros(0), empty, empty
    return torch.stack(losses), torch.cat(scores), torch.cat(preds)


def build_embed_fn(pair: AdapterPair, cfg: ExperimentConfig) -> Callable:
    """(params, embs) -> adapted image embeddings (for analysis)."""
    return torch.no_grad()(lambda params, embs: apply_image(pair, params, embs))
