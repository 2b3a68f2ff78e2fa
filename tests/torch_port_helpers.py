"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
parameter trees cross over as numpy leaves through the port's
``params_from_jax``.  JAX is imported where it is used, so that the ranks
``parallel/mesh.py::spawn_ranks`` starts for the mesh tests (they import
this module) load none of it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a module of toy-size steps: thousands of
    tiny ops run several times faster than with a thread pool, above all
    beside the other test workers.  Import it into a test module to use it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_numpy_tree(tree):
    """A JAX parameter tree with numpy leaves (structure unchanged)."""
    import jax

    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype=np.float32), tree)


def randomize_bn(tree, rng: np.random.Generator):
    """Non-trivial frozen-BN statistics in every BN dict of the tree, so a
    conversion bug cannot hide behind identity batch norms."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = np.shape(tree["scale"])[0]
            return {
                "scale": (rng.random(c) + 0.5).astype(np.float32),
                "bias": (rng.normal(size=c) * 0.1).astype(np.float32),
                "mean": (rng.normal(size=c) * 0.1).astype(np.float32),
                "var": (rng.random(c) + 0.5).astype(np.float32),
            }
        return {k: randomize_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [randomize_bn(v, rng) for v in tree]
    return tree


def _torch_default_conv_scale(tree):
    """Rescale every HWIO conv kernel from the JAX init's kaiming-normal
    (fan_out) spread to torch's default conv init spread, 1/sqrt(3*fan_in),
    which the JAX package's own parity fixture uses: activations then stay
    O(1) through the 53 convs, so absolute tolerances mean what they say."""
    if isinstance(tree, dict):
        out = {k: _torch_default_conv_scale(v) for k, v in tree.items()}
        k = out.get("kernel")
        if k is not None and np.ndim(k) == 4:
            kh, kw, cin, cout = np.shape(k)
            out["kernel"] = (k * np.sqrt((kh * kw * cout) / (6.0 * kh * kw * cin))).astype(np.float32)
        return out
    if isinstance(tree, (list, tuple)):
        return [_torch_default_conv_scale(v) for v in tree]
    return tree


def biovil_numpy_params(seed: int = 0, bn_seed: int | None = 3):
    """The JAX package's BioViL init (PRNGKey(seed)) as a numpy tree, at
    torch's default conv scale, optionally with randomized BN statistics."""
    import jax

    from incremental_multimodal_medical_learning_ii_tpu.models.biovil_image import (
        init_biovil_image_model,
    )

    tree = to_numpy_tree(init_biovil_image_model(jax.random.PRNGKey(seed)))
    tree = _torch_default_conv_scale(tree)
    if bn_seed is not None:
        tree = randomize_bn(tree, np.random.default_rng(bn_seed))
    return tree


def biovil_numpy_params_from_port(seed: int = 0, bn_seed: int | None = 3):
    """A BioViL tree in the JAX layout from the port's seeded init (a torch
    generator), at torch's default conv scale, optionally with randomized
    BN statistics: the same weights for both packages at a fraction of the
    JAX init's cost (the eager JAX init takes ~15 s on the CPU)."""
    from incremental_multimodal_medical_learning_ii_torch.convert import params_to_jax
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        init_biovil_image_model,
    )

    tree = params_to_jax(init_biovil_image_model(torch.Generator().manual_seed(seed)))
    tree = _torch_default_conv_scale(tree)
    if bn_seed is not None:
        tree = randomize_bn(tree, np.random.default_rng(bn_seed))
    return tree


def assert_parity(name: str, ours, ref, atol: float) -> float:
    """assert_allclose(ours, ref, atol, rtol=0), printing the measured
    largest difference (``pytest -rA`` shows it) for the port's parity
    table."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    err = float(np.max(np.abs(ours.astype(np.float64) - ref))) if ours.size else 0.0
    print(f"PARITY {name}: max |port - jax| = {err:.3e} (atol {atol:g})")
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=0, err_msg=name)
    return err


def bf16_ulps(a: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Elementwise |a - ref| counted in bf16 units in the last place of
    max(|ref|, 1) — the scale of the kernels' ``rel`` bar, so a ReLU-edge
    flip between 0 and a tiny value counts as the small error it is."""
    mag = np.maximum(np.abs(np.asarray(ref, np.float64)), 1.0)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)  # bf16 keeps 8 significant bits
    return np.abs(np.asarray(a, np.float64) - ref) / ulp


def reference_bert_state_dict(seed=0, projection=True, decoder_bias="cls.predictions.decoder.bias",
                              hidden=64, layers=2, inter=96, vocab=200, pos=40, proj=128):
    """A BertForMaskedLM (+ CXR-BERT projection head) state dict in the
    reference's key layout, made with numpy."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.05

    sd = {"bert.embeddings.word_embeddings.weight": w(vocab, hidden),
          "bert.embeddings.position_embeddings.weight": w(pos, hidden),
          "bert.embeddings.token_type_embeddings.weight": w(2, hidden),
          "bert.embeddings.position_ids": np.arange(pos, dtype=np.int64)[None]}

    def linear(prefix, dout, din):
        sd[prefix + ".weight"], sd[prefix + ".bias"] = w(dout, din), w(dout)

    def ln(prefix, d):
        sd[prefix + ".weight"], sd[prefix + ".bias"] = 1 + w(d), w(d)

    ln("bert.embeddings.LayerNorm", hidden)
    for li in range(layers):
        p = f"bert.encoder.layer.{li}."
        for name in ("query", "key", "value"):
            linear(p + "attention.self." + name, hidden, hidden)
        linear(p + "attention.output.dense", hidden, hidden)
        ln(p + "attention.output.LayerNorm", hidden)
        linear(p + "intermediate.dense", inter, hidden)
        linear(p + "output.dense", hidden, inter)
        ln(p + "output.LayerNorm", hidden)
    linear("cls.predictions.transform.dense", hidden, hidden)
    ln("cls.predictions.transform.LayerNorm", hidden)
    sd[decoder_bias] = w(vocab)
    if projection:
        linear("cls_projection_head.dense_to_hidden", proj, hidden)
        ln("cls_projection_head.LayerNorm", proj)
        linear("cls_projection_head.dense_to_output", proj, proj)
    return sd


# ----------------------------------------------------------------------
# Ranks of a data-parallel mesh: ``spawn_ranks`` pickles these functions by
# name, so they live here, importable in a fresh process
# ----------------------------------------------------------------------
class Recorder:
    """A writer that keeps (tag, value, step) in memory, for both packages."""

    log_dir = None
    enabled = True

    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def commit(self):
        pass

    def discard(self):
        pass

    def close(self):
        pass


def mesh_orders(epoch, n):
    """The epoch orders both packages' trainers draw in the mesh tests."""
    return np.random.default_rng(1000 + epoch).permutation(n)


def mesh_splits(n_train=97, n_eval=70, seed=5):
    """Train / val / test (embeddings, labels) arrays of learnable synthetic
    data: 97 rows are three batches of 32 and one row, so the last batch of
    every epoch leaves the second rank nothing but padding."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(5, 128)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    out = []
    for n in (n_train, n_eval, n_eval):
        labels = (rng.random((n, 5)) < 0.35).astype(np.float32)
        embs = labels @ dirs + rng.normal(size=(n, 128)).astype(np.float32) * 0.8
        out.append((embs.astype(np.float32), labels))
    return out


def protocols_on_rank(cases, trees, splits):
    """Every ``cases`` entry, ``{name: (runner, config kwargs, fold)}``,
    through the port's protocol ``runner`` on this rank's mesh, from the
    JAX init ``trees[name]`` with :func:`mesh_orders`; ``fold=False`` keeps
    the incremental protocols off their whole-run fold.  Returns ``{name:
    {"scalars", "params"}}``."""
    torch.set_num_threads(1)
    from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
    from incremental_multimodal_medical_learning_ii_torch.data.store import EmbeddingDataset
    from incremental_multimodal_medical_learning_ii_torch.engine import protocols
    from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer
    from incremental_multimodal_medical_learning_ii_torch.models.adapters import AdapterPair
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import create_mesh
    from incremental_multimodal_medical_learning_ii_torch.text.bank import (
        build_prompt_bank,
        synthetic_encode_fn,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
        ExperimentConfig,
    )

    mesh = create_mesh(2)
    bundle = protocols.DataBundle(*(EmbeddingDataset(e, lbl) for e, lbl in splits))
    bank = build_prompt_bank(synthetic_encode_fn(), create_prompts(CHEXPERT_COMPETITION_TASKS),
                             CHEXPERT_COMPETITION_TASKS)
    init, fusible = Trainer.__init__, Trainer.incremental_run_fusible
    out = {}
    for name, (runner, kw, fold) in cases.items():
        rec = Recorder()

        def trainer_init(self, *a, **k):
            init(self, *a, **k)
            self.permutation_source = mesh_orders

        Trainer.__init__ = trainer_init
        Trainer.incremental_run_fusible = fusible if fold else (lambda self, *a: False)
        AdapterPair.init = lambda self, generator=None, tree=trees[name]: params_from_jax(tree)
        protocols._make_writer = lambda cfg, log_dir, rec=rec: rec
        res = getattr(protocols, runner)(ExperimentConfig(**kw), bundle, bank, log_dir=None,
                                         mesh=mesh)
        out[name] = {"scalars": rec.scalars,
                     "params": {k: v.numpy() for k, v in res["trainer"].state.params.items()}}
    return out


def mesh_primitives_on_rank(x, t, ragged):
    """``parallel/mesh.py``'s helpers and K1-mesh on this rank: an even and
    a ragged batch sliced and gathered back, a sum, a broadcast, and the
    sharded cosine of both batches against ``t``."""
    torch.set_num_threads(1)
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
        pairwise_cosine_sharded,
    )
    from incremental_multimodal_medical_learning_ii_torch.parallel import mesh as m

    mesh = m.create_mesh(2)
    x, t, ragged = (torch.from_numpy(a) for a in (x, t, ragged))
    x_local, r_local = m.batch_rows(mesh, x), m.batch_rows(mesh, ragged)
    try:
        m.gather_rows(mesh, x_local[1:], len(x))
        wrong_shard = None
    except ValueError as e:
        wrong_shard = str(e)
    return {
        "rows": (len(x_local), len(r_local)),
        "even": m.gather_rows(mesh, x_local.clone(), len(x)).numpy(),
        "ragged": m.gather_rows(mesh, r_local.clone(), len(ragged)).numpy(),
        "sum": m.all_reduce_sum(mesh, torch.full((3,), float(mesh.rank + 1))).numpy(),
        "replicated": m.replicate(mesh, [torch.full((2,), float(mesh.rank))])[0].numpy(),
        "cosine": pairwise_cosine_sharded(mesh, x_local, t).numpy(),
        "cosine_ragged": pairwise_cosine_sharded(mesh, r_local, t, len(ragged)).numpy(),
        "calls": pairwise_cosine_sharded.calls,
        "wrong_shard": wrong_shard,
    }


def extract_manifest_on_rank(tree, csv_path, img_dir, kw, store_dir, cut):
    """``extract_embeddings(mesh=)`` on this rank over a manifest's PNGs:
    the stream decoding every image, the stream decoding the rank's slices
    only (``rank_positions``), and a run of the latter cut after ``cut``
    images then resumed.  Returns each run's embeddings and the files the
    sliced and the resumed run decoded."""
    torch.set_num_threads(1)
    import itertools
    from pathlib import Path

    from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
    from incremental_multimodal_medical_learning_ii_torch.data.images import load_image_raw_uint8
    from incremental_multimodal_medical_learning_ii_torch.data.manifest import ChexpertManifest
    from incremental_multimodal_medical_learning_ii_torch.data.store import ShardedEmbeddingStore
    from incremental_multimodal_medical_learning_ii_torch.engine.extract import (
        extract_embeddings,
        manifest_image_iterator,
        rank_positions,
    )
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import create_mesh

    mesh = create_mesh(2)
    model = params_from_jax(tree)
    manifest = ChexpertManifest.from_csv(csv_path, img_dir=img_dir)
    decoded = []

    def loader(path):
        decoded.append(Path(path).name)
        return load_image_raw_uint8(path)

    def stream(skip=0, keep=rank_positions(mesh, kw["batch_size"])):
        return manifest_image_iterator(manifest, loader=loader, start=skip, keep=keep)

    def run(images, **extra):
        return extract_embeddings(images, model, dtype=torch.float32, mesh=mesh, **kw,
                                  **extra).embeddings

    out = {"full": run(stream(keep=None))}
    decoded.clear()
    out["sliced"] = run(stream)
    out["sliced_decoded"] = list(decoded)
    store = ShardedEmbeddingStore(Path(store_dir) / "cut")  # rank 0's, read by both
    run(itertools.islice(stream(), cut), store=store)
    decoded.clear()
    out["resumed"] = run(stream, store=store, resume=True)
    out["resumed_decoded"] = list(decoded)
    ragged = ShardedEmbeddingStore(Path(store_dir) / "ragged")
    run(itertools.islice(stream(), cut + 1), store=ragged)
    try:
        run(stream(), store=ragged, resume=True)
    except ValueError as e:
        out["ragged_iterable_resume"] = str(e)
    return out


def recorded_joint_on_rank(splits, kw):
    """A fused joint run on this rank of two, under the port's recorder:
    returns the rank's ``train-step`` spans and its counters."""
    torch.set_num_threads(1)
    from incremental_multimodal_medical_learning_ii_torch.data.store import EmbeddingDataset
    from incremental_multimodal_medical_learning_ii_torch.engine import protocols
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import create_mesh
    from incremental_multimodal_medical_learning_ii_torch.text.bank import (
        build_prompt_bank,
        synthetic_encode_fn,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
    from incremental_multimodal_medical_learning_ii_torch.utils import profiling
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
        ExperimentConfig,
    )

    mesh = create_mesh(2)
    bundle = protocols.DataBundle(*(EmbeddingDataset(e, lbl) for e, lbl in splits))
    bank = build_prompt_bank(synthetic_encode_fn(), create_prompts(CHEXPERT_COMPETITION_TASKS),
                             CHEXPERT_COMPETITION_TASKS)
    with profiling.recording() as rec:
        protocols.run_zero_joint(ExperimentConfig(**kw), bundle, bank, log_dir=None, mesh=mesh)
    return {"rank": mesh.rank, "steps": [tuple(s[:3]) for s in rec.named("train-step")],
            "counters": dict(rec.counters)}


def fail_on_rank_one():
    """A rank function whose rank 1 raises while rank 0 waits in a collective."""
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import barrier, create_mesh

    mesh = create_mesh(2)
    if mesh.rank == 1:
        raise KeyError("rank one gives up")
    barrier(mesh)


def driver_on_rank(cli, argv, tree):
    """A driver CLI's ``main(argv)`` on this rank, from the JAX init ``tree``
    with :func:`mesh_orders`; returns (its printout, its final params)."""
    import contextlib
    import importlib
    import io

    torch.set_num_threads(1)
    from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
    from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer
    from incremental_multimodal_medical_learning_ii_torch.models.adapters import AdapterPair

    init = Trainer.__init__
    trainers = []

    def trainer_init(self, *a, **k):
        init(self, *a, **k)
        self.permutation_source = mesh_orders
        trainers.append(self)

    Trainer.__init__ = trainer_init
    AdapterPair.init = lambda self, generator=None: params_from_jax(tree)
    printout = io.StringIO()
    with contextlib.redirect_stdout(printout):
        importlib.import_module(f"incremental_multimodal_medical_learning_ii_torch.cli.{cli}").main(argv)
    return printout.getvalue(), {k: v.numpy() for k, v in trainers[-1].state.params.items()}


def figures_driver_on_rank(cli, argv, tree):
    """:func:`driver_on_rank` with the figures' data captured: returns (its
    printout, its final params, the heatmaps' (rows, cols, data) in the
    order drawn, whether this rank's writer writes)."""
    from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer
    from incremental_multimodal_medical_learning_ii_torch.evaluation import plots

    heatmaps, writers = [], []
    draw = plots.heatmap_figure

    def capture(data, rows, cols, *a, **k):
        heatmaps.append((list(rows), list(cols), np.asarray(data, np.float64)))
        return draw(data, rows, cols, *a, **k)

    init = Trainer.__init__

    def trainer_init(self, *a, **k):
        init(self, *a, **k)
        writers.append(self.writer)

    plots.heatmap_figure = capture
    Trainer.__init__ = trainer_init
    printout, params = driver_on_rank(cli, argv, tree)
    return printout, params, heatmaps, writers[-1].writes


def extract_on_rank(tree, imgs, kw, store_dir, cut):
    """``extract_embeddings(mesh=)`` on this rank: the whole image list, a
    clean run with shard checkpoints, and a run cut after ``cut`` images
    then resumed.  Returns the embeddings of each and the stores' rows."""
    torch.set_num_threads(1)
    from pathlib import Path

    from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
    from incremental_multimodal_medical_learning_ii_torch.data.store import ShardedEmbeddingStore
    from incremental_multimodal_medical_learning_ii_torch.engine.extract import extract_embeddings
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import create_mesh

    mesh = create_mesh(2)
    model = params_from_jax(tree)

    def run(images, store=None, **extra):
        return extract_embeddings(iter(images), model, store=store, dtype=torch.float32,
                                  mesh=mesh, **kw, **extra).embeddings

    clean_store = ShardedEmbeddingStore(Path(store_dir) / "clean")
    cut_store = ShardedEmbeddingStore(Path(store_dir) / "cut")
    out = {"plain": run(imgs), "clean": run(imgs, clean_store)}
    run(imgs[:cut], cut_store)
    out["resumed"] = run(imgs, cut_store, resume=True)
    for name, store in (("clean_rows", clean_store), ("cut_rows", cut_store)):
        out[name] = store.glue().embeddings if store.total_rows() else None
    return out


def ring_on_rank(cases):
    """``ops/ring_attention.py`` on this rank of a ``(1, n)`` seq mesh: for
    each ``cases`` entry, ``{name: (q, k, v, valid, w)}`` of whole (B, nh, S,
    hd) arrays, this rank's output chunk and the gradients of ``sum(out *
    w)`` for its q, k and v chunks; and the 2-D view of the same ranks as
    ``(2, n / 2)``: each line's members."""
    torch.set_num_threads(1)
    from incremental_multimodal_medical_learning_ii_torch.ops.ring_attention import ring_attention
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import create_mesh
    from incremental_multimodal_medical_learning_ii_torch.parallel.sp import create_mesh_sp

    world = create_mesh()
    mesh = create_mesh_sp(1, world.size)
    i, n = mesh.axis_index("seq"), world.size
    out = {}
    for name, (q, k, v, valid, w) in cases.items():
        sl = q.shape[2] // n
        cols = slice(i * sl, (i + 1) * sl)
        q, k, v, w = (torch.from_numpy(np.ascontiguousarray(a[:, :, cols])).requires_grad_(True)
                      for a in (q, k, v, w))
        o = ring_attention(q, k, v, torch.from_numpy(valid[:, cols]), mesh, "seq",
                           sm_scale=1.0 / float(np.sqrt(q.shape[-1])))
        (o * w).sum().backward()
        out[name] = {"out": o.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                     "dv": v.grad.numpy()}
    view = create_mesh((2, n // 2), axis_names=("data", "seq"))
    out["view"] = {axis: (view.along(axis).ranks, view.axis_index(axis), view.along(axis).size)
                   for axis in ("data", "seq")}
    out["transport"] = mesh.transport
    return out


def ppermute_on_rank():
    """``parallel/mesh.py::ppermute`` on this rank of a 1-D mesh: a float
    tensor hopped by +1 and -1, cyclic and not, with the gradient of
    ``sum(hopped * w)`` for each; an int32 tensor hopped; ``psum`` and
    ``pvary`` with their gradients."""
    torch.set_num_threads(1)
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import (
        DATA_AXIS,
        create_mesh,
        ppermute,
        psum,
        pvary,
    )

    mesh = create_mesh()
    r = mesh.rank
    out = {}
    for shift in (1, -1):
        for wrap in (True, False):
            x = torch.full((2, 3), float(r + 1)).requires_grad_(True)
            w = torch.arange(6.0).reshape(2, 3) * (10 ** r)
            (ppermute(mesh, DATA_AXIS, x, shift, wrap) * w).sum().backward()
            out[(shift, wrap)] = {"y": ppermute(mesh, DATA_AXIS, x.detach(), shift, wrap).numpy(),
                                  "grad": x.grad.numpy()}
    out["int"] = ppermute(mesh, DATA_AXIS, torch.full((3,), r + 7, dtype=torch.int32)).numpy()
    x = torch.full((2,), float(r + 1)).requires_grad_(True)
    (psum(mesh, DATA_AXIS, x) * (r + 2)).sum().backward()
    out["psum"] = (psum(mesh, DATA_AXIS, x.detach()).numpy(), x.grad.numpy())
    x = torch.full((2,), 3.0).requires_grad_(True)
    (pvary(mesh, DATA_AXIS, x) * (r + 2)).sum().backward()
    out["pvary"] = x.grad.numpy()
    return out


def text_partitions_on_rank(cases, wide, engine_case):
    """The text tower's partitions on this rank of four (each on its 2 x 2
    mesh: ``create_mesh_2d``, ``create_mesh_sp``, ``create_mesh_pp``).

    ``cases``: ``{name: (partition, dims kwargs, JAX tree, ids, mask, dtype
    name, grad)}``: the encode's output and, with ``grad``, the whole
    gradient of ``sum(out * out[::-1])`` (``full_gradients``).  ``wide``:
    ``(dims kwargs, seed, ids, mask)``, TP at that width from the port's
    own init.  ``engine_case``: ``(vocab path, {partition: (dims kwargs,
    tree)}, prompts)``, the engine's embeddings with ``mesh=``."""
    torch.set_num_threads(1)
    from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
    from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import (
        BertDims,
        init_cxr_bert,
    )
    from incremental_multimodal_medical_learning_ii_torch.parallel import pp, sp, tp
    from incremental_multimodal_medical_learning_ii_torch.text.engine import TextInferenceEngine
    from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import PromptTokenizer

    mods = {"tp": tp, "sp": sp, "pp": pp}
    meshes = {"tp": tp.create_mesh_2d(2, 2), "sp": sp.create_mesh_sp(2, 2),
              "pp": pp.create_mesh_pp(2, 2)}

    def encoder(part, dims, model, dtype):
        mesh = meshes[part]
        if part == "tp":
            return tp.make_tp_text_encode(dims, mesh, dtype=dtype), tp.shard_bert_tp(model, mesh)
        if part == "sp":
            return sp.make_sp_text_encode(dims, mesh, dtype=dtype), model
        return pp.make_pp_text_encode(dims, mesh, 2, dtype=dtype), model

    out = {}
    for name, (part, dims_kw, tree, ids, mask, dtype, grad) in cases.items():
        dims = BertDims(**dims_kw)
        encode, model = encoder(part, dims, params_from_jax(tree, dims), getattr(torch, dtype))
        ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
        if grad:
            model.requires_grad_(True)
            o = encode(model, ids, mask)
            (o * o.flip(0)).sum().backward()
            grads = mods[part].full_gradients(meshes[part], model)
            out[name] = {"out": o.detach().numpy(), "grads": {k: v.numpy() for k, v in grads.items()}}
        else:
            with torch.no_grad():
                out[name] = {"out": encode(model, ids, mask).numpy()}
    dims_kw, seed, ids, mask = wide
    dims = BertDims(**dims_kw)
    encode, shard = encoder("tp", dims, init_cxr_bert(torch.Generator().manual_seed(seed), dims),
                            torch.float32)
    with torch.no_grad():
        out["wide"] = {"out": encode(shard, torch.from_numpy(ids), torch.from_numpy(mask)).numpy(),
                       "q_rows": tuple(shard.layers[0].q.weight.shape)}
    vocab, trees, prompts = engine_case
    for part, (dims_kw, tree) in trees.items():
        dims = BertDims(**dims_kw)
        engine = TextInferenceEngine(params_from_jax(tree, dims), PromptTokenizer(vocab),
                                     mesh=meshes[part], partition=part, n_microbatches=2)
        out[f"engine {part}"] = {"out": engine.get_embeddings_from_prompt(prompts)}
    return out


def trace_spans(trace_dir) -> dict:
    """{span name: count} of the named spans (``annotate``) in the
    profiler traces written into ``trace_dir`` (``*.pt.trace.json``)."""
    import collections
    import json
    from pathlib import Path

    files = sorted(Path(trace_dir).rglob("*.pt.trace.json"))
    assert files, f"no trace written into {trace_dir}"
    spans = collections.Counter()
    for f in files:
        for e in json.loads(f.read_text())["traceEvents"]:
            if e.get("cat") == "user_annotation":
                spans[e["name"]] += 1
    return dict(spans)
