"""Shared CLI plumbing (counterpart of the JAX package's ``cli/common.py``):
the image tower and the prompt bank from the weight-source flags, and the
training drivers' flags (defaults equal the reference's constants),
configuration, data and results.

The drivers run on CUDA unless ``--device cpu`` is given.
``--mesh-devices`` has the JAX CLI's meaning (:func:`mesh_size`): more
than one runs the driver data-parallel on that many ranks, one process
each (:func:`run_ranks`; NCCL on the card, one card a rank; gloo on the
CPU), and only rank 0 prints and writes.  ``--trace-dir`` writes a
``torch.profiler`` trace of the training and eval loop
(``utils/profiling.py``).  ``--plot-figures`` and ``--tsne-plots`` draw the
reference's figures into the event file (``evaluation/plots.py``, PIL);
the JAX package's compile cache has no counterpart.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def load_image_tower(args):
    """BioViL image model from the weight-source flags, in precedence order:
    --biovil-npz (a JAX bundle) > --biovil-checkpoint (the reference's torch
    state dict) > --random-weights (seeded, as the JAX CLI's PRNGKey(0))."""
    if getattr(args, "biovil_npz", None):
        from incremental_multimodal_medical_learning_ii_torch.convert import load_biovil_npz

        return load_biovil_npz(args.biovil_npz)
    if getattr(args, "biovil_checkpoint", None):
        from incremental_multimodal_medical_learning_ii_torch.models.convert import (
            load_biovil_image_checkpoint,
        )

        return load_biovil_image_checkpoint(args.biovil_checkpoint)
    if getattr(args, "random_weights", False):
        import torch

        from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
            init_biovil_image_model,
        )

        print("[warn] --random-weights: scores are meaningless")
        return init_biovil_image_model(torch.Generator().manual_seed(0))
    raise SystemExit("--biovil-checkpoint or --biovil-npz required (or --random-weights)")


def cxr_bert_engine(args, device):
    """CXR-BERT behind a ``TextInferenceEngine`` on ``device``, from
    --cxr-bert-snapshot, or --cxr-bert-checkpoint with --cxr-bert-vocab;
    ``None`` when neither is given.  A half-given checkpoint/vocab pair and
    a text tower that does not project into the 128-d joint space raise."""
    snapshot = getattr(args, "cxr_bert_snapshot", None)
    checkpoint = getattr(args, "cxr_bert_checkpoint", None)
    vocab = getattr(args, "cxr_bert_vocab", None)
    if not (snapshot or checkpoint or vocab):
        return None
    from incremental_multimodal_medical_learning_ii_torch.models import convert
    from incremental_multimodal_medical_learning_ii_torch.text.engine import TextInferenceEngine
    from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import PromptTokenizer

    if snapshot:
        model, tokenizer = convert.load_cxr_bert_snapshot(snapshot)
        if tokenizer is None:
            raise SystemExit(f"{snapshot} has no vocab.txt")
    elif checkpoint and vocab:
        model = convert.load_cxr_bert_checkpoint(checkpoint,
                                                 num_heads=getattr(args, "cxr_bert_num_heads", None))
        tokenizer = PromptTokenizer(vocab)
    else:
        # a half-given pair must not fall back to the synthetic encoder: the
        # run would finish exit-0 against random text embeddings
        missing = "--cxr-bert-vocab" if checkpoint else "--cxr-bert-checkpoint"
        raise SystemExit(
            f"--cxr-bert-checkpoint and --cxr-bert-vocab go together; "
            f"{missing} is missing (or pass --cxr-bert-snapshot instead)"
        )
    if model.dims.projection_size != 128:
        # the text embeddings live in the image tower's 128-d joint space
        raise SystemExit(
            f"text checkpoint projects to {model.dims.projection_size}-d but the "
            f"joint space is 128-d; this checkpoint is not a BioViL-paired CXR-BERT"
        )
    return TextInferenceEngine(model, tokenizer, device=device)


def build_bank(args, device):
    """The prompt bank: --bank if given; else the prompts ``create_prompts``
    selects, encoded by CXR-BERT on ``device`` (:func:`cxr_bert_engine`)
    or, without weights, by the synthetic encoder."""
    from incremental_multimodal_medical_learning_ii_torch.text.bank import (
        build_prompt_bank,
        load_prompt_bank,
        synthetic_encode_fn,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
    )

    if getattr(args, "bank", None):
        return load_prompt_bank(args.bank)
    train_logit_diff = not args.train_logit_pos
    prompts = create_prompts(
        CHEXPERT_COMPETITION_TASKS,
        single_prompt=args.single_prompt,
        new_prompts=args.new_prompts,
        train_logit_diff=train_logit_diff,
        seed=args.seed,
    )
    engine = cxr_bert_engine(args, device)
    if engine is not None:
        encode = engine.encode_fn(normalize=False)
    else:
        print("[warn] no CXR-BERT checkpoint given; using synthetic prompt encoder")
        encode = synthetic_encode_fn(seed=args.seed)
    return build_prompt_bank(encode, prompts, CHEXPERT_COMPETITION_TASKS,
                             train_logit_diff=train_logit_diff)


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--batch-size", type=int, default=6144)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--seed", type=int, default=27)
    p.add_argument("--single-prompt", action="store_true")
    p.add_argument("--new-prompts", action="store_true")
    p.add_argument("--max-emb", action="store_true", help="MAX over prompt ensemble")
    p.add_argument("--adapter", choices=["mlp", "dense", "no-head"], default="mlp")
    p.add_argument("--optim", choices=["adam", "sgd"], default="adam")
    p.add_argument("--shared", action="store_true")
    p.add_argument("--no-image-adapter", action="store_true")
    p.add_argument("--no-text-adapter", action="store_true")
    p.add_argument("--train-logit-pos", action="store_true", help="train on pos only")
    p.add_argument("--pred-logit-diff", action="store_true")
    p.add_argument("--change-labels", action="store_true")
    p.add_argument("--xrays-position", choices=["all", "frontal"], default="all")
    p.add_argument(
        "--no-shuffle", action="store_true",
        help="deterministic epoch order (the reference's DataLoaders reshuffle every epoch)",
    )
    p.add_argument(
        "--fused-unit", action="store_true",
        help="run each incremental unit's epochs and its post-unit val/test evals as one "
        "call (the incremental protocols fold the whole run); joint mode folds the whole "
        "run with its per-epoch evals",
    )
    p.add_argument("--log-dir", default="runs")
    p.add_argument("--data-dir", help="dir with train/val/test .npz (or reference .pt) embedding datasets")
    p.add_argument("--synthetic", action="store_true", help="learnable fake data (smoke runs)")
    p.add_argument("--cxr-bert-checkpoint", help="torch state-dict path for CXR-BERT")
    p.add_argument("--cxr-bert-vocab", help="vocab.txt for the CXR-BERT tokenizer")
    p.add_argument("--cxr-bert-num-heads", type=int, default=None,
                   help="attention heads for --cxr-bert-checkpoint (default hidden//64)")
    p.add_argument("--cxr-bert-snapshot",
                   help="local HF snapshot dir (config.json + weights + vocab.txt)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu; nothing falls back")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="data-parallel ranks: 0 = every visible card (one process on the CPU), "
                   "1 = no mesh")
    p.add_argument("--tsne-plots", action="store_true", help="enable t-SNE figure hooks")
    p.add_argument(
        "--plot-figures", choices=["reference", "final", "off"], default="reference",
        help="TB figure cadence: 'reference' draws every figure every epoch/task like the "
        "reference's Trainer (host cost every eval); 'final' only at the last epoch/task; "
        "'off' skips figures. A --fused-unit joint run folds its epochs and evals into one "
        "call under any cadence (each epoch's own parameters draw its figures)",
    )
    p.add_argument("--trace-dir",
                   help="write a torch.profiler trace of the training/eval loop (host ops, and "
                   "the card's kernels on CUDA) into this directory; Perfetto and TensorBoard's "
                   "PyTorch profiler plugin open it")


def mesh_size(args) -> int:
    """``--mesh-devices`` as the JAX CLI reads it: 1 is no mesh, 0 every
    visible card on ``cuda`` and one process on the CPU, n > 1 n ranks."""
    if args.mesh_devices:
        return args.mesh_devices
    from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device

    if resolve_device(args.device).type == "cpu":
        return 1
    import torch

    return torch.cuda.device_count()


def _driver_rank(main, argv):
    """One rank of :func:`run_ranks`: the CLI's results, without the
    trainer (it stays in the rank's process)."""
    return {k: v for k, v in main(argv).items() if k != "trainer"}


def run_ranks(main, argv, args):
    """``main(argv)`` on :func:`mesh_size` ranks when that is above 1 and
    this process is not a rank already; returns rank 0's results, else
    ``None`` (the caller runs itself).  Raises ``ValueError("need n
    devices, have m")`` before starting anything when the cards are too
    few, and with a rank's traceback when one fails."""
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import (
        current_mesh,
        spawn_ranks,
    )

    n = mesh_size(args)
    if n <= 1 or current_mesh() is not None:
        return None
    argv = sys.argv[1:] if argv is None else list(argv)
    return spawn_ranks(_driver_rank, n, args.device, main, argv)[0]


def make_mesh(args):
    """This rank's mesh inside :func:`run_ranks`' group; ``None`` for one
    rank (``--mesh-devices 1`` is no mesh)."""
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import (
        create_mesh,
        current_mesh,
    )

    n = mesh_size(args)
    return create_mesh(n) if n > 1 and current_mesh() is not None else None


def prompt_mode_of(args) -> str:
    if args.single_prompt:
        return "single"
    return "max" if args.max_emb else "mean"


def config_kwargs(args) -> dict:
    return dict(
        batch_size=args.batch_size,
        lr=args.lr,
        epochs=args.epochs,
        seed=args.seed,
        prompt_mode=prompt_mode_of(args),
        new_prompts=args.new_prompts,
        adapter=args.adapter,
        optim=args.optim,
        shared=args.shared,
        image_adapter=not args.no_image_adapter,
        text_adapter=not args.no_text_adapter,
        train_logit_diff=not args.train_logit_pos,
        pred_logit_diff=args.pred_logit_diff,
        change_labels=args.change_labels,
        xrays_position=args.xrays_position,
        shuffle_train=not args.no_shuffle,
        fused_unit=args.fused_unit,
        plot_figures=args.plot_figures,
    )


def _load_split(data_dir: Path, split: str):
    from incremental_multimodal_medical_learning_ii_torch.data.store import EmbeddingDataset

    npz = data_dir / f"{split}.npz"
    if npz.exists():
        return EmbeddingDataset.load(npz)
    pt = data_dir / f"{split}.pt"
    if pt.exists():
        return EmbeddingDataset.load_torch_pt(pt)
    raise FileNotFoundError(f"no {split}.npz or {split}.pt in {data_dir}")


def load_bundle(args):
    from incremental_multimodal_medical_learning_ii_torch.data.store import synthetic_dataset
    from incremental_multimodal_medical_learning_ii_torch.engine.protocols import DataBundle

    if args.synthetic:
        rng = np.random.default_rng(args.seed)
        dirs = rng.normal(size=(5, 128)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        bundle = DataBundle(
            train=synthetic_dataset(8192, seed=1, class_directions=dirs),
            val=synthetic_dataset(2048, seed=2, class_directions=dirs),
            test=synthetic_dataset(2048, seed=3, class_directions=dirs),
        )
    else:
        if not args.data_dir:
            raise SystemExit("--data-dir required (or use --synthetic)")
        d = Path(args.data_dir)
        bundle = DataBundle(train=_load_split(d, "train"), val=_load_split(d, "val"),
                            test=_load_split(d, "test"))
    return bundle.with_tsne_subsets() if args.tsne_plots else bundle


def print_results(results) -> None:
    for key, metrics in results.items():
        if isinstance(metrics, dict):
            line = ", ".join(f"{k}={v:.4f}" for k, v in metrics.items())
            print(f"{key}: {line}")
