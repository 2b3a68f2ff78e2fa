"""Shared CLI plumbing (counterpart of the JAX package's ``cli/common.py``):
the image tower and the prompt bank from the weight-source flags, and the
training drivers' flags (defaults equal the reference's constants),
configuration, data and results.

The drivers run on CUDA unless ``--device cpu`` is given.  What is not
ported yet raises "not yet ported" (:func:`check_unported`): figures and
``--tsne-plots`` (matplotlib is absent on the card's machine),
``--trace-dir`` (``utils/profiling.py``) and ``--mesh-devices`` above 1
(multi-GPU); the JAX package's compile cache has no counterpart.
"""

from __future__ import annotations

import argparse
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


def build_bank(args, device):
    """The prompt bank: --bank if given; else the prompts ``create_prompts``
    selects, encoded by CXR-BERT on ``device`` (--cxr-bert-snapshot, or
    --cxr-bert-checkpoint with --cxr-bert-vocab) or, without weights, by
    the synthetic encoder."""
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
    if args.cxr_bert_snapshot:
        from incremental_multimodal_medical_learning_ii_torch.models.convert import (
            load_cxr_bert_snapshot,
        )
        from incremental_multimodal_medical_learning_ii_torch.text.engine import (
            TextInferenceEngine,
        )

        model, tokenizer = load_cxr_bert_snapshot(args.cxr_bert_snapshot)
        if tokenizer is None:
            raise SystemExit(f"{args.cxr_bert_snapshot} has no vocab.txt")
        encode = TextInferenceEngine(model, tokenizer, device=device).encode_fn(normalize=False)
    elif args.cxr_bert_checkpoint and args.cxr_bert_vocab:
        from incremental_multimodal_medical_learning_ii_torch.models.convert import (
            load_cxr_bert_checkpoint,
        )
        from incremental_multimodal_medical_learning_ii_torch.text.engine import (
            TextInferenceEngine,
        )
        from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import (
            PromptTokenizer,
        )

        model = load_cxr_bert_checkpoint(args.cxr_bert_checkpoint,
                                         num_heads=getattr(args, "cxr_bert_num_heads", None))
        encode = TextInferenceEngine(model, PromptTokenizer(args.cxr_bert_vocab),
                                     device=device).encode_fn(normalize=False)
    elif args.cxr_bert_checkpoint or args.cxr_bert_vocab:
        # a half-given pair must not fall back to the synthetic encoder: the
        # run would finish exit-0 against a random bank
        missing = "--cxr-bert-vocab" if args.cxr_bert_checkpoint else "--cxr-bert-checkpoint"
        raise SystemExit(
            f"--cxr-bert-checkpoint and --cxr-bert-vocab go together; "
            f"{missing} is missing (or pass --cxr-bert-snapshot instead)"
        )
    else:
        print("[warn] no CXR-BERT checkpoint given; using synthetic prompt encoder")
        encode, model = synthetic_encode_fn(seed=args.seed), None
    if model is not None and model.dims.projection_size != 128:
        # the bank lives in the image tower's 128-d joint space
        raise SystemExit(
            f"text checkpoint projects to {model.dims.projection_size}-d but the "
            f"joint space is 128-d; this checkpoint is not a BioViL-paired CXR-BERT"
        )
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
                   help="0 or 1: one card; more is multi-GPU, not yet ported")
    p.add_argument("--tsne-plots", action="store_true",
                   help="t-SNE figures: not yet ported (matplotlib is absent on the card's machine)")
    p.add_argument(
        "--plot-figures", choices=["reference", "final", "off"], default="off",
        help="TB figure cadence; only 'off' is ported: figures need matplotlib, which the "
        "card's machine lacks, so the default is 'off' (the JAX CLI's is 'reference')",
    )
    p.add_argument("--trace-dir", help="profiler trace: not yet ported (utils/profiling.py)")


def check_unported(args) -> None:
    """Raise for a flag whose feature is not ported yet (the CLIs call this
    before anything else; it takes the place of the JAX ``make_mesh``: the
    port runs on one card)."""
    from incremental_multimodal_medical_learning_ii_torch.engine.protocols import (
        TRACE_NOT_PORTED,
    )
    from incremental_multimodal_medical_learning_ii_torch.evaluation.tb import (
        FIGURES_NOT_PORTED,
    )

    if args.plot_figures != "off" or args.tsne_plots:
        raise NotImplementedError(FIGURES_NOT_PORTED)
    if args.trace_dir:
        raise NotImplementedError(TRACE_NOT_PORTED)
    if args.mesh_devices > 1:
        raise NotImplementedError("not yet ported: multi-GPU: ROADMAP slice 7")


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
        return DataBundle(
            train=synthetic_dataset(8192, seed=1, class_directions=dirs),
            val=synthetic_dataset(2048, seed=2, class_directions=dirs),
            test=synthetic_dataset(2048, seed=3, class_directions=dirs),
        )
    if not args.data_dir:
        raise SystemExit("--data-dir required (or use --synthetic)")
    d = Path(args.data_dir)
    return DataBundle(train=_load_split(d, "train"), val=_load_split(d, "val"),
                      test=_load_split(d, "test"))


def print_results(results) -> None:
    for key, metrics in results.items():
        if isinstance(metrics, dict):
            line = ", ".join(f"{k}={v:.4f}" for k, v in metrics.items())
            print(f"{key}: {line}")
