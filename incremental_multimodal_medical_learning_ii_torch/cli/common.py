"""Shared CLI plumbing: the image tower and the prompt bank from the
weight-source flags (counterpart of the JAX package's ``cli/common.py``,
the part the serving CLIs use)."""

from __future__ import annotations


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
