"""Classify CLI: raw CXR images -> per-class scores (counterpart of the JAX
package's ``cli/classify.py``).

    python -m incremental_multimodal_medical_learning_ii_torch.cli.classify \\
        --biovil-npz biovil.npz --bank bank.npz [--fused-layer1] img1.jpg ...

Weight sources ported so far: ``--biovil-npz`` (a bundle written by the
JAX package's ``cli/convert_weights.py``), ``--random-weights`` (seeded
demo weights) and ``--bank`` (a saved prompt bank); without ``--bank`` the
synthetic prompt encoder builds the bank.  Flags that need later slices
(the torch BioViL checkpoint, CXR-BERT, adapter checkpoints) fail with a
"not yet ported" error.  Runs on CUDA unless ``--device cpu``.

``add_classifier_args`` / ``build_classifier`` are shared with the HTTP
server (``cli/serve.py``).
"""

from __future__ import annotations

import argparse

NOT_YET_PORTED = (
    "biovil_checkpoint",
    "cxr_bert_checkpoint",
    "cxr_bert_vocab",
    "cxr_bert_snapshot",
    "adapter_checkpoint",
    "reference_image_adapter",
    "reference_text_adapter",
)


def add_classifier_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--biovil-checkpoint",
                   help="biovil_image_resnet50_proj_size_128.pt (not yet ported)")
    p.add_argument("--biovil-npz",
                   help="weight bundle written by the JAX package's cli.convert_weights")
    p.add_argument("--random-weights", action="store_true",
                   help="seeded random BioViL (smoke runs/demos; scores meaningless)")
    p.add_argument("--cxr-bert-checkpoint", help="(not yet ported)")
    p.add_argument("--cxr-bert-vocab", help="(not yet ported)")
    p.add_argument("--cxr-bert-snapshot", help="(not yet ported)")
    p.add_argument("--seed", type=int, default=27,
                   help="prompt seed (--new-prompts samples the bank with it)")
    p.add_argument("--adapter-checkpoint", help="(not yet ported)")
    p.add_argument("--reference-image-adapter", help="(not yet ported)")
    p.add_argument("--reference-text-adapter", help="(not yet ported)")
    p.add_argument("--train-logit-pos", action="store_true",
                   help="build the bank with mirrored negatives (TRAIN_LOGIT_DIFF=False)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--pad-to", type=int, default=1024)
    p.add_argument("--new-prompts", action="store_true")
    p.add_argument("--single-prompt", action="store_true")
    p.add_argument("--max-emb", action="store_true", dest="max_emb",
                   help="MAX prompt-ensemble reduction (default MEAN)")
    p.add_argument("--bank", help="a saved prompt bank .npz")
    p.add_argument("--save-bank", help="save the built prompt bank here")
    p.add_argument("--fused-layer1", action="store_true",
                   help="run ResNet layer1 through the fused bottleneck kernel")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _reject_unported(args) -> None:
    given = [f"--{a.replace('_', '-')}" for a in NOT_YET_PORTED if getattr(args, a, None)]
    if given:
        raise SystemExit(
            f"{', '.join(given)}: not yet ported to the PyTorch package "
            "(use the JAX package's CLI, or --biovil-npz / --random-weights / --bank)"
        )


def load_image_tower(args):
    """BioViL image model from the weight-source flags: --biovil-npz, else
    --random-weights (seeded, as the JAX CLI's PRNGKey(0))."""
    if args.biovil_npz:
        from incremental_multimodal_medical_learning_ii_torch.convert import load_biovil_npz

        return load_biovil_npz(args.biovil_npz)
    if args.random_weights:
        import torch

        from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
            init_biovil_image_model,
        )

        print("[warn] --random-weights: scores are meaningless")
        return init_biovil_image_model(torch.Generator().manual_seed(0))
    raise SystemExit("--biovil-npz required (or --random-weights)")


def build_bank(args):
    """The prompt bank: --bank if given, else the synthetic encoder over
    the prompts ``create_prompts`` selects (the CXR-BERT encoder is not
    ported yet)."""
    from incremental_multimodal_medical_learning_ii_torch.text.bank import (
        build_prompt_bank,
        load_prompt_bank,
        synthetic_encode_fn,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
    )

    if args.bank:
        return load_prompt_bank(args.bank)
    print("[warn] no CXR-BERT checkpoint given; using synthetic prompt encoder")
    train_logit_diff = not args.train_logit_pos
    prompts = create_prompts(
        CHEXPERT_COMPETITION_TASKS,
        single_prompt=args.single_prompt,
        new_prompts=args.new_prompts,
        train_logit_diff=train_logit_diff,
        seed=args.seed,
    )
    return build_prompt_bank(
        synthetic_encode_fn(seed=args.seed), prompts, CHEXPERT_COMPETITION_TASKS,
        train_logit_diff=train_logit_diff,
    )


def build_classifier(args):
    """Construct the ChexpertClassifier from parsed CLI args."""
    from incremental_multimodal_medical_learning_ii_torch.inference import ChexpertClassifier
    from incremental_multimodal_medical_learning_ii_torch.utils.config import ExperimentConfig
    from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device

    _reject_unported(args)
    device = resolve_device(args.device)
    image_model = load_image_tower(args)
    bank = build_bank(args)
    if args.save_bank:
        from incremental_multimodal_medical_learning_ii_torch.text.bank import save_prompt_bank

        save_prompt_bank(args.save_bank, bank)
        print(f"saved prompt bank -> {args.save_bank}")
    cfg = None
    if args.max_emb:
        # zero-shot serving with MAX prompt reduction
        cfg = ExperimentConfig(adapter="no-head", image_adapter=False,
                               text_adapter=False, prompt_mode="max")
    return ChexpertClassifier(
        image_model, bank, cfg=cfg, batch_size=args.batch_size, size=args.size,
        pad_to=args.pad_to, fused_layer1=args.fused_layer1, device=device,
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("images", nargs="+")
    add_classifier_args(p)
    args = p.parse_args(argv)

    clf = build_classifier(args)
    scores, _ = clf.predict_paths(args.images)
    print("image," + ",".join(c.replace(" ", "_") for c in clf.class_names))
    for path, row in zip(args.images, scores):
        print(path + "," + ",".join(f"{v:.4f}" for v in row))


if __name__ == "__main__":
    main()
