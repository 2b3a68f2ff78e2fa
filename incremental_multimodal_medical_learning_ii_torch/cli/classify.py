"""Classify CLI: raw CXR images -> per-class scores (counterpart of the JAX
package's ``cli/classify.py``).

    python -m incremental_multimodal_medical_learning_ii_torch.cli.classify \\
        --biovil-checkpoint biovil.pt --cxr-bert-snapshot cxr_bert_dir \\
        [--reference-image-adapter image_adapter.pt] [--fused-layer1] img1.jpg ...

Image tower: ``--biovil-npz`` (a bundle written by the JAX package's
``cli/convert_weights.py``), ``--biovil-checkpoint`` (the reference's
torch state dict) or ``--random-weights`` (seeded demo weights).  Prompt
bank: ``--bank`` (a saved bank), else the prompts encoded by CXR-BERT from
``--cxr-bert-snapshot`` or ``--cxr-bert-checkpoint`` + ``--cxr-bert-vocab``,
else the synthetic prompt encoder.  ``--reference-{image,text}-adapter``
load the reference's trained adapters; ``--adapter-checkpoint`` serves the
adapters of a run directory's ``train_state/state.pt`` (the port's
checkpoint; a JAX run's reaches it through
``convert.py::train_state_from_jax``), restored into a template built from
``--adapter``, ``--optim``, ``--shared``, ``--no-image-adapter`` and
``--no-text-adapter``.  Runs on CUDA unless ``--device cpu``.

``add_classifier_args`` / ``build_classifier`` are shared with the HTTP
server (``cli/serve.py``).
"""

from __future__ import annotations

import argparse


def add_classifier_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--biovil-checkpoint", help="biovil_image_resnet50_proj_size_128.pt")
    p.add_argument("--biovil-npz",
                   help="weight bundle written by the JAX package's cli.convert_weights")
    p.add_argument("--random-weights", action="store_true",
                   help="seeded random BioViL (smoke runs/demos; scores meaningless)")
    p.add_argument("--cxr-bert-checkpoint", help="CXR-BERT torch state dict")
    p.add_argument("--cxr-bert-vocab", help="vocab.txt for --cxr-bert-checkpoint")
    p.add_argument("--cxr-bert-snapshot",
                   help="local HF snapshot dir (config.json + weights + vocab.txt)")
    p.add_argument("--seed", type=int, default=27,
                   help="prompt seed (--new-prompts samples the bank with it)")
    p.add_argument("--adapter-checkpoint",
                   help="run dir with a saved TrainState (train_state/state.pt)")
    p.add_argument("--reference-image-adapter",
                   help="a reference image_adapter.pt (pickled torch module)")
    p.add_argument("--reference-text-adapter",
                   help="a reference text_adapter.pt (pickled torch module)")
    p.add_argument("--adapter", choices=["mlp", "dense"], default="mlp",
                   help="adapter architecture of --adapter-checkpoint")
    p.add_argument("--optim", choices=["adam", "sgd"], default="adam",
                   help="optimizer the --adapter-checkpoint was trained with (the saved "
                   "TrainState carries its moments; the other one is tried if it does not fit)")
    p.add_argument("--shared", action="store_true")
    p.add_argument("--no-image-adapter", action="store_true",
                   help="--adapter-checkpoint was trained with only a text adapter")
    p.add_argument("--no-text-adapter", action="store_true",
                   help="--adapter-checkpoint was trained with only an image adapter")
    p.add_argument("--train-logit-pos", action="store_true",
                   help="build the bank with mirrored negatives (TRAIN_LOGIT_DIFF=False)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--pad-to", type=int, default=1024)
    p.add_argument("--new-prompts", action="store_true")
    p.add_argument("--single-prompt", action="store_true")
    p.add_argument("--max-emb", action="store_true", dest="max_emb",
                   help="MAX prompt-ensemble reduction (default MEAN)")
    p.add_argument("--bank", help="a saved prompt bank .npz (skips CXR-BERT)")
    p.add_argument("--save-bank", help="save the built prompt bank here")
    p.add_argument("--fused-layer1", action="store_true",
                   help="run ResNet layer1 through the fused bottleneck kernel")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _reference_adapters(args):
    """The reference's adapter files -> (ModuleDict, the config they serve under)."""
    import torch.nn as nn

    from incremental_multimodal_medical_learning_ii_torch.models.adapters import MLPAdapter
    from incremental_multimodal_medical_learning_ii_torch.models.convert import (
        load_reference_adapter,
    )
    from incremental_multimodal_medical_learning_ii_torch.utils.config import joint_config

    adapters = nn.ModuleDict()
    if args.reference_image_adapter:
        adapters["image"] = load_reference_adapter(args.reference_image_adapter)
    if args.reference_text_adapter:
        adapters["text"] = load_reference_adapter(args.reference_text_adapter)
    kind = "mlp" if isinstance(next(iter(adapters.values())), MLPAdapter) else "dense"
    cfg = joint_config(adapter=kind, image_adapter="image" in adapters,
                       text_adapter="text" in adapters,
                       prompt_mode="max" if args.max_emb else "mean")
    return adapters, cfg


def _checkpoint_adapters(args):
    """The adapters of ``--adapter-checkpoint`` -> (ModuleDict, config).

    Restores into an ``init_train_state`` template; when the optimiser
    state does not fit (an SGD run has no moments), retries with the
    other optimiser's template.  If that fails too, the checkpoint is
    missing or corrupt and the first error is the one raised."""
    import dataclasses
    import pickle

    from incremental_multimodal_medical_learning_ii_torch.engine.checkpoint import (
        restore_checkpoint,
    )
    from incremental_multimodal_medical_learning_ii_torch.engine.steps import (
        init_train_state,
        params_from_modules,
    )
    from incremental_multimodal_medical_learning_ii_torch.models.adapters import AdapterPair
    from incremental_multimodal_medical_learning_ii_torch.utils.config import joint_config

    cfg = joint_config(adapter=args.adapter, shared=args.shared, optim=args.optim,
                       image_adapter=not args.no_image_adapter,
                       text_adapter=not args.no_text_adapter,
                       prompt_mode="max" if args.max_emb else "mean")
    pair = AdapterPair(cfg.adapter, cfg.shared, cfg.image_adapter, cfg.text_adapter)
    adapters = pair.init()
    params = params_from_modules(adapters, "cpu")
    # what a restore raises: a missing file, a tree that does not fit, an
    # unreadable pickle
    failures = (OSError, ValueError, TypeError, RuntimeError, pickle.UnpicklingError)
    try:
        state = restore_checkpoint(args.adapter_checkpoint, init_train_state(params, cfg, "cpu"))
    except failures as first_err:
        other = "sgd" if args.optim == "adam" else "adam"
        alt = init_train_state(params, dataclasses.replace(cfg, optim=other), "cpu")
        try:
            state = restore_checkpoint(args.adapter_checkpoint, alt)
        except failures:
            raise first_err from None
        print(f"[info] checkpoint restored with an {other} optimiser-state template "
              f"(pass --optim {other} to silence this)")
    adapters.load_state_dict(state.params)
    return adapters, cfg


def build_classifier(args):
    """Construct the ChexpertClassifier from parsed CLI args."""
    from incremental_multimodal_medical_learning_ii_torch.cli.common import (
        build_bank,
        load_image_tower,
    )
    from incremental_multimodal_medical_learning_ii_torch.inference import ChexpertClassifier
    from incremental_multimodal_medical_learning_ii_torch.utils.config import ExperimentConfig
    from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    image_model = load_image_tower(args)
    bank = build_bank(args, device)
    if args.save_bank:
        from incremental_multimodal_medical_learning_ii_torch.text.bank import save_prompt_bank

        save_prompt_bank(args.save_bank, bank)
        print(f"saved prompt bank -> {args.save_bank}")
    cfg, adapters = None, None
    if args.reference_image_adapter or args.reference_text_adapter:
        adapters, cfg = _reference_adapters(args)
    elif args.adapter_checkpoint:
        adapters, cfg = _checkpoint_adapters(args)
    elif args.max_emb:
        # zero-shot serving with MAX prompt reduction
        cfg = ExperimentConfig(adapter="no-head", image_adapter=False,
                               text_adapter=False, prompt_mode="max")
    return ChexpertClassifier(
        image_model, bank, cfg=cfg, adapter_params=adapters, batch_size=args.batch_size,
        size=args.size, pad_to=args.pad_to, fused_layer1=args.fused_layer1, device=device,
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
