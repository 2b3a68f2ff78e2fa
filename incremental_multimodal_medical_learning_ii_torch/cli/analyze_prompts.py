"""Standalone prompt-embedding analysis (counterpart of the JAX package's
``cli/analyze_prompts.py``; the reference's L5 scripts
``plot_text_emebeddings.py`` and ``text_prompts_cosine_similarity.py``).

Encodes the prompt banks, then writes the 10x10 (or 5x5 pos-only) cosine
heatmap and the PCA / t-SNE projections of the mean prompt embeddings as
PNG files (``evaluation/plots.py``; the projections on ``--device``).

    python -m incremental_multimodal_medical_learning_ii_torch.cli.analyze_prompts \\
        --out-dir plots/ [--new-prompts] [--single-prompt] \\
        [--cxr-bert-checkpoint ckpt.pt --cxr-bert-vocab vocab.txt]

``--partition tp|sp|pp`` encodes through ``TextInferenceEngine(mesh=)`` on
``--mesh-devices`` ranks (0: every visible card; on the CPU give the
count), one process each, ``--partition-size`` of them on the model, seq
or pipe axis and the rest on the data axis; rank 0 writes the figures.
"""

from __future__ import annotations

import argparse
from pathlib import Path

FIGURE_NAMES = ("cosine_similarity_heat_map.png", "pca_multiple_prompts.png",
                "tsne_multiple_prompts.png")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--single-prompt", action="store_true")
    p.add_argument("--new-prompts", action="store_true")
    p.add_argument("--pos-only", action="store_true", help="5x5 positive-only heatmap")
    p.add_argument(
        "--normalize", action="store_true",
        help="L2-normalise the mean prompt embeddings before projecting (the standalone "
             "reference scripts' variant, plot_text_emebeddings.py:44-53; the Trainer's plots "
             "use raw means)",
    )
    p.add_argument("--seed", type=int, default=27)
    p.add_argument("--cxr-bert-checkpoint")
    p.add_argument("--cxr-bert-vocab")
    p.add_argument("--cxr-bert-num-heads", type=int, default=None,
                   help="attention heads for the raw state dict (default hidden//64)")
    p.add_argument("--partition", choices=["tp", "sp", "pp"],
                   help="multi-rank text encode: tensor- (heads/FFN), sequence- (ring "
                        "attention) or pipeline-parallel (parallel/{tp,sp,pp}.py); default one "
                        "device")
    p.add_argument("--partition-size", type=int, default=0,
                   help="ranks on the model/seq/pipe axis (0 = all ranks; the rest become the "
                        "data axis)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu; nothing falls back")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="ranks of --partition: 0 = every visible card (one process on the CPU)")
    return p


def main(argv=None):
    """Writes the three figures; returns their paths."""
    args = build_parser().parse_args(argv)
    if args.partition and not (args.cxr_bert_checkpoint and args.cxr_bert_vocab):
        raise SystemExit("--partition needs --cxr-bert-checkpoint (the synthetic encoder has no "
                         "device program)")
    if args.partition:
        from incremental_multimodal_medical_learning_ii_torch.cli.common import mesh_size
        from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import spawn_ranks

        n = mesh_size(args)
        size = args.partition_size or n
        if n % size:
            raise SystemExit(f"--partition-size {size} does not divide {n} devices")
        return spawn_ranks(_analyze, (n // size, size), args.device, args)[0]
    return _analyze(args)


def _analyze(args):
    """Encode the banks (on this rank's mesh under --partition) and, on
    rank 0, write the figures."""
    from incremental_multimodal_medical_learning_ii_torch.evaluation import plots
    from incremental_multimodal_medical_learning_ii_torch.ops.cosine import masked_mean
    from incremental_multimodal_medical_learning_ii_torch.text.bank import (
        build_prompt_bank,
        synthetic_encode_fn,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
    )
    from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device

    prompts = create_prompts(CHEXPERT_COMPETITION_TASKS, single_prompt=args.single_prompt,
                             new_prompts=args.new_prompts, train_logit_diff=not args.pos_only,
                             seed=args.seed)
    device = resolve_device(args.device)
    rank = 0
    if args.cxr_bert_checkpoint and args.cxr_bert_vocab:
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
                                         num_heads=args.cxr_bert_num_heads)
        engine_kw = {"device": device}
        if args.partition:
            from incremental_multimodal_medical_learning_ii_torch.parallel import pp, sp, tp
            from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import (
                current_mesh,
            )

            make = {"tp": tp.create_mesh_2d, "sp": sp.create_mesh_sp,
                    "pp": pp.create_mesh_pp}[args.partition]
            world = current_mesh()
            size = args.partition_size or world.size
            mesh = make(world.size // size, size)
            engine_kw = {"mesh": mesh, "partition": args.partition}
            device, rank = mesh.device, mesh.rank
        encode = TextInferenceEngine(model, PromptTokenizer(args.cxr_bert_vocab),
                                     **engine_kw).encode_fn(normalize=False)
        emb_dim = model.dims.projection_size  # honours a nonstandard checkpoint's width
    else:
        print("[warn] no CXR-BERT checkpoint; synthetic prompt encoder")
        encode = synthetic_encode_fn(seed=args.seed)
        emb_dim = 128

    bank = build_prompt_bank(encode, prompts, CHEXPERT_COMPETITION_TASKS,
                             train_logit_diff=not args.pos_only, emb_dim=emb_dim).to(device)
    pos = masked_mean(bank.pos, bank.pos_count)
    neg = masked_mean(bank.neg, bank.neg_count)
    if args.normalize:
        pos = pos / pos.norm(dim=1, keepdim=True).clamp(min=1e-12)
        neg = neg / neg.norm(dim=1, keepdim=True).clamp(min=1e-12)
    if rank:
        return None
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = [out / name for name in FIGURE_NAMES]
    plots.prompt_cosine_heatmap_figure(pos, None if args.pos_only else neg,
                                       args.single_prompt).save(paths[0], dpi=150)
    # --pos-only: the bank's negatives mirror the positives; plotting them
    # would draw 5 duplicate 'Negative' markers that were never encoded
    pca_fig, tsne_fig = plots.prompt_projection_figures(pos, None if args.pos_only else neg,
                                                        seed=args.seed)
    pca_fig.save(paths[1], dpi=150)
    tsne_fig.save(paths[2], dpi=150)
    print(f"wrote 3 figures to {out}")
    return paths


if __name__ == "__main__":
    main()
