"""Embedding parity-check harness (counterpart of the JAX package's
``cli/verify_embeddings.py``; reference ``test_first_emb.py:50-103``).

Recomputes BioViL embeddings from raw images and diffs them against a
cached embedding dataset, reporting the max |delta|.  Runs on CUDA unless
``--device cpu``; decoding the images needs PIL.

    python -m incremental_multimodal_medical_learning_ii_torch.cli.verify_embeddings \\
        --csv labels.csv --img-dir /data/chexpert/ \\
        --biovil-checkpoint biovil.pt --cached embeddings/test/dataset.npz
"""

from __future__ import annotations

import argparse

import numpy as np


def verify(cached, recomputed, label_check: bool = True) -> dict:
    n = min(len(cached), len(recomputed))
    emb_diff = np.abs(cached.embeddings[:n] - recomputed.embeddings[:n])
    cos = np.sum(cached.embeddings[:n] * recomputed.embeddings[:n], axis=1) / np.maximum(
        np.linalg.norm(cached.embeddings[:n], axis=1)
        * np.linalg.norm(recomputed.embeddings[:n], axis=1),
        1e-12,
    )
    report = {
        "n": n,
        "max_abs_diff": float(emb_diff.max()),
        "mean_abs_diff": float(emb_diff.mean()),
        "min_cosine": float(cos.min()),
    }
    if label_check:
        report["labels_equal"] = bool(np.array_equal(cached.labels[:n], recomputed.labels[:n]))
    return report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--csv", required=True)
    p.add_argument("--img-dir", default="")
    p.add_argument("--biovil-checkpoint", required=True)
    p.add_argument("--cached", required=True, help=".npz or reference .pt dataset")
    p.add_argument("--limit", type=int, default=0, help="verify only the first N images")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 conv compute (default fp32 for parity checking)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu; nothing falls back")
    args = p.parse_args(argv)

    import itertools

    import torch

    from incremental_multimodal_medical_learning_ii_torch.data.manifest import ChexpertManifest
    from incremental_multimodal_medical_learning_ii_torch.data.store import EmbeddingDataset
    from incremental_multimodal_medical_learning_ii_torch.engine.extract import (
        extract_embeddings,
        manifest_image_iterator,
    )
    from incremental_multimodal_medical_learning_ii_torch.models.convert import (
        load_biovil_image_checkpoint,
    )
    from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cached = (
        EmbeddingDataset.load(args.cached)
        if args.cached.endswith(".npz")
        else EmbeddingDataset.load_torch_pt(args.cached)
    )
    model = load_biovil_image_checkpoint(args.biovil_checkpoint)
    manifest = ChexpertManifest.from_csv(args.csv, img_dir=args.img_dir)
    it = manifest_image_iterator(manifest)
    if args.limit:
        it = itertools.islice(it, args.limit)
    recomputed = extract_embeddings(
        it, model, batch_size=args.batch_size,
        dtype=torch.bfloat16 if args.bf16 else torch.float32, device=device,
    )
    report = verify(cached, recomputed)
    for k, v in report.items():
        print(f"{k}: {v}")
    return report


if __name__ == "__main__":
    main()
