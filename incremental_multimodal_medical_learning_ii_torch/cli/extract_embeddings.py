"""CheXpert embedding extraction driver (counterpart of the JAX package's
``cli/extract_embeddings.py``; reference ``chexpert-get-embedding.py``).

Batched, preprocessing on the device, bf16, shard-checkpointed (the
reference runs a batch-size-1 loop with a shard every 5000 images).  Runs
on CUDA unless ``--device cpu``.

    python -m incremental_multimodal_medical_learning_ii_torch.cli.extract_embeddings \\
        --csv labels.csv --img-dir /data/chexpert/ --biovil-checkpoint biovil.pt \\
        --out-dir embeddings/test

    # smoke run without data or weights (seeded random weights):
    python -m incremental_multimodal_medical_learning_ii_torch.cli.extract_embeddings \\
        --synthetic 64 --out-dir /tmp/emb

    # DINOv2 ViT-g/14 with registers (3,072-d embeddings, 518² by default)
    # from the public checkpoint (dinov2_vitg14_reg4_pretrain.pth):
    python -m incremental_multimodal_medical_learning_ii_torch.cli.extract_embeddings \\
        --image-model dinov2-vitg14-reg --dinov2-checkpoint dinov2_vitg14_reg4_pretrain.pth \\
        --csv labels.csv --img-dir /data/chexpert/ --out-dir embeddings/dinov2

Shards are written at batch boundaries once ``--checkpoint-interval``
images have gathered, so at the defaults (batch 128, interval 5000) a shard
holds 40 batches, 5120 rows; a resumed run's batches are the clean run's.
``--host-preprocess`` and decoding real images need PIL.
"""

from __future__ import annotations

import argparse
import math
import time
from pathlib import Path

import numpy as np

SYNTHETIC_SHAPE = (390, 320)  # CheXpert-small's most common geometry
IMAGE_MODELS = ("biovil", "dinov2-vitg14-reg")


def synthetic_images(n: int, lo: int = 0, hi: int | None = None, skip: int = 0):
    """The JAX CLI's ``--synthetic`` stream: images and labels drawn from
    ``np.random.default_rng(0)`` in order, yielding those in [lo + skip, hi)."""
    hi = n if hi is None else hi
    rng = np.random.default_rng(0)
    for i in range(n):
        img = rng.integers(0, 256, size=SYNTHETIC_SHAPE, dtype=np.uint8)
        lbl = (rng.random(5) < 0.3).astype(np.float32)
        if lo + skip <= i < hi:
            yield img, lbl


def host_bounds(n_total: int, num_hosts: int, host_index: int):
    """Contiguous ceil-sized slice of the image list for one host (the
    partitioning of ``split_contiguous``, Trainer.py:1214-1231)."""
    chunk = math.ceil(n_total / num_hosts)
    lo = min(n_total, host_index * chunk)
    return lo, min(n_total, lo + chunk)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--csv", help="CheXpert labels CSV (path column first)")
    p.add_argument("--img-dir", default="", help="prefix joined to CSV paths")
    p.add_argument("--image-model", choices=IMAGE_MODELS, default="biovil",
                   help="the image tower: BioViL's ResNet-50 (128-d) or DINOv2 ViT-g/14 with "
                   "registers (3,072-d)")
    p.add_argument("--biovil-checkpoint", help="biovil_image_resnet50_proj_size_128.pt")
    p.add_argument("--dinov2-checkpoint",
                   help="dinov2_vitg14_reg4_pretrain.pth (facebookresearch/dinov2's names)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--size", type=int, default=None,
                   help="shortest edge after the resize; default 512 (biovil) or the tower's "
                   "518 (dinov2)")
    p.add_argument("--crop", type=int, default=None, help="default: same as --size")
    p.add_argument("--pad-to", type=int, default=1024)
    p.add_argument("--checkpoint-interval", type=int, default=5000,
                   help="images between shard checkpoints (written at batch boundaries)")
    p.add_argument("--decode-workers", type=int, default=0,
                   help="JPEG-decode process pool size (reference num_workers=4)")
    p.add_argument("--fp32", action="store_true", help="fp32 conv compute (parity runs)")
    p.add_argument("--host-preprocess", action="store_true",
                   help="PIL path instead of the device path (needs PIL)")
    p.add_argument("--no-grayscale-conv1", action="store_true",
                   help="disable the folded-conv1 grayscale path (keeps 3-channel images on device)")
    p.add_argument("--int8", action="store_true",
                   help="int8-quantize the frozen trunk (biovil only; not for bit-parity runs)")
    p.add_argument("--synthetic", type=int, default=0, help="N synthetic images (smoke run)")
    p.add_argument("--resume", action="store_true",
                   help="skip images already covered by shards in --out-dir")
    p.add_argument("--readback-interval", type=int, default=4,
                   help="dispatched batches per device-to-host synchronisation")
    p.add_argument("--retries", type=int, default=2,
                   help="per-batch re-dispatch attempts on backend errors")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="shard the image list across this many extraction hosts; "
                   "each host writes to <out-dir>/host-<i> (merge with prepare_data)")
    p.add_argument("--host-index", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu; nothing falls back")
    args = p.parse_args(argv)

    import torch

    from incremental_multimodal_medical_learning_ii_torch.data.store import ShardedEmbeddingStore
    from incremental_multimodal_medical_learning_ii_torch.engine.extract import (
        extract_embeddings,
        manifest_image_iterator,
    )
    from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device

    if not (0 <= args.host_index < args.num_hosts):
        raise SystemExit(f"--host-index {args.host_index} not in [0, {args.num_hosts})")
    device = resolve_device(args.device)
    dinov2 = args.image_model == "dinov2-vitg14-reg"
    if dinov2:
        from incremental_multimodal_medical_learning_ii_torch.models import dinov2 as vit

        dims = vit.dinov2_vitg14_reg()
        size = args.size or dims.image_size
    else:
        size = args.size or 512
    checkpoint = args.dinov2_checkpoint if dinov2 else args.biovil_checkpoint

    if args.synthetic:
        if dinov2:
            model = vit.init_dinov2(dims, torch.Generator().manual_seed(0))
        else:
            from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
                init_biovil_image_model,
            )

            model = init_biovil_image_model(torch.Generator().manual_seed(0))
        lo, hi = host_bounds(args.synthetic, args.num_hosts, args.host_index)

        def iterator(skip=0):
            return synthetic_images(args.synthetic, lo, hi, skip)
    else:
        flag = "--dinov2-checkpoint" if dinov2 else "--biovil-checkpoint"
        if not (args.csv and checkpoint):
            raise SystemExit(f"--csv and {flag} required (or --synthetic N)")
        import itertools

        from incremental_multimodal_medical_learning_ii_torch.data.manifest import (
            ChexpertManifest,
        )

        if dinov2:
            model = vit.load_dinov2_checkpoint(checkpoint, dims)
        else:
            from incremental_multimodal_medical_learning_ii_torch.models.convert import (
                load_biovil_image_checkpoint,
            )

            model = load_biovil_image_checkpoint(checkpoint)
        manifest = ChexpertManifest.from_csv(args.csv, img_dir=args.img_dir)
        lo, hi = host_bounds(len(manifest), args.num_hosts, args.host_index)
        print(f"{len(manifest)} images" + (
            f"; host {args.host_index}/{args.num_hosts} takes [{lo}, {hi})"
            if args.num_hosts > 1 else ""
        ))

        def iterator(skip=0):
            it = manifest_image_iterator(manifest, workers=args.decode_workers, start=lo + skip)
            return itertools.islice(it, max(0, (hi - lo) - skip))

    out_dir = args.out_dir
    if args.num_hosts > 1:
        out_dir = str(Path(args.out_dir) / f"host-{args.host_index}")
    store = ShardedEmbeddingStore(out_dir)
    skipped = store.total_rows() if args.resume else 0
    stats: dict = {}
    t0 = time.perf_counter()
    ds = extract_embeddings(
        iterator,
        model,
        store=store,
        batch_size=args.batch_size,
        size=size,
        crop=args.crop,
        dtype=torch.float32 if args.fp32 else torch.bfloat16,
        checkpoint_interval=args.checkpoint_interval,
        device_preprocess=not args.host_preprocess,
        grayscale_conv1=not args.no_grayscale_conv1,
        int8=args.int8,
        pad_to=args.pad_to,
        resume=args.resume,
        retries=args.retries,
        readback_interval=args.readback_interval,
        stats=stats,
        device=device,
    )
    dt = time.perf_counter() - t0
    final = store.directory / "dataset.npz"
    ds.save(final)
    fresh = len(ds) - skipped
    print(
        f"extracted {fresh} embeddings in {dt:.1f}s ({fresh/max(dt,1e-9):.1f} imgs/sec)"
        + (f" [resumed past {skipped}]" if skipped else "")
        + f" -> {final} ({len(ds)} total)"
    )
    shards = len(store.shard_paths())
    print(f"stats: {stats}; {shards} shards in {store.directory}")
    return {"dataset": ds, "seconds": dt, "fresh": fresh, "stats": stats, "shards": shards}


if __name__ == "__main__":
    main()
