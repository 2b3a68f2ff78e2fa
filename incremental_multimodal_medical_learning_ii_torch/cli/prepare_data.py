"""Glue extraction shards and write train/val/test datasets (counterpart of
the JAX package's ``cli/prepare_data.py``).

Covers the reference's post-extraction plumbing: shard gluing
(``CSV_reformatting/glue_dataset.py:33-37``) and the head/tail train split
(``splitTrainingEmbedding.py:17-29``: 175000 + 16027), plus the native
mmap store for the C++ batcher (``--native``: ``<out>.embstore``,
``data/native.py``).

    python -m incremental_multimodal_medical_learning_ii_torch.cli.prepare_data \\
        --shards embeddings/train --out data/train.npz [--split-head 175000] [--native]
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--shards", nargs="+",
                   help="directory(ies) of extraction shard_*.npz files; several "
                   "(e.g. multi-host host-0 host-1 ...) are glued in the order given")
    p.add_argument("--pt", help="or: a reference-format torch TensorDataset .pt")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--split-head", type=int, default=0,
                   help="also write <out>.head.npz / <out>.tail.npz at this row")
    p.add_argument("--native", action="store_true",
                   help="also write the native mmap store (<out>.embstore)")
    args = p.parse_args(argv)

    from incremental_multimodal_medical_learning_ii_torch.data.store import (
        EmbeddingDataset,
        ShardedEmbeddingStore,
    )

    if args.shards:
        ds = EmbeddingDataset.concat([ShardedEmbeddingStore(d).glue() for d in args.shards])
    elif args.pt:
        ds = EmbeddingDataset.load_torch_pt(args.pt)
    else:
        raise SystemExit("need --shards or --pt")

    out = Path(args.out)
    ds.save(out)
    print(f"{len(ds)} rows -> {out}")

    if args.split_head:
        head = ds.subset(range(0, args.split_head))
        tail = ds.subset(range(args.split_head, len(ds)))
        head.save(out.with_suffix(".head.npz"))
        tail.save(out.with_suffix(".tail.npz"))
        print(f"split: {len(head)} head / {len(tail)} tail")

    if args.native:
        from incremental_multimodal_medical_learning_ii_torch.data.native import (
            NativeEmbeddingStore,
        )

        store = NativeEmbeddingStore.write(out.with_suffix(".embstore"), ds)
        print(f"native store: {store.path} ({store.n} rows)")
        store.close()


if __name__ == "__main__":
    main()
