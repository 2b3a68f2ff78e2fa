"""Embedding dataset store, batching, and incremental-protocol splitters
(a copy of the JAX package's ``data/store.py``: numpy, plus the reference
``.pt`` loader through ``torch.load``).

The reference trains on cached ``TensorDataset``s of ``(N, 128)`` fp32
embeddings and ``(N, 5)`` labels, saved as torch ``.pt`` shards during
extraction (``chexpert-get-embedding.py:86-113``) and re-loaded by
``Trainer._preprocessing`` (``Trainer.py:221-246``).  Here the store is
numpy-native (``.npz`` shards), with optional loading of the reference's
``.pt`` files for drop-in migration, and batching produces *padded* static
batches with element masks instead of ragged final batches so jitted steps
keep static shapes.

Splitters reproduce:
* ``split_dataloader_data_incremental`` (contiguous ceil-sized parts,
  ``Trainer.py:1214-1231``)
* ``split_dataloader_by_label`` (per-disease positives, with intersection,
  ``Trainer.py:1187-1212``)
* the t-SNE subset filters (``Trainer.py:59-98``).
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

EMB_DIM = 128
NUM_LABELS = 5


@dataclasses.dataclass
class EmbeddingDataset:
    """In-memory (N, D) embeddings + (N, C) multi-hot labels."""

    embeddings: np.ndarray
    labels: np.ndarray

    def __post_init__(self) -> None:
        self.embeddings = np.ascontiguousarray(self.embeddings, dtype=np.float32)
        self.labels = np.ascontiguousarray(self.labels, dtype=np.float32)
        if len(self.embeddings) != len(self.labels):
            raise ValueError("embeddings/labels length mismatch")

    def __len__(self) -> int:
        return len(self.embeddings)

    def subset(self, indices) -> "EmbeddingDataset":
        # dtype pinned: an EMPTY range/list would default to float64, which
        # numpy rejects as an index — empty subsets are legal (contiguous
        # split tails, classes with no positives), matching torch Subset
        indices = np.asarray(indices, dtype=np.intp)
        return EmbeddingDataset(self.embeddings[indices], self.labels[indices])

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------
    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, embeddings=self.embeddings, labels=self.labels)

    @staticmethod
    def load(path: str | Path) -> "EmbeddingDataset":
        with np.load(path) as z:
            return EmbeddingDataset(z["embeddings"], z["labels"])

    @staticmethod
    def load_torch_pt(path: str | Path) -> "EmbeddingDataset":
        """Load a reference-format torch dataset checkpoint.

        The reference saves three shapes of ``.pt`` dataset: plain
        ``TensorDataset`` shards (chexpert-get-embedding.py:86-113),
        ``ConcatDataset`` of shards — the actual format of the
        ``embeddings_dataset_final_old.pt`` files ``Trainer._preprocessing``
        loads (glue_dataset.py:33-37) — and ``Subset`` head/tail splits
        (splitTrainingEmbedding.py:17-29).  All three load here.
        """
        import torch

        ds = torch.load(path, map_location="cpu", weights_only=False)
        return EmbeddingDataset._from_torch_dataset(ds)

    @staticmethod
    def _from_torch_dataset(ds) -> "EmbeddingDataset":
        import torch.utils.data as tud

        if isinstance(ds, tud.ConcatDataset):
            return EmbeddingDataset.concat(
                [EmbeddingDataset._from_torch_dataset(d) for d in ds.datasets]
            )
        if isinstance(ds, tud.Subset):
            base = EmbeddingDataset._from_torch_dataset(ds.dataset)
            idx = np.asarray(list(ds.indices), dtype=np.int64)
            # the reference's splitTrainingEmbedding Subsets were built
            # against the full 191k dataset; clamp-free bounds check so a
            # truncated base surfaces loudly instead of wrapping
            if len(idx) and (idx.min() < 0 or idx.max() >= len(base)):
                raise ValueError(
                    f"Subset indices [{idx.min()}, {idx.max()}] out of range "
                    f"for base dataset of {len(base)} rows"
                )
            return base.subset(idx)
        embs, labels = ds.tensors
        return EmbeddingDataset(embs.numpy(), labels.numpy())

    def remove_all_negative(self) -> "EmbeddingDataset":
        """Drop rows whose labels are all zero.

        The embedding-level counterpart of the reference's
        ``CSV_reformatting/new_test_set_senza sani.py:21-32`` (mask
        ``sum(Y, dim=1) > 0`` over a cached embedding dataset);
        ``ChexpertManifest.remove_all_negative`` is the CSV-level one.
        """
        keep = self.labels.sum(axis=1) > 0
        return EmbeddingDataset(self.embeddings[keep], self.labels[keep])

    @staticmethod
    def concat(parts: Sequence["EmbeddingDataset"]) -> "EmbeddingDataset":
        return EmbeddingDataset(
            np.concatenate([p.embeddings for p in parts]),
            np.concatenate([p.labels for p in parts]),
        )


# ----------------------------------------------------------------------
# Sharded store (extraction checkpoints; chexpert-get-embedding.py:86-113)
# ----------------------------------------------------------------------
_SHARD_RE = re.compile(r"shard_(\d+)\.npz$")


class ShardedEmbeddingStore:
    """Directory of ``shard_<start>.npz`` files written during extraction.

    A crash loses at most one shard interval, matching the reference's
    5000-image checkpointing.
    """

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)

    def write_shard(self, start_index: int, embeddings: np.ndarray, labels: np.ndarray) -> Path:
        path = self.directory / f"shard_{start_index:09d}.npz"
        tmp = path.with_suffix(".tmp.npz")
        np.savez(tmp, embeddings=np.asarray(embeddings, np.float32), labels=np.asarray(labels, np.float32))
        os.replace(tmp, path)
        return path

    def shard_paths(self) -> List[Path]:
        return sorted(p for p in self.directory.glob("shard_*.npz") if _SHARD_RE.search(p.name))

    @staticmethod
    def _shard_rows(path: Path) -> int:
        """Row count of one shard from the .npy header alone — resume must
        not decompress hundreds of MB of embeddings just to count them."""
        import zipfile

        from numpy.lib import format as npf

        try:
            with zipfile.ZipFile(path) as z, z.open("embeddings.npy") as f:
                version = npf.read_magic(f)
                if version == (1, 0):
                    shape, _, _ = npf.read_array_header_1_0(f)
                else:
                    shape, _, _ = npf.read_array_header_2_0(f)
                return int(shape[0])
        except (zipfile.BadZipFile, KeyError, ValueError):
            with np.load(path) as z:  # fall back to a full read
                return len(z["embeddings"])

    def total_rows(self) -> int:
        """Number of rows covered by the existing shards, validating that
        they form one contiguous prefix starting at row 0 (the invariant
        extraction maintains; anything else means a foreign/corrupt store
        and resume must not silently skip the wrong images)."""
        rows = 0
        for path in self.shard_paths():
            start = int(_SHARD_RE.search(path.name).group(1))
            if start != rows:
                raise ValueError(
                    f"non-contiguous shard {path.name}: starts at {start}, "
                    f"expected {rows} — refusing to resume"
                )
            rows += self._shard_rows(path)
        return rows

    def glue(self) -> EmbeddingDataset:
        """Concatenate all shards in index order (glue_dataset.py:33-37)."""
        parts = [EmbeddingDataset.load(p) for p in self.shard_paths()]
        if not parts:
            raise FileNotFoundError(f"no shards in {self.directory}")
        return EmbeddingDataset.concat(parts)


# ----------------------------------------------------------------------
# Batching
# ----------------------------------------------------------------------
Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]  # embs, labels, element mask


def iterate_batches(
    dataset: EmbeddingDataset,
    batch_size: int,
    *,
    shuffle: bool,
    rng: Optional[np.random.Generator] = None,
    order: Optional[np.ndarray] = None,
    pad_multiple: int = 1,
    drop_last: bool = False,
) -> Iterator[Batch]:
    """Yield static-shape batches; the final partial batch is zero-padded to
    ``batch_size`` with a 0/1 mask (and ``batch_size`` itself should be a
    multiple of the mesh size, guaranteed by padding to ``pad_multiple``).
    ``order`` overrides the shuffle with an explicit row permutation (the
    twin-run harness injects the reference DataLoader's exact order)."""
    n = len(dataset)
    if order is not None:
        if len(order) != n:
            raise ValueError(f"order has {len(order)} entries for {n} rows")
    else:
        order = np.arange(n)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
    bs = ((batch_size + pad_multiple - 1) // pad_multiple) * pad_multiple
    for start in range(0, n, batch_size):
        idx = order[start : start + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        embs = dataset.embeddings[idx]
        labels = dataset.labels[idx]
        mask = np.ones(len(idx), np.float32)
        if len(idx) < bs:
            pad = bs - len(idx)
            embs = np.concatenate([embs, np.zeros((pad, embs.shape[1]), np.float32)])
            labels = np.concatenate([labels, np.zeros((pad, labels.shape[1]), np.float32)])
            mask = np.concatenate([mask, np.zeros(pad, np.float32)])
        yield embs, labels, mask


def num_batches(n_examples: int, batch_size: int) -> int:
    return math.ceil(n_examples / batch_size)


# ----------------------------------------------------------------------
# Incremental-protocol splitters
# ----------------------------------------------------------------------
def split_contiguous(dataset: EmbeddingDataset, parts: int) -> List[EmbeddingDataset]:
    """N contiguous ceil-sized parts (Trainer.py:1214-1231); the last part
    may be smaller."""
    n = len(dataset)
    size = math.ceil(n / parts)
    return [
        dataset.subset(range(i * size, min((i + 1) * size, n))) for i in range(parts)
    ]


def split_by_label(dataset: EmbeddingDataset, num_classes: int = NUM_LABELS) -> List[EmbeddingDataset]:
    """Per-class positive subsets, *with* intersection (Trainer.py:1187-1212):
    a sample positive for several diseases appears in each of their tasks."""
    return [
        dataset.subset(np.where(dataset.labels[:, i] == 1)[0]) for i in range(num_classes)
    ]


def filter_multiclass(dataset: EmbeddingDataset, per_class: int = 200) -> EmbeddingDataset:
    """First ``per_class`` single-positive samples of each class, in dataset
    order (Trainer.py:59-82); used for the 5-way t-SNE plot."""
    eye = np.eye(NUM_LABELS, dtype=np.float32)
    picked: List[int] = []
    counts = np.zeros(NUM_LABELS, np.int64)
    for idx, row in enumerate(dataset.labels):
        for c in range(NUM_LABELS):
            if counts[c] < per_class and np.array_equal(row, eye[c]):
                counts[c] += 1
                picked.append(idx)
    return dataset.subset(picked)


def filter_sani_malati(dataset: EmbeddingDataset, per_group: int = 400) -> EmbeddingDataset:
    """First ``per_group`` all-negative and all-positive samples
    (Trainer.py:84-98); the healthy-vs-all-diseased t-SNE subset."""
    zeros = np.zeros(NUM_LABELS, np.float32)
    ones = np.ones(NUM_LABELS, np.float32)
    picked: List[int] = []
    counts = [0, 0]
    for idx, row in enumerate(dataset.labels):
        if counts[0] < per_group and np.array_equal(row, zeros):
            counts[0] += 1
            picked.append(idx)
        if counts[1] < per_group and np.array_equal(row, ones):
            counts[1] += 1
            picked.append(idx)
    return dataset.subset(picked)


def count_positive_labels(dataset: EmbeddingDataset) -> np.ndarray:
    """Per-class positive counts (Trainer.py:1233-1249)."""
    return dataset.labels.sum(axis=0)


def synthetic_dataset(
    n: int,
    seed: int = 0,
    emb_dim: int = EMB_DIM,
    num_classes: int = NUM_LABELS,
    class_directions: Optional[np.ndarray] = None,
) -> EmbeddingDataset:
    """Learnable synthetic data for tests/CI (the reference's CheXpert data
    is not redistributable): embeddings are noisy sums of per-class
    direction vectors."""
    rng = np.random.default_rng(seed)
    if class_directions is None:
        class_directions = rng.normal(size=(num_classes, emb_dim)).astype(np.float32)
        class_directions /= np.linalg.norm(class_directions, axis=1, keepdims=True)
    labels = (rng.random((n, num_classes)) < 0.3).astype(np.float32)
    embs = labels @ class_directions + 0.5 * rng.normal(size=(n, emb_dim)).astype(np.float32)
    return EmbeddingDataset(embs.astype(np.float32), labels)
