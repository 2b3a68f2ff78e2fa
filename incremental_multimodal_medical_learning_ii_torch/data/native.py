"""Python face of the native (C++) embedding-store runtime (counterpart of
the JAX package's ``data/native.py``, over the port's own
``runtime/``).

:class:`NativeEmbeddingStore` persists an :class:`EmbeddingDataset` into
the flat mmap format (magic ``EMBSTORE``, n, emb_dim, n_labels, fp32
embeddings, fp32 labels: the JAX package's, so a store written by either
package opens in the other) and serves padded, shuffled, mask-carrying
batches assembled by the C++ prefetch thread; the trainer takes it
wherever it takes a dataset (``engine/trainer.py::Trainer._batches``).

Without a C++ toolchain the store is written as ``.npz`` beside the path
and served by the numpy batcher of ``data/store.py``: the JAX package's
documented contract.  That happens only when the library cannot be
built (:func:`native_build_error` says why); a library that built and
then fails a call raises.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from incremental_multimodal_medical_learning_ii_torch.data.store import (
    Batch,
    EmbeddingDataset,
    iterate_batches,
)
from incremental_multimodal_medical_learning_ii_torch.runtime import (  # noqa: F401
    load_library,
    native_build_error,
)


def native_available() -> bool:
    return load_library() is not None


_FP = ctypes.POINTER(ctypes.c_float)


class NativeEmbeddingStore:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._lib = load_library()
        self._handle = None
        self._fallback: Optional[EmbeddingDataset] = None
        npz_sibling = self.path.with_suffix(".npz")
        if self._lib is not None and self.path.exists():
            self._handle = self._lib.embstore_open(str(self.path).encode())
            if not self._handle:
                raise FileNotFoundError(f"cannot open native store {self.path} (not a store, "
                                        "or truncated)")
            self.n = int(self._lib.embstore_n(self._handle))
            self.emb_dim = int(self._lib.embstore_emb_dim(self._handle))
            self.n_labels = int(self._lib.embstore_n_labels(self._handle))
        elif npz_sibling.exists():
            # a store written without the toolchain (.npz) opens on a host
            # with it, and the other way round
            self._fallback = EmbeddingDataset.load(npz_sibling)
            self.n = len(self._fallback)
            self.emb_dim = self._fallback.embeddings.shape[1]
            self.n_labels = self._fallback.labels.shape[1]
        else:
            raise FileNotFoundError(f"no native store at {self.path} and no fallback at "
                                    f"{npz_sibling}")

    def __len__(self) -> int:
        return self.n

    @property
    def native(self) -> bool:
        """True when the C++ runtime serves this store (not the numpy batcher)."""
        return self._handle is not None

    @staticmethod
    def write(path: str | Path, dataset: EmbeddingDataset) -> "NativeEmbeddingStore":
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        lib = load_library()
        if lib is None:
            dataset.save(path.with_suffix(".npz"))
            return NativeEmbeddingStore(path)
        embs = np.ascontiguousarray(dataset.embeddings, np.float32)
        labels = np.ascontiguousarray(dataset.labels, np.float32)
        # a temporary file renamed into place: a crash or a full disk never
        # leaves a truncated store with a valid header at the destination
        tmp = path.with_name(path.name + ".tmp")
        rc = lib.embstore_write(str(tmp).encode(), embs.ctypes.data_as(_FP),
                                labels.ctypes.data_as(_FP), len(dataset), embs.shape[1],
                                labels.shape[1])
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise OSError(f"embstore_write failed with {rc}")
        os.replace(tmp, path)
        return NativeEmbeddingStore(path)

    def gather(self, indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        if self._handle is None:
            sub = self._fallback.subset(indices)
            return sub.embeddings, sub.labels
        idx_signed = np.asarray(indices)
        # bounds checked BEFORE the ctypes call: a negative index would wrap
        # through the uint64 cast into a wild read, and one >= n would read
        # the labels region; the numpy path raises IndexError, and so must this
        if idx_signed.size and (idx_signed.min() < 0 or idx_signed.max() >= self.n):
            bad = idx_signed[(idx_signed < 0) | (idx_signed >= self.n)][0]
            raise IndexError(f"index {bad} out of range for store of {self.n} rows")
        idx = np.ascontiguousarray(idx_signed, np.uint64)
        embs = np.empty((len(idx), self.emb_dim), np.float32)
        labels = np.empty((len(idx), self.n_labels), np.float32)
        self._lib.embstore_gather(self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                                  len(idx), embs.ctypes.data_as(_FP), labels.ctypes.data_as(_FP))
        return embs, labels

    def to_dataset(self) -> EmbeddingDataset:
        embs, labels = self.gather(np.arange(self.n, dtype=np.uint64))
        return EmbeddingDataset(embs, labels)

    def iterate_batches(self, batch_size: int, *, shuffle: bool, seed: int = 0,
                        pad_multiple: int = 1) -> Iterator[Batch]:
        """Padded static batches with masks, gathered and prefetched by the
        C++ runtime (a seeded SplitMix64 Fisher-Yates shuffle per epoch)."""
        if self._handle is None:
            yield from iterate_batches(self._fallback, batch_size, shuffle=shuffle,
                                       rng=np.random.default_rng(seed), pad_multiple=pad_multiple)
            return
        padded = ((batch_size + pad_multiple - 1) // pad_multiple) * pad_multiple
        b = self._lib.batcher_create(self._handle, batch_size, padded, 1 if shuffle else 0, seed)
        try:
            self._lib.batcher_start_epoch(b)
            while True:
                embs = np.empty((padded, self.emb_dim), np.float32)
                labels = np.empty((padded, self.n_labels), np.float32)
                mask = np.empty(padded, np.float32)
                valid = self._lib.batcher_next(b, embs.ctypes.data_as(_FP),
                                               labels.ctypes.data_as(_FP), mask.ctypes.data_as(_FP))
                if valid == 0:
                    return
                yield embs, labels, mask
        finally:
            self._lib.batcher_destroy(b)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.embstore_close(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()
