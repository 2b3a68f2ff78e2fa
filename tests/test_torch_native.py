"""The port's native (C++) embedding store (``runtime/`` + ``data/native.py``)
against the JAX package's: the cases of ``tests/test_native.py``; files
byte for byte and batch orders across the two packages; a ``Trainer`` run
over each package's store; ``prepare_data --native``; the numpy batcher
only when the library cannot be built."""

import ctypes

import jax
import numpy as np
import pytest

from incremental_multimodal_medical_learning_ii_tpu.cli import prepare_data as j_prepare
from incremental_multimodal_medical_learning_ii_tpu.data import native as jnative
from incremental_multimodal_medical_learning_ii_tpu.data.store import (
    EmbeddingDataset as JDataset,
)
from incremental_multimodal_medical_learning_ii_tpu.engine.trainer import Trainer as JTrainer
from incremental_multimodal_medical_learning_ii_tpu.models.adapters import AdapterPair as JPair
from incremental_multimodal_medical_learning_ii_tpu.text.bank import (
    build_prompt_bank as j_build_bank,
)
from incremental_multimodal_medical_learning_ii_tpu.text.bank import (
    synthetic_encode_fn as j_encode_fn,
)
from incremental_multimodal_medical_learning_ii_tpu.text.prompts import (
    create_prompts as j_create_prompts,
)
from incremental_multimodal_medical_learning_ii_tpu.utils.config import (
    joint_config as j_joint_config,
)
from incremental_multimodal_medical_learning_ii_torch import runtime
from incremental_multimodal_medical_learning_ii_torch.cli import prepare_data as t_prepare
from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
from incremental_multimodal_medical_learning_ii_torch.data.native import (
    NativeEmbeddingStore,
    native_available,
    native_build_error,
)
from incremental_multimodal_medical_learning_ii_torch.data.store import (
    ShardedEmbeddingStore,
    synthetic_dataset,
)
from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer as TTrainer
from incremental_multimodal_medical_learning_ii_torch.models.adapters import AdapterPair as TPair
from incremental_multimodal_medical_learning_ii_torch.text.bank import (
    build_prompt_bank,
    synthetic_encode_fn,
)
from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
from incremental_multimodal_medical_learning_ii_torch.utils.config import (
    CHEXPERT_COMPETITION_TASKS,
    joint_config,
)

from torch_port_helpers import assert_parity, one_torch_thread, to_numpy_tree  # noqa: F401

LOSS_ATOL = 1e-5  # tests/test_torch_trainer.py's bar
METRIC_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _toolchain():
    """The native cases need g++ (decided here, never at import)."""
    if not native_available():
        pytest.skip(f"no C++ toolchain: {native_build_error()}")


# ----------------------------------------------------------------------
# the cases of tests/test_native.py
# ----------------------------------------------------------------------
def test_roundtrip_gather_and_bounds(tmp_path):
    ds = synthetic_dataset(100, seed=1)
    store = NativeEmbeddingStore.write(tmp_path / "train.embstore", ds)
    assert store.native and (store.n, store.emb_dim, store.n_labels) == (100, 128, 5)
    back = store.to_dataset()
    np.testing.assert_array_equal(back.embeddings, ds.embeddings)
    np.testing.assert_array_equal(back.labels, ds.labels)
    idx = np.array([3, 7, 7, 99, 0], np.uint64)
    embs, labels = store.gather(idx)
    np.testing.assert_array_equal(embs, ds.embeddings[idx.astype(int)])
    np.testing.assert_array_equal(labels, ds.labels[idx.astype(int)])
    with pytest.raises(IndexError, match="-1"):
        store.gather(np.array([0, -1]))
    with pytest.raises(IndexError, match="100"):
        store.gather(np.array([100]))
    assert store.gather(np.array([], np.int64))[0].shape == (0, 128)
    store.close()
    assert not store.native


def test_batcher_epochs_padding_and_shuffle(tmp_path):
    ds = synthetic_dataset(37, seed=3)
    store = NativeEmbeddingStore.write(tmp_path / "b.embstore", ds)
    batches = list(store.iterate_batches(8, shuffle=False))
    assert len(batches) == 5 and int(sum(b[2].sum() for b in batches)) == 37
    got = np.concatenate([b[0][b[2] > 0] for b in batches])
    np.testing.assert_array_equal(got, ds.embeddings)  # unshuffled: dataset order
    last = batches[-1]
    assert np.all(last[0][last[2] == 0] == 0) and np.all(last[1][last[2] == 0] == 0)
    assert all(b[0].shape[0] == 16 for b in store.iterate_batches(6, shuffle=False,
                                                                 pad_multiple=16))
    a = [b[0].copy() for b in store.iterate_batches(16, shuffle=True, seed=5)]
    c = [b[0].copy() for b in store.iterate_batches(16, shuffle=True, seed=5)]
    for x, y in zip(a, c, strict=True):
        np.testing.assert_array_equal(x, y)
    flat = np.concatenate(a)[np.concatenate([b[2] for b in store.iterate_batches(
        16, shuffle=True, seed=5)]) > 0]
    assert not np.array_equal(flat, ds.embeddings)
    np.testing.assert_array_equal(np.sort(flat[:, 0]), np.sort(ds.embeddings[:, 0]))
    # abandoned mid-epoch, again and again; full epochs still follow
    for _ in range(10):
        for i, _batch in enumerate(store.iterate_batches(8, shuffle=True, seed=1)):
            if i == 2:
                break
    assert sum(int(b[2].sum()) for b in store.iterate_batches(8, shuffle=False)) == 37
    store.close()


def test_truncated_store_rejected_and_write_is_atomic(tmp_path):
    path = tmp_path / "store.embstore"
    NativeEmbeddingStore.write(path, synthetic_dataset(64, seed=0)).close()
    assert not list(tmp_path.glob("*.tmp"))
    data = path.read_bytes()
    truncated = tmp_path / "trunc.embstore"
    truncated.write_bytes(data[: len(data) // 2])  # header intact, payload cut
    with pytest.raises(FileNotFoundError, match="truncated"):
        NativeEmbeddingStore(truncated)
    assert NativeEmbeddingStore(path).n == 64


def test_cross_backend_npz_open(tmp_path):
    ds = synthetic_dataset(20, seed=5)
    ds.save(tmp_path / "x.npz")  # what write() leaves without a toolchain
    store = NativeEmbeddingStore(tmp_path / "x.embstore")
    assert store.n == 20 and not store.native
    np.testing.assert_array_equal(store.to_dataset().embeddings, ds.embeddings)
    assert len(list(store.iterate_batches(8, shuffle=False))) == 3
    with pytest.raises(FileNotFoundError, match="no native store"):
        NativeEmbeddingStore(tmp_path / "missing.embstore")


def test_batcher_c_abi_restart_mid_epoch(tmp_path):
    """batcher_start_epoch on a batcher abandoned mid-epoch joins the live
    prefetch worker before resetting its order, then serves a full epoch."""
    store = NativeEmbeddingStore.write(tmp_path / "c.embstore", synthetic_dataset(64, seed=3))
    lib, padded = store._lib, 8
    b = lib.batcher_create(store._handle, 8, padded, 1, 5)
    fp = ctypes.POINTER(ctypes.c_float)
    embs = np.empty((padded, store.emb_dim), np.float32)
    labels = np.empty((padded, store.n_labels), np.float32)
    mask = np.empty(padded, np.float32)

    def next_valid():
        return lib.batcher_next(b, embs.ctypes.data_as(fp), labels.ctypes.data_as(fp),
                                mask.ctypes.data_as(fp))

    try:
        for _ in range(50):
            lib.batcher_start_epoch(b)
            assert next_valid() == 8
        lib.batcher_start_epoch(b)
        total = 0
        while (v := next_valid()) != 0:
            total += v
        assert total == 64
    finally:
        lib.batcher_destroy(b)
        store.close()


# ----------------------------------------------------------------------
# the two packages' stores
# ----------------------------------------------------------------------
def test_stores_are_byte_identical_and_open_across_packages(tmp_path):
    ds = synthetic_dataset(70, seed=8)
    ours = NativeEmbeddingStore.write(tmp_path / "port.embstore", ds)
    ref = jnative.NativeEmbeddingStore.write(tmp_path / "jax.embstore",
                                             JDataset(ds.embeddings, ds.labels))
    data = (tmp_path / "port.embstore").read_bytes()
    assert data == (tmp_path / "jax.embstore").read_bytes()
    assert data[:8] == b"EROTSBME"  # 0x454d4253544f5245 little-endian: "EMBSTORE"
    for a, b_ in ((NativeEmbeddingStore(tmp_path / "jax.embstore"), ref),
                  (jnative.NativeEmbeddingStore(tmp_path / "port.embstore"), ours)):
        np.testing.assert_array_equal(a.to_dataset().embeddings, b_.to_dataset().embeddings)
        np.testing.assert_array_equal(a.to_dataset().labels, b_.to_dataset().labels)
    # the same seed gives the same batch order in both packages
    for shuffle, seed in ((True, 3), (True, 2**31 - 1), (False, 0)):
        got = list(ours.iterate_batches(16, shuffle=shuffle, seed=seed))
        want = list(ref.iterate_batches(16, shuffle=shuffle, seed=seed))
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                np.testing.assert_array_equal(x, y)


def test_numpy_batcher_only_without_a_library(tmp_path, monkeypatch):
    """No toolchain: the store goes to .npz and the numpy batcher, with a
    readable reason; a library that built and then fails raises."""
    ds = synthetic_dataset(30, seed=2)
    # a call of the built library that fails raises, with no .npz written
    class FailingWrite:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            return getattr(self._lib, name)

        @staticmethod
        def embstore_write(*args):
            return -2  # a short fwrite: disk full

    monkeypatch.setattr(runtime, "_lib", FailingWrite(runtime.load_library()))
    with pytest.raises(OSError, match="embstore_write failed with -2"):
        NativeEmbeddingStore.write(tmp_path / "bad.embstore", ds)
    assert not list(tmp_path.iterdir())

    def no_gxx():
        raise FileNotFoundError(2, "No such file or directory", "g++")

    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_build_error", None)
    monkeypatch.setattr(runtime, "build_library", no_gxx)
    assert not native_available()
    assert "g++" in native_build_error()
    store = NativeEmbeddingStore.write(tmp_path / "x.embstore", ds)
    assert not store.native and (tmp_path / "x.npz").exists()
    assert not (tmp_path / "x.embstore").exists()
    got = np.concatenate([b[0] for b in store.iterate_batches(8, shuffle=False)])[:30]
    np.testing.assert_array_equal(got, ds.embeddings)


def test_prepare_data_native_matches_jax(tmp_path):
    shards = ShardedEmbeddingStore(tmp_path / "shards")
    for start, seed in ((0, 1), (12, 2)):
        part = synthetic_dataset(12, seed=seed)
        shards.write_shard(start, part.embeddings, part.labels)
    for main, name in ((j_prepare.main, "jax"), (t_prepare.main, "port")):
        main(["--shards", str(tmp_path / "shards"), "--out", str(tmp_path / f"{name}.npz"),
              "--native"])
    data = (tmp_path / "port.embstore").read_bytes()
    assert data == (tmp_path / "jax.embstore").read_bytes()
    assert NativeEmbeddingStore(tmp_path / "port.embstore").n == 24


# ----------------------------------------------------------------------
# training over the store
# ----------------------------------------------------------------------
class _Recorder:
    """A writer that keeps every scalar."""

    enabled = True

    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, int(step), float(value)))

    def add_figure(self, *args, **kwargs):
        pass


@pytest.mark.parametrize("shuffle", [False, True], ids=["unshuffled", "shuffled"])
def test_trainer_over_the_store_matches_jax(tmp_path, monkeypatch, shuffle):
    """Each package's trainer over its own store of the same file, from
    the same init: the per-batch path, the C++ batcher's orders."""
    rng = np.random.default_rng(4)
    dirs = rng.normal(size=(5, 128)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    train = synthetic_dataset(150, seed=1, class_directions=dirs)
    val = synthetic_dataset(70, seed=2, class_directions=dirs)
    stores = {}
    for name, ds in (("train", train), ("val", val)):
        stores[name] = (NativeEmbeddingStore.write(tmp_path / f"{name}.embstore", ds),
                        jnative.NativeEmbeddingStore(tmp_path / f"{name}.embstore"))

    def port_init(self, generator=None):
        jpair = JPair(kind=self.kind, shared=self.shared, use_image=self.use_image,
                      use_text=self.use_text)
        return params_from_jax(to_numpy_tree(jpair.init(jax.random.PRNGKey(27))))

    monkeypatch.setattr(TPair, "init", port_init)
    kw = dict(batch_size=32, eval_batch_size=32, epochs=2, lr=1e-3, shuffle_train=shuffle,
              plot_figures="off")
    runs = {}
    for name, trainer_cls, cfg, bank, side in (
        ("port", TTrainer, joint_config(**kw),
         build_prompt_bank(synthetic_encode_fn(), create_prompts(CHEXPERT_COMPETITION_TASKS),
                           CHEXPERT_COMPETITION_TASKS), 0),
        ("jax", JTrainer, j_joint_config(**kw),
         j_build_bank(j_encode_fn(), j_create_prompts(CHEXPERT_COMPETITION_TASKS),
                      CHEXPERT_COMPETITION_TASKS), 1),
    ):
        writer = _Recorder()
        extra = {"device": "cpu"} if name == "port" else {}
        trainer = trainer_cls(cfg, bank, writer=writer, **extra)
        aurocs = []
        for epoch in (1, 2):
            trainer.train(stores["train"][side], epoch=epoch)
            aurocs.append(trainer.validate(stores["val"][side], epoch, 2)["auroc_macro"])
        runs[name] = (writer.rows, aurocs)
    (rows, aurocs), (jrows, jaurocs) = runs["port"], runs["jax"]
    for tag in ("train/Loss", "val/Loss"):
        got = [(s, v) for t, s, v in rows if t == tag]
        want = [(s, v) for t, s, v in jrows if t == tag]
        assert [s for s, _ in got] == [s for s, _ in want] and len(got) == (10 if tag == "train/Loss"
                                                                            else 6)
        assert_parity(f"native store trainer {tag} shuffle={shuffle}", [v for _, v in got],
                      [v for _, v in want], LOSS_ATOL)
    assert_parity(f"native store trainer val AUROC shuffle={shuffle}", aurocs, jaurocs, METRIC_ATOL)
