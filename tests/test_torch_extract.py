"""The port's engine/extract.py against the JAX package's on the CPU: the
same images and weights through the shared-size, indexed and host
preprocess paths (grayscale fold on and off), shard checkpoints, the
readback window, resume, retries and the refusals."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.data.store import (
    ShardedEmbeddingStore as JStore,
)
from incremental_multimodal_medical_learning_ii_tpu.engine import extract as jex
from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
from incremental_multimodal_medical_learning_ii_torch.data.store import ShardedEmbeddingStore
from incremental_multimodal_medical_learning_ii_torch.engine import extract as tex

from torch_port_helpers import (  # noqa: F401
    assert_parity,
    biovil_numpy_params_from_port,
    one_torch_thread,
    trace_spans,
)

EMB_ATOL = 2e-4  # the ResNet bar
KW = dict(batch_size=2, size=64, pad_to=128)


@pytest.fixture(scope="module")
def weights():
    tree = biovil_numpy_params_from_port(seed=1, bn_seed=4)
    return jax.tree_util.tree_map(jnp.asarray, tree), params_from_jax(tree)


def _images(n, seed, shapes=((100, 80), (101, 80), (102, 80))):
    rng = np.random.default_rng(seed)
    return [((rng.random(shapes[i % len(shapes)]) * 255).astype(np.uint8),
             (rng.random(5) < 0.5).astype(np.float32)) for i in range(n)]


MIXED = _images(5, 1)  # mixed shapes: the indexed path
SAME = _images(5, 2, shapes=((100, 80),))  # one shape: the shared path


PATHS = {
    "shared": (SAME, {}),
    "shared-3ch": (SAME, {"grayscale_conv1": False}),
    "indexed": (MIXED, {}),
    "indexed-3ch": (MIXED, {"grayscale_conv1": False}),
    "host": (MIXED, {"device_preprocess": False}),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_extract_matches_jax(weights, path):
    imgs, extra = PATHS[path]
    jtree, model = weights
    ref = jex.extract_embeddings(iter(imgs), jtree, dtype=jnp.float32, **KW, **extra)
    ours = tex.extract_embeddings(iter(imgs), model, dtype=torch.float32, device="cpu",
                                  **KW, **extra)
    assert ours.embeddings.shape == (5, 128)
    assert_parity(f"extract {path}", ours.embeddings, ref.embeddings, EMB_ATOL)
    np.testing.assert_array_equal(ours.labels, ref.labels)


def test_shards_match_jax_and_windows_agree(weights, tmp_path):
    """Shard names and row counts as JAX's (tests/test_extract.py:171); the
    readback windows 1 and 4 give bit-equal results, the padded final batch
    included."""
    jtree, model = weights
    imgs = _images(7, 3)
    jstore, tstore = JStore(tmp_path / "jax"), ShardedEmbeddingStore(tmp_path / "port")
    jex.extract_embeddings(iter(imgs), jtree, store=jstore, dtype=jnp.float32,
                           checkpoint_interval=4, **KW)
    stats: dict = {}
    ds = tex.extract_embeddings(iter(imgs), model, store=tstore, dtype=torch.float32,
                                device="cpu", checkpoint_interval=4, stats=stats, **KW)
    assert [p.name for p in tstore.shard_paths()] == [p.name for p in jstore.shard_paths()]
    assert [tstore._shard_rows(p) for p in tstore.shard_paths()] == \
        [jstore._shard_rows(p) for p in jstore.shard_paths()] == [4, 3]
    assert_parity("extract shards", tstore.glue().embeddings, jstore.glue().embeddings, EMB_ATOL)
    np.testing.assert_array_equal(tstore.glue().embeddings, ds.embeddings)
    assert stats["batches"] == 4 and stats["retried_batches"] == 0
    one = tex.extract_embeddings(iter(imgs), model, dtype=torch.float32, device="cpu",
                                 readback_interval=1, **KW)
    np.testing.assert_array_equal(one.embeddings, ds.embeddings)
    np.testing.assert_array_equal(one.labels, ds.labels)


def test_stats_time_the_wait_for_a_slow_feeder(weights):
    """``feed_wait_s`` is the loop's wait for the prefetch thread: with a
    source that takes 0.1 s an image, it holds at least the first batch's
    two images, the splits cover the six images' production (the loop
    cannot run ahead of its source), and they add up to no more than the
    wall."""
    _, model = weights
    imgs = _images(6, 5, shapes=((100, 80),))

    def slow():
        for item in imgs:
            time.sleep(0.1)
            yield item

    stats: dict = {}
    t0 = time.perf_counter()
    ds = tex.extract_embeddings(slow(), model, dtype=torch.float32, device="cpu", stats=stats,
                                **KW)
    wall = time.perf_counter() - t0
    assert len(ds) == 6 and stats["batches"] == 3
    splits = stats["feed_wait_s"] + stats["dispatch_s"] + stats["readback_s"]
    assert stats["feed_wait_s"] >= 0.95 * 0.1 * KW["batch_size"]
    assert 0.9 * 0.1 * len(imgs) <= splits <= wall


@pytest.mark.parametrize("source", ["callable", "iterable"])
def test_resume_is_bit_exact(weights, tmp_path, source):
    _, model = weights
    imgs = _images(7, 4)
    clean = tex.extract_embeddings(iter(imgs), model, dtype=torch.float32, device="cpu", **KW)
    store = ShardedEmbeddingStore(tmp_path)
    tex.extract_embeddings(iter(imgs[:4]), model, store=store, dtype=torch.float32, device="cpu",
                           checkpoint_interval=4, **KW)  # the "crashed" first run
    assert store.total_rows() == 4
    consumed = []

    def images_from(skip):
        consumed.append(skip)
        return iter(imgs[skip:])

    resumed = tex.extract_embeddings(
        images_from if source == "callable" else iter(imgs), model,
        store=ShardedEmbeddingStore(tmp_path), dtype=torch.float32, device="cpu",
        checkpoint_interval=4, resume=True, **KW)
    assert consumed == ([4] if source == "callable" else [])
    np.testing.assert_array_equal(resumed.embeddings, clean.embeddings)
    np.testing.assert_array_equal(resumed.labels, clean.labels)
    assert ShardedEmbeddingStore(tmp_path).total_rows() == 7


def test_transient_errors_are_retried_and_counted(weights, monkeypatch):
    """One dispatch failure and one readback failure: 1 re-dispatched batch
    plus the whole 3-batch readback window, as in JAX's test."""
    _, model = weights
    imgs = _images(5, 5)
    kw = dict(dtype=torch.float32, device="cpu", device_preprocess=False, **KW)
    clean = tex.extract_embeddings(iter(imgs), model, **kw)
    fail = {"dispatch": 1, "readback": 1}
    real_make, real_readback = tex.make_encode_preprocessed_fn, tex.readback

    def flaky_make(**k):
        real = real_make(**k)

        def fn(m, images):
            if fail["dispatch"] > 0:
                fail["dispatch"] -= 1
                raise RuntimeError("injected transient dispatch error")
            return real(m, images)

        return fn

    def flaky_readback(tree):
        if fail["readback"] > 0:
            fail["readback"] -= 1
            raise RuntimeError("injected transient readback error")
        return real_readback(tree)

    monkeypatch.setattr(tex, "make_encode_preprocessed_fn", flaky_make)
    monkeypatch.setattr(tex, "readback", flaky_readback)
    stats: dict = {}
    ds = tex.extract_embeddings(iter(imgs), model, retries=2, retry_backoff_s=0.0, stats=stats, **kw)
    assert fail == {"dispatch": 0, "readback": 0}
    assert stats["retried_batches"] == 4 and stats["batches"] == 3
    np.testing.assert_array_equal(ds.embeddings, clean.embeddings)
    np.testing.assert_array_equal(ds.labels, clean.labels)

    def broken_make(**k):
        def fn(m, images):
            raise RuntimeError("permanently broken backend")

        return fn

    monkeypatch.setattr(tex, "make_encode_preprocessed_fn", broken_make)
    with pytest.raises(RuntimeError, match="permanently broken"):
        tex.extract_embeddings(iter(imgs), model, retries=1, retry_backoff_s=0.0, **kw)


def test_refusals(weights, monkeypatch, tmp_path):
    _, model = weights
    imgs = _images(2, 6)
    with pytest.raises(ValueError, match="readback_interval"):
        tex.extract_embeddings(iter(imgs), model, device="cpu", readback_interval=0, **KW)
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import Mesh

    mesh = Mesh(rank=0, size=3, device=torch.device("cpu"), backend="gloo", group=None)
    with pytest.raises(ValueError, match="not divisible by the mesh's 3 data shards"):
        tex.extract_embeddings(iter(imgs), model, mesh=mesh, **KW)
    # trace_dir= is ported: the run writes a trace with its spans
    tex.extract_embeddings(iter(imgs), model, device="cpu", trace_dir=str(tmp_path), **KW)
    assert trace_spans(tmp_path)["extract_dispatch"] == 1
    with pytest.raises(ValueError, match="requires a store"):
        tex.extract_embeddings(iter(imgs), model, device="cpu", resume=True, **KW)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tex.extract_embeddings(iter(imgs), model, **KW)


def test_prefetch_worker_stops_when_abandoned():
    """A consumer that stops early (exhausted retries) must not leave the
    worker blocked on a full queue."""
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    before = threading.active_count()
    it = tex._prefetch(gen(), depth=2)
    assert next(it) == 0
    it.close()
    deadline = time.monotonic() + 5
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
    assert len(produced) < 10

    def boom():
        yield 1
        raise OSError("decode failed")

    with pytest.raises(OSError, match="decode failed"):
        list(tex._prefetch(boom()))


def test_batched_pads_the_last_batch():
    items = [(np.full((2, 2), i, np.uint8), np.full(5, i, np.float32)) for i in range(5)]
    batches = list(tex._batched(iter(items), 2))
    assert [n for _, _, n in batches] == [2, 2, 1]
    last_imgs, last_labels, _ = batches[-1]
    assert len(last_imgs) == 2 and last_imgs[1] is last_imgs[0]
    np.testing.assert_array_equal(last_labels, [[4] * 5, [4] * 5])
