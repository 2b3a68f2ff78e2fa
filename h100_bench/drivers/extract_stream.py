"""Extraction over a stream of images: building the embedding cache.

The window drives the port's ``engine/extract.py::extract_embeddings`` over
seeded CheXpert-small images, a seeded pool of ``pool_blocks`` blocks of
``batch`` drawn in set-up and cycled, with its shard checkpoints written
under the run's temporary directory.  The draw stays out of the loop's
prefetch thread, which does the program's work alone (stack, pin), as it
would behind a decoder that keeps up.  The stream stops at the first batch
boundary after the window's length; the loop then drains what it has in
flight, and the rate is every image read back over the whole time from the
window's start to the last readback.  The window opens the program's
recorder (``utils/profiling.py::recording``), so its spans name the card's
idle gaps and its counters reach the run.

Set-up draws the pool, builds the model from the benchmark's weights and
runs the loop over ``warmup_batches`` batches of the pool, so the shapes the
window uses are warm.  ``correct``: a sample of the window's images, drawn
anew from the seed (not read from the pool), against the plain fp32
reference; and every image sent came back.
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from h100_bench.common import images as img
from h100_bench.common.weights import biovil_weights
from h100_bench.reference import biovil as ref


def _program():
    from incremental_multimodal_medical_learning_ii_torch.data.store import ShardedEmbeddingStore
    from incremental_multimodal_medical_learning_ii_torch.engine import extract
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import BioViLImageModel

    return extract, BioViLImageModel, ShardedEmbeddingStore


def build_model(weights, device):
    """The port's BioViL model holding the benchmark's weights."""
    _, model_cls, _ = _program()
    with torch.device(device):
        model = model_cls()
    model.load_state_dict(weights, strict=True)
    return model.eval()


def draw_pool(run) -> None:
    """The cell's images, drawn from the seed into ``run.state["pool"]``: a
    thread a block (numpy's generators and ufuncs release the GIL), all of
    them done before the window opens."""
    n, hw, blocks = run.params["batch"], tuple(run.params["image_hw"]), run.params["pool_blocks"]
    with ThreadPoolExecutor(max_workers=min(blocks, os.cpu_count() or 1)) as ex:
        run.state["pool"] = list(ex.map(lambda b: img.block(run.seed, b, n, hw), range(blocks)))


def stream(pool, stop_at=None, limit=None):
    """(image, label) pairs, block ``b % len(pool)`` of the pool for
    ``b = 0, 1, ...``; stops after ``limit`` blocks, or at the first block
    boundary at which ``stop_at()`` is true: never before the first block,
    so a window that the loop's own start outlasts still sends a batch."""
    b = 0
    label = np.zeros(5, np.float32)
    while limit is None or b < limit:
        for x in pool[b % len(pool)]:
            yield x, label
        b += 1
        if stop_at is not None and stop_at():
            return


def _extract(run, model, images, store, stats):
    extract, _, _ = _program()
    p = run.params
    return extract.extract_embeddings(
        images, model, store, batch_size=p["batch"], size=p["size"], crop=p["crop"],
        dtype=getattr(torch, p["dtype"]), checkpoint_interval=p["shard_every"],
        grayscale_conv1=p["grayscale_conv1"], int8=p.get("int8", False),
        prefetch_depth=p["prefetch_depth"], readback_interval=p["readback_window"],
        stats=stats, device=run.device)


def setup(run) -> None:
    _, _, store_cls = _program()
    draw_pool(run)
    weights = biovil_weights(run.seed, run.device)
    run.state["weights"] = weights
    run.state["model"] = build_model(weights, run.device)
    warm = store_cls(run.tmp / "warmup")
    _extract(run, run.state["model"], stream(run.state["pool"], limit=run.params["warmup_batches"]), warm, {})
    if run.device.type == "cuda":
        torch.cuda.synchronize()


def window(run) -> None:
    from incremental_multimodal_medical_learning_ii_torch.utils.profiling import recording

    from h100_bench.common.trace import DeviceTrace

    p = run.params
    _, _, store_cls = _program()
    store = store_cls(run.tmp / "shards")
    stats: dict = {}
    with DeviceTrace(run.trace, run.device) as tr:
        with recording() as rec:
            t0 = time.perf_counter()
            t0_ns = time.time_ns()
            end = t0 + run.seconds
            ds = _extract(run, run.state["model"],
                          stream(run.state["pool"], stop_at=lambda: time.perf_counter() >= end), store, stats)
            t1 = time.perf_counter()
            run.spans.add("extract_embeddings", t0_ns, time.time_ns())
    for s in rec.spans:
        run.spans.add(s.name, s.t0_ns, s.t1_ns)
    run.kernels, run.trace_t0_ns, run.trace_t1_ns = tr.kernels, tr.t0_ns, tr.t1_ns
    run.window_s = t1 - t0
    n = len(ds)
    run.state["embeddings"] = ds.embeddings
    run.attempted = -(-n // p["batch"]) * p["batch"] if n else p["batch"]
    run.failed = run.attempted - n
    run.counters.update(stats)
    run.counters.update(rec.counters)
    run.counters["images"] = n
    run.counters["shards"] = len(store.shard_paths())
    run.e2e["extract_images_per_s"] = n / run.window_s
    prep = [s.t1_ns - s.t0_ns for s in rec.spans if s.name == "extract-prepare"]
    print(f"[extract] {n} images in {run.window_s:.3f} s; batches {stats.get('batches')}, "
          f"dispatch {stats.get('dispatch_s', 0):.3f} s, readback {stats.get('readback_s', 0):.3f} s, "
          f"feed wait {stats.get('feed_wait_s', 0):.3f} s, retried {stats.get('retried_batches')}; "
          f"extract-prepare {1e-6 * sum(prep) / max(len(prep), 1):.2f} ms a batch", file=sys.stderr)


def release(run) -> None:
    run.state.pop("model", None)
    run.state.pop("pool", None)


def sample_indices(seed: int, n: int, k: int) -> np.ndarray:
    """``k`` of the window's ``n`` images, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 7])
    return np.sort(rng.choice(n, size=min(k, n), replace=False)) if n else np.zeros(0, np.int64)


def check(run) -> None:
    p = run.params
    embs = run.state.pop("embeddings")
    idx = sample_indices(run.seed, len(embs), p["check_images"])
    if not len(idx):
        run.checks.append(("emb_rel_gap", float("inf"), p["limit_emb_rel_gap"]))
        return
    pics = img.images_at(run.seed, idx, p["batch"], tuple(p["image_hw"]), blocks=p["pool_blocks"])
    with torch.no_grad():
        want = ref.embed_images(run.state["weights"], pics, p["size"], p["crop"], run.device)
    got = torch.as_tensor(embs[idx], device=run.device)
    gaps = ref.rel_gap(got, want)
    print(f"[extract] relative gaps of {len(idx)} sampled images: median {float(gaps.median())!r}",
          file=sys.stderr)
    run.checks.append(("emb_rel_gap", float(gaps.max()), p["limit_emb_rel_gap"]))
