"""CheXpert embedding extraction at scale (counterpart of the JAX package's
``engine/extract.py``).

Reference: ``chexpert-get-embedding.py:34-113``, a batch-size-1 Python
loop over 191k JPEGs through frozen BioViL ResNet-50 with CPU PIL
preprocessing, checkpointing a torch shard every 5000 images.

The port:

* static-size batches through one forward that runs the preprocessing on
  the device (PIL-parity matmul resize + crop + /255, ``ops/preprocess.py``)
  and then ResNet-50 + projector;
* bf16 conv compute by default (fp32 statistics and accumulations), or the
  int8 trunk (``ops/quant.py``);
* a host prefetch thread decodes and plans batch N+1 while the device runs
  batch N, and holds each batch's pixels in pinned memory, so the upload is
  an asynchronous copy;
* the resize matrices of a shared-size plan are uploaded once per image
  shape and stay on the device;
* the embeddings of ``readback_interval`` batches come back with one
  synchronisation (``utils/device.py::readback``);
* crash-safe shard checkpoints in the same 5000-image cadence, resume and
  per-batch retry.

The encode functions are plain functions of (model, tensors on the model's
device); the model is an argument of each call, as the JAX package passes
its parameters.  ``trace_dir=`` captures a ``torch.profiler`` trace of
the run (``utils/profiling.py``) with each batch's dispatch and each
window's readback in spans named ``extract_dispatch`` and
``extract_readback``, as the JAX package names them; inside the dispatch,
``extract-upload`` and ``extract-encode`` (the forward's enqueue) apart;
in the prefetch thread, ``extract-prepare`` a batch (the draw or decode,
the host preprocess, the pinned staging; ``prepared_batches`` counts
them); and ``extract-shard-write`` for each shard.

``mesh=`` (``parallel/mesh.py``) runs the extraction on each rank of a
data-parallel group, as the JAX package shards each batch over its mesh:
every rank draws the same image stream, prepares and encodes its
contiguous slice of every batch, and the embeddings are gathered back in
order on every rank.  A stream from :func:`manifest_image_iterator` with
``keep=rank_positions(mesh, batch_size)`` decodes only the rank's slice
(the other images are zeros of their files' sizes, which still choose
the batch's preprocess path), so the host's decode splits over the ranks
as the encode does.  Rank 0 alone writes the shards; the resume point is
rank 0's, broadcast.  A failed batch is not retried on a mesh: one rank
re-running its collective alone would put the ranks out of step.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from incremental_multimodal_medical_learning_ii_torch.data.store import (
    EmbeddingDataset,
    ShardedEmbeddingStore,
)
from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
    BioViLImageModel,
    biovil_image_forward,
    fold_grayscale_conv1,
    quantize_biovil_int8,
)
from incremental_multimodal_medical_learning_ii_torch.ops.preprocess import (
    DevicePreprocessPlan,
    SharedSizePreprocessPlan,
    preprocess_device,
    preprocess_device_indexed,
    preprocess_device_shared,
    preprocess_host,
)
from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import (
    barrier,
    gather_rows,
    replicate,
    shard_bounds,
)
from incremental_multimodal_medical_learning_ii_torch.utils.device import readback, resolve_device
from incremental_multimodal_medical_learning_ii_torch.utils.profiling import (
    annotate,
    count,
    maybe_trace,
)
from incremental_multimodal_medical_learning_ii_torch.utils.retry import retry_call

ImageLabel = Tuple[np.ndarray, np.ndarray]  # (H, W) uint8, (5,) float32


def make_encode_preprocessed_fn(dtype=torch.bfloat16, int8: bool = False):
    """(model, (B, S, S, 3) float images) -> (B, 128) embeddings."""

    @torch.no_grad()
    def fn(model, images):
        return biovil_image_forward(model, images, dtype=dtype, int8=int8).projected_global_embedding

    return fn


def make_encode_raw_indexed_fn(dtype=torch.bfloat16, channels: int = 3, int8: bool = False):
    """(model, raw u8 (B,P,P), uniq_w_h (U,crop,P), uniq_w_w, idx) -> (B, 128)
    for mixed-shape batches: the per-image resize matrices are gathered on
    the device from U unique pairs (``DevicePreprocessPlan.prepare_deduped``),
    so the host uploads U matrix pairs instead of B."""

    @torch.no_grad()
    def fn(model, raw, uniq_w_h, uniq_w_w, idx):
        images = preprocess_device_indexed(raw, uniq_w_h, uniq_w_w, idx, channels=channels)
        return biovil_image_forward(model, images, dtype=dtype, int8=int8).projected_global_embedding

    return fn


def make_encode_raw_fn(dtype=torch.bfloat16, channels: int = 3, int8: bool = False):
    """(model, raw u8 (B,P,P), w_h, w_w) -> (B, 128) with per-image matrices.

    ``channels=1`` expects conv1 folded for grayscale input
    (:func:`fold_grayscale_conv1`): the image stays single-channel on the
    device and conv1 does a third of the work, with the same math (the
    reference's ``ExpandChannels`` copies one plane three times)."""

    @torch.no_grad()
    def fn(model, raw, w_h, w_w):
        images = preprocess_device(raw, w_h, w_w, channels=channels)
        return biovil_image_forward(model, images, dtype=dtype, int8=int8).projected_global_embedding

    return fn


def make_encode_raw_shared_fn(dtype=torch.bfloat16, channels: int = 3, int8: bool = False):
    """(model, raw u8 (B,H,W), shared w_h, w_w) -> (B, 128); the uniform-size
    path: only raw uint8 pixels cross to the device with each batch."""

    @torch.no_grad()
    def fn(model, raw, w_h, w_w):
        images = preprocess_device_shared(raw, w_h, w_w, channels=channels)
        return biovil_image_forward(model, images, dtype=dtype, int8=int8).projected_global_embedding

    return fn


def _batched(it: Iterator[ImageLabel], batch_size: int) -> Iterator[Tuple[list, np.ndarray, int]]:
    """Group into fixed-size batches; the final batch is padded by repeating
    its last image (static shapes) and carries the true count."""
    batch: list = []
    labels: list = []
    for img, lbl in it:
        batch.append(img)
        labels.append(lbl)
        if len(batch) == batch_size:
            yield batch, np.stack(labels), batch_size
            batch, labels = [], []
    if batch:
        n = len(batch)
        while len(batch) < batch_size:
            batch.append(batch[-1])
            labels.append(labels[-1])
        yield batch, np.stack(labels), n


def _prefetch(gen, depth: int = 2):
    """Run a generator in a background thread with a bounded queue.

    The consumer abandoning this generator (extraction aborting after
    exhausted retries) sets ``stop`` in the ``finally``, so the worker never
    blocks forever on a full queue: a leaked thread would pin its prepared
    batch (tens of MB of pinned memory at production shapes) for the life
    of the process."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    err: list = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not _put(item):
                    return
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            _put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def rank_positions(mesh, batch_size: int) -> Callable[[int], bool]:
    """Whether the j-th image of a stream (counted from the first image it
    yields) lies in this rank's slice of its batch on ``mesh``: the ``keep``
    of :func:`manifest_image_iterator` for ``extract_embeddings(mesh=mesh,
    batch_size=batch_size)``.  To resume, pass the stream as a callable of
    the skip that starts it there (a run cut after a part batch refuses an
    iterable on a mesh)."""
    lo, hi = shard_bounds(mesh, batch_size)
    return lambda j: lo <= j % batch_size < hi


def extract_embeddings(
    images: Iterable[ImageLabel] | Callable[[int], Iterable[ImageLabel]],
    model: BioViLImageModel,
    store: Optional[ShardedEmbeddingStore] = None,
    *,
    batch_size: int = 64,
    size: int = 512,
    crop: Optional[int] = None,
    dtype: torch.dtype = torch.bfloat16,
    checkpoint_interval: int = 5000,  # images, like the reference's 5000 batches of 1
    device_preprocess: bool = True,
    grayscale_conv1: bool = True,
    int8: bool = False,
    pad_to: int = 1024,
    mesh=None,
    prefetch_depth: int = 2,
    readback_interval: int = 4,
    trace_dir: Optional[str] = None,
    resume: bool = False,
    retries: int = 2,
    retry_backoff_s: float = 0.5,
    stats: Optional[dict] = None,
    device=None,
) -> EmbeddingDataset:
    """Run the full extraction pass; returns the (N, 128) dataset and writes
    shard checkpoints along the way when ``store`` is given.  ``device=None``
    means CUDA (raises without it); ``device="cpu"`` runs the plain path.

    Fault tolerance (beyond the reference, whose extraction dies on any
    error and restarts from image 0):

    * an error during dispatch or readback re-dispatches the in-flight
      batch up to ``retries`` times with exponential backoff;
    * ``resume=True`` (requires ``store``) skips the images already covered
      by existing contiguous shards and extracts only the tail, returning
      the full glued dataset.  ``images`` may be a callable ``skip ->
      iterator`` so skipped images are never decoded (pass ``lambda s:
      manifest_image_iterator(manifest, start=s)``); a plain iterable is
      sliced instead (skipped items are drawn and discarded).  Shards are
      written at batch boundaries, so the resumed batches are the clean
      run's.

    ``stats``, if given a dict, is filled with wall-time totals:
    ``{"dispatch_s", "readback_s", "feed_wait_s", "batches",
    "retried_batches"}``; ``feed_wait_s`` is the time the loop waited for
    the prefetch thread's next prepared batch.

    On a ``mesh`` (one call on every rank, with the same arguments),
    ``batch_size`` must divide over the ranks; ``device`` is the rank's.

    ``readback_interval`` is the number of dispatched batches read back per
    device-to-host synchronisation.  On CUDA the run uses
    ``torch.backends.cudnn.benchmark = False`` (restored afterwards), so
    cuDNN picks its algorithms by heuristics, the same ones in a resumed
    run as in a clean one.
    """
    crop = crop or size
    if readback_interval < 1:
        # 0 would make every flush a no-op: the window (and its host raw
        # buffers) grows unboundedly and no shard checkpoint is ever written
        raise ValueError(f"readback_interval must be >= 1, got {readback_interval}")
    if mesh is not None:
        if batch_size % mesh.size:
            raise ValueError(f"batch_size={batch_size} not divisible by the mesh's "
                             f"{mesh.size} data shards")
        device, retries = mesh.device, 0
        lo, hi = shard_bounds(mesh, batch_size)
    else:
        lo, hi = 0, batch_size
    writes = mesh is None or mesh.rank == 0
    device = resolve_device(device)
    if stats is not None:
        stats.update(dispatch_s=0.0, readback_s=0.0, feed_wait_s=0.0, batches=0,
                     retried_batches=0)
    channels = 3
    if device_preprocess and grayscale_conv1:
        # the pipeline's 3 channels are identical (ExpandChannels,
        # DataRetrieval.py:27-40): fold conv1 over its input channels and
        # keep images single-channel, the same math at a third of the traffic
        model = fold_grayscale_conv1(model)
        channels = 1
    if int8:
        # post-training quantization of the frozen trunk; after the fold,
        # which works on the float conv1 kernel
        model = quantize_biovil_int8(model)
    model = model.to(device).eval()
    cuda = device.type == "cuda"

    def host(array) -> torch.Tensor:
        """A host tensor for the upload: pinned on CUDA (made in the
        prefetch thread), so the copy does not block the host."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        return t.pin_memory() if cuda else t

    def up(t: torch.Tensor) -> torch.Tensor:
        return t.to(device, non_blocking=True)

    if device_preprocess:
        plan = DevicePreprocessPlan(size=size, crop=crop, pad_to=pad_to)
        encode_indexed = make_encode_raw_indexed_fn(dtype=dtype, channels=channels, int8=int8)
        encode_shared = make_encode_raw_shared_fn(dtype=dtype, channels=channels, int8=int8)
        shared_plans: dict = {}  # (h, w) -> SharedSizePreprocessPlan
        shared_matrices: dict = {}  # (h, w) -> its (w_h, w_w) on the device

        def prepare(batch_imgs):
            # the path is the whole batch's; the pixels are this rank's slice
            shapes = {im.shape for im in batch_imgs}
            batch_imgs = batch_imgs[lo:hi]
            if len(shapes) == 1:
                hw = next(iter(shapes))
                sp = shared_plans.get(hw)
                if sp is None:
                    sp = shared_plans[hw] = SharedSizePreprocessPlan(*hw, size=size, crop=crop)
                return ("shared", host(sp.prepare(batch_imgs)), hw)
            # mixed shapes: one matrix pair per DISTINCT shape + a per-image
            # gather index (B dense pairs would be ~4 MB an image)
            raw, uniq_w_h, uniq_w_w, idx = plan.prepare_deduped(batch_imgs)
            return ("indexed", host(raw), host(uniq_w_h), host(uniq_w_w), host(idx))

        def staged(prepared):
            """(encode function, its device operands), the upload enqueued."""
            if prepared[0] == "shared":
                _, raw, hw = prepared
                mats = shared_matrices.get(hw)
                if mats is None:  # once per image shape, then kept on the device
                    sp = shared_plans[hw]
                    mats = shared_matrices[hw] = (up(host(sp.w_h)), up(host(sp.w_w)))
                return encode_shared, (up(raw), *mats)
            _, raw, uniq_w_h, uniq_w_w, idx = prepared
            return encode_indexed, (up(raw), up(uniq_w_h), up(uniq_w_w), up(idx))

    else:
        encode_pre = make_encode_preprocessed_fn(dtype=dtype, int8=int8)

        def prepare(batch_imgs):
            return host(np.stack([preprocess_host(im, size=size, crop=crop)
                                  for im in batch_imgs[lo:hi]]))

        def staged(prepared):
            return encode_pre, (up(prepared),)

    skip = 0
    all_embs: list = []
    all_labels: list = []
    if resume:
        if store is None:
            raise ValueError("resume=True requires a store")
        existing = store.total_rows()
        if mesh is not None:  # rank 0's resume point
            existing = int(replicate(mesh, torch.tensor([existing], device=device))[0])
        if existing:
            prior = store.glue()
            all_embs.append(prior.embeddings)
            all_labels.append(prior.labels)
            skip = existing
    if mesh is not None and skip % batch_size and not callable(images):
        # a stream's rank_positions count from its first image: dropping a
        # part of a batch would shift every rank's slice
        raise ValueError(f"resuming at {skip} images, not a multiple of batch_size="
                         f"{batch_size}, on a mesh needs images as a callable of the skip")

    def prepared_batches():
        if callable(images):
            it = iter(images(skip))
        else:
            it = iter(images)
            if skip:
                it = itertools.islice(it, skip, None)
        batches = _batched(it, batch_size)
        while True:
            # the draw or decode happens inside next(): the span covers it
            with annotate("extract-prepare") as span:
                item = next(batches, None)
                if item is None:
                    span.drop()
                    return
                batch_imgs, labels, n = item
                prepared = prepare(batch_imgs)
            count("prepared_batches")
            yield prepared, labels, n

    pending_embs: list = []
    pending_labels: list = []
    written = skip
    seen = skip

    def handle(embs_np, labels, n):
        nonlocal seen, written, pending_embs, pending_labels
        embs_np = embs_np[:n]
        labels = labels[:n]
        seen += n
        all_embs.append(embs_np)
        all_labels.append(labels)
        if store is not None and writes:
            pending_embs.append(embs_np)
            pending_labels.append(labels)
            if seen - written >= checkpoint_interval:
                with annotate("extract-shard-write"):
                    store.write_shard(written, np.concatenate(pending_embs),
                                      np.concatenate(pending_labels))
                written = seen
                pending_embs, pending_labels = [], []

    def encode(prepared):
        with annotate("extract-upload"):
            fn, operands = staged(prepared)
        with annotate("extract-encode"):
            out = fn(model, *operands)
            return out if mesh is None else gather_rows(mesh, out.float(), batch_size)

    def dispatch(prepared):
        """encode() with retry: an error re-dispatches with exponential backoff."""

        def count(_attempt, _e):
            if stats is not None:
                stats["retried_batches"] += 1

        return retry_call(lambda: encode(prepared), retries, retry_backoff_s, on_retry=count)

    def flush(window, k=None):
        """One device-to-host transfer for the oldest ``k`` dispatched
        batches, with retry: a failed readback re-dispatches every batch in
        the head from its still-held host ``prepared`` tensors."""
        k = len(window) if k is None else min(k, len(window))
        if k == 0:
            return
        head = window[:k]
        del window[:k]
        with annotate("extract_readback"):
            t0 = time.perf_counter()

            def redispatch(_attempt, _e):
                nonlocal head
                if stats is not None:
                    stats["retried_batches"] += len(head)
                head = [(dispatch(w[1]), w[1], w[2], w[3]) for w in head]

            arrs = retry_call(lambda: readback([w[0] for w in head]), retries, retry_backoff_s,
                              on_retry=redispatch)
            if stats is not None:
                stats["readback_s"] += time.perf_counter() - t0
        for (_, _, labels, n), arr in zip(head, arrs):
            handle(np.asarray(arr, dtype=np.float32), labels, n)

    # Windowed pipeline: dispatch up to ``readback_interval`` batches (async
    # upload + compute enqueue), then read the window back with ONE
    # synchronisation; the window runs one batch ahead (a flush starts only
    # once a batch beyond it is dispatched), which at interval 1 is the
    # two-deep loop.
    benchmark = torch.backends.cudnn.benchmark
    if cuda:
        torch.backends.cudnn.benchmark = False
    try:
        with maybe_trace(trace_dir, device):
            window: list = []  # (device result, host prepared, labels, n)
            fed = time.perf_counter()
            for prepared, labels, n in _prefetch(prepared_batches(), depth=prefetch_depth):
                if stats is not None:
                    stats["feed_wait_s"] += time.perf_counter() - fed
                with annotate("extract_dispatch"):
                    t0 = time.perf_counter()
                    window.append((dispatch(prepared), prepared, labels, n))
                    if stats is not None:
                        stats["dispatch_s"] += time.perf_counter() - t0
                        stats["batches"] += 1
                if len(window) > readback_interval:
                    flush(window, readback_interval)  # keep the newest in flight
                fed = time.perf_counter()
            flush(window)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    if store is not None and pending_embs:
        with annotate("extract-shard-write"):
            store.write_shard(written, np.concatenate(pending_embs), np.concatenate(pending_labels))
    if mesh is not None:
        barrier(mesh)  # rank 0's shards are on disk before any rank returns
    if not all_embs:
        return EmbeddingDataset(np.zeros((0, 128), np.float32), np.zeros((0, 5), np.float32))
    return EmbeddingDataset(np.concatenate(all_embs), np.concatenate(all_labels))


def manifest_image_iterator(
    manifest, loader: Optional[Callable] = None, workers: int = 0, start: int = 0,
    keep: Optional[Callable[[int], bool]] = None,
) -> Iterator[ImageLabel]:
    """Iterate (raw grayscale uint8, label) pairs from a ChexpertManifest.

    ``workers > 0`` decodes with a process pool (the reference's
    ``num_workers=4`` DataLoader parallelism, ``DataRetrieval.py:151-153``);
    order is preserved.  ``start`` skips the first N images without
    decoding them (extraction resume).  Where ``keep(j)`` is false for the
    j-th image yielded, it is not decoded: zeros of its file's size (read
    from the header; the loader must keep that size) stand in for it
    (:func:`rank_positions`: a rank of a mesh decodes its slices only).
    """
    from incremental_multimodal_medical_learning_ii_torch.data.images import (
        image_shape,
        load_image_raw_uint8,
    )

    labels = manifest.labels()[start:]
    paths = manifest.image_paths()[start:]
    loader = loader or load_image_raw_uint8
    keep = keep or (lambda j: True)

    def stand_in(path):
        return np.zeros(image_shape(path), np.uint8)

    if workers:
        # the pool runs whatever loader was given (it must be picklable: a
        # module-level function, not a lambda).  NEVER fork here: the
        # caller has CUDA (and torch's thread pools) initialised, and a
        # forked child inherits their state mid-use.  forkserver/spawn
        # start workers from a clean process; the loader's module
        # (data/images.py) is torch-free, so each worker imports only
        # numpy and PIL.
        import multiprocessing

        methods = multiprocessing.get_all_start_methods()
        ctx = multiprocessing.get_context("forkserver" if "forkserver" in methods else "spawn")
        with ctx.Pool(workers) as pool:
            decoded = pool.imap(loader, (p for j, p in enumerate(paths) if keep(j)), chunksize=8)
            for idx, path in enumerate(paths):
                yield (next(decoded) if keep(idx) else stand_in(path)), labels[idx]
        return
    for idx, path in enumerate(paths):
        yield (loader(path) if keep(idx) else stand_in(path)), labels[idx]
