"""Extraction through a second image tower: DINOv2 ViT-g/14 with registers
building the embedding cache.

The traffic and the loop are ``extract_stream.py``'s (seeded CheXpert-small
images, a pool of ``pool_blocks`` blocks of ``batch`` drawn in set-up and
cycled, shard checkpoints under the run's temporary directory, the rate
over every image read back from the window's start to the last readback);
the tower is the port's ``models/dinov2.py`` at the configuration's widths,
its weights drawn from the seed.  The window opens the program's recorder
(``utils/profiling.py::recording``), so its counters (``vit_images``,
``vit_tokens``, ``vit_attention_launches``) and spans reach the run.

Set-up draws the pool, draws the weights on the card, builds the tower on
them (one fp32 copy of the weights serves the program, which casts its
blocks to bf16 in each call of the loop, and the reference) and runs the
loop over ``warmup_batches`` batches of the pool.  ``correct``: a sample of
the window's images, drawn anew from the seed, against the plain fp32
reference (``reference/dinov2.py``); and every image sent came back.
"""

from __future__ import annotations

import sys
import time

import torch

from h100_bench.common import images as img
from h100_bench.common.dinov2_weights import dinov2_weights
from h100_bench.drivers.extract_stream import _extract, _program, draw_pool, sample_indices, stream
from h100_bench.drivers.extract_stream import release  # noqa: F401  (frees the model and the pool)
from h100_bench.reference import dinov2 as ref


def _tower():
    from incremental_multimodal_medical_learning_ii_torch.models import dinov2

    return dinov2


def dims_of(cfg: dict):
    """The port's dims of the configuration."""
    return _tower().Dinov2Dims(
        hidden_size=cfg["hidden_size"], depth=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
        patch_size=cfg["patch_size"], image_size=cfg["image_size"],
        ffn="swiglu" if cfg["use_swiglu_ffn"] else "mlp", ffn_hidden=cfg["ffn_hidden_size"],
        num_registers=cfg["num_register_tokens"], ln_eps=cfg["layer_norm_eps"])


def build_model(weights, cfg: dict, device):
    """The port's tower holding the benchmark's weights: their tensors
    themselves (fp32, as a checkpoint is loaded), not a copy."""
    with torch.device("meta"):
        model = _tower().Dinov2(dims_of(cfg))
    model.load_state_dict(weights, strict=True, assign=True)
    return model.to(device).eval()


def setup(run) -> None:
    _, _, store_cls = _program()
    draw_pool(run)
    weights = dinov2_weights(run.seed, run.device, run.config)
    run.state["weights"] = weights
    run.state["model"] = build_model(weights, run.config, run.device)
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
    print(f"[extract] {n} images in {run.window_s:.3f} s; batches {stats.get('batches')}, "
          f"dispatch {stats.get('dispatch_s', 0):.3f} s, readback {stats.get('readback_s', 0):.3f} s, "
          f"feed wait {stats.get('feed_wait_s', 0):.3f} s, retried {stats.get('retried_batches')}; "
          f"vit_images {rec.counters.get('vit_images')}, attention calls "
          f"{rec.counters.get('vit_attention_launches')}", file=sys.stderr)


def check(run) -> None:
    p = run.params
    embs = run.state.pop("embeddings")
    idx = sample_indices(run.seed, len(embs), p["check_images"])
    if not len(idx):
        run.checks.append(("emb_rel_gap", float("inf"), p["limit_emb_rel_gap"]))
        return
    pics = img.images_at(run.seed, idx, p["batch"], tuple(p["image_hw"]), blocks=p["pool_blocks"])
    want = ref.embed_images(run.state["weights"], pics, run.config, p["size"], p["crop"], run.device)
    got = torch.as_tensor(embs[idx], device=run.device)
    gaps = ref.rel_gap(got, want)
    print(f"[extract] relative gaps of {len(idx)} sampled images: median {float(gaps.median())!r}",
          file=sys.stderr)
    run.checks.append(("emb_rel_gap", float(gaps.max()), p["limit_emb_rel_gap"]))
