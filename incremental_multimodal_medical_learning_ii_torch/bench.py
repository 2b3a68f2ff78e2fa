"""Headline benchmark: CheXpert embedding-extraction throughput (images/s per card).

    python -m incremental_multimodal_medical_learning_ii_torch.bench

Counterpart of the JAX repo's ``bench.py``.  Measures the port's REAL
extraction loop (``engine/extract.py``: host-prefetched raw uint8 batches
through pinned memory -> the device preprocess + BioViL ResNet-50 in bf16
-> windowed embedding readback) on synthetic CheXpert-small geometry
images: what a user's extraction run executes, every host<->device
transfer and synchronisation included.

Methodology on the card:
* a CUDA synchronisation is a real barrier (the loop's readback waits on
  the stream), and nothing memoises executions; every batch and every
  round still has fresh pixels, because a user's extraction reads new
  images, and the host's work of drawing them is part of what is timed;
* rounds are sampled within a time budget and the report gives best AND
  median, with the dispatch, readback and feed-wait wall split per batch
  (the feed wait is the loop's wait for the prefetch thread's next
  batch), so a number set by the host shows as such;
* errors are retried per batch inside the extraction loop and per round
  here; the retries cost nothing when nothing fails.

Baseline: the reference is a batch-size-1 torch-CPU loop with PIL
preprocessing (``chexpert-get-embedding.py:49,68-99``; no throughput is
recorded anywhere in the reference); the JAX repo measured **1.509
images/s** for it, with the model's FLOPs and pipeline.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras},
with the card's name (``"device"``) and power limit (``"power_limit_w"``).
Exits 0 unless the program itself is broken; a run that measured nothing
reports value 0.0 with the reason (``"failure"``) and a link probe.

Supervision: the measurement runs in a CHILD process under a hard deadline.
The internal deadline can only fire between operations; one call that
never returns would otherwise take the report with it.  The child prints a
PRELIMINARY wall-only report before the device-side stage and the
enriched final one after; the parent forwards the LAST report (so a hang
in a later stage still delivers the collected wall samples) or, if the
child produced none, a value-0 line with the bounded link probe
(``cli/linkhealth.py::quick_probe``).  The child's stderr is collected and
passed on when it ends; its last line (the exception of a crashed child)
goes into ``"failure"``.  The headline has no CPU mode: without CUDA the
child raises, and the parent prints the value-0 line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

TORCH_CPU_BASELINE_IMGS_PER_SEC = 1.509  # measured 2026-08-16 by the JAX repo

# CheXpert-v1.0-small frontal geometry
IMG_H, IMG_W = 390, 320
BATCH = 512
IMAGES_PER_ROUND = 2048
SIZE, CROP = 512, 512

# FLOPs of ONE image through the device preprocess + grayscale-folded
# BioViL ResNet-50 forward at 512x512 (XLA's cost analysis of the JAX
# program, 2xMACs; the arithmetic is the device-independent count).
FLOPS_PER_IMAGE = 4.317e10
# Dense bf16 peak of one H100 SXM (data sheet); override for other cards.
PEAK_FLOPS_PER_CHIP = float(os.environ.get("IMML_PEAK_FLOPS", 989e12))
MIN_ROUNDS = 2
MAX_ROUNDS = 12
MAX_FAILURES = 6
TIME_BUDGET_S = 180.0
WARMUP_ATTEMPTS = 5
# Overall deadline: past it the remaining stages are skipped, never the
# report.  One in-flight operation may still overshoot it.
DEADLINE_S = float(os.environ.get("IMML_BENCH_DEADLINE", 540.0))

MODULE = "incremental_multimodal_medical_learning_ii_torch.bench"
REPO_ROOT = Path(__file__).resolve().parent.parent  # the child's cwd: the package imports from it
METRIC = "chexpert_extraction_images_per_sec_per_chip"


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _text(stream) -> str:
    if stream is None:
        return ""
    return stream if isinstance(stream, str) else stream.decode(errors="replace")


def _last_line(text: str) -> str:
    lines = [ln.strip() for ln in text.strip().splitlines() if ln.strip()]
    return lines[-1] if lines else ""


def _supervise() -> int:
    """Run the measurement in a child; ALWAYS print one JSON line.

    The child gets DEADLINE_S for its own graceful skipping; the parent
    grants +120s of grace for one overshooting in-flight op, then kills it
    and reports a value-0 line with link attribution."""
    env = dict(os.environ, IMML_BENCH_CHILD="1")
    hard = DEADLINE_S + 120.0
    out, err, reason = None, "", None
    try:
        res = subprocess.run(
            [sys.executable, "-m", MODULE], env=env, cwd=str(REPO_ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=hard, text=True,
        )
        out, err = res.stdout, _text(res.stderr)
        if res.returncode != 0:
            reason = f"child exited rc={res.returncode}"
            if _last_line(err):
                reason += f": {_last_line(err)}"
    except subprocess.TimeoutExpired as e:
        out, err = _text(e.stdout), _text(e.stderr)
        reason = f"child killed after {hard:.0f}s (in-flight op never returned)"
    if err:
        sys.stderr.write(err if err.endswith("\n") else err + "\n")
        sys.stderr.flush()
    for line in (out or "").strip().splitlines()[::-1]:
        try:
            parsed = json.loads(line)
        except ValueError:
            continue
        # the child prints a PRELIMINARY wall-only report before the
        # device-side stage and the final enriched one after: forward the
        # LAST real report line.  Require the metric dict shape: a stray
        # JSON-parseable fragment on stdout (a bare number from a library)
        # must not become the benchmark artifact.
        if not (isinstance(parsed, dict) and "metric" in parsed):
            continue
        print(line)
        if reason:
            _log(f"[bench] note: {reason} after reporting")
        return 0
    _log(f"[bench] {reason or 'child produced no report'}; emitting failure line")
    link = None
    try:
        from incremental_multimodal_medical_learning_ii_torch.cli.linkhealth import quick_probe

        link = quick_probe(timeout_s=45.0)
    except Exception as e:  # noqa: BLE001 - attribution must never lose the line
        _log(f"[bench] link probe skipped: {type(e).__name__}: {e}")
    print(json.dumps({
        "metric": METRIC, "value": 0.0, "unit": "images/sec", "vs_baseline": 0.0,
        "failure": reason or "no report", "link": link,
    }))
    return 0


def images(n: int, rng: np.random.Generator):
    """``n`` (image, labels) pairs of CheXpert-small geometry: the JAX
    bench's draws, one ``rng.integers`` call an image."""
    for _ in range(n):
        yield (
            rng.integers(0, 256, size=(IMG_H, IMG_W), dtype=np.uint8),
            np.zeros(5, np.float32),
        )


def mfu(rate):
    """Model FLOPs utilisation of ``rate`` images/s against the card's peak."""
    if not rate:
        return None
    return round(rate * FLOPS_PER_IMAGE / PEAK_FLOPS_PER_CHIP, 4)


def power_limit_w():
    """The card's power limit in watts from ``nvidia-smi``, or None (with a
    note on stderr) where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True,
        )
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
        _log(f"[bench] power limit not read: {type(e).__name__}: {e}")
        return None


def device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def main() -> None:
    import torch

    from incremental_multimodal_medical_learning_ii_torch.engine import extract
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        init_biovil_image_model,
    )
    from incremental_multimodal_medical_learning_ii_torch.utils import device as device_mod

    dev = device_mod.resolve_device(None)  # CUDA, or raise: the headline has no CPU mode
    model = init_biovil_image_model(torch.Generator().manual_seed(0)).to(dev)
    rng = np.random.default_rng(0)

    def run(n):
        stats: dict = {}
        t0 = time.perf_counter()
        ds = extract.extract_embeddings(
            images(n, rng), model, batch_size=BATCH, size=SIZE, crop=CROP,
            dtype=torch.bfloat16, retries=3, stats=stats, device=dev,
        )
        dt = time.perf_counter() - t0
        if len(ds) != n:
            raise RuntimeError(f"extracted {len(ds)} of {n} images")
        return n / dt, stats

    bench_t0 = time.perf_counter()

    def past_deadline(stage: str) -> bool:
        if time.perf_counter() - bench_t0 > DEADLINE_S:
            _log(f"[bench] deadline ({DEADLINE_S:.0f}s) passed; skipping {stage}")
            return True
        return False

    # Warm-up: the first launches, cuDNN's algorithm choice, the pinned pool.
    for attempt in range(WARMUP_ATTEMPTS):
        try:
            run(BATCH)
            break
        except Exception as e:  # noqa: BLE001 - a device error is retried, then reported
            _log(f"[bench] warm-up attempt {attempt + 1} failed: {type(e).__name__}: {e}")
            if attempt == WARMUP_ATTEMPTS - 1:
                _log("[bench] warm-up never succeeded; sampling anyway")
                break
            if past_deadline("remaining warm-up attempts"):
                break
            time.sleep(2.0 * (attempt + 1))

    samples: list = []
    dispatch_ms: list = []
    readback_ms: list = []
    feed_wait_ms: list = []
    retried = 0
    failures = 0
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    start = time.perf_counter()
    # Hard wall: even when MIN_ROUNDS isn't reached, never spin past 2x the
    # budget; report whatever was collected.
    while len(samples) < MIN_ROUNDS or (
        len(samples) < MAX_ROUNDS and time.perf_counter() - start < TIME_BUDGET_S
    ):
        if time.perf_counter() - bench_t0 > DEADLINE_S and samples:
            _log("[bench] deadline passed mid-sampling; reporting collected samples")
            break
        if failures >= MAX_FAILURES or time.perf_counter() - start > 2 * TIME_BUDGET_S:
            _log(f"[bench] giving up after {failures} failures / "
                 f"{time.perf_counter() - start:.0f}s with {len(samples)} sample(s)")
            break
        try:
            rate, stats = run(IMAGES_PER_ROUND)
        except Exception as e:  # noqa: BLE001 - keep sampling through a failed round
            failures += 1
            _log(f"[bench] round failed ({failures}): {type(e).__name__}: {e}")
            time.sleep(2.0 * failures)
            continue
        samples.append(rate)
        n_b = max(stats.get("batches", 1), 1)
        dispatch_ms.append(1e3 * stats.get("dispatch_s", 0.0) / n_b)
        readback_ms.append(1e3 * stats.get("readback_s", 0.0) / n_b)
        feed_wait_ms.append(1e3 * stats.get("feed_wait_s", 0.0) / n_b)
        retried += stats.get("retried_batches", 0)

    best = max(samples) if samples else 0.0
    median = float(np.median(samples)) if samples else 0.0

    base_report = {
        "metric": METRIC,
        "value": round(best, 2),
        "unit": "images/sec",
        "vs_baseline": round(best / TORCH_CPU_BASELINE_IMGS_PER_SEC, 2),
        "batch": BATCH,
        "samples": [round(s, 2) for s in samples],
        "median": round(median, 2),
        "dispatch_ms_per_batch": [round(x, 1) for x in dispatch_ms],
        "readback_ms_per_batch": [round(x, 1) for x in readback_ms],
        # the wait for the prefetch thread's next batch (drawing, pinning)
        "feed_wait_ms_per_batch": [round(x, 1) for x in feed_wait_ms],
        "retried_batches": retried,
        "failed_rounds": failures,
        "flops_per_image": FLOPS_PER_IMAGE,
        # the wall rate includes the host's work; mfu_device is the card's alone
        "mfu_wall": mfu(best),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
        "device": device_name(dev),
        "power_limit_w": power_limit_w(),
    }
    # PRELIMINARY report before the device-side stage and the link probe:
    # if one of them never returns, the parent still forwards the wall
    # samples (it takes the LAST report printed).
    print(json.dumps({**base_report, "preliminary": True}), flush=True)

    # Device-side rate: the same preprocess + encode chained through an
    # accumulator, long minus short (utils/device_bench.py), which cancels
    # the host's part of the wall loop.  At the wall loop's batch and at 256
    # (the JAX repo's historical shape); each soft-fails to None on its own.
    device_rate = device_rate_256 = None
    if os.environ.get("IMML_BENCH_DEVICE", "1") != "0":
        def _try_device(b):
            if past_deadline(f"device-side measurement (batch {b})"):
                return None
            try:
                return _device_side_rate(batch=b, device=dev)
            except Exception as e:  # noqa: BLE001
                _log(f"[bench] device-side (batch {b}) skipped: {type(e).__name__}: {e}")
                return None

        device_rate = _try_device(BATCH)
        device_rate_256 = _try_device(256)

    # Link attribution IN the artifact: the card's round trip and upload
    # rate beside the number (bounded; no compile leg).
    link = None
    if not past_deadline("link probe"):
        try:
            from incremental_multimodal_medical_learning_ii_torch.cli import linkhealth

            link = linkhealth.quick_probe(timeout_s=45.0)
        except Exception as e:  # noqa: BLE001 - attribution must never fail the bench
            _log(f"[bench] link probe skipped: {type(e).__name__}: {e}")

    print(
        json.dumps(
            {
                **base_report,
                "device_images_per_sec_per_chip": (
                    round(device_rate, 1) if device_rate else None
                ),
                "device_batch": BATCH,
                "mfu_device": mfu(device_rate),
                "device_images_per_sec_per_chip_b256": (
                    round(device_rate_256, 1) if device_rate_256 else None
                ),
                "mfu_device_b256": mfu(device_rate_256),
                "link": link,
            }
        ),
        flush=True,
    )


def _device_side_rate(batch: int = 256, device=None) -> float:
    """Chained device-only encode throughput (images/s on one card) through
    the shared loop (``utils/device_bench.py``: the same program as
    bench_all's ``extraction_device_images_per_sec_per_chip``)."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        fold_grayscale_conv1,
        init_biovil_image_model,
    )
    from incremental_multimodal_medical_learning_ii_torch.utils.device_bench import (
        device_encode_rate,
    )

    model = fold_grayscale_conv1(init_biovil_image_model(torch.Generator().manual_seed(0)))
    return device_encode_rate(
        model, batch=batch, img_h=IMG_H, img_w=IMG_W, size=SIZE, crop=CROP,
        channels=1, device=device,
    )


if __name__ == "__main__":
    if os.environ.get("IMML_BENCH_CHILD") == "1":
        main()
    else:
        sys.exit(_supervise())
