#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout, one card
    python3 chip_smoke.py --profile  # also torch.profiler windows (phases 7, 11, 13, 14)

Phases, in order; any failure ends the script with a non-zero exit code
and without the final result line:

1. the card, as ``nvidia-smi --query-gpu=name,power.limit`` reports it;
2. build every hand-written kernel of the serving path from ``csrc/``
   (one ``nvcc`` per source, in parallel); the ``ptxas -v`` report of every
   instantiation (no spills allowed in K3's bf16 kernel nor in K2);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it (fp32 with TF32 off); K2 at both
   serving crops, (3, 40, 24, 64) and ragged tiles ((3, 37, 21, 64), an
   image smaller than a tile), each block alone and the chained layer; K1, K2 and K3 refuse an operand that requires grad under
   grad mode (no backward kernel);
4. small-input check: the fp32 classifier on the card against the same
   classifier on the CPU (plain versions);
5. the serving path at full width: ``ChexpertClassifier`` with seeded
   random BioViL ResNet-50 weights, the synthetic bank of the 5
   competition tasks, 512^2 crops, batch 16, bf16, ``fused_layer1=True``,
   in MEAN then MAX mode, with the kernels' launch counts read around it
   (K2: one launch per bottleneck block, 3 per forward); compared with the
   stock cuDNN forward and the plain scorer;
6. HTTP: ``make_server`` with micro-batching, concurrent requests;
7. times with CUDA events (kernels, plain versions, library calls; K1
   against ``torch.matmul`` and K2 against the cuDNN bf16 chain as medians
   of 5 rounds in turns) and host-clock serving latency;
8. the flash-attention kernel against its plain version on the card:
   BERT-base report length (32, 12, 512, 64) with ragged lengths, hd 128,
   S = 77 and 200 with padding, a row with one valid token, lengths on
   every edge of a 64-row block, a batch with every row full, and queries
   whose segment no key shares (different q and kv ids), in fp32 (TF32
   off) and bf16; the bf16 kernel with key-tile skipping equals itself
   without (kv ids cloned) bit for bit, and the key tiles it computed,
   counted on the card, are the ones its predicate keeps;
9. the CXR-BERT text tower at full width (BERT-base, seeded random
   weights) and report length (batch 32, seq 512, ragged masks):
   ``get_projected_text_embeddings(use_flash_attention=True)`` against the
   dense path, in bf16 and fp32, with the flash kernel's launches read
   around it (12 per encode);
10. the prompt bank from weights in the reference's formats, through the
   classify CLI on the card: a BERT-base state dict (``torch.save``) +
   vocab, and an HF snapshot directory; both banks agree and match the CPU
   build; one batch served with the bank;
11. times: the flash kernel (CUDA events, in turns with SDPA as the
   library yardstick and with skipping off; the plain version) in bf16 at
   report length and hd 128 and in fp32, text encodes in prompts/s (flash
   and dense at report length, dense at the bank's shape) and the bank
   build;
12. the paper's experiment at the reference's scale (191,027 / 16,027 /
   2,048 rows of synthetic 128-d embeddings, bs 6144, eval bs 1024, MLP
   double adapter, Adam lr 1e-4, 10 epochs, the synthetic bank): K1 against
   its plain version at the eval shapes (1024x10, 1024x(5 P_max)) and
   timed; then the drivers' CLIs on the card, with their fused loops under
   ``torch.cuda.set_sync_debug_mode("error")`` (no call may synchronise
   between upload and readback): joint, data-incremental over 20 parts with
   myCL and threshold scheduling (per unit, then ``--fused-unit``, then
   both again in turns) and class-incremental MORE_LABELS in MAX mode; K1's
   launches in each run must equal what its eval passes imply; the same
   runs on the CPU must agree with the card's (losses 1e-5, AUROC 1e-3,
   myCL reset counts within 0.5% of the weights on 99% of the steps, and
   on every step of one step from the same state);
13. embedding extraction at the extraction CLI's defaults (batch 128, 512^2,
   bf16, grayscale conv1, the shared-size path, readback window 4):
   ``--synthetic 4096`` through the CLI's ``main`` with each batch's upload
   and forward under ``torch.cuda.set_sync_debug_mode("error")`` (images/s,
   stats, shards), then a cut run of 2048 resumed to 4096, bit for bit the
   clean run; mixed CheXpert shapes through the indexed path against one
   image at a time; 8 images in fp32 (TF32 off), the card against its own
   CPU, and bf16 against fp32; the int8 trunk (the int32 sums of three convs
   equal the CPU's exact path, its embedding against bf16, images/s); the
   device encode alone with layer1 through K2 against cuDNN, in turns, and
   K2 against its plain version at (128, 128, 128, 64); ``reproduce
   --rehearsal`` with each gate's wall time, and ``--dry-run`` on the card
   against the CPU; the classify CLI serving ``--adapter-checkpoint`` from
   a short training run, the card against the CPU;
14. phrase grounding at full width through ``cli/ground.py`` (a
   reference-format BioViL ResNet-50 checkpoint of seeded random weights,
   the BERT-base snapshot directory, a 390x320 PNG at resize 512 / crop
   480: a 15 x 15 patch grid), the query's wall time (p50 of 5) split into
   host load and preprocess, image forward, text encode, smoothing and
   resize; fp32 (TF32 off) the card against its own CPU (embeddings and
   map 2e-4, score 1e-4), bf16 against fp32 (patch cos > 0.999); K1, K2
   and K3 launch no time on the grounding path; at 512^2 in fp32 dilated
   ResNet-50 (False, False, True) and ResNet-18 the card against its CPU,
   the space-to-depth stem against the standard stem (2e-4 of the largest
   feature), int8 sums of dilated convs equal to the CPU's; the two stems
   timed in turns at (128, 512, 512, 1) bf16; the native store at the
   reference's scale (191,027 x 128, 5 labels): write, open, a shuffled
   epoch at batch 6144 against the numpy batcher, and a joint run (bs 6144,
   eval bs 1024, 2 epochs, unshuffled, per-batch steps) over the store bit
   for bit the run over the in-memory dataset, K1 launched once an eval
   batch, the C++ batcher serving.

It prints the kernels' JSON line, the card line, and as its last line
``{"ok": true, "device": {...}}``.  A copy of the results goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import http.client
import io
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PACKAGE = "incremental_multimodal_medical_learning_ii_torch"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor cores

COSINE_ATOL = 1e-5
FLASH_F32_ATOL = 1e-5  # fp32 online softmax vs one-pass softmax, TF32 off
FLASH_BF16_ATOL = 2e-2  # bf16 kernel vs the plain version in fp32 from the same bf16 inputs
FLASH_BF16_COS = 0.9999
TEXT_BF16_COS = 0.999  # flash vs dense encode, per batch row (valid positions) and projection
TEXT_F32_ATOL = 1e-4  # flash vs dense projected embeddings, fp32
BANK_ATOL = 3e-5  # the BERT parity tolerance: the card's bank vs the CPU build
LAYER_SHAPES = [(16, 128, 128, 64), (2, 120, 120, 64)]  # 512^2 batch 16; the 480 crop
# + a small crop, and K2's ragged 8 x 8 tiles: on both axes, and an image smaller than a tile
LAYER_CHECK_SHAPES = LAYER_SHAPES + [(3, 40, 24, 64), (3, 37, 21, 64), (1, 5, 7, 64)]
K2_KERNEL = "bottleneck_block_kernel"
LAYER_REL = 0.02  # one block, kernel vs plain from the same input
LAYER_CHAIN_REL = 0.06  # the three chained blocks (see kernel_checks)
LAYER_COS = 0.9999
EMB_COS = 0.999
NEAR_TIE = 0.01  # |pos - neg| below this may flip between two bf16 forwards


def ptxas_report(cuda_build) -> dict:
    """Registers, spills and shared memory of every kernel instantiation,
    from the ``ptxas -v`` report kept beside each built library."""
    import re

    out, entry = {}, None
    for name in cuda_build.SOURCES:
        for line in cuda_build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
                out[entry] = {}
            elif entry and "spill stores" in line:
                nums = [int(n) for n in re.findall(r"(\d+) bytes (?:spill stores|spill loads)", line)]
                out[entry].update(spill_stores=nums[0], spill_loads=nums[1])
            elif entry and "Used" in line and "registers" in line:
                out[entry]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                out[entry]["static_smem"] = int(smem.group(1)) if smem else 0
    return out


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternating_ms(fns: dict, rounds: int = 5, iters: int = 100) -> dict:
    """Median CUDA-event time of each function over ``rounds`` rounds, in
    turns: the order is reversed every other round (a, b, b, a, ...), so a
    drift of the card's clock falls on every candidate alike."""
    import statistics

    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(cuda_time_ms(fns[name], iters))
    return {name: statistics.median(ts) for name, ts in times.items()}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def raises(fn, exc=RuntimeError) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


# ----------------------------------------------------------------------
# kernels vs plain versions
# ----------------------------------------------------------------------
def cosine_bound_ms(b: int, t: int, d: int = 128):
    bytes_ = 4 * (b * d + t * d + b * t)
    flops = 2 * b * t * d + 3 * (b + t) * d
    tb, tf = bytes_ / HBM_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def layer_macs_per_pixel(folded) -> int:
    macs = 0
    for bi in range(len(folded["w1"])):
        cin, cm = folded["w1"][bi].shape
        macs += cin * cm + 9 * cm * cm + folded["w3"][bi].shape[0] * folded["w3"][bi].shape[1]
        if bi == 0 and folded["wd"]:
            macs += folded["wd"][0].shape[0] * folded["wd"][0].shape[1]
    return macs


def layer_bound_ms(x_shape, folded):
    b, h, w, cin = x_shape
    cout = folded["w3"][0].shape[1]
    weights = sum(t.numel() * t.element_size() for ts in folded.values() for t in ts)
    bytes_ = b * h * w * (cin + cout) * 2 + weights
    flops = 2 * layer_macs_per_pixel(folded) * b * h * w
    tb, tf = bytes_ / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations"), flops


def cudnn_layer(folded):
    """The library yardstick for layer1: the same folded block chain as
    cuDNN bf16 convolutions (channels_last), bias and ReLU between them."""
    import torch
    import torch.nn.functional as F

    blocks = []
    for bi in range(len(folded["w1"])):
        cin, cm = folded["w1"][bi].shape
        cout = folded["w3"][bi].shape[1]

        def conv_w(t, shape):
            return t.reshape(shape).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)

        w1 = conv_w(folded["w1"][bi].t(), (cm, cin, 1, 1))
        w2 = folded["w2"][bi].reshape(3, 3, cm, cm).permute(3, 2, 1, 0)  # (out, in, dy, dx)
        w2 = w2.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        w3 = conv_w(folded["w3"][bi].t(), (cout, cm, 1, 1))
        wd = conv_w(folded["wd"][0].t(), (cout, cin, 1, 1)) if bi == 0 and folded["wd"] else None
        bias = [folded[k][bi].reshape(-1).to(torch.bfloat16) for k in ("b1", "b2", "b3")]
        blocks.append((w1, w2, w3, wd, bias))

    def run(x_nhwc):
        t = x_nhwc.permute(0, 3, 1, 2)
        for w1, w2, w3, wd, (b1, b2, b3) in blocks:
            a = torch.relu(F.conv2d(t, w1, b1))
            a = torch.relu(F.conv2d(a, w2, b2, padding=1))
            out = F.conv2d(a, w3, b3)
            ident = F.conv2d(t, wd) if wd is not None else t
            t = torch.relu(out + ident)
        return t.permute(0, 2, 3, 1)

    return run


def kernel_checks(model, bank, results):
    import torch

    from incremental_multimodal_medical_learning_ii_torch.objectives.scorer import PromptBank
    from incremental_multimodal_medical_learning_ii_torch.ops.cosine import masked_mean
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_bottleneck import (
        Folded,
        fold_bottleneck_layer,
        fused_bottleneck_layer,
        fused_bottleneck_layer_reference,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
        fused_pairwise_cosine,
        pairwise_cosine,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bank = PromptBank(*(t.to(dev) for t in bank))
    c, p, d = bank.pos.shape
    mean_bank = torch.cat([masked_mean(bank.pos, bank.pos_count), masked_mean(bank.neg, bank.neg_count)])
    max_bank = bank.pos.reshape(c * p, d)

    # --- K1: fused cosine -------------------------------------------
    cases = {
        "serve-mean (16x10)": (torch.randn(16, d, device=dev, generator=g), mean_bank),
        "serve-max (16x%d)" % (c * p): (torch.randn(16, d, device=dev, generator=g), max_bank),
        "batch (6144x10)": (torch.randn(6144, d, device=dev, generator=g), mean_bank),
        "unaligned (37x23, zero rows)": (torch.randn(37, d, device=dev, generator=g),
                                         torch.randn(23, d, device=dev, generator=g)),
        "full bank (1000x128)": (torch.randn(1000, d, device=dev, generator=g),
                                 torch.randn(128, d, device=dev, generator=g)),
        "chunked bank (16x300)": (torch.randn(16, d, device=dev, generator=g),
                                  torch.randn(300, d, device=dev, generator=g)),
    }
    x, t = cases["unaligned (37x23, zero rows)"]
    x[5] = 0.0
    t[22] = 0.0
    cos_err = {}
    # no backward kernel: an operand that requires grad is refused under
    # grad mode (on every device for K1, as jax.grad through the Pallas
    # kernel fails), never scored into a result cut from autograd
    from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import flash_attention

    xg = torch.randn(16, d, device=dev, generator=g).requires_grad_(True)
    check(raises(lambda: fused_pairwise_cosine(xg, mean_bank)), "K1 took an operand that requires grad")
    check(raises(lambda: fused_pairwise_cosine(mean_bank, xg)), "K1 took a bank that requires grad")
    qg = torch.randn(1, 2, 64, 64, device=dev, generator=g).requires_grad_(True)
    ones = torch.ones(1, 64, dtype=torch.int32, device=dev)
    check(raises(lambda: flash_attention(qg, qg.detach(), qg.detach(), ones, ones)),
          "K3 took a q that requires grad")
    with torch.no_grad():
        check(fused_pairwise_cosine(xg, mean_bank).shape == (16, 10), "K1 under no_grad")
        check(flash_attention(qg, qg, qg, ones, ones).shape == qg.shape, "K3 under no_grad")
    log("  K1 and K3 refuse an operand that requires grad under grad mode; both run under no_grad")
    for name, (x, t) in cases.items():
        got = fused_pairwise_cosine(x, t)
        ref = pairwise_cosine(x, t)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        cos_err[name] = err
        log(f"  K1 fused_cosine {name}: max|kernel - plain| = {err:.3e}")
        check(err <= COSINE_ATOL, f"fused cosine {name} off by {err}")
        check(bool(torch.isfinite(got).all()), f"fused cosine {name} not finite")
    check(fused_pairwise_cosine(torch.zeros(0, d, device=dev), mean_bank).shape == (0, 10), "B=0")
    results["cosine_check"] = cos_err

    # --- K2: fused layer1 --------------------------------------------
    # Each block alone, from the same bf16 input, is held to LAYER_REL.
    # Across the chained blocks a one-ulp rounding flip of the bf16
    # residual stream (0.0625 at magnitude 8-16) can land on an output
    # near 1.6 after the next block's residual sum; the plain version
    # against itself with fp64 sums ("order floor" below) shows the same.
    # So the whole layer is held to the JAX kernel test's bar
    # (tests/test_pallas_bottleneck.py: rel < 0.06, cos > 0.9999).
    folded = Folded({k: [t.to(dev) for t in v]
                     for k, v in fold_bottleneck_layer(model.encoder.layer1).items()})
    # no backward kernel: an input or weight that requires grad is refused
    # under grad mode (as jax.grad through the Pallas kernel fails)
    xg = torch.randn(1, 8, 16, 64, device=dev, generator=g).to(torch.bfloat16).requires_grad_(True)
    check(raises(lambda: fused_bottleneck_layer(xg, folded)), "K2 took an input that requires grad")
    wg = Folded({k: [t.detach().clone().requires_grad_(k == "w2") for t in v] for k, v in folded.items()})
    check(raises(lambda: fused_bottleneck_layer(xg.detach(), wg)), "K2 took a weight that requires grad")
    with torch.no_grad():
        check(fused_bottleneck_layer(xg, wg).shape == (1, 8, 16, 256), "K2 under no_grad")
    log("  K2 refuses an input or a weight that requires grad under grad mode; runs under no_grad")
    layer_err = {}
    for shape in LAYER_CHECK_SHAPES:
        x = torch.randn(*shape, device=dev, generator=g).abs().to(torch.bfloat16)
        got = fused_bottleneck_layer(x, folded)
        ref = fused_bottleneck_layer_reference(x, folded)
        floor = layer_metrics(ref, fused_bottleneck_layer_reference(x, folded, torch.float64))
        m = layer_metrics(got, ref)
        block_rel, t = [], x
        for bi in range(len(folded["w1"])):
            one = Folded({k: v[bi:bi + 1] if k != "wd" else (v if bi == 0 else [])
                          for k, v in folded.items()})
            block_rel.append(layer_metrics(fused_bottleneck_layer(t, one),
                                           fused_bottleneck_layer_reference(t, one))["rel"])
            t = fused_bottleneck_layer_reference(t, one)
        m.update(block_rel=block_rel, order_floor_rel=floor["rel"],
                 order_floor_elems_over_1ulp=floor["elems_over_1ulp"])
        layer_err[str(shape)] = m
        log(f"  K2 fused_bottleneck {shape}: max abs err {m['max_abs_err']:.4g}, "
            f"rel {m['rel']:.3e} (order floor {floor['rel']:.3e}), per block "
            f"{', '.join(f'{r:.3e}' for r in block_rel)}, cos {m['cos']:.7f}, "
            f"{m['elems_over_1ulp']} of {got.numel()} elements > 1 bf16 ulp "
            f"(order floor {floor['elems_over_1ulp']}), {m['bit_equal_share']:.4f} bit-equal")
        check(max(block_rel) < LAYER_REL, f"fused layer1 {shape}: per-block rel {block_rel}")
        check(m["rel"] < LAYER_CHAIN_REL, f"fused layer1 {shape}: rel {m['rel']}")
        check(m["cos"] > LAYER_COS, f"fused layer1 {shape}: cos {m['cos']}")
        check(bool(torch.isfinite(got).all()), f"fused layer1 {shape} not finite")
    results["layer_check"] = layer_err
    return folded, cases


def layer_metrics(got, ref) -> dict:
    """bf16 layer outputs compared: max |got - ref| / max(|ref|, 1) per
    element, cosine, and how many elements differ by more than one bf16
    ulp of max(|ref|, 1)."""
    import torch

    got, ref = got.float(), ref.float()
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    mag = ref.abs().clamp(min=1.0)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return dict(max_abs_err=float(diff.max()), rel=float((diff / mag).max()),
                cos=float((got * ref).sum() / (got.norm() * ref.norm())),
                elems_over_1ulp=int((diff > ulp).sum()),
                bit_equal_share=float((got == ref).float().mean()))


def profiled_device_ms(fn, wrapper, kernel: str, event_ms: float, bound_ms: float,
                       iters: int = 50, tries: int = 3):
    """Device time of one call's kernels named ``kernel``, from the
    profiler's CUDA rows (CUDA events over back-to-back calls measure the
    host's launch rate when a kernel runs for microseconds).

    The time per call is the mean over the ``kernel`` rows the profiler
    recorded, times the launches ``wrapper`` counted per call (the profiler
    may drop a row of a window).  A reading is kept only if it can be true:
    at least 90% of the launches have a row, and the time per call lies
    between the card's bound for the work and the same run's event time
    (10% over it allowed for the clock).  Otherwise it is taken again, up
    to ``tries`` times; None if no reading passes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        before = wrapper.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        launched = wrapper.launches - before
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and kernel in e.key]
        recorded = sum(e.count for e in rows)
        ms = (sum(e.self_device_time_total for e in rows) / max(recorded, 1) * launched / iters
              / 1e3)
        if launched > 0 and recorded >= 0.9 * launched and bound_ms <= ms <= 1.1 * event_ms:
            return ms
        log(f"    profiler reading of {kernel} rejected (try {attempt + 1}): {recorded} rows for "
            f"{launched} launches, {ms:.5f} ms a call against bound {bound_ms:.5f} and event "
            f"time {event_ms:.5f} ms")
    return None


def time_kernels(folded, cases, results):
    import torch

    from incremental_multimodal_medical_learning_ii_torch.ops.cosine import l2_normalize
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_bottleneck import (
        fused_bottleneck_layer,
        fused_bottleneck_layer_reference,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
        fused_pairwise_cosine,
        pairwise_cosine,
    )

    cos_times = {}
    for name in ("serve-mean (16x10)", [k for k in cases if k.startswith("serve-max")][0],
                 "batch (6144x10)"):
        x, t = cases[name]
        xn, tn = l2_normalize(x), l2_normalize(t)
        bound, by = cosine_bound_ms(x.shape[0], t.shape[0])
        # event times: medians of 5 rounds in turns (kernel, library)
        med = alternating_ms({"ms": lambda: fused_pairwise_cosine(x, t),
                              "library_ms": lambda: torch.matmul(xn, tn.T)}, iters=200)
        cos_times[name] = dict(
            **med, plain_ms=cuda_time_ms(lambda: pairwise_cosine(x, t), 200),
            bound_ms=bound, bound_by=by,
            kernel_device_ms=profiled_device_ms(lambda: fused_pairwise_cosine(x, t),
                                                fused_pairwise_cosine, "fused_cosine_kernel",
                                                med["ms"], bound),
        )
        log(f"  K1 {name}: {json.dumps(cos_times[name])}")
    results["cosine_times"] = cos_times

    layer_times = {}
    lib = cudnn_layer(folded)
    g = torch.Generator(device="cuda").manual_seed(1)
    for shape in LAYER_SHAPES:
        x = torch.randn(*shape, device="cuda", generator=g).abs().to(torch.bfloat16)
        lib_out, ref = lib(x).float(), fused_bottleneck_layer_reference(x, folded).float()
        lib_cos = float((lib_out * ref).sum() / (lib_out.norm() * ref.norm()))
        check(lib_cos > EMB_COS, f"cuDNN yardstick disagrees with the plain layer: cos {lib_cos}")
        bound, by, flops = layer_bound_ms(shape, folded)
        with torch.no_grad():
            # event times: medians of 5 rounds in turns (kernel, cuDNN chain)
            med = alternating_ms({"ms": lambda: fused_bottleneck_layer(x, folded),
                                  "library_ms": lambda: lib(x)}, iters=20)
            layer_times[str(shape)] = dict(
                **med, plain_ms=cuda_time_ms(lambda: fused_bottleneck_layer_reference(x, folded), 5),
                bound_ms=bound, bound_by=by, tflops=flops / med["ms"] / 1e9,
                library_cos_vs_plain=lib_cos,
                kernel_device_ms=profiled_device_ms(lambda: fused_bottleneck_layer(x, folded),
                                                    fused_bottleneck_layer, K2_KERNEL, med["ms"],
                                                    bound),
            )
        log(f"  K2 {shape}: {json.dumps(layer_times[str(shape)])}")
    results["layer_times"] = layer_times


# ----------------------------------------------------------------------
# the serving path
# ----------------------------------------------------------------------
def synthetic_cxrs(n: int, seed: int):
    """CheXpert-like uint8 radiographs in the dataset's common geometries:
    smooth anatomy-like structure plus noise, so the resize sees real
    gradients."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shapes = [(390, 320), (320, 390), (1024, 848), (848, 1024), (512, 512), (390, 320)]
    out = []
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        yy, xx = np.mgrid[0:h, 0:w]
        img = 110 + 60 * np.sin(xx / (23 + i % 7)) * np.cos(yy / (31 + i % 5))
        img += rng.normal(0, 20, size=(h, w))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def small_parity(model, bank):
    """fp32 classifier on the card vs the same on the CPU (plain versions)."""
    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.inference import ChexpertClassifier

    imgs = synthetic_cxrs(5, seed=3)
    imgs = [im[::8, ::8].copy() for im in imgs]  # small: 40x49 .. 128x106
    kw = dict(batch_size=2, size=64, pad_to=128, dtype=torch.float32)
    gpu = ChexpertClassifier(model, bank, device="cuda", **kw).predict_arrays(imgs)
    cpu = ChexpertClassifier(model, bank, device="cpu", **kw).predict_arrays(imgs)
    err = float(np.abs(gpu[0] - cpu[0]).max())
    log(f"  fp32 size-64 classifier, card vs CPU: max |score diff| = {err:.3e}")
    check(gpu[0].shape == (5, 5) and np.isfinite(gpu[0]).all(), "small classifier output")
    check(err < 1e-4, f"card vs CPU scores differ by {err}")
    return err


def serving(model, bank, results):
    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.inference import ChexpertClassifier
    from incremental_multimodal_medical_learning_ii_torch.objectives.scorer import score_embeddings
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_bottleneck import (
        fused_bottleneck_layer,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
        fused_pairwise_cosine,
    )
    from incremental_multimodal_medical_learning_ii_torch.utils.config import ExperimentConfig

    images = synthetic_cxrs(48, seed=0)
    kw = dict(batch_size=16, size=512, pad_to=1024, dtype=torch.bfloat16)
    clfs = {
        mode: ChexpertClassifier(model, bank, cfg=ExperimentConfig(
            adapter="no-head", image_adapter=False, text_adapter=False, prompt_mode=mode),
            fused_layer1=True, device="cuda", **kw)
        for mode in ("mean", "max")
    }
    plain = ChexpertClassifier(model, bank, fused_layer1=False, device="cuda", **kw)
    for clf in (*clfs.values(), plain):  # warm-up: kernel load, cuDNN algorithm choice
        clf.predict_arrays(images[:1])
    torch.cuda.synchronize()

    # the main path, with the kernels' launch counts around it
    fused_pairwise_cosine.launches = 0
    fused_bottleneck_layer.launches = 0
    torch.cuda.reset_peak_memory_stats()
    outs = {}
    t0 = time.perf_counter()
    for mode, clf in clfs.items():
        outs[mode] = (clf.predict_arrays(images), clf.predict_arrays(images[-1:]))
    wall = time.perf_counter() - t0
    launches = {"fused_cosine": fused_pairwise_cosine.launches,
                "fused_bottleneck": fused_bottleneck_layer.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    # one image forward per batch of 16 (the lone image is a batch of its own)
    forwards = len(clfs) * (-(-len(images) // kw["batch_size"]) + 1)
    log(f"  main path: 2 modes x (48 + 1 lone) images in {wall:.3f} s; launches {launches} "
        f"over {forwards} forwards; peak device memory {peak:.2f} GiB")
    check(launches["fused_cosine"] > 0, "the serving path never launched the fused cosine kernel")
    check(launches["fused_bottleneck"] == 3 * forwards,
          f"K2 launched {launches['fused_bottleneck']} times, not 3 per forward ({forwards})")
    results["launches"] = launches
    results["peak_memory_gib"] = peak

    ref_embs = plain.embed_arrays(images)
    ref_embs_t = torch.from_numpy(ref_embs).cuda()
    agree = {}
    for mode, clf in clfs.items():
        (scores, preds), (lone_s, lone_p) = outs[mode]
        check(scores.shape == preds.shape == (48, 5), f"{mode}: shapes {scores.shape}")
        check(bool(np.isfinite(scores).all()) and bool(((scores >= 0) & (scores <= 1)).all()),
              f"{mode}: scores not finite in [0, 1]")
        embs = clf.embed_arrays(images)
        cos = np.sum(embs * ref_embs, 1) / (np.linalg.norm(embs, axis=1) * np.linalg.norm(ref_embs, axis=1))
        ref = score_embeddings(ref_embs_t, clf.bank, clf.cfg.prompt_mode, True, False, use_kernel=False)
        margin = (ref.pos_sim - ref.neg_sim).abs().cpu().numpy()
        ref_preds = ref.preds.cpu().numpy()
        sure = margin > NEAR_TIE
        flips = int((preds != ref_preds)[sure].sum())
        lone_err = float(np.abs(lone_s[0] - scores[-1]).max())
        agree[mode] = dict(min_emb_cos=float(cos.min()), pred_flips_outside_ties=flips,
                           near_ties=int((~sure).sum()), lone_vs_batched_score=lone_err,
                           max_score_diff=float(np.abs(scores - ref.scores.cpu().numpy()).max()))
        log(f"  {mode}: {json.dumps(agree[mode])}")
        check(cos.min() > EMB_COS, f"{mode}: embedding cos {cos.min()} vs the cuDNN forward")
        check(flips == 0, f"{mode}: {flips} predictions differ outside near-ties")
        check(lone_err < 1e-3, f"{mode}: a lone image scores {lone_err} off its batched self")
    results["serving_check"] = agree
    return clfs, plain, images


def http_phase(clf, images):
    import numpy as np
    from PIL import Image

    from incremental_multimodal_medical_learning_ii_torch.cli.serve import make_server

    def png(im):
        buf = io.BytesIO()
        Image.fromarray(im, "L").save(buf, "PNG")
        return buf.getvalue()

    srv = make_server(clf, "127.0.0.1", 0, microbatch_s=0.005)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        port = srv.server_address[1]

        def request(method, path, body=None, ctype=None):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            conn.request(method, path, body=body, headers={"Content-Type": ctype} if ctype else {})
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            conn.close()
            return resp.status, payload

        status, health = request("GET", "/healthz")
        check(status == 200 and health["platform"] == "cuda", f"healthz: {status} {health}")
        bodies = [png(im) for im in images[:3]]
        batch = json.dumps({"images_b64": [base64.b64encode(png(im)).decode() for im in images[3:5]]})
        out = {}

        def worker(i):
            if i < 3:
                out[i] = request("POST", "/classify", bodies[i], "image/png")
            else:
                out[i] = request("POST", "/classify", batch, "application/json")

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            check(not t.is_alive(), "an HTTP request hung")
        direct, _ = clf.predict_arrays(images[:5])
        for i in range(4):
            status, payload = out[i]
            n = 1 if i < 3 else 2
            check(status == 200, f"request {i}: {status} {payload}")
            got = np.asarray(payload["scores"], np.float32)
            check(got.shape == (n, 5), f"request {i}: shape {got.shape}")
            want = direct[i : i + 1] if i < 3 else direct[3:5]
            check(float(np.abs(got - want).max()) < 1e-3, f"request {i}: scores differ")
        log(f"  HTTP: healthz {health['device']}; 4 concurrent /classify requests answered "
            f"in {srv.microbatcher.dispatches} device dispatches")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


def serving_times(clfs, plain, images, results):
    import statistics

    import torch

    times = {}
    for name, clf in (("fused-mean", clfs["mean"]), ("fused-max", clfs["max"]), ("cudnn-mean", plain)):
        lat = []
        for _ in range(5):
            t0 = time.perf_counter()
            clf.predict_arrays(images[:16])
            lat.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        clf.predict_arrays(images)
        ips = len(images) / (time.perf_counter() - t0)
        # one batch of 16 split into host prepare, upload and device forward
        t0 = time.perf_counter()
        host = clf.plan.prepare_deduped(images[:16])
        prepare_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = [torch.from_numpy(a).to(clf.device) for a in host]
        torch.cuda.synchronize()
        upload_ms = (time.perf_counter() - t0) * 1e3
        times[name] = dict(batch16_ms_median=statistics.median(lat), batch16_ms=lat,
                           images_per_s=ips, prepare_ms=prepare_ms, upload_ms=upload_ms,
                           upload_mb=sum(a.nbytes for a in host) / 1e6,
                           forward_ms=cuda_time_ms(lambda: clf._fn(*dev), 5, warmup=1))
        log(f"  serving {name}: {json.dumps(times[name])}")
    results["serving_times"] = times
    torch.cuda.synchronize()


def profile_window(name, fn, results):
    """One call of ``fn`` (after a warm-up call) under the profiler: wall
    time, device busy time and the top device rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        # device-side rows only (kernels, copies): the aten:: rows repeat
        # their kernels' time; the profiler's own buffer requests are not work
        if e.device_type != DeviceType.CUDA or e.key.startswith("Activity Buffer"):
            continue
        if e.self_device_time_total > 0:
            rows.append((e.self_device_time_total, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"  profile: {name}, wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}%)")
    for dev_us, key, count in rows[:15]:
        log(f"    {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")
    results.setdefault("profile", {})[name] = dict(
        wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
        top=[dict(ms=r[0] / 1e3, kernel=r[1], calls=r[2]) for r in rows[:25]])


def profile_text(model, ids, mask, results):
    import torch

    from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import (
        get_projected_text_embeddings,
    )

    for name, flash in (("one (32, 512) bf16 encode, flash", True),
                        ("one (32, 512) bf16 encode, dense", False)):
        with torch.no_grad():
            profile_window(name, lambda: get_projected_text_embeddings(
                model, ids, mask, dtype=torch.bfloat16, use_flash_attention=flash), results)


# ----------------------------------------------------------------------
# kernel 3 (flash attention) and the CXR-BERT text tower
# ----------------------------------------------------------------------
REPORT = (32, 12, 512, 64)  # BERT-base at report length: (B, nh, S, hd)


def ragged_lengths(n: int, seq: int, seed: int):
    """Seeded valid lengths from 64 to ``seq``; the last row is full."""
    import numpy as np

    lengths = np.random.default_rng(seed).integers(64, seq + 1, size=n)
    lengths[-1] = seq
    return lengths


def segment_ids(lengths, seq: int):
    import torch

    return (torch.arange(seq, device="cuda")[None, :]
            < torch.as_tensor(lengths, device="cuda")[:, None]).to(torch.int32)


def flash_bound_ms(q, seg):
    """Bytes: q, k, v read once, o written once, the segment ids.
    Operations: 4*hd for every (query, key) pair of one segment, per head;
    the pairs this run's masks need (a key of another segment adds
    nothing)."""
    import torch

    b, nh, s, hd = q.shape
    bytes_ = 4 * b * nh * s * hd * q.element_size() + 2 * seg.numel() * 4
    pairs = int((seg[:, :, None] == seg[:, None, :]).sum())
    flops = 4 * nh * hd * pairs
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    tb, tf = bytes_ / HBM_BYTES_PER_S, flops / peak
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations"), flops, 4 * b * nh * s * s * hd


def computed_tiles(q, k, v, seg_q, seg_kv, scale) -> int:
    """The (64-query block, 64-key tile) pairs that one bf16 launch
    computed, summed over heads, as the kernel counts them on the card."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import (
        flash_attention,
    )

    count = torch.zeros(1, dtype=torch.int32, device=q.device)
    flash_attention(q, k, v, seg_q, seg_kv, scale, computed_tiles=count)
    return int(count.item())


def tile_counts(q, k, v, seg, scale) -> dict:
    """Key tiles of one bf16 call with self segment ids, counted on the
    card, against the predicate's count (``key_tiles_needed``, per head)
    and the pairs there are; the kernel with kv ids that are a copy (no
    skipping) must compute every pair."""
    from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import (
        key_tiles_needed,
    )

    nh = q.shape[1]
    needed = key_tiles_needed(seg, seg, self_segments=True)
    total, predicted = nh * needed.numel(), nh * int(needed.sum())
    done = computed_tiles(q, k, v, seg, seg, scale)
    done_no_skip = computed_tiles(q, k, v, seg, seg.clone(), scale)
    check(done == predicted, f"the kernel computed {done} key tiles, its predicate keeps {predicted}")
    check(done_no_skip == total, f"without skipping the kernel computed {done_no_skip} of {total}")
    return dict(tiles=total, computed=done, computed_without_skipping=done_no_skip,
                skipped_tile_share=1.0 - done / total)


def flash_inputs(shape, lengths, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(*shape, device="cuda", generator=g).to(dtype) for _ in range(3))
    return q, k, v, segment_ids(lengths, shape[2]), 1.0 / float(shape[3]) ** 0.5


def flash_checks(results):
    """Kernel 3 against its plain version (fp32 from the same inputs)."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import (
        flash_attention,
        mha_reference,
    )

    cases = [("report (32,12,512,64)", REPORT, ragged_lengths(REPORT[0], REPORT[2], seed=1)),
             ("hd128 (4,4,256,128)", (4, 4, 256, 128), [256, 200, 130, 17]),
             ("S=77 (2,12,77,64)", (2, 12, 77, 64), [77, 40]),
             ("S=200 (3,12,200,64), a one-token row", (3, 12, 200, 64), [200, 1, 123]),
             ("block edges (6,12,512,64)", (6, 12, 512, 64), [1, 63, 64, 65, 300, 512]),
             ("all rows full (4,12,512,64)", (4, 12, 512, 64), [512] * 4),
             ("lonely queries (2,12,200,64)", (2, 12, 200, 64), [200, 150])]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, shape, lengths) in enumerate(cases):
            q, k, v, seg, scale = flash_inputs(shape, lengths, dtype, seed=10 + i)
            seg_kv = seg
            if name.startswith("lonely"):  # kv ids no query shares: each averages every key
                seg_kv = seg.clone()
                seg_kv[1] = 7
            got = flash_attention(q, k, v, seg, seg_kv, scale).float()
            ref = mha_reference(q.float(), k.float(), v.float(), seg, seg_kv, scale)
            torch.cuda.synchronize()
            key = f"{name} {str(dtype).split('.')[-1]}"
            err = float((got - ref).abs().max())
            cos = float((got * ref).sum() / (got.norm() * ref.norm()))
            out[key] = dict(max_abs_err=err, cos=cos)
            bar = FLASH_F32_ATOL if dtype == torch.float32 else FLASH_BF16_ATOL
            log(f"  K3 flash_attention {key}: max|kernel - plain| = {err:.3e} (bar {bar:g}), "
                f"cos {cos:.8f}" + (f" (bar {FLASH_BF16_COS})" if dtype == torch.bfloat16 else ""))
            check(bool(torch.isfinite(got).all()), f"flash {key} not finite")
            check(err <= bar, f"flash {key} off by {err}")
            check(dtype == torch.float32 or cos > FLASH_BF16_COS, f"flash {key}: cos {cos}")
    results["flash_check"] = out

    # Skipping is exact: at report length the bf16 kernel with skipping
    # (q and kv share one id array) equals itself without (a clone as kv)
    # bit for bit, in every case above with self segments; and it skipped
    # the tiles its predicate rules out, counted on the card
    skips = {}
    for i, (name, shape, lengths) in enumerate(cases):
        if name.startswith("lonely"):
            continue
        q, k, v, seg, scale = flash_inputs(shape, lengths, torch.bfloat16, seed=10 + i)
        same = torch.equal(flash_attention(q, k, v, seg, seg, scale),
                           flash_attention(q, k, v, seg, seg.clone(), scale))
        counts = tile_counts(q, k, v, seg, scale)
        skips[name] = dict(bit_equal=same, **counts)
        log(f"  K3 bf16 {name}: computed {counts['computed']} of {counts['tiles']} key tiles "
            f"({counts['skipped_tile_share']:.4f} skipped, as the predicate says); with skipping "
            f"== without: {same}")
        check(same, f"flash {name}: skipping changed the result")
    results["flash_skip_check"] = skips


def report_batch(vocab_size: int, seed: int):
    """(32, 512) token ids and a ragged attention mask, as a batch of
    radiology reports padded to the position table."""
    import numpy as np
    import torch

    b, s = REPORT[0], REPORT[2]
    lengths = ragged_lengths(b, s, seed)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    ids = np.random.default_rng(seed).integers(5, vocab_size, size=(b, s)).astype(np.int32) * mask
    ids[:, 0] = 2
    return torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()


def text_tower(results):
    """BERT-base at report length: the flash path (the main path of kernel
    3, launches counted) against the dense path."""
    import torch
    import torch.nn.functional as F

    from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import (
        BertDims,
        bert_encode,
        get_projected_text_embeddings,
        init_cxr_bert,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import (
        flash_attention,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_bottleneck import (
        fused_bottleneck_layer,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
        fused_pairwise_cosine,
    )

    t0 = time.perf_counter()
    model = init_cxr_bert(torch.Generator().manual_seed(0), BertDims()).cuda()
    init_s = time.perf_counter() - t0
    ids, mask = report_batch(model.dims.vocab_size, seed=2)
    bf16 = torch.bfloat16
    with torch.no_grad():
        counters = (flash_attention, fused_pairwise_cosine, fused_bottleneck_layer)
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        proj_bf = get_projected_text_embeddings(model, ids, mask, dtype=bf16, use_flash_attention=True)
        hid_bf = bert_encode(model, ids, mask, dtype=bf16, use_flash_attention=True)
        proj_32 = get_projected_text_embeddings(model, ids, mask, use_flash_attention=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        dense_proj_bf = get_projected_text_embeddings(model, ids, mask, dtype=bf16)
        dense_hid_bf = bert_encode(model, ids, mask, dtype=bf16)
        dense_proj_32 = get_projected_text_embeddings(model, ids, mask)
    log(f"  main path: 3 encodes of (32, 512) (bf16 projected, bf16 hidden, fp32 projected) "
        f"in {wall:.3f} s; launches {launches}")
    check(launches["flash_attention"] == 3 * model.dims.num_layers,
          f"flash_attention launched {launches['flash_attention']} times, not 12 per encode")
    check(hid_bf.shape == (32, 512, 768) and proj_bf.shape == proj_32.shape == (32, 128),
          "text tower output shapes")
    check(all(bool(torch.isfinite(t).all()) for t in (proj_bf, hid_bf, proj_32)), "not finite")
    valid = mask.bool()[..., None]
    h, d = hid_bf.float() * valid, dense_hid_bf.float() * valid
    row_cos = (h * d).sum((1, 2)) / (h.norm(dim=(1, 2)) * d.norm(dim=(1, 2)))
    token_cos = F.cosine_similarity(hid_bf.float(), dense_hid_bf.float(), dim=-1)[mask.bool()]
    proj_cos = F.cosine_similarity(proj_bf, dense_proj_bf, dim=-1)
    f32_err = float((proj_32 - dense_proj_32).abs().max())
    out = dict(init_s=init_s, main_path_s=wall, launches=launches,
               hidden_row_cos_min=float(row_cos.min()), hidden_token_cos_min=float(token_cos.min()),
               projection_cos_min=float(proj_cos.min()), fp32_projection_max_abs=f32_err)
    log(f"  flash vs dense: {json.dumps(out)}")
    check(out["hidden_row_cos_min"] > TEXT_BF16_COS, f"bf16 hidden rows: cos {row_cos.min()}")
    check(out["projection_cos_min"] > TEXT_BF16_COS, f"bf16 projections: cos {proj_cos.min()}")
    check(f32_err <= TEXT_F32_ATOL, f"fp32 projections off by {f32_err}")
    results["text_tower"] = out
    return model, ids, mask


def reference_state_dict(model) -> dict:
    """The port's CXR-BERT under the reference's keys (a ``BertForMaskedLM``
    state dict plus the CXR-BERT projection head)."""
    emb, sd = model.embeddings, {}

    def put(prefix, module):
        sd[prefix + ".weight"] = module.weight
        sd[prefix + ".bias"] = module.bias

    sd["bert.embeddings.word_embeddings.weight"] = emb.word.weight
    sd["bert.embeddings.position_embeddings.weight"] = emb.position.weight
    sd["bert.embeddings.token_type_embeddings.weight"] = emb.token_type.weight
    put("bert.embeddings.LayerNorm", emb.ln)
    for li, layer in enumerate(model.layers):
        p = f"bert.encoder.layer.{li}."
        for name, module in (("attention.self.query", layer.q), ("attention.self.key", layer.k),
                             ("attention.self.value", layer.v),
                             ("attention.output.dense", layer.attn_out),
                             ("attention.output.LayerNorm", layer.attn_ln),
                             ("intermediate.dense", layer.ffn_in), ("output.dense", layer.ffn_out),
                             ("output.LayerNorm", layer.ffn_ln)):
            put(p + name, module)
    put("cls.predictions.transform.dense", model.mlm_head.transform_dense)
    put("cls.predictions.transform.LayerNorm", model.mlm_head.transform_ln)
    sd["cls.predictions.decoder.bias"] = model.mlm_head.decoder_bias
    put("cls_projection_head.dense_to_hidden", model.cls_projection.dense_to_hidden)
    put("cls_projection_head.LayerNorm", model.cls_projection.ln)
    put("cls_projection_head.dense_to_output", model.cls_projection.dense_to_output)
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def write_cxr_bert_files(model, tmp: Path):
    """The port's CXR-BERT in the reference's formats under ``tmp``: a
    ``torch.save`` state dict (``cxr_bert.pt``) with ``vocab.txt``, and an HF
    snapshot directory (``snapshot/``: ``config.json``, ``pytorch_model.bin``,
    ``vocab.txt``).  Returns (vocab path, snapshot dir)."""
    import shutil

    import torch

    from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import write_test_vocab

    torch.save(reference_state_dict(model), tmp / "cxr_bert.pt")
    vocab = write_test_vocab(tmp / "vocab.txt")
    snap = tmp / "snapshot"
    snap.mkdir()
    dims = model.dims
    (snap / "config.json").write_text(json.dumps(dict(
        vocab_size=dims.vocab_size, hidden_size=dims.hidden_size,
        num_hidden_layers=dims.num_layers, num_attention_heads=dims.num_heads,
        intermediate_size=dims.intermediate_size,
        max_position_embeddings=dims.max_position_embeddings,
        type_vocab_size=dims.type_vocab_size, projection_size=dims.projection_size)))
    shutil.copy(tmp / "cxr_bert.pt", snap / "pytorch_model.bin")
    shutil.copy(vocab, snap / "vocab.txt")
    return vocab, snap


def bank_from_weights(model, images, results):
    """The serving CLI builds its bank from BERT-base weights in the
    reference's formats, on the card, and serves a batch with it."""
    import tempfile

    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.cli import classify
    from incremental_multimodal_medical_learning_ii_torch.cli.common import build_bank
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_bottleneck import (
        fused_bottleneck_layer,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
        fused_pairwise_cosine,
    )

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        vocab, snap = write_cxr_bert_files(model, tmp)
        p = argparse.ArgumentParser()
        classify.add_classifier_args(p)
        routes = {"checkpoint": ["--cxr-bert-checkpoint", str(tmp / "cxr_bert.pt"),
                                 "--cxr-bert-vocab", str(vocab)],
                  "snapshot": ["--cxr-bert-snapshot", str(snap)]}
        clfs = {}
        for route, flags in routes.items():
            args = p.parse_args(["--random-weights", "--fused-layer1", *flags])
            t0 = time.perf_counter()
            build_bank(args, torch.device("cuda"))
            torch.cuda.synchronize()
            out[f"bank_build_s_{route}"] = time.perf_counter() - t0
            clfs[route] = classify.build_classifier(args)
        t0 = time.perf_counter()
        cpu_bank = build_bank(p.parse_args(["--random-weights", *routes["checkpoint"]]),
                              torch.device("cpu"))
        out["bank_build_s_cpu"] = time.perf_counter() - t0
    ck, sn = clfs["checkpoint"].bank, clfs["snapshot"].bank
    out["checkpoint_vs_snapshot_max_abs"] = max(float((getattr(ck, f) - getattr(sn, f)).abs().max())
                                                for f in ("pos", "neg"))
    out["card_vs_cpu_max_abs"] = max(float((getattr(ck, f).cpu() - getattr(cpu_bank, f)).abs().max())
                                     for f in ("pos", "neg"))
    check(bool(torch.isfinite(ck.pos).all()) and ck.pos.shape[0] == 5, "bank shape")
    check(out["checkpoint_vs_snapshot_max_abs"] <= BANK_ATOL, "checkpoint and snapshot banks differ")
    check(out["card_vs_cpu_max_abs"] <= BANK_ATOL, "the card's bank differs from the CPU build")
    fused_pairwise_cosine.launches = fused_bottleneck_layer.launches = 0
    scores, preds = clfs["snapshot"].predict_arrays(images[:16])
    out["launches"] = {"fused_cosine": fused_pairwise_cosine.launches,
                       "fused_bottleneck": fused_bottleneck_layer.launches}
    check(scores.shape == preds.shape == (16, 5) and bool(np.isfinite(scores).all())
          and bool(((scores >= 0) & (scores <= 1)).all()), "scores with the CXR-BERT bank")
    check(out["launches"]["fused_cosine"] > 0, "serving with the CXR-BERT bank skipped K1")
    check(out["launches"]["fused_bottleneck"] == 3, "serving with the CXR-BERT bank: K2 not 3 launches")
    log(f"  bank from weights: {json.dumps(out)}")
    results["bank_from_weights"] = out


def text_times(model, ids, mask, results):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import (
        get_projected_text_embeddings,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import (
        flash_attention,
        mha_reference,
    )

    times = {}
    report_lengths = ragged_lengths(REPORT[0], REPORT[2], seed=1)
    for name, shape, lengths, dtype in (
            ("bfloat16", REPORT, report_lengths, torch.bfloat16),
            ("float32", REPORT, report_lengths, torch.float32),
            ("bfloat16 hd128", (4, 4, 256, 128), [256, 200, 130, 17], torch.bfloat16)):
        q, k, v, seg, scale = flash_inputs(shape, lengths, dtype, seed=10)
        allowed = (seg[:, :, None] == seg[:, None, :])[:, None]  # (B, 1, S, S)
        lib = F.scaled_dot_product_attention(q, k, v, attn_mask=allowed, scale=scale).float()
        ref = mha_reference(q.float(), k.float(), v.float(), seg, seg, scale)
        bound, by, flops, dense_flops = flash_bound_ms(q, seg)
        bf16 = dtype == torch.bfloat16
        # event times: medians of 5 rounds in turns
        seg_copy = seg.clone()
        fns = {"ms": lambda: flash_attention(q, k, v, seg, seg, scale),
               "library_ms": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed,
                                                                     scale=scale)}
        if bf16:  # the same kernel with skipping off: kv ids are a copy
            fns["no_skip_ms"] = lambda: flash_attention(q, k, v, seg, seg_copy, scale)
        med = alternating_ms(fns, iters=50)
        kernel = f"flash_fwd_{'bf16' if bf16 else 'f32'}_kernel"
        times[name] = dict(
            **med, plain_ms=cuda_time_ms(lambda: mha_reference(q, k, v, seg, seg, scale), 5),
            bound_ms=bound, bound_by=by, flops_needed=flops, flops_dense=dense_flops,
            tflops_needed=flops / med["ms"] / 1e9, shape=list(shape),
            library_max_abs_vs_plain=float((lib - ref).abs().max()),
            kernel_device_ms=profiled_device_ms(lambda: flash_attention(q, k, v, seg, seg, scale),
                                                flash_attention, kernel, med["ms"], bound))
        if bf16:  # the skipped share, counted by the kernel (fp32 computes every tile)
            times[name].update(tile_counts(q, k, v, seg, scale))
        log(f"  K3 {name} {shape}: {json.dumps(times[name])}")
    results["flash_times"] = times

    g = np.random.default_rng(3)
    short_len = g.integers(8, 33, size=256)
    short_mask = torch.from_numpy((np.arange(32)[None, :] < short_len[:, None]).astype(np.int32)).cuda()
    short_ids = torch.from_numpy(g.integers(5, 30000, size=(256, 32)).astype(np.int32)).cuda()
    rates = {}
    with torch.no_grad():
        for name, (i, m, dtype, flash) in {
            "report (32, 512) bf16 flash": (ids, mask, torch.bfloat16, True),
            "report (32, 512) bf16 dense": (ids, mask, torch.bfloat16, False),
            "bank (256, 32) fp32 dense": (short_ids, short_mask, torch.float32, False),
            "bank (256, 32) bf16 dense": (short_ids, short_mask, torch.bfloat16, False),
        }.items():
            ms = cuda_time_ms(lambda: get_projected_text_embeddings(
                model, i, m, dtype=dtype, use_flash_attention=flash), 10, warmup=2)
            rates[name] = dict(ms=ms, prompts_per_s=i.shape[0] / ms * 1e3)
            log(f"  text encode {name}: {ms:.3f} ms, {rates[name]['prompts_per_s']:.1f} prompts/s")
    results["text_encode_times"] = rates


# ----------------------------------------------------------------------
# the paper's experiment: the three drivers over cached embeddings
# ----------------------------------------------------------------------
# the reference's scale (cli/reproduce.py --rehearsal): the full 191,027-row
# train set, a 16,027-row val split, 2,048 test rows; bs 6144, eval bs 1024
TRAIN_ROWS, VAL_ROWS, TEST_ROWS = 191_027, 16_027, 2_048
EVAL_BS = 1024
TRAIN_FLAGS = ["--batch-size", "6144", "--lr", "1e-4", "--epochs", "10", "--plot-figures", "off"]
K1_EVAL_ATOL = 1e-6
CPU_LOSS_ATOL = 1e-5  # CUDA run vs the same run on the CPU: train/Loss, val/Loss
CPU_AUROC_ATOL = 1e-3  # val/test AUROC-macro
# myCL reset counts per step, as a share of the weights compared: held for
# every step of one step from the same state on the card and on the CPU,
# and for 99% of the steps of two whole runs (their trajectories drift
# apart by fp32 noise, and a weight near the reset cutoff flips: the knife
# edge of PARITY.md:172-185; the largest share is reported)
RESET_SHARE = 0.005
LOOPS = ("build_fused_epoch", "build_fused_unit", "build_fused_run", "build_fused_eval")


def training_data(directory: Path, seed: int = 27) -> Path:
    """Synthetic cached embeddings at the reference's scale (noisy sums of
    per-class directions, as the JAX package's rehearsal makes them), as the
    drivers' ``--data-dir`` reads them."""
    import numpy as np

    from incremental_multimodal_medical_learning_ii_torch.data.store import synthetic_dataset

    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(5, 128)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    for split, n, s in (("train", TRAIN_ROWS, 1), ("val", VAL_ROWS, 2), ("test", TEST_ROWS, 3)):
        synthetic_dataset(n, seed=s, class_directions=dirs).save(directory / f"{split}.npz")
    return directory


def eval_kernel_checks(bank, results):
    """K1 at the eval passes' shapes: 1024 rows against the MEAN/SINGLE bank
    (10 rows: 5 classes x pos/neg means) and against one polarity of the MAX
    bank (5 x P_max rows), against its plain version; times as in phase 7."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.objectives.scorer import PromptBank
    from incremental_multimodal_medical_learning_ii_torch.ops.cosine import (
        l2_normalize,
        masked_mean,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
        fused_pairwise_cosine,
        pairwise_cosine,
    )

    bank = PromptBank(*(t.cuda() for t in bank))
    c, p, d = bank.pos.shape
    g = torch.Generator(device="cuda").manual_seed(5)
    banks = {f"eval {EVAL_BS}x{2 * c}": torch.cat([masked_mean(bank.pos, bank.pos_count),
                                                   masked_mean(bank.neg, bank.neg_count)]),
             f"eval {EVAL_BS}x{c * p}": bank.pos.reshape(c * p, d)}
    out = {}
    for name, t in banks.items():
        x = torch.randn(EVAL_BS, d, device="cuda", generator=g)
        got, ref = fused_pairwise_cosine(x, t), pairwise_cosine(x, t)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        check(err <= K1_EVAL_ATOL, f"K1 {name}: off by {err}")
        xn, tn = l2_normalize(x), l2_normalize(t)
        bound, by = cosine_bound_ms(EVAL_BS, t.shape[0])
        med = alternating_ms({"ms": lambda: fused_pairwise_cosine(x, t),
                              "library_ms": lambda: torch.matmul(xn, tn.T)}, iters=200)
        out[name] = dict(
            max_abs_err=err, **med, plain_ms=cuda_time_ms(lambda: pairwise_cosine(x, t), 200),
            bound_ms=bound, bound_by=by,
            kernel_device_ms=profiled_device_ms(lambda: fused_pairwise_cosine(x, t),
                                                fused_pairwise_cosine, "fused_cosine_kernel",
                                                med["ms"], bound))
        log(f"  K1 {name}: {json.dumps(out[name])}")
    results["cosine_eval"] = out
    return list(banks)


def guarded_loops(calls: dict, host_s: dict):
    """Wrap the trainer's fused loops so each call runs under
    ``torch.cuda.set_sync_debug_mode("error")``: between the upload of its
    operands and the readback of its outputs, any call that synchronises
    with the card raises.  ``calls`` counts the guarded calls of each loop,
    ``host_s`` sums the host's time inside them (the time to queue the
    work: nothing in them waits for the card).  Returns the undo function."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.engine import trainer as tmod

    originals = {n: getattr(tmod, n) for n in LOOPS}

    def wrap(name, build):
        def builder(*a, **k):
            fn = build(*a, **k)

            def guarded(*args, **kw):
                if not args[1].is_cuda:  # every loop's second operand is its data
                    return fn(*args, **kw)
                calls[name] = calls.get(name, 0) + 1
                torch.cuda.set_sync_debug_mode("error")
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    host_s[name] = host_s.get(name, 0.0) + time.perf_counter() - t0
                    torch.cuda.set_sync_debug_mode("default")
            return guarded
        return builder

    for n in LOOPS:
        setattr(tmod, n, wrap(n, originals[n]))
    return lambda: [setattr(tmod, n, f) for n, f in originals.items()]


def event_streams(log_dir: Path) -> dict:
    from incremental_multimodal_medical_learning_ii_torch.evaluation.tb import read_scalars

    files = sorted(log_dir.glob("**/events.out.tfevents.*"))
    check(len(files) == 1, f"expected one event file under {log_dir}, found {len(files)}")
    streams = {}
    for tag, step, value in read_scalars(files[0]):
        streams.setdefault(tag, []).append((step, value))
    return streams


def run_driver(cli: str, flags, data_dir: Path, log_dir: Path, device: str,
               host_s: dict) -> dict:
    """One driver through its CLI's ``main`` (its printout discarded); the
    K1 launches, the per-step myCL reset counts, the wall time around it
    and the host's time inside its guarded loops."""
    import contextlib
    import importlib

    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer
    from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import (
        flash_attention,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_bottleneck import (
        fused_bottleneck_layer,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
        fused_pairwise_cosine,
    )

    main = importlib.import_module(f"{PACKAGE}.cli.{cli}").main
    resets = []
    flush = Trainer._flush_epoch_metrics

    def record(self, fetched, *a, **k):
        if "n_reset" in fetched:
            resets.append(np.asarray(fetched["n_reset"], np.int64))
        return flush(self, fetched, *a, **k)

    Trainer._flush_epoch_metrics = record
    counters = (fused_pairwise_cosine, fused_bottleneck_layer, flash_attention)
    try:
        for fn in counters:
            fn.launches = 0
        host_s.clear()
        printout = io.StringIO()  # the drivers print every eval's metrics
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printout):
            res = main(["--data-dir", str(data_dir), "--log-dir", str(log_dir), "--device", device,
                        *TRAIN_FLAGS, *flags])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
    finally:
        Trainer._flush_epoch_metrics = flush
    steps = int(res["trainer"].state.step)
    return dict(wall_s=wall, steps=steps, steps_per_s=steps / wall, launches=launches,
                loop_host_s=dict(host_s),
                resets=np.concatenate(resets) if resets else np.zeros(0, np.int64),
                streams=event_streams(log_dir),
                params={k: v.detach().cpu() for k, v in res["trainer"].state.params.items()})


def compare_runs(a: dict, b: dict, n_weights: int) -> dict:
    """Two runs of one configuration: max |diff| of the loss streams, of
    the AUROC-macro scalars, and of the per-step myCL reset counts."""
    import numpy as np

    check(sorted(a["streams"]) == sorted(b["streams"]), "the runs logged different tags")
    out = {}
    for tag in ("train/Loss", "val/Loss", "val/AUROC-macro", "test/AUROC-macro"):
        sa, sb = a["streams"][tag], b["streams"][tag]
        check([s for s, _ in sa] == [s for s, _ in sb], f"{tag}: the runs logged different steps")
        out[tag] = float(np.max(np.abs(np.array([v for _, v in sa]) - np.array([v for _, v in sb]))))
    check(a["resets"].shape == b["resets"].shape, "the runs reset on different steps")
    diff = np.abs(a["resets"] - b["resets"])
    out["reset_count_max_diff"] = int(diff.max()) if diff.size else 0
    out["reset_count_max_share"] = out["reset_count_max_diff"] / n_weights
    if diff.size:  # how the disagreement spreads over the run's steps
        share = diff / n_weights
        q = len(share) // 4
        out["reset_share_quantiles"] = {k: float(np.quantile(share, v)) for k, v in
                                        (("p50", 0.5), ("p90", 0.9), ("p99", 0.99))}
        out["reset_steps_over_bar"] = int((share > RESET_SHARE).sum())
        out["reset_steps"] = int(len(share))
        out["reset_argmax_step"] = int(diff.argmax())
        out["reset_mean_share_first_last_quarter"] = [float(share[:q].mean()), float(share[-q:].mean())]
        out["resets_per_step_mean"] = float(a["resets"].mean())
    out["params_max_abs"] = max(float((a["params"][k] - b["params"][k]).abs().max())
                                for k in a["params"])
    return out


def reset_agreement(bank, data_dir: Path, n_weights: int, steps: int = 20) -> dict:
    """myCL's reset mask on the card against the CPU's, one step at a time
    from the same state and batch (the CPU step starts from a copy of the
    card's state before every step), at thresholds across the data-inc
    schedule (0.011 ... 0.21): the disagreement one step's fp32 noise
    makes, without the drift of two whole runs apart."""
    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.data.store import EmbeddingDataset
    from incremental_multimodal_medical_learning_ii_torch.engine.steps import TrainState
    from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer
    from incremental_multimodal_medical_learning_ii_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(continual_learning="myCL", plot_figures="off")
    card = Trainer(cfg, bank, device="cuda")
    train = EmbeddingDataset.load(data_dir / "train.npz")
    bs, state = cfg.batch_size, card.state
    ones = torch.ones(5)
    diffs = []
    for i in range(steps):
        rows = slice(i * bs, (i + 1) * bs)
        embs = torch.from_numpy(train.embeddings[rows])
        labels = torch.from_numpy(train.labels[rows])
        thr = torch.tensor(0.011 + 0.2 * i / (steps - 1))
        host = TrainState(*({k: v.cpu() for k, v in f.items()} if isinstance(f, dict) else f.cpu()
                            for f in state))
        state, m_card = card._train_step(state, embs.cuda(), labels.cuda(), torch.ones(bs).cuda(),
                                         ones.cuda(), card.bank, thr.cuda())
        _, m_host = card._train_step(host, embs, labels, torch.ones(bs), ones,
                                     card.bank.to("cpu"), thr)
        diffs.append(abs(int(m_card["n_reset"]) - int(m_host["n_reset"])))
    share = np.array(diffs) / n_weights
    return dict(steps=steps, max_diff=int(max(diffs)), max_share=float(share.max()),
                mean_share=float(share.mean()), diffs=diffs)


def profile_training(bank, results):
    """Where a training epoch's time goes: one fused epoch of the joint run
    (32 steps of 6144 rows) and one val pass (16 batches of 1024, K1) under
    the profiler: wall, device busy share, top kernels."""
    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer
    from incremental_multimodal_medical_learning_ii_torch.utils.config import ExperimentConfig
    from incremental_multimodal_medical_learning_ii_torch.utils.device import upload

    trainer = Trainer(ExperimentConfig(plot_figures="off"), bank, device="cuda")
    rng = np.random.default_rng(0)
    n = 32 * 6144
    embs = upload(rng.normal(size=(n, 128)).astype(np.float32), trainer.device)
    labels = upload((rng.random((n, 5)) < 0.3).astype(np.float32), trainer.device)
    valid = torch.ones(n, device="cuda")
    val = (embs[:16 * EVAL_BS], labels[:16 * EVAL_BS], valid[:16 * EVAL_BS])
    perm = upload(np.random.default_rng(1).permutation(n), trainer.device)
    mask, thr = torch.ones(5, device="cuda"), torch.zeros((), device="cuda")

    def epoch_and_eval():
        trainer.state, stacked = trainer._fused_epoch(trainer.state, embs, labels, valid,
                                                      trainer.bank, mask, thr, perm)
        return stacked, trainer._fused_eval(trainer.state.params, *val, trainer.bank)

    profile_window("one train epoch (32 x 6144) + one val pass (16 x 1024)", epoch_and_eval,
                   results)


def training(bank, results):
    """The paper's experiment through the three drivers' CLIs at the
    reference's scale, on the card, with K1 scoring every eval pass (joint
    and data-incremental also with ``--fused-unit``), then the same runs on
    the card machine's CPU, held against the card's."""
    import math
    import shutil
    import tempfile

    import torch

    c, p, _ = bank.pos.shape
    eval_batches = math.ceil(VAL_ROWS / EVAL_BS) + math.ceil(TEST_ROWS / EVAL_BS)
    runs = {  # name: (cli, flags, units evaluated, K1 launches per eval batch)
        "joint": ("zero_joint_bounds", [], 10, 1),
        "joint --fused-unit": ("zero_joint_bounds", ["--fused-unit"], 10, 1),
        "data-inc": ("data_incremental", ["--parts", "20", "--continual-learning", "myCL"], 20, 1),
        "data-inc --fused-unit": ("data_incremental", ["--parts", "20", "--continual-learning",
                                                       "myCL", "--fused-unit"], 20, 1),
        "class-pos-neg MORE_LABELS MAX": ("class_incremental", ["--max-emb"], 5, 2),
    }
    out = {"runs": {}, "cpu": {}}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    calls: dict = {}
    host_s: dict = {}
    undo = guarded_loops(calls, host_s)
    try:
        t0 = time.perf_counter()
        data_dir = training_data(tmp / "data")
        out["data_s"] = time.perf_counter() - t0
        # positive control: the guard does catch a synchronising call
        x = torch.ones(4, device="cuda")
        torch.cuda.set_sync_debug_mode("error")
        try:
            caught = raises(lambda: x.sum().item(), RuntimeError)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(caught, "sync debug mode did not catch .item()")
        cuda_runs = {}
        order = ["joint", "joint --fused-unit", "data-inc", "data-inc --fused-unit",
                 "class-pos-neg MORE_LABELS MAX",
                 "data-inc --fused-unit", "data-inc"]  # the two data-inc paths in turns
        for i, name in enumerate(order):
            cli, flags, units, per_batch = runs[name]
            r = run_driver(cli, flags, data_dir, tmp / f"cuda{i}", "cuda", host_s)
            expected = units * eval_batches * per_batch
            check(r["launches"]["fused_pairwise_cosine"] == expected,
                  f"{name}: K1 launched {r['launches']['fused_pairwise_cosine']} times, "
                  f"the eval passes imply {expected}")
            check(r["launches"]["fused_bottleneck_layer"] == 0 and r["launches"]["flash_attention"] == 0,
                  f"{name}: a kernel off the training path was launched")
            final = r["streams"]["test/AUROC-macro"][-1][1]
            check(0.0 <= final <= 1.0, f"{name}: final test AUROC-macro {final}")
            check(name != "joint" or final > 0.5, f"joint training did not learn: AUROC {final}")
            key = name if name not in cuda_runs else name + " (2nd)"
            cuda_runs[key] = r
            out["runs"][key] = dict(wall_s=r["wall_s"], steps=r["steps"], steps_per_s=r["steps_per_s"],
                                    loop_host_s=r["loop_host_s"],
                                    launches=r["launches"], expected_k1_launches=expected,
                                    final_test_auroc_macro=final,
                                    final_val_auroc_macro=r["streams"]["val/AUROC-macro"][-1][1])
            log(f"  {key}: {r['steps']} steps in {r['wall_s']:.2f} s ({r['steps_per_s']:.1f} steps/s), "
                f"host time inside the guarded loops {json.dumps(r['loop_host_s'])}, "
                f"K1 launches {r['launches']['fused_pairwise_cosine']} (= {expected}), "
                f"final test AUROC-macro {final:.4f}")
        check(all(calls.get(n, 0) > 0 for n in LOOPS), f"a fused loop ran unguarded: {calls}")
        out["guarded_loop_calls"] = dict(calls)
        n_weights = sum(v.numel() for v in cuda_runs["data-inc"]["params"].values())
        for name in ("joint", "data-inc"):
            same = compare_runs(cuda_runs[name], cuda_runs[name + " --fused-unit"], n_weights)
            log(f"  {name} per epoch/unit vs --fused-unit on the card: {json.dumps(same)}")
            check(same["train/Loss"] <= CPU_LOSS_ATOL and same["val/Loss"] <= CPU_LOSS_ATOL,
                  f"{name}: --fused-unit changed the loss streams: {same}")
            out[f"fused_vs_unfused {name}"] = same
        for name in ("data-inc", "joint", "class-pos-neg MORE_LABELS MAX"):
            cli, flags, _, _ = runs[name]
            r = run_driver(cli, flags, data_dir, tmp / f"cpu-{name.split()[0]}", "cpu", host_s)
            diff = compare_runs(cuda_runs[name], r, n_weights)
            out["cpu"][name] = dict(wall_s=r["wall_s"], steps_per_s=r["steps_per_s"],
                                    cuda_wall_s=cuda_runs[name]["wall_s"], **diff)
            log(f"  {name} on the CPU: {r['wall_s']:.2f} s ({r['steps_per_s']:.2f} steps/s) against "
                f"{cuda_runs[name]['wall_s']:.2f} s on the card; CUDA vs CPU {json.dumps(diff)}")
            check(diff["train/Loss"] <= CPU_LOSS_ATOL and diff["val/Loss"] <= CPU_LOSS_ATOL,
                  f"{name}: CUDA and CPU loss streams differ: {diff}")
            check(diff["val/AUROC-macro"] <= CPU_AUROC_ATOL and diff["test/AUROC-macro"] <= CPU_AUROC_ATOL,
                  f"{name}: CUDA and CPU AUROC differ: {diff}")
        out["reset_agreement_one_step"] = reset_agreement(bank, data_dir, n_weights)
        log(f"  myCL reset counts, card vs CPU, one step from the same state: "
            f"{json.dumps(out['reset_agreement_one_step'])}")
        one = out["reset_agreement_one_step"]
        check(one["max_share"] <= RESET_SHARE,
              f"one step from the same state: myCL reset counts differ by {one['max_diff']}")
        for name, diff in out["cpu"].items():  # after every run, so all were measured
            check(diff.get("reset_share_quantiles", {}).get("p99", 0.0) <= RESET_SHARE,
                  f"{name}: myCL reset counts differ by more than {RESET_SHARE:.1%} of the "
                  f"weights on more than 1% of the steps: {diff}")
    finally:
        undo()
        shutil.rmtree(tmp, ignore_errors=True)
        out_dir = REPO / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_training.json").write_text(json.dumps(out, indent=1))
    profile_training(bank, results)
    out["k1_launches"] = {
        f"eval {EVAL_BS}x{2 * c}": sum(r["launches"]["fused_pairwise_cosine"]
                                       for n, r in cuda_runs.items() if "MAX" not in n),
        f"eval {EVAL_BS}x{c * p}": sum(r["launches"]["fused_pairwise_cosine"]
                                       for n, r in cuda_runs.items() if "MAX" in n),
    }
    results["training"] = out
    return out


# ----------------------------------------------------------------------
# embedding extraction, the paper's table and served checkpoints
# ----------------------------------------------------------------------
EXTRACT_N = 4096  # images of the CLI's clean run; its cut run stops at half of them
EXTRACT_BS = 128  # the extraction CLI's defaults: batch 128, 512^2, bf16, grayscale conv1
EXTRACT_SIZE = 512
EMB_ATOL = 2e-4  # the ResNet bar (PARITY.md), fp32 with TF32 off
INT8_COS = 0.99  # the int8 trunk against bf16 (tests/test_quant.py:78,97)
INT8_N = 1024  # images timed through the int8 trunk
REPRO_ATOL = 1e-3  # a --dry-run gate's AUROC, the card against the CPU (phase 12's bar)
SCORE_ATOL = 1e-4  # served scores, the card against the CPU, fp32


def counters():
    from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import flash_attention
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_bottleneck import (
        fused_bottleneck_layer,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
        fused_pairwise_cosine,
    )

    return {"fused_cosine": fused_pairwise_cosine, "fused_bottleneck": fused_bottleneck_layer,
            "flash_attention": flash_attention}


def zero_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def guarded_extraction(calls: dict):
    """Run the body of ``extract_embeddings``' dispatch loop (upload and
    forward of each batch) under ``torch.cuda.set_sync_debug_mode("error")``:
    the prefetch generator turns the guard on as it hands a batch to the loop
    and off when the loop asks for the next one, and ``readback`` (the one
    synchronisation a window makes) runs unguarded.  ``calls`` counts the
    guarded batches.  Returns the undo function."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.engine import extract as emod

    prefetch, readback = emod._prefetch, emod.readback

    def guarded_prefetch(gen, depth=2):
        it = prefetch(gen, depth)
        try:
            for item in it:
                calls["batches"] = calls.get("batches", 0) + 1
                torch.cuda.set_sync_debug_mode("error")
                yield item
                torch.cuda.set_sync_debug_mode("default")
        finally:
            torch.cuda.set_sync_debug_mode("default")
            it.close()

    def unguarded_readback(tree):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        try:
            calls["readbacks"] = calls.get("readbacks", 0) + 1
            return readback(tree)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    emod._prefetch, emod.readback = guarded_prefetch, unguarded_readback
    return lambda: (setattr(emod, "_prefetch", prefetch), setattr(emod, "readback", readback))


def extraction_cli(tmp: Path, results) -> dict:
    """(a) The extraction CLI end to end at its defaults; a cut run resumed
    to the same images must equal the clean run bit for bit."""
    import numpy as np

    from incremental_multimodal_medical_learning_ii_torch.cli import extract_embeddings as cli

    flags = ["--batch-size", str(EXTRACT_BS), "--size", str(EXTRACT_SIZE)]
    # warm-up, not measured: the first forward at this shape
    cli.main(["--synthetic", str(EXTRACT_BS), "--out-dir", str(tmp / "warm"), *flags])
    calls: dict = {}
    undo = guarded_extraction(calls)
    try:
        zero_counts()
        clean = cli.main(["--synthetic", str(EXTRACT_N), "--out-dir", str(tmp / "clean"), *flags])
        launches = read_counts()
    finally:
        undo()
    batches = EXTRACT_N // EXTRACT_BS
    ds = clean["dataset"]
    check(ds.embeddings.shape == (EXTRACT_N, 128) and bool(np.isfinite(ds.embeddings).all()),
          f"extraction output {ds.embeddings.shape}")
    check(clean["stats"]["batches"] == batches == calls.get("batches")
          and clean["stats"]["retried_batches"] == 0, f"extraction stats {clean['stats']} {calls}")
    check(not any(launches.values()), f"extraction launched a kernel off its path: {launches}")
    cli.main(["--synthetic", str(EXTRACT_N // 2), "--out-dir", str(tmp / "cut"), *flags])
    resumed = cli.main(["--synthetic", str(EXTRACT_N), "--out-dir", str(tmp / "cut"), "--resume",
                        *flags])
    rds = resumed["dataset"]
    bit_exact = (np.array_equal(rds.embeddings, ds.embeddings)
                 and np.array_equal(rds.labels, ds.labels))
    diff = float(np.abs(rds.embeddings - ds.embeddings).max())
    out = dict(images=EXTRACT_N, batch=EXTRACT_BS, size=EXTRACT_SIZE, wall_s=clean["seconds"],
               images_per_s=clean["fresh"] / clean["seconds"], stats=clean["stats"],
               shards=clean["shards"], guarded_batches=calls.get("batches"),
               readbacks=calls.get("readbacks"), launches=launches,
               resumed_fresh=resumed["fresh"], resumed_shards=resumed["shards"],
               resumed_bit_exact=bit_exact, resumed_max_abs_diff=diff)
    log(f"  (a) extraction CLI: {json.dumps(out)}")
    check(resumed["fresh"] == EXTRACT_N // 2 and resumed["shards"] == 2,
          f"the resumed run extracted {resumed['fresh']} images into {resumed['shards']} shards")
    check(bit_exact, f"the resumed run differs from the clean run by {diff}")
    results["extraction_cli"] = out
    return out


def extraction_paths(model, results) -> None:
    """(b) mixed CheXpert shapes through the indexed path against one image
    at a time (the shared path); (c) the card against its own CPU in fp32,
    and bf16 against fp32 on the card."""
    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.cli.extract_embeddings import (
        synthetic_images,
    )
    from incremental_multimodal_medical_learning_ii_torch.engine.extract import extract_embeddings

    def run(items, **kw):
        kw = {"size": EXTRACT_SIZE, "dtype": torch.float32, **kw}
        return extract_embeddings(list(items), model, **kw).embeddings

    labels = np.zeros(5, np.float32)
    mixed = [(im, labels) for im in synthetic_cxrs(12, seed=5)]
    indexed = run(mixed, batch_size=6, device="cuda")
    lone = run(mixed, batch_size=1, device="cuda")
    b = dict(images=len(mixed), shapes=len({im.shape for im, _ in mixed}),
             max_abs_diff=float(np.abs(indexed - lone).max()),
             max_abs_emb=float(np.abs(lone).max()), min_cos=float(row_cos(indexed, lone).min()))
    log(f"  (b) indexed path, mixed shapes, vs one image at a time (fp32): {json.dumps(b)}")
    check(b["max_abs_diff"] <= EMB_ATOL, f"indexed vs shared path: {b}")

    items = list(synthetic_images(8))
    card = run(items, batch_size=8, device="cuda")
    cpu = run(items, batch_size=8, device="cpu")
    bf16 = run(items, batch_size=8, device="cuda", dtype=torch.bfloat16)
    c = dict(images=len(items), max_abs_diff=float(np.abs(card - cpu).max()),
             max_abs_emb=float(np.abs(cpu).max()), bf16_vs_fp32_min_cos=float(row_cos(bf16, card).min()))
    log(f"  (c) 512^2 fp32 (TF32 off), the card against its CPU: {json.dumps(c)}")
    check(c["max_abs_diff"] <= EMB_ATOL, f"the card's embeddings differ from the CPU's: {c}")
    check(c["bf16_vs_fp32_min_cos"] > EMB_COS, f"bf16 vs fp32 on the card: {c}")
    results["extraction_paths"] = {"indexed_vs_shared": b, "card_vs_cpu": c}


def row_cos(a, b):
    import numpy as np

    return np.sum(a * b, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def int8_trunk(model, results) -> None:
    """(d) The int8 trunk: the int32 sums of three convs on the card equal
    the CPU's exact path; its embedding against bf16; its images/s."""
    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.cli.extract_embeddings import (
        synthetic_images,
    )
    from incremental_multimodal_medical_learning_ii_torch.engine.extract import extract_embeddings
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        fold_grayscale_conv1,
        quantize_biovil_int8,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.quant import conv_int8_sums

    enc = quantize_biovil_int8(fold_grayscale_conv1(model)).encoder
    g = torch.Generator().manual_seed(13)
    convs = {  # conv: (module, input shape (B, C, H, W)), at the 512^2 forward's shapes
        "conv1 7x7/2 (cin 1)": (enc.conv1, (2, 1, 512, 512)),
        "layer1.0.conv2 3x3": (enc.layer1[0].conv2, (2, 64, 128, 128)),
        "layer2.0.downsample 1x1/2": (enc.layer2[0].downsample_conv, (2, 256, 128, 128)),
    }
    sums = {}
    for name, (conv, shape) in convs.items():
        xq = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        xq = xq.contiguous(memory_format=torch.channels_last)
        cpu = conv_int8_sums(xq, conv.kernel_q, conv.stride, conv.padding)
        card = conv_int8_sums(xq.cuda(), conv.kernel_q.cuda(), conv.stride, conv.padding)
        equal = bool(torch.equal(card.cpu(), cpu))
        sums[name] = dict(shape=list(cpu.shape), equal=equal,
                          max_abs_sum=int(cpu.abs().max()))
        check(card.dtype == torch.int32 and equal, f"int8 conv {name}: the card's sums differ")
    log(f"  (d) int8 conv sums, card vs CPU: {json.dumps(sums)}")

    items = list(synthetic_images(EXTRACT_BS))
    kw = dict(batch_size=EXTRACT_BS, size=EXTRACT_SIZE, device="cuda")
    bf16 = extract_embeddings(items, model, **kw).embeddings
    int8 = extract_embeddings(items, model, int8=True, **kw).embeddings
    cos = float(row_cos(int8, bf16).min())
    many = list(synthetic_images(INT8_N))
    rates = {}
    for name, flag in (("int8", True), ("bf16", False), ("bf16 (2nd)", False), ("int8 (2nd)", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extract_embeddings(many, model, int8=flag, **kw)
        rates[name] = INT8_N / (time.perf_counter() - t0)
    out = dict(sums=sums, int8_vs_bf16_min_cos=cos, images_per_s=rates)
    log(f"  (d) int8 trunk: embedding vs bf16 min cos {cos:.6f}; images/s at batch "
        f"{EXTRACT_BS}, {INT8_N} images, extract_embeddings in turns: {json.dumps(rates)}")
    check(bool(np.isfinite(int8).all()) and cos > INT8_COS, f"int8 vs bf16 embedding cos {cos}")
    results["int8"] = out


def device_encode(model, results, profile: bool = False) -> dict:
    """(e) The device encode alone (``preprocess_device_shared`` then
    BioViL), batch 128, 512^2, bf16, grayscale: layer1 through K2 against the
    cuDNN chain, in turns; K2 against its plain version at the layer's shape
    in this forward, (128, 128, 128, 64), and its launches."""
    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        biovil_image_forward,
        fold_grayscale_conv1,
    )
    from incremental_multimodal_medical_learning_ii_torch.models.resnet import max_pool_3x3_s2
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_bottleneck import (
        folded_layer,
        fused_bottleneck_layer,
        fused_bottleneck_layer_reference,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.preprocess import (
        SharedSizePreprocessPlan,
        preprocess_device_shared,
    )

    fm = fold_grayscale_conv1(model).cuda()
    plan = SharedSizePreprocessPlan(390, 320, size=EXTRACT_SIZE)
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(rng.integers(0, 256, (EXTRACT_BS, 390, 320), dtype=np.uint8)).cuda()
    w_h, w_w = torch.from_numpy(plan.w_h).cuda(), torch.from_numpy(plan.w_w).cuda()

    @torch.no_grad()
    def encode(fused: bool):
        imgs = preprocess_device_shared(raw, w_h, w_w, channels=1)
        return biovil_image_forward(fm, imgs, dtype=torch.bfloat16,
                                    fused_layer1=fused).projected_global_embedding

    encode(True)  # warm-up: the layer fold, cuDNN's first calls
    encode(False)
    torch.cuda.synchronize()
    zero_counts()
    fused = encode(True)
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches["fused_bottleneck"] == 3, f"K2 launched {launches} in one encode, not 3")
    cos = float(row_cos(fused.float().cpu().numpy(), encode(False).float().cpu().numpy()).min())
    check(cos > EMB_COS, f"the K2 encode against the cuDNN encode: cos {cos}")
    med = alternating_ms({"fused_layer1_ms": lambda: encode(True),
                          "cudnn_ms": lambda: encode(False)}, iters=3)
    enc = dict(batch=EXTRACT_BS, size=EXTRACT_SIZE, **med, k2_launches=launches["fused_bottleneck"],
               min_cos_vs_cudnn=cos,
               images_per_s={k[:-3]: EXTRACT_BS / (v / 1e3) for k, v in med.items()})
    log(f"  (e) device encode: {json.dumps(enc)}")
    if profile:
        for fused in (True, False):
            profile_window(f"one extraction encode, batch {EXTRACT_BS} at {EXTRACT_SIZE}^2, bf16, "
                           f"{'K2' if fused else 'cuDNN'} layer1", lambda: encode(fused), results)

    # K2 at this forward's layer1 input
    folded = folded_layer(fm.encoder.layer1)
    with torch.no_grad():
        t = preprocess_device_shared(raw, w_h, w_w, channels=1).to(torch.bfloat16)
        t = t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        t = max_pool_3x3_s2(torch.relu(fm.encoder.bn1(fm.encoder.conv1(t))))
        x = t.permute(0, 2, 3, 1).contiguous()
        shape = tuple(x.shape)
        got, ref = fused_bottleneck_layer(x, folded), fused_bottleneck_layer_reference(x, folded)
        m = layer_metrics(got, ref)
        check(m["rel"] < LAYER_CHAIN_REL and m["cos"] > LAYER_COS
              and bool(torch.isfinite(got).all()), f"K2 at {shape}: {m}")
        bound, by, flops = layer_bound_ms(shape, folded)
        lib = cudnn_layer(folded)
        times = alternating_ms({"ms": lambda: fused_bottleneck_layer(x, folded),
                                "library_ms": lambda: lib(x)}, iters=5)
        k2 = dict(shape=list(shape), **m, **times,
                  plain_ms=cuda_time_ms(lambda: fused_bottleneck_layer_reference(x, folded), 2, 1),
                  bound_ms=bound, bound_by=by, tflops=flops / times["ms"] / 1e9,
                  kernel_device_ms=profiled_device_ms(lambda: fused_bottleneck_layer(x, folded),
                                                      fused_bottleneck_layer, K2_KERNEL,
                                                      times["ms"], bound, iters=10))
    log(f"  (e) K2 at {shape}: {json.dumps(k2)}")
    del got, ref, x, t
    torch.cuda.empty_cache()
    results["device_encode"] = enc
    results["k2_extraction"] = k2
    return k2


def reproduce_gates(tmp: Path, results) -> dict:
    """(f) ``reproduce --rehearsal`` on the card, the wall time of each gate
    and K1's launches; ``--dry-run`` on the card against the CPU."""
    import contextlib

    from incremental_multimodal_medical_learning_ii_torch.cli import reproduce

    zero_counts()
    t0 = time.perf_counter()
    rehearsal = reproduce.main(["--rehearsal", "--log-dir", str(tmp / "rehearsal")])
    wall = time.perf_counter() - t0
    launches = read_counts()
    check(launches["fused_cosine"] > 0 and launches["fused_bottleneck"] == 0
          and launches["flash_attention"] == 0, f"reproduce --rehearsal launches {launches}")
    check(all(0.0 <= g["measured"] <= 1.0 for g in rehearsal.values()), f"gates {rehearsal}")
    dry = {}
    for device in ("cuda", "cpu"):
        with contextlib.redirect_stdout(io.StringIO()):
            dry[device] = reproduce.main(["--dry-run", "--device", device,
                                          "--log-dir", str(tmp / f"dry-{device}")])
    diffs = {g: abs(dry["cuda"][g]["measured"] - dry["cpu"][g]["measured"]) for g in dry["cpu"]}
    out = dict(rehearsal_wall_s=wall, launches=launches,
               gates={g: dict(auroc=v["measured"], wall_s=v["wall_s"]) for g, v in rehearsal.items()},
               class_inc_curve=rehearsal["class-inc"]["curve"], dry_run_card_vs_cpu=diffs,
               dry_run_wall_s={d: {g: v["wall_s"] for g, v in r.items()} for d, r in dry.items()})
    log(f"  (f) reproduce: {json.dumps(out)}")
    check(max(diffs.values()) <= REPRO_ATOL, f"--dry-run gates, card vs CPU: {diffs}")
    results["reproduce"] = out
    return out


def served_checkpoint(tmp: Path, results) -> dict:
    """(g) The classify CLI serving ``--adapter-checkpoint`` from a short
    training run of the port: K1's launches on the card, and the scores of
    the pieces each CLI built (fp32) on the card against the CPU."""
    import argparse
    import contextlib

    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.cli import classify, zero_joint_bounds
    from incremental_multimodal_medical_learning_ii_torch.inference import ChexpertClassifier

    with contextlib.redirect_stdout(io.StringIO()):
        zero_joint_bounds.main(["--synthetic", "--epochs", "2", "--batch-size", "512",
                                "--plot-figures", "off", "--log-dir", str(tmp / "train")])
    (run_dir,) = [p.parent for p in (tmp / "train").rglob("train_state")]
    p = argparse.ArgumentParser()
    classify.add_classifier_args(p)
    flags = ["--random-weights", "--adapter-checkpoint", str(run_dir), "--batch-size", "4"]
    card = classify.build_classifier(p.parse_args(flags))
    cpu = classify.build_classifier(p.parse_args([*flags, "--device", "cpu"]))
    check(card.cfg.image_adapter and card.cfg.text_adapter and len(card.adapter_params) == 2,
          f"the checkpoint's adapters were not served: {card.cfg}")
    images = synthetic_cxrs(8, seed=7)
    card.predict_arrays(images[:1])  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    served, _ = card.predict_arrays(images)
    launches = read_counts()
    batches = -(-len(images) // 4)
    check(launches["fused_cosine"] == batches, f"K1 launched {launches}, not once per batch")
    kw = dict(batch_size=4, size=512, pad_to=1024, dtype=torch.float32)
    scores = {name: ChexpertClassifier(clf.image_params, clf.bank, cfg=clf.cfg,
                                       adapter_params=clf.adapter_params, device=dev,
                                       **kw).predict_arrays(images)[0]
              for name, clf, dev in (("card", card, "cuda"), ("cpu", cpu, "cpu"))}
    out = dict(run=run_dir.name, images=len(images), launches=launches,
               card_vs_cpu_fp32=float(np.abs(scores["card"] - scores["cpu"]).max()),
               bf16_vs_fp32_on_card=float(np.abs(served - scores["card"]).max()))
    log(f"  (g) classify --adapter-checkpoint: {json.dumps(out)}")
    check(bool(np.isfinite(served).all()) and out["card_vs_cpu_fp32"] <= SCORE_ATOL,
          f"served scores, card vs CPU: {out}")
    results["served_checkpoint"] = out
    return out


def extraction(model, results, profile: bool = False) -> dict:
    """Phase 13: extraction, the paper's table and a served checkpoint."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_extract_"))
    try:
        extraction_cli(tmp, results)
        extraction_paths(model, results)
        int8_trunk(model, results)
        k2 = device_encode(model, results, profile)
        reproduce_gates(tmp, results)
        served_checkpoint(tmp, results)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return k2


# ----------------------------------------------------------------------
# phrase grounding, the rest of the image model surface, the native store
# ----------------------------------------------------------------------
GROUND_HW = (390, 320)  # CheXpert-small's common geometry (rows, columns)
GROUND_FLAGS = ["--resize", "512", "--crop", "480"]  # the CLI's defaults: a 15 x 15 patch grid
GROUND_QUERY = "There is no pleural effusion"
GROUND_REPEATS = 5
MAP_ATOL = 2e-4  # the ResNet bar: patch embeddings, the map
GROUND_SCORE_ATOL = 1e-4
SURFACE_ATOL = 2e-4  # the ResNet bar, of the largest |feature| (random trunks grow to O(100))
STEM_SHAPE = (128, 512, 512, 1)  # the extraction batch, grayscale
NATIVE_BS = 6144


def biovil_reference_state_dict(model) -> dict:
    """The port's BioViL image model under the reference's
    ``ImageModel`` keys (``encoder.encoder.*``, ``projector.model.{0,1,3}``)."""
    bn_keys = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    sd = {}
    for key, value in model.state_dict().items():
        parts = key.split(".")
        if parts[0] == "encoder":
            parts = ["encoder", "encoder", *parts[1:]]
            parts = [{"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(q, q)
                     for q in parts]
        else:
            parts = ["projector", "model", {"conv1": "0", "bn": "1", "conv2": "3",
                                            "conv2_bias": "3"}[parts[1]], *parts[2:]]
            if key.endswith("conv2_bias"):
                parts.append("bias")
        if parts[-1] in bn_keys:
            parts[-1] = bn_keys[parts[-1]]
        sd[".".join(parts)] = value.detach().cpu().clone()
    return sd


def write_cxr_png(path: Path, seed: int = 21) -> Path:
    """A CheXpert-like 8-bit grayscale PNG at CheXpert-small's geometry."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = GROUND_HW
    yy, xx = np.mgrid[0:h, 0:w]
    img = 110 + 60 * np.sin(xx / 23) * np.cos(yy / 31) + rng.normal(0, 20, size=(h, w))
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), mode="L").save(path)
    return path


def grounding_split(engine, image: Path) -> dict:
    """One grounding query in the order ``get_score_and_map_from_raw_data``
    runs it, each part timed: host load and preprocess, the image forward
    (CUDA events, and the host clock to its readback), the text encode
    (host clock; it returns numpy), the similarity, smoothing and resize."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    img, size = engine.image_engine.load_and_transform_input_image(image)
    t1 = time.perf_counter()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    global_emb, patches = engine.image_engine.embed(img)
    end.record()
    global_emb.cpu()
    t2 = time.perf_counter()
    txt = engine.text_engine.get_embeddings_from_prompt([GROUND_QUERY], normalize=False)[0]
    t3 = time.perf_counter()
    engine._map_from(patches, size, txt / max(np.linalg.norm(txt), 1e-12))
    t4 = time.perf_counter()
    return {"load_preprocess_ms": 1e3 * (t1 - t0), "image_forward_event_ms": start.elapsed_time(end),
            "image_forward_host_ms": 1e3 * (t2 - t1), "text_encode_ms": 1e3 * (t3 - t2),
            "smooth_resize_ms": 1e3 * (t4 - t3)}


def grounding(bert, results, profile: bool = False) -> None:
    """(a) the grounding CLI at full width: a reference-format BioViL
    ResNet-50 checkpoint (seeded random weights) and the BERT-base snapshot
    directory, a 390x320 PNG at resize 512 / crop 480; the query's wall time
    and its split (and, with ``profile``, one query under the profiler);
    (b) fp32 (TF32 off) the card against its own CPU, bf16 against fp32;
    (c) K1-K3 launch no time on the grounding path."""
    import statistics
    import tempfile

    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.cli import ground
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        init_biovil_image_model,
    )
    from incremental_multimodal_medical_learning_ii_torch.vlp.engine import (
        ImageTextInferenceEngine,
    )

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ground_") as tmp:
        tmp = Path(tmp)
        _, snap = write_cxr_bert_files(bert, tmp)
        image = init_biovil_image_model(torch.Generator().manual_seed(0))
        torch.save(biovil_reference_state_dict(image), tmp / "biovil.pt")
        png = write_cxr_png(tmp / "cxr.png")
        flags = ["--image", str(png), "--query", GROUND_QUERY, "--biovil-checkpoint",
                 str(tmp / "biovil.pt"), "--cxr-bert-snapshot", str(snap), *GROUND_FLAGS]
        zero_counts()  # the grounding path: the CLI, then the timed queries
        printout = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printout):
            score, sim_map = ground.main([*flags, "--save-map", str(tmp / "map.npy")])
        out["cli_wall_s"] = time.perf_counter() - t0
        saved = np.load(tmp / "map.npy")
        out.update(score=score, map_shape=list(sim_map.shape),
                   map_nan=int(np.isnan(sim_map).sum()),
                   map_finite_range=[float(np.nanmin(sim_map)), float(np.nanmax(sim_map))],
                   cli_printout=printout.getvalue().strip().splitlines())
        check(np.array_equal(saved, sim_map, equal_nan=True), "--save-map wrote another map")
        check(sim_map.shape == GROUND_HW and 0 < out["map_nan"] < sim_map.size
              and bool(np.isfinite(score)), f"grounding output: {out}")
        args = ground.build_parser().parse_args(flags)
        card = ground.build_engine(args)
        card.get_score_and_map_from_raw_data(png, GROUND_QUERY)  # warm-up
        walls, splits = [], []
        for _ in range(GROUND_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card.get_score_and_map_from_raw_data(png, GROUND_QUERY)
            walls.append(1e3 * (time.perf_counter() - t0))
        for _ in range(GROUND_REPEATS):
            splits.append(grounding_split(card, png))
        out["query_wall_ms_p50"] = statistics.median(walls)
        out["query_wall_ms"] = walls
        out["split_ms_p50"] = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
        if profile:
            profile_window("one grounding query",
                           lambda: card.get_score_and_map_from_raw_data(png, GROUND_QUERY), results)
        out["launches"] = read_counts()
        log(f"  (a) ground CLI: score {score:.6f}, map {sim_map.shape} with {out['map_nan']} NaN; "
            f"one query p50 {out['query_wall_ms_p50']:.2f} ms of {GROUND_REPEATS}, split p50 "
            f"{json.dumps(out['split_ms_p50'])}")
        check(all(v == 0 for v in out["launches"].values()),
              f"a kernel launched on the grounding path: {out['launches']}")
        log(f"  (c) launches on the grounding path: {json.dumps(out['launches'])}")

        cpu = ground.build_engine(ground.build_parser().parse_args([*flags, "--device", "cpu"]))
        b = {}
        img, _ = card.image_engine.load_and_transform_input_image(png)
        for name, eng in (("card", card), ("cpu", cpu)):
            g, pt = (t.cpu().numpy() for t in eng.image_engine.embed(img))
            sc, mp = eng.get_score_and_map_from_raw_data(png, GROUND_QUERY)
            b[name] = (g, pt, sc, mp)
        (g, pt, sc, mp), (g0, pt0, sc0, mp0) = b["card"], b["cpu"]
        ok = ~np.isnan(mp0)
        bf16 = ImageTextInferenceEngine(card.image_engine.model, card.text_engine,
                                        dtype=torch.bfloat16, device="cuda")
        low = bf16.image_engine.embed(img)[1].cpu().numpy()
        cos = np.sum(low * pt, -1).ravel()  # both L2-normalised
        out["card_vs_cpu"] = dict(
            global_max_abs=float(np.abs(g - g0).max()), patches_max_abs=float(np.abs(pt - pt0).max()),
            map_max_abs=float(np.abs(mp[ok] - mp0[ok]).max()), score_abs=abs(sc - sc0),
            same_nan=bool(np.array_equal(np.isnan(mp), np.isnan(mp0))),
            bf16_vs_fp32_patch_min_cos=float(cos.min()))
        log(f"  (b) fp32 (TF32 off), the card against its CPU; bf16 against fp32: "
            f"{json.dumps(out['card_vs_cpu'])}")
        c = out["card_vs_cpu"]
        check(max(c["global_max_abs"], c["patches_max_abs"], c["map_max_abs"]) <= MAP_ATOL
              and c["same_nan"], f"grounding, the card against its CPU: {c}")
        check(c["score_abs"] <= GROUND_SCORE_ATOL, f"grounding score, card vs CPU: {c}")
        check(c["bf16_vs_fp32_patch_min_cos"] > EMB_COS, f"grounding bf16 vs fp32: {c}")
    results["grounding"] = out


def scaled_err(got, ref) -> tuple:
    """(max |got - ref|, the same over max(1, max |ref|))."""
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = float(np.abs(got - ref).max())
    return err, err / max(1.0, float(np.abs(ref).max()))


def model_surface(results) -> None:
    """(d) at 512^2, fp32 (TF32 off): dilated ResNet-50 and ResNet-18, the
    card against its CPU; the space-to-depth stem against the standard stem
    on the same grayscale-folded weights; int8 sums of dilated convs, the
    card against the CPU's exact path; the two stems timed in turns."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.models import resnet as tr
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        biovil_image_forward,
        fold_grayscale_conv1,
        init_biovil_image_model,
        quantize_biovil_int8,
        space_to_depth_stem,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.quant import conv_int8_sums

    model = init_biovil_image_model(torch.Generator().manual_seed(0))  # on the CPU
    out = {}
    g = torch.Generator().manual_seed(17)
    x = torch.rand(1, 512, 512, 3, generator=g)
    dil = (False, False, True)
    r18 = tr.init_resnet18(torch.Generator().manual_seed(1))
    with torch.no_grad():
        for name, fwd, net in (
            ("resnet50 dilation (F, F, T)",
             lambda net, t: tr.resnet50_forward(net, t, replace_stride_with_dilation=dil),
             model.encoder),
            ("resnet18", tr.resnet18_forward, r18),
        ):
            cpu = fwd(net, x)
            card = fwd(net.cuda(), x.cuda()).cpu()
            net.cpu()
            err, rel = scaled_err(card, cpu)
            out[name] = dict(shape=list(card.shape), max_abs=err, max_abs_over_max_feature=rel,
                             max_feature=float(cpu.abs().max()))
            check(rel <= SURFACE_ATOL and bool(torch.isfinite(card).all()),
                  f"{name}, the card against its CPU: {out[name]}")
        check(out["resnet50 dilation (F, F, T)"]["shape"] == [1, 32, 32, 2048],
              "the dilated x4 grid is not 32 x 32")
        folded = fold_grayscale_conv1(model).cuda()
        s2d = space_to_depth_stem(folded)
        gray = x[..., :1].cuda()
        std_out = biovil_image_forward(folded, gray)
        s2d_out = biovil_image_forward(s2d, gray)
        stem = {}
        for key in ("projected_global_embedding", "projected_patch_embeddings"):
            err, rel = scaled_err(getattr(s2d_out, key).cpu(), getattr(std_out, key).cpu())
            stem[key] = dict(max_abs=err, max_abs_over_max=rel)
            check(rel <= SURFACE_ATOL, f"s2d stem vs the standard stem, {key}: {stem[key]}")
        out["s2d_vs_standard_stem"] = stem
        enc = quantize_biovil_int8(model).encoder
        sums = {}
        for name, conv, shape, kw in (
            ("layer4.0.conv2 3x3, stride 2 -> 1", enc.layer4[0].conv2, (1, 512, 32, 32),
             dict(stride=1, padding=1, dilation=1)),
            ("layer4.1.conv2 3x3, dilation 2", enc.layer4[1].conv2, (1, 512, 32, 32),
             dict(stride=1, padding=2, dilation=2)),
        ):
            xq = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
            xq = xq.contiguous(memory_format=torch.channels_last)
            want = conv_int8_sums(xq, conv.kernel_q, kw["stride"], kw["padding"], kw["dilation"])
            got = conv_int8_sums(xq.cuda(), conv.kernel_q.cuda(), kw["stride"], kw["padding"],
                                 kw["dilation"]).cpu()
            sums[name] = dict(shape=list(want.shape), equal=bool(torch.equal(got, want)))
            check(got.dtype == torch.int32 and sums[name]["equal"],
                  f"int8 dilated conv {name}: the card's sums differ")
        out["int8_dilated_sums"] = sums
        log(f"  (d) model surface at 512^2: {json.dumps(out)}")
        # the two stems at the extraction batch, bf16, in turns
        b, h, w, _ = STEM_SHAPE
        xs = torch.rand(b, 1, h, w, device="cuda", generator=torch.Generator(device="cuda")
                        .manual_seed(3)).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        stems = {"standard 7x7/2": folded.encoder.conv1, "space-to-depth 4x4": s2d.encoder.conv1}
        y_std, y_s2d = (tr.stem_conv_apply(c, xs) for c in stems.values())
        same = scaled_err(y_s2d.float().cpu(), y_std.float().cpu())
        times = alternating_ms({k: (lambda c=c: tr.stem_conv_apply(c, xs)) for k, c in stems.items()},
                               rounds=5, iters=20)
        bytes_moved = xs.numel() * 2 + y_std.numel() * 2
        flops = 2 * y_std.numel() * 49
        bound = max(bytes_moved / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3
        out["stem_times_ms"] = dict(**times, shape=list(STEM_SHAPE), out_shape=list(y_std.shape),
                                    bound_ms=bound, bf16_max_abs=same[0],
                                    bf16_max_abs_over_max=same[1])
        log(f"  (d) stems at {STEM_SHAPE} bf16, medians of 5 rounds in turns: "
            f"{json.dumps(out['stem_times_ms'])}")
        folded.cpu()
    results["model_surface"] = out


def native_store(bank, results) -> None:
    """(e) the native store at the reference's scale (191,027 x 128 + 5
    labels): write, open, one shuffled epoch at batch 6144 against the numpy
    batcher in turns; a joint run (bs 6144, eval bs 1024, 2 epochs,
    unshuffled, per-batch steps) over the store and over the same
    in-memory dataset, bit-equal, with K1 scoring every eval batch and the
    C++ batcher serving."""
    import math
    import statistics
    import tempfile

    import numpy as np

    from incremental_multimodal_medical_learning_ii_torch.data.native import (
        NativeEmbeddingStore,
        native_available,
        native_build_error,
    )
    from incremental_multimodal_medical_learning_ii_torch.data.store import (
        EmbeddingDataset,
        iterate_batches,
    )
    from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer
    from incremental_multimodal_medical_learning_ii_torch.utils.config import joint_config

    check(native_available(), f"the native store did not build: {native_build_error()}")
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_native_") as tmp:
        tmp = Path(tmp)
        training_data(tmp)
        train, val = EmbeddingDataset.load(tmp / "train.npz"), EmbeddingDataset.load(tmp / "val.npz")
        t0 = time.perf_counter()
        store = NativeEmbeddingStore.write(tmp / "train.embstore", train)
        out["write_s"] = time.perf_counter() - t0
        store.close()
        t0 = time.perf_counter()
        store = NativeEmbeddingStore(tmp / "train.embstore")
        out["open_s"] = time.perf_counter() - t0
        val_store = NativeEmbeddingStore.write(tmp / "val.embstore", val)
        out["file_bytes"] = (tmp / "train.embstore").stat().st_size
        check(store.native and val_store.native and store.n == TRAIN_ROWS,
              "the C++ runtime does not serve the store")

        def native_epoch():
            return sum(int(m.sum()) for _, _, m in store.iterate_batches(NATIVE_BS, shuffle=True,
                                                                         seed=7))

        def numpy_epoch():
            return sum(int(m.sum()) for _, _, m in iterate_batches(
                train, NATIVE_BS, shuffle=True, rng=np.random.default_rng(7)))

        epochs = {"native": [], "numpy": []}
        for r in range(3):
            for name in (["native", "numpy"] if r % 2 == 0 else ["numpy", "native"]):
                t0 = time.perf_counter()
                rows = native_epoch() if name == "native" else numpy_epoch()
                epochs[name].append(time.perf_counter() - t0)
                check(rows == TRAIN_ROWS, f"{name} epoch served {rows} rows")
        out["epoch_s"] = {k: statistics.median(v) for k, v in epochs.items()}
        out["epoch_batches"] = math.ceil(TRAIN_ROWS / NATIVE_BS)

        cfg = joint_config(batch_size=NATIVE_BS, eval_batch_size=EVAL_BS, epochs=2, lr=1e-4,
                           shuffle_train=False, fused_epoch=False, plot_figures="off")
        class Recorder:  # a writer that keeps every scalar
            enabled = True

            def __init__(self):
                self.rows = []

            def add_scalar(self, tag, value, step):
                self.rows.append((tag, int(step), float(value)))

        runs = {}
        for name, (tr_data, va_data) in (("native", (store, val_store)), ("in-memory", (train, val))):
            writer = Recorder()
            rec = writer.rows
            trainer = Trainer(cfg, bank, writer=writer, device="cuda")
            if name == "native":
                zero_counts()  # this slice's training path: the store's run
            t0 = time.perf_counter()
            aurocs = []
            for epoch in (1, 2):
                trainer.train(tr_data, epoch=epoch)
                aurocs.append(trainer.validate(va_data, epoch, 2)["auroc_macro"])
            wall = time.perf_counter() - t0
            if name == "native":
                out["launches"] = read_counts()
            runs[name] = (rec, aurocs, wall)
        (rec, aurocs, wall), (rec0, aurocs0, wall0) = runs["native"], runs["in-memory"]
        eval_batches = 2 * math.ceil(VAL_ROWS / EVAL_BS)
        out.update(run_wall_s={"native": wall, "in-memory": wall0}, aurocs=aurocs,
                   losses=sum(t.endswith("Loss") for t, _, _ in rec),
                   bit_equal=rec == rec0 and aurocs == aurocs0, expected_k1=eval_batches,
                   native_available=native_available(), served_native=store.native)
        log(f"  (e) native store: {json.dumps(out)}")
        check(out["bit_equal"] and out["losses"] > 0,
              "the runs over the store and over the in-memory dataset differ")
        check(out["launches"]["fused_cosine"] == eval_batches,
              f"K1 launched {out['launches']['fused_cosine']} times for {eval_batches} eval batches")
        check(out["launches"]["fused_bottleneck"] == 0 and out["launches"]["flash_attention"] == 0,
              "a kernel off the training path was launched")
        store.close()
        val_store.close()
    results["native_store"] = out


# ----------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler windows over one served batch, one "
                         "report-length text encode (flash and dense), one extraction "
                         "encode (K2 and cuDNN layer1) and one grounding query")
    args = ap.parse_args(argv)

    if not (REPO / PACKAGE / "csrc").is_dir():
        print(f"chip_smoke: {PACKAGE}/ not found beside this script; run it from a checkout",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        init_biovil_image_model,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops import cuda_build
    from incremental_multimodal_medical_learning_ii_torch.text.bank import (
        build_prompt_bank,
        synthetic_encode_fn,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
    )

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    results: dict = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"[1] card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    t0 = time.perf_counter()
    cuda_build.build()
    results["build_s"] = time.perf_counter() - t0
    log(f"[2] built {sorted(cuda_build.SOURCES)} in {results['build_s']:.1f} s")
    ptxas = ptxas_report(cuda_build)
    results["ptxas"] = ptxas
    for entry, rep in ptxas.items():
        log(f"  {entry}: {rep}")
    for entry, rep in ptxas.items():
        if "flash_fwd_bf16_kernel" in entry or K2_KERNEL in entry:
            check(rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0,
                  f"{entry} spills: {rep}")
    check(sum("flash_fwd_bf16_kernel" in e for e in ptxas) == 2, "no ptxas report for K3 bf16")
    check(sum(K2_KERNEL in e for e in ptxas) == 2, "no ptxas report for K2's two instantiations")

    model = init_biovil_image_model(torch.Generator().manual_seed(0))
    bank = build_prompt_bank(synthetic_encode_fn(27), create_prompts(CHEXPERT_COMPETITION_TASKS),
                             CHEXPERT_COMPETITION_TASKS)

    log("[3] kernels vs plain versions")
    folded, cases = kernel_checks(model, bank, results)
    log("[4] small-input check")
    results["small_card_vs_cpu"] = small_parity(model, bank)
    log("[5] serving path at full width")
    clfs, plain, images = serving(model, bank, results)
    log("[6] HTTP")
    http_phase(clfs["mean"], images)
    log("[7] times")
    time_kernels(folded, cases, results)
    serving_times(clfs, plain, images, results)
    if args.profile:
        profile_window("one batch of 16", lambda: clfs["mean"].predict_arrays(images[:16]), results)
    log("[8] flash attention vs its plain version")
    flash_checks(results)
    log("[9] text tower at full width, report length")
    bert, ids, mask = text_tower(results)
    log("[10] prompt bank from weights through the CLI")
    bank_from_weights(bert, images, results)
    log("[11] times: flash attention, text encodes")
    text_times(bert, ids, mask, results)
    if args.profile:
        profile_text(bert, ids, mask, results)
    log("[12] the paper's experiment at the reference's scale: K1 at the eval shapes, then the "
        "three drivers on the card (loops under sync debug mode) and on the CPU")
    eval_names = eval_kernel_checks(bank, results)
    train = training(bank, results)
    log("[13] extraction on the card: the CLI at its defaults and a resumed run, the indexed "
        "path, the card against its CPU, the int8 trunk, the device encode with K2 against "
        "cuDNN, reproduce --rehearsal, serving --adapter-checkpoint")
    k2x = extraction(model, results, args.profile)
    log("[14] phrase grounding through the CLI at full width (BioViL ResNet-50 at 480^2, "
        "BERT-base), the card against its CPU; dilated ResNet-50, ResNet-18 and the "
        "space-to-depth stem; the native store at the reference's scale")
    grounding(bert, results, args.profile)
    model_surface(results)
    native_store(bank, results)

    k1 = results["cosine_times"]["serve-mean (16x10)"]
    k2 = results["layer_times"]["(16, 128, 128, 64)"]
    k3 = results["flash_times"]["bfloat16"]
    kernels = [
        dict(name="fused_cosine", route="cuda", source=f"{PACKAGE}/csrc/fused_cosine.cu",
             replaces="incremental_multimodal_medical_learning_ii_tpu/ops/pallas_cosine.py:32",
             launches=results["launches"]["fused_cosine"],
             max_abs_err=max(results["cosine_check"].values()),
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=k1["library_ms"],
             kernel_device_ms=k1["kernel_device_ms"]),
        dict(name="fused_bottleneck", route="cuda", source=f"{PACKAGE}/csrc/fused_bottleneck.cu",
             replaces="incremental_multimodal_medical_learning_ii_tpu/ops/pallas_bottleneck.py:117",
             launches=results["launches"]["fused_bottleneck"],
             max_abs_err=results["layer_check"]["(16, 128, 128, 64)"]["max_abs_err"],
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=k2["library_ms"],
             kernel_device_ms=k2["kernel_device_ms"], tflops=k2["tflops"]),
        dict(name="flash_attention", route="cuda", source=f"{PACKAGE}/csrc/flash_attention.cu",
             replaces="incremental_multimodal_medical_learning_ii_tpu/models/cxr_bert.py:197",
             launches=results["text_tower"]["launches"]["flash_attention"],
             max_abs_err=results["flash_check"]["report (32,12,512,64) bfloat16"]["max_abs_err"],
             ms=k3["ms"], plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
             bound_by=k3["bound_by"], library_ms=k3["library_ms"],
             kernel_device_ms=k3["kernel_device_ms"],
             skipped_tile_share=k3["skipped_tile_share"], tflops_needed=k3["tflops_needed"]),
    ]
    for name in eval_names:  # K1 at the eval passes' shapes, launched by the training runs
        k = results["cosine_eval"][name]
        kernels.append(dict(
            name=f"fused_cosine ({name})", route="cuda", source=f"{PACKAGE}/csrc/fused_cosine.cu",
            replaces="incremental_multimodal_medical_learning_ii_tpu/ops/pallas_cosine.py:32",
            launches=train["k1_launches"][name], max_abs_err=k["max_abs_err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            library_ms=k["library_ms"], kernel_device_ms=k["kernel_device_ms"]))
    kernels.append(dict(  # K2 in the extraction encode (phase 13e), batch 128 at 512^2
        name=f"fused_bottleneck (extraction {'x'.join(map(str, k2x['shape']))})", route="cuda",
        source=f"{PACKAGE}/csrc/fused_bottleneck.cu",
        replaces="incremental_multimodal_medical_learning_ii_tpu/ops/pallas_bottleneck.py:117",
        launches=results["device_encode"]["k2_launches"], max_abs_err=k2x["max_abs_err"],
        ms=k2x["ms"], plain_ms=k2x["plain_ms"], bound_ms=k2x["bound_ms"],
        bound_by=k2x["bound_by"], library_ms=k2x["library_ms"],
        kernel_device_ms=k2x["kernel_device_ms"], tflops=k2x["tflops"]))
    k1n = results["cosine_eval"][eval_names[0]]  # K1 at the eval shape of the store's run (14e)
    kernels.append(dict(
        name=f"fused_cosine (native store {eval_names[0]})", route="cuda",
        source=f"{PACKAGE}/csrc/fused_cosine.cu",
        replaces="incremental_multimodal_medical_learning_ii_tpu/ops/pallas_cosine.py:32",
        launches=results["native_store"]["launches"]["fused_cosine"],
        max_abs_err=k1n["max_abs_err"], ms=k1n["ms"], plain_ms=k1n["plain_ms"],
        bound_ms=k1n["bound_ms"], bound_by=k1n["bound_by"], library_ms=k1n["library_ms"],
        kernel_device_ms=k1n["kernel_device_ms"]))
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t_start
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    log(f"total {results['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
