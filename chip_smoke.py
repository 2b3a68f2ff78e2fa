#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout, one card
    python3 chip_smoke.py --profile  # also torch.profiler windows (a batch, a text encode)

Phases, in order; any failure ends the script with a non-zero exit code
and without the final result line:

1. the card, as ``nvidia-smi --query-gpu=name,power.limit`` reports it;
2. build every hand-written kernel of the serving path from ``csrc/``
   (one ``nvcc`` per source, in parallel); the ``ptxas -v`` report of every
   instantiation (no spills allowed in K3's bf16 kernel);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it (fp32 with TF32 off); K1 and K3 refuse
   an operand that requires grad under grad mode (no backward kernel);
4. small-input check: the fp32 classifier on the card against the same
   classifier on the CPU (plain versions);
5. the serving path at full width: ``ChexpertClassifier`` with seeded
   random BioViL ResNet-50 weights, the synthetic bank of the 5
   competition tasks, 512^2 crops, batch 16, bf16, ``fused_layer1=True``,
   in MEAN then MAX mode, with the kernels' launch counts read around it;
   compared with the stock cuDNN forward and the plain scorer;
6. HTTP: ``make_server`` with micro-batching, concurrent requests;
7. times with CUDA events (kernels, plain versions, library calls; K1
   against ``torch.matmul`` as medians of 5 rounds in turns) and
   host-clock serving latency;
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
   build.

It prints the kernels' JSON line, the card line, and as its last line
``{"ok": true, "device": {...}}``.  A copy of the results goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import base64
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
        "eval (6144x10)": (torch.randn(6144, d, device=dev, generator=g), mean_bank),
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
    folded = {k: [t.to(dev) for t in v] for k, v in fold_bottleneck_layer(model.encoder.layer1).items()}
    layer_err = {}
    for shape in LAYER_SHAPES:
        x = torch.randn(*shape, device=dev, generator=g).abs().to(torch.bfloat16)
        got = fused_bottleneck_layer(x, folded)
        ref = fused_bottleneck_layer_reference(x, folded)
        floor = layer_metrics(ref, fused_bottleneck_layer_reference(x, folded, torch.float64))
        m = layer_metrics(got, ref)
        block_rel, t = [], x
        for bi in range(len(folded["w1"])):
            one = {k: v[bi:bi + 1] if k != "wd" else (v if bi == 0 else []) for k, v in folded.items()}
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
                 "eval (6144x10)"):
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
        ms = cuda_time_ms(lambda: fused_bottleneck_layer(x, folded), 20)
        layer_times[str(shape)] = dict(
            ms=ms, plain_ms=cuda_time_ms(lambda: fused_bottleneck_layer_reference(x, folded), 5),
            library_ms=cuda_time_ms(lambda: lib(x), 20), bound_ms=bound, bound_by=by,
            tflops=flops / ms / 1e9, library_cos_vs_plain=lib_cos,
            kernel_device_ms=profiled_device_ms(lambda: fused_bottleneck_layer(x, folded),
                                                fused_bottleneck_layer, "conv_gemm_kernel", ms,
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
    log(f"  main path: 2 modes x (48 + 1 lone) images in {wall:.3f} s; launches {launches}; "
        f"peak device memory {peak:.2f} GiB")
    check(launches["fused_cosine"] > 0, "the serving path never launched the fused cosine kernel")
    check(launches["fused_bottleneck"] > 0, "the serving path never launched the fused layer1 kernel")
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


def bank_from_weights(model, images, results):
    """The serving CLI builds its bank from BERT-base weights in the
    reference's formats, on the card, and serves a batch with it."""
    import shutil
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
    from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import write_test_vocab

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        sd = reference_state_dict(model)
        torch.save(sd, tmp / "cxr_bert.pt")
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
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler windows over one served batch and one "
                         "report-length text encode (flash and dense)")
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
        if "flash_fwd_bf16_kernel" in entry:
            check(rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0,
                  f"{entry} spills: {rep}")
    check(sum("flash_fwd_bf16_kernel" in e for e in ptxas) == 2, "no ptxas report for K3 bf16")

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
             kernel_device_ms=k2["kernel_device_ms"]),
        dict(name="flash_attention", route="cuda", source=f"{PACKAGE}/csrc/flash_attention.cu",
             replaces="incremental_multimodal_medical_learning_ii_tpu/models/cxr_bert.py:197",
             launches=results["text_tower"]["launches"]["flash_attention"],
             max_abs_err=results["flash_check"]["report (32,12,512,64) bfloat16"]["max_abs_err"],
             ms=k3["ms"], plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
             bound_by=k3["bound_by"], library_ms=k3["library_ms"],
             kernel_device_ms=k3["kernel_device_ms"],
             skipped_tile_share=k3["skipped_tile_share"], tflops_needed=k3["tflops_needed"]),
    ]
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
