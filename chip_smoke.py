#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout, one card
    python3 chip_smoke.py --profile  # also torch.profiler windows (phases 7, 11, 13, 14, 17)
    python3 chip_smoke.py --mesh-only  # phases 1, 2 and 15 alone; no result line

Phases, in order (their numbers stay fixed, as other documents cite them
by number, so there is no 20); any failure ends the script with a non-zero exit code
and without the final result line:

1. the card, as ``nvidia-smi --query-gpu=name,power.limit`` reports it;
2. build every hand-written kernel from ``csrc/`` (one ``nvcc`` per
   source, in parallel); the ``ptxas -v`` report of every instantiation (no
   spills allowed in K3's bf16 and fp32 kernels, K3b's bf16 kernels nor
   K2);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it (fp32 with TF32 off); K2 at both
   serving crops, (3, 40, 24, 64) and ragged tiles ((3, 37, 21, 64), an
   image smaller than a tile), each block alone and the chained layer; K1
   and K2 refuse an operand that requires grad under grad mode (they have
   no backward kernel), and K3 differentiates: its backward launches K3b;
4. small-input check: the fp32 classifier on the card against the same
   classifier on the CPU (plain versions);
5. the serving path at full width: ``ChexpertClassifier`` with seeded
   random BioViL ResNet-50 weights, the synthetic bank of the 5
   competition tasks, 512^2 crops, batch 16, bf16, ``fused_layer1=True``,
   in MEAN then MAX mode, with the kernels' launch counts read around it
   (K2: one launch per bottleneck block, 3 per forward); compared with the
   stock cuDNN forward and the plain scorer;
6. HTTP: ``make_server`` with micro-batching, then with its default lock,
   concurrent requests each way;
7. times with CUDA events (kernels, plain versions, library calls; K1
   against ``torch.matmul`` and K2 against the cuDNN bf16 chain as medians
   of 5 rounds in turns) and host-clock serving latency;
8. the flash-attention kernel against its plain version on the card:
   BERT-base report length (32, 12, 512, 64) with ragged lengths, hd 128,
   S = 77 and 200 with padding, a row with one valid token, lengths on
   every edge of a 64-row block, a batch with every row full, and queries
   whose segment no key shares (different q and kv ids), in fp32 (TF32
   off) and bf16; in both types the kernel with key-tile skipping equals
   itself without (kv ids cloned) bit for bit, and the key tiles it
   computed, counted on the card, are the ones its predicate keeps; then
   K3 at the DINOv2 tower's shape (512, 24, 1374, 64) bf16, one segment,
   q, k and v split views of one qkv product as the tower makes them, the
   whole batch in one launch: four batch rows (the first three and the
   last) against the plain version, its launches in one tower forward at
   the published widths, and times in turns with SDPA;
9. the CXR-BERT text tower at full width (BERT-base, seeded random
   weights) and report length (batch 32, seq 512, ragged masks):
   ``get_projected_text_embeddings(use_flash_attention=True)`` against the
   dense path, in bf16 and fp32, with the flash kernel's launches read
   around it (12 per encode, the fp32 encode's read on their own);
10. the prompt bank from weights in the reference's formats, through the
   classify CLI on the card: a BERT-base state dict (``torch.save``) +
   vocab, and an HF snapshot directory; both banks agree and match the CPU
   build; one batch served with the bank;
11. times: the flash kernel (CUDA events, in turns with SDPA as the
   library yardstick and with skipping off; the plain version) in bf16 and
   fp32 at report length and at hd 128, with the key tiles it computed;
   text encodes in prompts/s (flash and dense at report length in bf16 and
   fp32, dense at the bank's shape) and the bank build;
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
   batch, the C++ batcher serving;
15. the data-parallel mesh (``parallel/mesh.py``): K1-mesh at two gloo
   ranks sharing the card; one NCCL rank through the three drivers against
   no mesh; the same at two gloo ranks; extraction with ``mesh=``; two NCCL
   ranks where two cards are visible;
16. sweeps and the text tower's partitions: (a) ``cli/sweep.py`` at phase
   12's scale (4 lrs x 2 seeds, MEAN, Adam, 3 epochs) with ``--vmap``
   (upload to readback under ``set_sync_debug_mode("error")``) and
   sequentially, K1 once an eval batch of every point in both, each
   point's mean AUROC vmapped vs sequential (2e-4), the vmapped sweep at a
   small size the card against its CPU (1e-3); (b) TP (``model=2``), SP
   (``seq=2``) and PP (``pipe=2``, 4 microbatches) at BERT-base width and
   depth on two gloo ranks sharing the card against the one-rank dense
   encode (fp32 5e-5, bf16 row cos > 0.999; TP also at the bank's shape),
   the prompt bank through ``TextInferenceEngine(mesh=)`` (3e-5), gradients
   at 2 layers (5e-5 of the largest), prompts/s beside one rank's; (c) the
   same on two NCCL ranks where two cards are visible;
17. K3b, the flash-attention backward (``csrc/flash_attention_bwd.cu``):
   (a) against its plain backward at phase 8's cases, fp32 (TF32 off, 1e-5
   of each gradient's largest entry) and bf16 (cos > 0.999 a tensor), from
   the forward's own o and log-sum-exp; the forward's o with the lse output
   equals o without it bit for bit, its lse equals the plain forward's;
   the pairs each pass computed, counted on the card, are the predicate's;
   with one id array skipping on equals skipping off (a copy of the ids)
   bit for bit, and two launches give the same bits;
   (b) the gradient of sum(w * get_projected_text_embeddings(
   use_flash_attention=True)) at BERT-base, phase 9's batch, with respect
   to every parameter and the input embeddings, against the dense path
   (fp32 5e-5 of the largest gradient, bf16 cos > 0.999 a parameter), with
   K3's and K3b's launches read around it (12 each), one gradient's time
   through flash and dense in turns, in bf16 and fp32; (c) times: K3b in
   turns with itself with skipping off and with SDPA's backward, the plain
   backward, the forward with and without the lse, the profiler's device
   time, TFLOP/s, each K3b kernel's ``ptxas -v`` line; (d) the profiling tools:
   ``zero_joint_bounds --trace-dir`` (its spans and K1's kernel in the
   trace), ``extract_embeddings(trace_dir=)``, ``device_encode_rate`` at
   the root bench.py's shape with and without K2;
18. the figures: (a) ``zero_joint_bounds`` joint at phase 12's scale with
   ``--plot-figures reference --tsne-plots`` and with ``--plot-figures
   off``, in turns, the fused loops under sync debug mode, with the walls,
   the image events (640 x 480 RGB) and K1's launches (= phase 12's joint
   run's; past ``FIGURE_CUT_AFTER_S`` seconds of script the runs take 2
   epochs, said so); (b) the exact t-SNE on the card at the t-SNE subsets'
   1,000 and 800 rows (CUDA events); (c) the card against its CPU on the
   same inputs: heatmap, curve, PCA and prompt-cosine data (1e-6), the
   t-SNE's KL (5%) and its 10 nearest neighbours (a share of 0.2 at
   least); (d) ``ground --out``, ``dataset_stats --patterns-png`` and
   ``analyze_prompts`` write decodable PNGs of the JAX figures' sizes;
19. link health on the card (``cli/linkhealth.py``): ``main`` at its
   defaults gives backend "cuda" and verdict "ok" with 0 < rtt_ms <= 20,
   upload_mb_per_s > 0 and 0 < compile_s < 30 (a fresh ``nvcc`` build, a
   launch and a readback); a second run (``--compile-slow-s 0``) builds a
   new salt and says "degraded-compile"; ``_build/`` lists the same files
   before and after; deadlines of 0.01 s give null legs and "timeout" and
   leave no toolchain process running; ``quick_probe`` returns rtt and
   upload and prints nothing; the probe's median upload is within 3x of
   the same 8 MiB pageable copy timed here with CUDA events;
21. a training epoch as a CUDA graph (``engine/steps.py::EpochGraph``): the
   joint, data-incremental (20 parts, myCL, ``--fused-unit``) and
   class-incremental (MORE_LABELS MAX) drivers at phase 12's scale, their
   fused loops under sync debug mode, graphed and forced onto the eager
   loop on the same inputs: the staged losses, eval outputs and per-epoch
   / per-unit states and the final parameters bit for bit; one capture a
   Trainer, a replay an epoch, ``train_steps`` the eager run's and no
   ``train-step`` span; device memory back to its level once a Trainer is
   gone (after the process's first capture), a joint run's peak below
   2 GiB; the joint run on one NCCL rank stays eager; ms an epoch of the
   joint run both ways, in turns, and the first graphed call (capture);
22. the conv epilogue (``csrc/conv_epilogue.cu``): bit for bit its plain
   version at every (C, H, W, residual, ReLU) a 512^2 BioViL forward gives
   it, at batch 2 and 512; its refusals (fp32, NCHW, C not a multiple of 8,
   a misaligned tensor, an operand that requires grad); a bf16 forward at
   (4, 512, 512) with it against the chain of torch ops and both against
   fp32; 50 launches a forward; the forward at batch 512 both ways in turns
   and its memory peak (no higher fused); each case's ms at batch 512 in
   turns with the chain it replaces, against its byte bound, and the
   profiler's device time and the plain version's at the largest.

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
# K3 at the DINOv2 tower's shape, relative L2 over the compared rows: the bf16
# output's own rounding reads ~2e-3; a kernel that lost the last, column-masked
# key tile (30 of 1,374 keys) would read ~0.15
VIT_FLASH_REL = 1e-2
VIT_FLASH = (512, 24, 1374, 64)  # DINOv2 ViT-g/14-reg at 518^2, batch 512: (B, nh, S, hd)
TEXT_BF16_COS = 0.999  # flash vs dense encode, per batch row (valid positions) and projection
TEXT_F32_ATOL = 1e-4  # flash vs dense projected embeddings, fp32
BANK_ATOL = 3e-5  # the BERT parity tolerance: the card's bank vs the CPU build
LAYER_SHAPES = [(16, 128, 128, 64), (2, 120, 120, 64)]  # 512^2 batch 16; the 480 crop
# + a small crop, and K2's ragged 8 x 8 tiles: on both axes, and an image smaller than a tile
LAYER_CHECK_SHAPES = LAYER_SHAPES + [(3, 40, 24, 64), (3, 37, 21, 64), (1, 5, 7, 64)]
K2_KERNEL = "bottleneck_block_kernel"
K3_KERNELS = ("flash_fwd_bf16_kernel", "flash_fwd_f32_kernel")  # hd 64 and 128 each
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
    # K1 has no backward kernel: an operand that requires grad is refused
    # under grad mode (on every device, as jax.grad through the Pallas
    # kernel fails), never scored into a result cut from autograd.  K3
    # differentiates: its backward is K3b (phase 17 holds it to its plain
    # version)
    from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )

    xg = torch.randn(16, d, device=dev, generator=g).requires_grad_(True)
    check(raises(lambda: fused_pairwise_cosine(xg, mean_bank)), "K1 took an operand that requires grad")
    check(raises(lambda: fused_pairwise_cosine(mean_bank, xg)), "K1 took a bank that requires grad")
    qg = torch.randn(1, 2, 64, 64, device=dev, generator=g).requires_grad_(True)
    ones = torch.ones(1, 64, dtype=torch.int32, device=dev)
    before = flash_attention_bwd.launches
    out = flash_attention(qg, qg.detach(), qg.detach(), ones, ones)
    check(out.grad_fn is not None, "K3's result carries no backward for a q that requires grad")
    (dq,) = torch.autograd.grad(out.sum(), qg)
    torch.cuda.synchronize()
    check(flash_attention_bwd.launches == before + 1 and dq.shape == qg.shape
          and bool(torch.isfinite(dq).all()), "K3's backward did not launch K3b")
    with torch.no_grad():
        check(fused_pairwise_cosine(xg, mean_bank).shape == (16, 10), "K1 under no_grad")
        check(flash_attention(qg, qg, qg, ones, ones).shape == qg.shape, "K3 under no_grad")
    log("  K1 refuses an operand that requires grad under grad mode; K3 differentiates "
        "(one K3b launch); both run under no_grad")
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
                       iters: int = 50, tries: int = 3, per_launch: int = 1):
    """Device time of one call's kernels named ``kernel``, from the
    profiler's CUDA rows (CUDA events over back-to-back calls measure the
    host's launch rate when a kernel runs for microseconds).

    The time per call is the mean over the ``kernel`` rows the profiler
    recorded, times the launches ``wrapper`` counted per call and the
    ``per_launch`` kernels each launch runs (the profiler may drop a row of
    a window).  A reading is kept only if it can be true:
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
        ms = (sum(e.self_device_time_total for e in rows) / max(recorded, 1) * launched
              * per_launch / iters / 1e3)
        if (launched > 0 and recorded >= 0.9 * launched * per_launch
                and bound_ms <= ms <= 1.1 * event_ms):
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
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    outs = {}
    t0 = time.perf_counter()
    for mode, clf in clfs.items():
        outs[mode] = (clf.predict_arrays(images), clf.predict_arrays(images[-1:]))
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    # one image forward per batch of 16 (the lone image is a batch of its own)
    forwards = len(clfs) * (-(-len(images) // kw["batch_size"]) + 1)
    log(f"  main path: 2 modes x (48 + 1 lone) images in {wall:.3f} s; launches {launches} "
        f"over {forwards} forwards; peak device memory {peak:.2f} GiB")
    check(launches["fused_cosine"] > 0, "the serving path never launched the fused cosine kernel")
    check(launches["fused_bottleneck"] == 3 * forwards,
          f"K2 launched {launches['fused_bottleneck']} times, not 3 per forward ({forwards})")
    check(launches["conv_epilogue"] == EPILOGUE_LAUNCHES_K2 * forwards,
          f"the conv epilogue launched {launches['conv_epilogue']} times, not "
          f"{EPILOGUE_LAUNCHES_K2} per forward ({forwards})")
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

    bodies = [png(im) for im in images[:3]]
    batch = json.dumps({"images_b64": [base64.b64encode(png(im)).decode() for im in images[3:5]]})
    direct, _ = clf.predict_arrays(images[:5])
    k1 = counters()["fused_cosine"]
    # micro-batched, then the default lock (``cli/serve.py --microbatch-ms 0``)
    for mode, window_s in (("micro-batched", 0.005), ("locked", 0.0)):
        srv = make_server(clf, "127.0.0.1", 0, microbatch_s=window_s)
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
            check(status == 200 and health["platform"] == "cuda", f"{mode} healthz: {status} {health}")
            out = {}

            def worker(i):
                if i < 3:
                    out[i] = request("POST", "/classify", bodies[i], "image/png")
                else:
                    out[i] = request("POST", "/classify", batch, "application/json")

            k1.launches = 0
            threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
                check(not t.is_alive(), f"a {mode} HTTP request hung")
            launched = k1.launches
            for i in range(4):
                status, payload = out[i]
                n = 1 if i < 3 else 2
                check(status == 200, f"{mode} request {i}: {status} {payload}")
                got = np.asarray(payload["scores"], np.float32)
                check(got.shape == (n, 5), f"{mode} request {i}: shape {got.shape}")
                want = direct[i : i + 1] if i < 3 else direct[3:5]
                check(float(np.abs(got - want).max()) < 1e-3, f"{mode} request {i}: scores differ")
            check(launched > 0, f"the {mode} server never launched K1")
            dispatches = (f"{srv.microbatcher.dispatches} device dispatches"
                          if srv.microbatcher is not None else "turns under the lock")
            log(f"  HTTP {mode}: healthz {health['device']}; 4 concurrent /classify requests "
                f"answered in {dispatches}, K1 launched {launched} times")
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
BLOCK_PAIR = 64 * 64  # (query, key) pairs of one (64-query block, 64-key tile) pair


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
    """The (64-query block, 64-key tile) pairs that one launch computed,
    summed over heads, as the kernel counts them on the card."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import (
        flash_attention,
    )

    count = torch.zeros(1, dtype=torch.int32, device=q.device)
    flash_attention(q, k, v, seg_q, seg_kv, scale, computed_tiles=count)
    return int(count.item())


def tile_counts(q, k, v, seg, scale) -> dict:
    """Key tiles of one call with self segment ids (bf16 or fp32), counted
    on the card, against the predicate's count (``key_tiles_needed``, per
    head) and the pairs there are; the kernel with kv ids that are a copy
    (no skipping) must compute every pair."""
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


# phase 8's cases (and phase 17a's): report length, hd 128, S = 77 and 200
# with padding, a one-token row, lengths on every edge of a 64-row block,
# full rows, and queries whose segment no key shares
def flash_cases():
    return [
        ("report (32,12,512,64)", REPORT, ragged_lengths(REPORT[0], REPORT[2], seed=1)),
        ("hd128 (4,4,256,128)", (4, 4, 256, 128), [256, 200, 130, 17]),
        ("S=77 (2,12,77,64)", (2, 12, 77, 64), [77, 40]),
        ("S=200 (3,12,200,64), a one-token row", (3, 12, 200, 64), [200, 1, 123]),
        ("block edges (6,12,512,64)", (6, 12, 512, 64), [1, 63, 64, 65, 300, 512]),
        ("all rows full (4,12,512,64)", (4, 12, 512, 64), [512] * 4),
        ("lonely queries (2,12,200,64)", (2, 12, 200, 64), [200, 150]),
    ]


def flash_checks(results):
    """Kernel 3 against its plain version (fp32 from the same inputs)."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import (
        flash_attention,
        mha_reference,
    )

    cases = flash_cases()
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

    # Skipping is exact: in both types the kernel with skipping (q and kv
    # share one id array) equals itself without (a clone as kv) bit for
    # bit, in every case above with self segments; and it skipped the tiles
    # its predicate rules out, counted on the card
    skips = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, shape, lengths) in enumerate(cases):
            if name.startswith("lonely"):
                continue
            q, k, v, seg, scale = flash_inputs(shape, lengths, dtype, seed=10 + i)
            same = torch.equal(flash_attention(q, k, v, seg, seg, scale),
                               flash_attention(q, k, v, seg, seg.clone(), scale))
            counts = tile_counts(q, k, v, seg, scale)
            key = f"{name} {str(dtype).split('.')[-1]}"
            skips[key] = dict(bit_equal=same, **counts)
            log(f"  K3 {key}: computed {counts['computed']} of {counts['tiles']} key tiles "
                f"({counts['skipped_tile_share']:.4f} skipped, as the predicate says); with "
                f"skipping == without: {same}")
            check(same, f"flash {key}: skipping changed the result")
    results["flash_skip_check"] = skips


def vit_flash_phase(results):
    """K3 where the DINOv2 tower runs it (``models/dinov2.py::_attention``):
    (512, 24, 1374, 64) bf16, S not a multiple of 64 (the last key tile is
    masked by column), one segment, q, k and v strided views of one (B, S,
    3 x 1536) product.  The whole batch in one launch; four of its rows
    (the first three and the last) against the plain fp32 version (the
    whole batch's fp32 logits would be 92 GB); K3's launches in one forward
    of the tower at its published widths (one a block); CUDA events in turns
    with SDPA on contiguous copies, the profiler's device time, and the
    bound (operations at the bf16 peak here)."""
    import torch
    import torch.nn.functional as F

    from incremental_multimodal_medical_learning_ii_torch.models import dinov2 as vit
    from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import (
        flash_attention,
        mha_reference,
    )

    b, nh, s, hd = VIT_FLASH
    g = torch.Generator(device="cuda").manual_seed(91)
    qkv = torch.randn(b, s, 3 * nh * hd, device="cuda", generator=g).to(torch.bfloat16)
    q, k, v = (t.reshape(b, s, nh, hd).transpose(1, 2) for t in qkv.split(nh * hd, dim=-1))
    check(not q.is_contiguous(), "the tower's q is a strided view")
    ids = torch.ones((b, s), dtype=torch.int32, device="cuda")
    scale = hd ** -0.5
    with torch.no_grad():
        got = flash_attention(q, k, v, ids, ids, scale)
        rows = torch.tensor([0, 1, 2, b - 1], device="cuda")
        ref = mha_reference(q[rows].float(), k[rows].float(), v[rows].float(), ids[rows], ids[rows], scale)
        out = got[rows].float()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        rel = float(torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref))
        cos = float((out * ref).sum() / (out.norm() * ref.norm()))
        log(f"  K3 at the tower's shape {VIT_FLASH} bf16, rows 0-2 and {b - 1}: max|kernel - plain| = "
            f"{err:.3e} (bar {FLASH_BF16_ATOL:g}), relative L2 {rel:.3e} (bar {VIT_FLASH_REL:g}), "
            f"cos {cos:.8f} (bar {FLASH_BF16_COS})")
        check(bool(torch.isfinite(got).all()), "K3 at the tower's shape: not finite")
        check(err <= FLASH_BF16_ATOL and rel <= VIT_FLASH_REL and cos > FLASH_BF16_COS,
              f"K3 at the tower's shape off: max {err}, relative L2 {rel}, cos {cos}")
        del got, ref, out
        # the launches on the main path: one tower forward at the published widths
        with torch.device("cuda"):
            tower = vit.Dinov2(vit.dinov2_vitg14_reg())
        pixels = torch.rand(1, 518, 518, 3, device="cuda")
        before = flash_attention.launches
        vit.dinov2_forward(tower, pixels, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        launches = flash_attention.launches - before
        check(launches == tower.dims.depth, f"{launches} K3 launches in a tower forward, not {tower.dims.depth}")
        del tower, pixels
        bound, by, flops, _ = flash_bound_ms(q, ids)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))  # SDPA's own layout, made once
        kernel = lambda: flash_attention(q, k, v, ids, ids, scale)  # noqa: E731
        library = lambda: F.scaled_dot_product_attention(qc, kc, vc, scale=scale)  # noqa: E731
        lib_err = float((library()[rows].float() - mha_reference(
            q[rows].float(), k[rows].float(), v[rows].float(), ids[rows], ids[rows], scale)).abs().max())
        med = alternating_ms({"kernel": kernel, "library": library}, rounds=5, iters=10)
        device_ms = profiled_device_ms(kernel, flash_attention, "flash_fwd_bf16_kernel", med["kernel"],
                                       bound, iters=10)
    res = dict(shape=list(VIT_FLASH), max_abs_err=err, rel_l2=rel, cos=cos, library_max_abs_err=lib_err,
               launches_per_forward=launches, ms=med["kernel"], library_ms=med["library"],
               kernel_device_ms=device_ms, plain_ms=None, bound_ms=bound, bound_by=by,
               tflops=flops / med["kernel"] / 1e9, library_tflops=flops / med["library"] / 1e9)
    log(f"  K3 {VIT_FLASH} bf16: {med['kernel']:.3f} ms ({res['tflops']:.1f} TFLOP/s), device "
        f"{device_ms} ms; SDPA {med['library']:.3f} ms (max|SDPA - plain| {lib_err:.3e}); bound "
        f"{bound:.3f} ms by {by}; {launches} launches a tower forward")
    results["vit_flash"] = res
    del qkv, q, k, v, qc, kc, vc
    torch.cuda.empty_cache()
    return res


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
        bf16_flash = flash_attention.launches
        proj_32 = get_projected_text_embeddings(model, ids, mask, use_flash_attention=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        launches["flash_attention fp32 encode"] = flash_attention.launches - bf16_flash
        dense_proj_bf = get_projected_text_embeddings(model, ids, mask, dtype=bf16)
        dense_hid_bf = bert_encode(model, ids, mask, dtype=bf16)
        dense_proj_32 = get_projected_text_embeddings(model, ids, mask)
    log(f"  main path: 3 encodes of (32, 512) (bf16 projected, bf16 hidden, fp32 projected) "
        f"in {wall:.3f} s; launches {launches}")
    check(launches["flash_attention"] == 3 * model.dims.num_layers,
          f"flash_attention launched {launches['flash_attention']} times, not 12 per encode")
    check(launches["flash_attention fp32 encode"] == model.dims.num_layers,
          f"the fp32 encode launched flash_attention {launches['flash_attention fp32 encode']} times")
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
            ("bfloat16 hd128", (4, 4, 256, 128), [256, 200, 130, 17], torch.bfloat16),
            ("float32 hd128", (4, 4, 256, 128), [256, 200, 130, 17], torch.float32)):
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
        # the same kernel with skipping off: kv ids are a copy
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
        counts = tile_counts(q, k, v, seg, scale)  # the skipped share, counted by the kernel
        times[name].update(counts, tflops_computed=counts["computed"] * BLOCK_PAIR * 4 * shape[3]
                           / med["ms"] / 1e9)
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
            "report (32, 512) fp32 flash": (ids, mask, torch.float32, True),
            "report (32, 512) fp32 dense": (ids, mask, torch.float32, False),
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
TRAIN_BS, TRAIN_EPOCHS = 6144, 10
TRAIN_FLAGS = ["--batch-size", str(TRAIN_BS), "--lr", "1e-4", "--epochs", str(TRAIN_EPOCHS),
               "--plot-figures", "off"]
K1_EVAL_ATOL = 1e-6
CPU_LOSS_ATOL = 1e-5  # CUDA run vs the same run on the CPU: train/Loss, val/Loss
CPU_AUROC_ATOL = 1e-3  # val/test AUROC-macro
# myCL reset counts per step, as a share of the weights compared: held for
# every step of one step from the same state on the card and on the CPU,
# and for 99% of the steps of two whole runs (their trajectories drift
# apart by fp32 noise, and a weight near the reset cutoff flips: the knife
# edge of PARITY.md:172-185; the largest share is reported)
RESET_SHARE = 0.005
# the CPU reference runs on at most the one-card machine's 8 threads on any
# host: its summation order, and so a whole run's fp32 drift, follows the
# thread count (class-incremental MAX at 32 threads: 1.17e-5 from the card)
CPU_REFERENCE_THREADS = 8
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


def k1_case(x, t, atol: float) -> dict:
    """K1 at (x, t) against its plain version, with the times of phase 7:
    event medians in turns with ``torch.matmul`` of the normalised rows,
    the plain version's time, the bound, the profiler's device time."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.ops.cosine import l2_normalize
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
        fused_pairwise_cosine,
        pairwise_cosine,
    )

    got, ref = fused_pairwise_cosine(x, t), pairwise_cosine(x, t)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    check(err <= atol, f"K1 at {tuple(x.shape)} x {tuple(t.shape)}: off by {err}")
    xn, tn = l2_normalize(x), l2_normalize(t)
    bound, by = cosine_bound_ms(x.shape[0], t.shape[0])
    med = alternating_ms({"ms": lambda: fused_pairwise_cosine(x, t),
                          "library_ms": lambda: torch.matmul(xn, tn.T)}, iters=200)
    return dict(
        max_abs_err=err, **med, plain_ms=cuda_time_ms(lambda: pairwise_cosine(x, t), 200),
        bound_ms=bound, bound_by=by,
        kernel_device_ms=profiled_device_ms(lambda: fused_pairwise_cosine(x, t),
                                            fused_pairwise_cosine, "fused_cosine_kernel",
                                            med["ms"], bound))


def eval_kernel_checks(bank, results):
    """K1 at the eval passes' shapes: 1024 rows against the MEAN/SINGLE bank
    (10 rows: 5 classes x pos/neg means) and against one polarity of the MAX
    bank (5 x P_max rows), against its plain version; times as in phase 7."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.objectives.scorer import PromptBank
    from incremental_multimodal_medical_learning_ii_torch.ops.cosine import masked_mean

    bank = PromptBank(*(t.cuda() for t in bank))
    c, p, d = bank.pos.shape
    g = torch.Generator(device="cuda").manual_seed(5)
    banks = {f"eval {EVAL_BS}x{2 * c}": torch.cat([masked_mean(bank.pos, bank.pos_count),
                                                   masked_mean(bank.neg, bank.neg_count)]),
             f"eval {EVAL_BS}x{c * p}": bank.pos.reshape(c * p, d)}
    out = {}
    for name, t in banks.items():
        out[name] = k1_case(torch.randn(EVAL_BS, d, device="cuda", generator=g), t, K1_EVAL_ATOL)
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
               host_s: dict, read_streams: bool = True) -> dict:
    """One driver through its CLI's ``main`` (its printout discarded), in
    this process (``--mesh-devices 1``) unless ``flags`` ask for ranks; the
    kernels' launches (K1 on the training path) and K1-mesh's calls, the per-step
    myCL reset counts, the wall time around it, the host's time inside its
    guarded loops and (``read_streams``) its event streams."""
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
        pairwise_cosine_sharded,
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
    if "--mesh-devices" not in flags:  # 0, the default, starts a rank a visible card
        flags = [*flags, "--mesh-devices", "1"]
    try:
        for fn in counters:
            fn.launches = 0
        pairwise_cosine_sharded.calls = 0
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
        launches["pairwise_cosine_sharded_calls"] = pairwise_cosine_sharded.calls
    finally:
        Trainer._flush_epoch_metrics = flush
    steps = int(res["trainer"].state.step)
    return dict(wall_s=wall, steps=steps, steps_per_s=steps / wall, launches=launches,
                loop_host_s=dict(host_s),
                resets=np.concatenate(resets) if resets else np.zeros(0, np.int64),
                streams=event_streams(log_dir) if read_streams else None,
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
            check(r["launches"]["fused_bottleneck_layer"] == 0 and r["launches"]["flash_attention"] == 0
                  and r["launches"]["pairwise_cosine_sharded_calls"] == 0,
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
        threads = torch.get_num_threads()
        for name in ("data-inc", "joint", "class-pos-neg MORE_LABELS MAX"):
            cli, flags, _, _ = runs[name]
            torch.set_num_threads(min(threads, CPU_REFERENCE_THREADS))
            try:
                r = run_driver(cli, flags, data_dir, tmp / f"cpu-{name.split()[0]}", "cpu", host_s)
            finally:
                torch.set_num_threads(threads)
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
    from incremental_multimodal_medical_learning_ii_torch.ops.conv_epilogue import conv_epilogue_
    from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_bottleneck import (
        fused_bottleneck_layer,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
        fused_pairwise_cosine,
    )

    return {"fused_cosine": fused_pairwise_cosine, "fused_bottleneck": fused_bottleneck_layer,
            "flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
            "conv_epilogue": conv_epilogue_}


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
    check(launches["conv_epilogue"] == EPILOGUE_LAUNCHES * batches,
          f"the conv epilogue launched {launches['conv_epilogue']} times, not "
          f"{EPILOGUE_LAUNCHES} a batch ({batches})")
    check(not any(v for k, v in launches.items() if k != "conv_epilogue"),
          f"extraction launched a kernel off its path: {launches}")
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
    embs, launches = {}, {}
    for name in ("bf16", "int8"):  # one batch each, the epilogue's launches around it
        zero_counts()
        embs[name] = extract_embeddings(items, model, int8=name == "int8", **kw).embeddings
        launches[name] = read_counts()["conv_epilogue"]
    bf16, int8 = embs["bf16"], embs["int8"]
    check(launches == {"bf16": EPILOGUE_LAUNCHES, "int8": 0},
          f"the conv epilogue's launches in one batch each way: {launches}")
    cos = float(row_cos(int8, bf16).min())
    many = list(synthetic_images(INT8_N))
    rates = {}
    for name, flag in (("int8", True), ("bf16", False), ("bf16 (2nd)", False), ("int8 (2nd)", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extract_embeddings(many, model, int8=flag, **kw)
        rates[name] = INT8_N / (time.perf_counter() - t0)
    out = dict(sums=sums, int8_vs_bf16_min_cos=cos, images_per_s=rates,
               epilogue_launches=launches)
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
    check(launches["fused_bottleneck"] == 3 and launches["conv_epilogue"] == EPILOGUE_LAUNCHES_K2,
          f"K2 and the conv epilogue launched {launches} in one encode, not 3 and "
          f"{EPILOGUE_LAUNCHES_K2}")
    cos = float(row_cos(fused.float().cpu().numpy(), encode(False).float().cpu().numpy()).min())
    check(cos > EMB_COS, f"the K2 encode against the cuDNN encode: cos {cos}")
    med = alternating_ms({"fused_layer1_ms": lambda: encode(True),
                          "cudnn_ms": lambda: encode(False)}, iters=3)
    enc = dict(batch=EXTRACT_BS, size=EXTRACT_SIZE, **med, k2_launches=launches["fused_bottleneck"],
               epilogue_launches=launches["conv_epilogue"],
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
    rehearsal = reproduce.main(["--rehearsal", "--mesh-devices", "1",
                                "--log-dir", str(tmp / "rehearsal")])
    wall = time.perf_counter() - t0
    launches = read_counts()
    check(launches["fused_cosine"] > 0 and launches["fused_bottleneck"] == 0
          and launches["flash_attention"] == 0, f"reproduce --rehearsal launches {launches}")
    check(all(0.0 <= g["measured"] <= 1.0 for g in rehearsal.values()), f"gates {rehearsal}")
    dry = {}
    for device in ("cuda", "cpu"):
        with contextlib.redirect_stdout(io.StringIO()):
            dry[device] = reproduce.main(["--dry-run", "--device", device, "--mesh-devices", "1",
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
                                "--plot-figures", "off", "--mesh-devices", "1",
                                "--log-dir", str(tmp / "train")])
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
# the data-parallel mesh: ranks over torch.distributed (parallel/mesh.py)
# ----------------------------------------------------------------------
# phase 12's regimes on a mesh: (cli, flags, units evaluated, K1 launches
# per eval batch); joint for 2 epochs
MESH_RUNS = {
    "joint": ("zero_joint_bounds", ["--epochs", "2"], 2, 1),
    "joint --fused-unit": ("zero_joint_bounds", ["--epochs", "2", "--fused-unit"], 2, 1),
    "data-inc": ("data_incremental", ["--parts", "20", "--continual-learning", "myCL"], 20, 1),
    "data-inc --fused-unit": ("data_incremental", ["--parts", "20", "--continual-learning", "myCL",
                                                   "--fused-unit"], 20, 1),
    "class-pos-neg MORE_LABELS MAX": ("class_incremental", ["--max-emb"], 5, 2),
}
# one NCCL rank against no mesh (the same arithmetic), and one step of two
# ranks against one (a sum in another order): the loss and the MAX gaps
MESH_LOSS_ATOL = 1e-6
MESH_AUROC_ATOL = 1e-4
# two ranks' whole runs against one rank's: each gradient is summed in
# another order, and that fp32 difference compounds over hundreds of Adam
# steps and myCL resets (class-incremental MAX parts from task 2 on, on the
# CPU too), so phase 12's whole-run bars (1e-5, 0.5% on 99% of the steps)
# do not hold.  These bars sit between the sound runs' largest readings
# (losses 1.81e-5, reset p99 0.92%) and the readings of two planted faults
# (PERF.md section 6: a rank-local loss denominator, reset counts summed
# over the ranks)
MESH_RUN_LOSS_ATOL = 5e-5
MESH_RUN_RESET_P99 = 0.02
K1_MESH_CASES = ((1024, 10), (1024, 20), (1023, 10))  # global rows x bank rows; 1023: ragged
K1_MESH_SHAPE = (EVAL_BS // 2, 10)  # one rank's rows of an eval batch at two ranks, MEAN bank
MESH_EXTRACT_N = 512
MESH_EXTRACT_FP32_N = 8
GLOO_ON_ONE_CARD = ["cuda:0", "cuda:0"]  # NCCL needs a card a rank; gloo shares one


def eval_batches_per_unit() -> int:
    import math

    return math.ceil(VAL_ROWS / EVAL_BS) + math.ceil(TEST_ROWS / EVAL_BS)


def k1_mesh_checks(mesh) -> dict:
    """(15a) K1-mesh on this rank against its plain version: every rank
    scores its rows of the same global batch (drawn from one seed) and
    gathers; the result is held against ``pairwise_cosine`` of the whole
    batch.  Then the whole call, gather included, timed with both ranks in
    the collective."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
        pairwise_cosine,
        pairwise_cosine_sharded,
    )
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import batch_rows

    g = torch.Generator(device="cuda").manual_seed(11)
    errs = {}
    for b, t in K1_MESH_CASES:
        x = torch.randn(b, 128, device="cuda", generator=g)
        bank = torch.randn(t, 128, device="cuda", generator=g)
        got = pairwise_cosine_sharded(mesh, batch_rows(mesh, x), bank, b)
        errs[f"{b}x{t}"] = float((got - pairwise_cosine(x, bank)).abs().max())
    local = batch_rows(mesh, torch.randn(EVAL_BS, 128, device="cuda", generator=g))
    bank = torch.randn(K1_MESH_SHAPE[1], 128, device="cuda", generator=g)
    sharded_ms = cuda_time_ms(lambda: pairwise_cosine_sharded(mesh, local, bank, EVAL_BS), 50)
    return {"max_abs_err": errs, "sharded_ms": sharded_ms}


def mesh_extraction(mesh, tmp: Path) -> dict:
    """(15d) ``extract_embeddings(mesh=)`` on this rank: ``--synthetic``'s
    images at the CLI's defaults (batch 128, 512^2, bf16) into rank 0's
    shards, the same cut after half and resumed, and 8 images in fp32."""
    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.cli.extract_embeddings import (
        synthetic_images,
    )
    from incremental_multimodal_medical_learning_ii_torch.data.store import ShardedEmbeddingStore
    from incremental_multimodal_medical_learning_ii_torch.engine.extract import extract_embeddings
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        init_biovil_image_model,
    )

    model = init_biovil_image_model(torch.Generator().manual_seed(0))
    items = list(synthetic_images(MESH_EXTRACT_N))
    half = MESH_EXTRACT_N // 2

    def run(images, **kw):
        kw = {"batch_size": EXTRACT_BS, "size": EXTRACT_SIZE, "checkpoint_interval": half,
              "mesh": mesh, **kw}
        return extract_embeddings(images, model, **kw).embeddings

    run(items[:EXTRACT_BS])  # warm-up at the batch's shape, not timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clean = run(items, store=ShardedEmbeddingStore(tmp / "clean"))
    wall = time.perf_counter() - t0
    cut = ShardedEmbeddingStore(tmp / "cut")
    run(items[:half], store=cut)
    resumed = run(items, store=cut, resume=True)
    fp32 = run(items[:MESH_EXTRACT_FP32_N], batch_size=MESH_EXTRACT_FP32_N, dtype=torch.float32)
    return dict(bf16=clean, fp32=fp32, wall_s=wall, images_per_s=MESH_EXTRACT_N / wall,
                resumed_bit_exact=bool(np.array_equal(resumed, clean)),
                shards=len(ShardedEmbeddingStore(tmp / "clean").shard_paths()))


# one step from the same state at two ranks against the card alone: myCL
# over all classes (MEAN), and MORE_LABELS' first two classes in MAX mode
ONE_STEP_CONFIGS = {
    "myCL MEAN": (dict(continual_learning="myCL"), (1, 1, 1, 1, 1)),
    "MAX MORE_LABELS": (dict(prompt_mode="max"), (1, 1, 0, 0, 0)),
}


def one_step_agreement(mesh, data_dir: Path, steps: int = 20) -> dict:
    """A train step at this mesh's ranks against the same step on this
    rank's card with no mesh, from the same state and batch (the no-mesh
    step starts from the mesh's state before every step), at myCL
    thresholds across the data-inc schedule: the loss, the MAX gaps and the
    reset counts of each step.  The mesh's arithmetic without the drift of
    two whole runs apart (phase 12's one-step bar)."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.data.store import EmbeddingDataset
    from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer
    from incremental_multimodal_medical_learning_ii_torch.text.bank import (
        build_prompt_bank,
        synthetic_encode_fn,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
        ExperimentConfig,
    )

    bank = build_prompt_bank(synthetic_encode_fn(27), create_prompts(CHEXPERT_COMPETITION_TASKS),
                             CHEXPERT_COMPETITION_TASKS)
    train = EmbeddingDataset.load(data_dir / "train.npz")
    out = {}
    for name, (kw, classes) in ONE_STEP_CONFIGS.items():
        cfg = ExperimentConfig(plot_figures="off", **kw)
        on_mesh, alone = Trainer(cfg, bank, mesh=mesh), Trainer(cfg, bank, device=mesh.device)
        bs, state = cfg.batch_size, on_mesh.state
        class_mask = torch.tensor(classes, dtype=torch.float32, device=mesh.device)
        loss_diff, gap_diff, resets = 0.0, 0.0, []
        for i in range(steps):
            rows = slice(i * bs, (i + 1) * bs)
            embs, labels = (torch.from_numpy(a[rows]).to(mesh.device)
                            for a in (train.embeddings, train.labels))
            thr = torch.tensor(0.011 + 0.2 * i / (steps - 1), device=mesh.device)
            mask = torch.ones(bs, device=mesh.device)
            before = state
            state, got = on_mesh._train_step(before, embs, labels, mask, class_mask,
                                             on_mesh.bank, thr)
            _, want = alone._train_step(before, embs, labels, mask, class_mask, alone.bank, thr)
            loss_diff = max(loss_diff, float((got["loss"] - want["loss"]).abs()))
            for k in ("max_mean_gap_pos", "max_mean_gap_neg"):
                if k in want:
                    gap_diff = max(gap_diff, float((got[k] - want[k]).abs()))
            if "n_reset" in want:
                resets.append(abs(int(got["n_reset"]) - int(want["n_reset"])))
        n_weights = sum(v.numel() for v in state.params.values())
        out[name] = dict(steps=steps, loss_max_abs_diff=loss_diff, gap_max_abs_diff=gap_diff,
                         reset_max_diff=max(resets, default=0),
                         reset_max_share=max(resets, default=0) / n_weights)
    return out


def mesh_rank(data_dir: str, tmp: str, runs) -> dict:
    """One rank of a group spawned by phase 15 (two over gloo on one card,
    or two over NCCL on two cards): K1-mesh's checks, the drivers' regimes
    ``runs`` through their CLIs' ``main`` with ``--mesh-devices 2``, and
    (over gloo) extraction.  Rank 0 alone reads the event streams."""
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import create_mesh

    mesh = create_mesh(2)
    out = {"rank": mesh.rank, "backend": mesh.backend, "k1_mesh": k1_mesh_checks(mesh), "runs": {},
           "one_step": one_step_agreement(mesh, Path(data_dir))}
    for i, name in enumerate(runs):
        cli, flags, _, _ = MESH_RUNS[name]
        r = run_driver(cli, [*flags, "--mesh-devices", "2"], Path(data_dir),
                       Path(tmp) / f"{mesh.backend}{i}", "cuda", {}, read_streams=mesh.rank == 0)
        r["params"] = {k: v.numpy() for k, v in r["params"].items()}
        out["runs"][name] = r
    if mesh.backend == "gloo":
        out["extraction"] = mesh_extraction(mesh, Path(tmp) / "extract-gloo")
    return out


def as_torch_params(run: dict) -> dict:
    import torch

    return dict(run, params={k: torch.as_tensor(v) for k, v in run["params"].items()})


def check_ranks(name: str, ranks: list, reference: dict, n_weights: int, log_dirs) -> dict:
    """Two ranks' run of one regime against the one-rank run: the ranks'
    parameters bit-equal, one event stream, K1 and K1-mesh on every eval
    batch, AUROC 1e-3, the loss streams and the myCL reset counts within
    the whole-run bars above (phase 12's are reported beside them).  The
    mesh's arithmetic is held to phase 12's bars step by step
    (:func:`one_step_agreement`)."""
    import numpy as np

    r0, r1 = (r["runs"][name] for r in ranks)
    _, _, units, per_batch = MESH_RUNS[name]
    expected = units * eval_batches_per_unit() * per_batch
    for r in (r0, r1):
        check(r["launches"]["fused_pairwise_cosine"] == expected
              and r["launches"]["pairwise_cosine_sharded_calls"] == expected,
              f"{name} at two ranks: K1 launched / K1-mesh called {r['launches']}, the eval "
              f"passes imply {expected} each")
    same = all(np.array_equal(r0["params"][k], r1["params"][k]) for k in r0["params"])
    check(same, f"{name}: the two ranks' parameters differ")
    files = sorted(log_dirs[name].glob("**/events.out.tfevents.*"))
    check(len(files) == 1, f"{name}: {len(files)} event files from two ranks")
    diff = compare_runs(reference, as_torch_params(r0), n_weights)
    check(diff["val/AUROC-macro"] <= CPU_AUROC_ATOL and diff["test/AUROC-macro"] <= CPU_AUROC_ATOL,
          f"{name}: two ranks' AUROC differs from one rank's: {diff}")
    loss = max(diff["train/Loss"], diff["val/Loss"])
    reset_p99 = diff.get("reset_share_quantiles", {}).get("p99", 0.0)
    check(loss <= MESH_RUN_LOSS_ATOL and reset_p99 <= MESH_RUN_RESET_P99,
          f"{name}: two ranks' whole run drifts from one rank's: losses {loss:.3g} (bar "
          f"{MESH_RUN_LOSS_ATOL:g}), reset p99 {reset_p99:.4%} (bar {MESH_RUN_RESET_P99:.1%})")
    return dict(diff, within_phase12_bars=loss <= CPU_LOSS_ATOL and reset_p99 <= RESET_SHARE,
                wall_s=r0["wall_s"], steps_per_s=r0["steps_per_s"], launches=r0["launches"],
                ranks_bit_equal=same)


def k1_mesh_times() -> dict:
    """K1 at one rank's share of an eval batch at two ranks, (1024 / 2) x 10,
    next to K1 at the whole batch; the plain version, ``torch.matmul`` of
    the normalised operands, the profiler's device time, the bound."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.ops.cosine import l2_normalize
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
        fused_pairwise_cosine,
        pairwise_cosine,
    )

    g = torch.Generator(device="cuda").manual_seed(12)
    b, t = K1_MESH_SHAPE
    whole = torch.randn(EVAL_BS, 128, device="cuda", generator=g)
    x, bank = whole[:b], torch.randn(t, 128, device="cuda", generator=g)
    xn, tn = l2_normalize(x), l2_normalize(bank)
    bound, by = cosine_bound_ms(b, t)
    med = alternating_ms({"ms": lambda: fused_pairwise_cosine(x, bank),
                          "library_ms": lambda: torch.matmul(xn, tn.T),
                          "whole_batch_ms": lambda: fused_pairwise_cosine(whole, bank)}, iters=200)
    return dict(shape=f"{b}x{t}", **med, plain_ms=cuda_time_ms(lambda: pairwise_cosine(x, bank), 200),
                bound_ms=bound, bound_by=by,
                kernel_device_ms=profiled_device_ms(lambda: fused_pairwise_cosine(x, bank),
                                                    fused_pairwise_cosine, "fused_cosine_kernel",
                                                    med["ms"], bound))


def mesh_phase(results) -> dict:
    """Phase 15: (a) K1-mesh at two gloo ranks on the card; (b) one NCCL
    rank (``create_mesh(1)``) through the drivers against no mesh, K1-mesh
    on every eval batch, the fused loops under sync debug mode; (c) the
    same regimes at two gloo ranks on the card; (d) extraction with
    ``mesh=``; (e) two NCCL ranks where two cards are visible; (f) times."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.cli import common
    from incremental_multimodal_medical_learning_ii_torch.cli.extract_embeddings import (
        synthetic_images,
    )
    from incremental_multimodal_medical_learning_ii_torch.engine.extract import extract_embeddings
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        init_biovil_image_model,
    )
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import (
        create_mesh,
        destroy_mesh,
        spawn_ranks,
    )

    out: dict = {"nccl1": {}, "none": {}, "gloo2": {}}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    calls: dict = {}
    host_s: dict = {}
    try:
        data_dir = training_data(tmp / "data")
        mesh = create_mesh(1)
        check(mesh.backend == "nccl" and mesh.device == torch.device("cuda", 0),
              f"create_mesh(1) on the card: {mesh}")
        # (b) each regime with --mesh-devices 1 (no mesh), then on the hand-built
        # NCCL mesh, the fused loops guarded; K1-mesh's launches are the path's
        undo = guarded_loops(calls, host_s)
        make_mesh = common.make_mesh
        runs: dict = {"none": {}, "nccl1": {}}
        try:
            for i, (name, (cli, flags, units, per_batch)) in enumerate(MESH_RUNS.items()):
                runs["none"][name] = run_driver(cli, [*flags, "--mesh-devices", "1"], data_dir,
                                                tmp / f"none{i}", "cuda", host_s)
                common.make_mesh = lambda args: mesh
                try:
                    runs["nccl1"][name] = run_driver(cli, [*flags, "--mesh-devices", "1"], data_dir,
                                                     tmp / f"nccl{i}", "cuda", host_s)
                finally:
                    common.make_mesh = make_mesh
                expected = units * eval_batches_per_unit() * per_batch
                for kind, want_mesh in (("none", 0), ("nccl1", expected)):
                    r = runs[kind][name]
                    check(r["launches"]["fused_pairwise_cosine"] == expected
                          and r["launches"]["pairwise_cosine_sharded_calls"] == want_mesh,
                          f"{name} ({kind}): K1 launched / K1-mesh called {r['launches']}, the eval "
                          f"passes imply {expected} / {want_mesh}")
                    out[kind][name] = dict(wall_s=r["wall_s"], steps=r["steps"],
                                           steps_per_s=r["steps_per_s"], launches=r["launches"],
                                           loop_host_s=r["loop_host_s"])
                n_weights = sum(v.numel() for v in runs["none"][name]["params"].values())
                diff = compare_runs(runs["none"][name], runs["nccl1"][name], n_weights)
                out["nccl1"][name]["vs_no_mesh"] = diff
                log(f"  (b) {name}: one NCCL rank {runs['nccl1'][name]['steps_per_s']:.1f} steps/s "
                    f"against {runs['none'][name]['steps_per_s']:.1f} with no mesh; "
                    f"launches {json.dumps(runs['nccl1'][name]['launches'])}; {json.dumps(diff)}")
                check(diff["train/Loss"] <= MESH_LOSS_ATOL and diff["val/Loss"] <= MESH_LOSS_ATOL,
                      f"{name}: one NCCL rank's losses differ from no mesh: {diff}")
                check(diff["val/AUROC-macro"] <= MESH_AUROC_ATOL
                      and diff["test/AUROC-macro"] <= MESH_AUROC_ATOL,
                      f"{name}: one NCCL rank's AUROC differs from no mesh: {diff}")
            # (f) the collectives' cost: the whole-run fold again, in turns
            # (no mesh, one rank, one rank, no mesh)
            name = "data-inc --fused-unit"
            cli, flags, _, _ = MESH_RUNS[name]
            common.make_mesh = lambda args: mesh
            try:
                again = run_driver(cli, [*flags, "--mesh-devices", "1"], data_dir, tmp / "nccl-turn",
                                   "cuda", host_s)
            finally:
                common.make_mesh = make_mesh
            first = run_driver(cli, [*flags, "--mesh-devices", "1"], data_dir, tmp / "none-turn",
                               "cuda", host_s)
            turns = {"none": [runs["none"][name]["steps_per_s"], first["steps_per_s"]],
                     "nccl1": [runs["nccl1"][name]["steps_per_s"], again["steps_per_s"]]}
            out["fold_steps_per_s_in_turns"] = turns
            log(f"  (f) {name} in turns (no mesh, one NCCL rank, one NCCL rank, no mesh): "
                f"steps/s {json.dumps(turns)}")
        finally:
            undo()
        check(all(calls.get(n, 0) > 0 for n in LOOPS), f"a fused loop ran unguarded: {calls}")
        # K1-mesh's launches are K1's on the mesh runs (every K1 launch there
        # came through K1-mesh: the counts are checked equal above)
        out["k1_mesh_launches"] = sum(r["launches"]["fused_pairwise_cosine"]
                                      for r in runs["nccl1"].values())
        out["guarded_loop_calls"] = dict(calls)

        # (a), (c), (d) at two gloo ranks on the card
        t0 = time.perf_counter()
        ranks = spawn_ranks(mesh_rank, 2, GLOO_ON_ONE_CARD, str(data_dir), str(tmp / "gloo"),
                            list(MESH_RUNS), backend="gloo")
        out["gloo_spawn_wall_s"] = time.perf_counter() - t0
        errs = {k: max(r["k1_mesh"]["max_abs_err"][k] for r in ranks)
                for k in ranks[0]["k1_mesh"]["max_abs_err"]}
        out["k1_mesh_check"] = errs
        out["k1_mesh_sharded_gloo_ms"] = ranks[0]["k1_mesh"]["sharded_ms"]
        log(f"  (a) K1-mesh at two gloo ranks on one card vs plain: {json.dumps(errs)}")
        check(max(errs.values()) <= COSINE_ATOL, f"K1-mesh differs from its plain version: {errs}")
        one_step = [r["one_step"] for r in ranks]
        out["one_step"] = one_step[0]
        log(f"  (c) one step from the same state, two gloo ranks vs the card alone: "
            f"{json.dumps(one_step[0])}")
        for per_rank in one_step:
            for name, a in per_rank.items():
                check(a["loss_max_abs_diff"] <= MESH_LOSS_ATOL
                      and a["gap_max_abs_diff"] <= MESH_LOSS_ATOL
                      and a["reset_max_share"] <= RESET_SHARE,
                      f"one step from the same state ({name}): two ranks differ from one: {a}")
        log_dirs = {name: tmp / "gloo" / f"gloo{i}" for i, name in enumerate(MESH_RUNS)}
        for name in MESH_RUNS:
            n_weights = sum(v.numel() for v in runs["nccl1"][name]["params"].values())
            out["gloo2"][name] = check_ranks(name, ranks, runs["nccl1"][name], n_weights, log_dirs)
            log(f"  (c) {name} at two gloo ranks vs one NCCL rank: {json.dumps(out['gloo2'][name])}")

        # (d) extraction: no mesh, one NCCL rank, two gloo ranks
        one = mesh_extraction(mesh, tmp / "extract-nccl")
        model = init_biovil_image_model(torch.Generator().manual_seed(0))
        items = list(synthetic_images(MESH_EXTRACT_N))
        none_bf16 = extract_embeddings(items, model, batch_size=EXTRACT_BS,
                                       size=EXTRACT_SIZE).embeddings
        none_fp32 = extract_embeddings(items[:MESH_EXTRACT_FP32_N], model,
                                       batch_size=MESH_EXTRACT_FP32_N, size=EXTRACT_SIZE,
                                       dtype=torch.float32).embeddings
        two = ranks[0]["extraction"]
        ext = {}
        for name, r in (("one NCCL rank", one), ("two gloo ranks", two)):
            ext[name] = dict(bf16_min_cos=float(row_cos(r["bf16"], none_bf16).min()),
                             fp32_max_abs_diff=float(np.abs(r["fp32"] - none_fp32).max()),
                             resumed_bit_exact=r["resumed_bit_exact"], shards=r["shards"],
                             wall_s=r["wall_s"], images_per_s=r["images_per_s"])
            check(ext[name]["bf16_min_cos"] > EMB_COS and ext[name]["fp32_max_abs_diff"] <= EMB_ATOL
                  and r["resumed_bit_exact"] and r["shards"] == 2,
                  f"extraction with mesh= at {name}: {ext[name]}")
        check(np.array_equal(ranks[0]["extraction"]["bf16"], ranks[1]["extraction"]["bf16"]),
              "extraction: the two ranks returned different embeddings")
        out["extraction"] = ext
        log(f"  (d) extraction with mesh= ({MESH_EXTRACT_N} images, batch {EXTRACT_BS}, "
            f"{EXTRACT_SIZE}^2, bf16; {MESH_EXTRACT_FP32_N} in fp32) vs no mesh: {json.dumps(ext)}")

        # (e) two NCCL ranks need two cards
        if torch.cuda.device_count() >= 2:
            nccl = spawn_ranks(mesh_rank, 2, "cuda", str(data_dir), str(tmp / "nccl2"), ["joint"])
            n_weights = sum(v.numel() for v in runs["nccl1"]["joint"]["params"].values())
            out["nccl2"] = check_ranks("joint", nccl, runs["nccl1"]["joint"], n_weights,
                                       {"joint": tmp / "nccl2" / "nccl0"})
            log(f"  (e) joint at two NCCL ranks vs one: {json.dumps(out['nccl2'])}")
        else:
            out["nccl2"] = (f"not run: {torch.cuda.device_count()} card visible; NCCL needs one "
                            "card a rank (two gloo ranks share the card in (c))")
            log(f"  (e) two ranks over NCCL: {out['nccl2']}")
        out["k1_mesh_times"] = k1_mesh_times()
        log(f"  (f) K1 at one rank's rows of an eval batch: {json.dumps(out['k1_mesh_times'])}; "
            f"the whole K1-mesh call at two gloo ranks (gather through the host) "
            f"{out['k1_mesh_sharded_gloo_ms']:.4f} ms")
        destroy_mesh()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        out_dir = REPO / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_mesh.json").write_text(json.dumps(out, indent=1, default=str))
    results["mesh"] = out
    return out


# ----------------------------------------------------------------------
# sweeps and the text tower's partitions (engine/sweep.py, parallel/{tp,sp,pp}.py)
# ----------------------------------------------------------------------
SWEEP_LRS = ["1e-4", "3e-4", "1e-3", "3e-3"]
SWEEP_SEEDS = ["27", "99"]
SWEEP_EPOCHS = 3  # the JAX CLI A/B's epochs (engine/sweep.py:70-71)
SWEEP_ATOL = 2e-4  # a point's mean AUROC, vmapped vs sequential (JAX's CLI-scale bound, :70)
SWEEP_SMALL_ROWS = (12_288, 2_048)  # the card against its own CPU: train, val rows
PART_F32_ATOL = 5e-5  # a partition vs the one-rank dense encode, BERT-base (tests/test_tp.py:103)
PART_BF16_COS = 0.999  # bf16, per row (tests/test_sp.py:164)
GRAD_ATOL = 5e-5  # parameter gradients, scaled by the largest (tests/test_sp.py:199)
# the gradient check's loss is sum(out * w) with a seeded w: the JAX tests'
# sum(out * out[::-1]) is ill-conditioned at random weights (every row's
# projection is nearly parallel, so fp32 rounding in the [CLS] states moves
# the head's gradient by far more than the bar), and would measure fp32
# noise, not the partition
PP_MICROBATCHES = 4
GRAD_BATCH = 8  # report rows in the gradient check (2 layers at full width)


def sweep_phase(bank, results) -> dict:
    """(16a) ``cli/sweep.py`` at phase 12's scale: 4 lrs x 2 seeds, MEAN,
    Adam, the MLP double adapter, 3 epochs; once with ``--vmap`` (from the
    first upload to the readback under ``set_sync_debug_mode("error")``)
    and once sequentially; K1's launches in each; each point's mean AUROC
    vmapped vs sequential; the vmapped sweep at a small size, the card
    against its own CPU."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.cli import sweep as cli
    from incremental_multimodal_medical_learning_ii_torch.data.store import synthetic_dataset
    from incremental_multimodal_medical_learning_ii_torch.engine import sweep
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
        fused_pairwise_cosine,
    )
    from incremental_multimodal_medical_learning_ii_torch.utils.config import ExperimentConfig

    out: dict = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sweep_"))
    guarded = {"calls": 0, "host_s": []}  # host seconds from the first upload to the readback
    upload, readback = sweep.upload, sweep.readback

    def guarded_upload(a, device):
        if device.type == "cuda" and guarded.get("t0") is None:
            guarded["calls"] += 1
            guarded["t0"] = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
        return upload(a, device)

    def unguarded_readback(tree):
        if guarded.get("t0") is not None:
            torch.cuda.set_sync_debug_mode("default")
            guarded["host_s"].append(time.perf_counter() - guarded.pop("t0"))
        return readback(tree)

    try:
        data_dir = training_data(tmp / "data")
        flags = ["--data-dir", str(data_dir), "--batch-size", "6144", "--epochs",
                 str(SWEEP_EPOCHS), "--lrs", *SWEEP_LRS, "--seeds", *SWEEP_SEEDS, "--optims",
                 "adam", "--adapters", "mlp", "--prompt-modes", "mean", "--device", "cuda"]
        runs: dict = {"vmap": [], "sequential": []}
        sweep.upload, sweep.readback = guarded_upload, unguarded_readback
        try:  # in turns: the first run of each mode pays its warm-ups
            for mode in ("vmap", "sequential", "sequential", "vmap"):
                fused_pairwise_cosine.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    res = cli.main([*flags, *(["--vmap"] if mode == "vmap" else [])])
                torch.cuda.synchronize()
                runs[mode].append(dict(wall_s=time.perf_counter() - t0,
                                       k1_launches=fused_pairwise_cosine.launches,
                                       aurocs=[r[0] for r in res]))
        finally:
            sweep.upload, sweep.readback = upload, readback
            torch.cuda.set_sync_debug_mode("default")
        points = len(SWEEP_LRS) * len(SWEEP_SEEDS)
        expected = points * math.ceil(VAL_ROWS / EVAL_BS)
        vm, seq = runs["vmap"][0], runs["sequential"][0]
        diffs = [abs(a - b) for a, b in zip(vm["aurocs"], seq["aurocs"])]
        walls = {mode: [r["wall_s"] for r in rs] for mode, rs in runs.items()}
        out.update(points=points, epochs=SWEEP_EPOCHS, k1_expected=expected, runs=runs,
                   wall_s_in_turns=walls, vmap_vs_sequential_max_abs=max(diffs),
                   speedup_second_runs=walls["sequential"][1] / walls["vmap"][1],
                   guarded_calls=guarded["calls"], guarded_host_s=guarded["host_s"])
        log(f"  (a) {points} points x {SWEEP_EPOCHS} epochs at {TRAIN_ROWS:,} rows, in turns "
            f"(vmap, sequential, sequential, vmap): --vmap {walls['vmap']} s, sequential "
            f"{walls['sequential']} s ({card_line()}); K1 launches "
            f"{[r['k1_launches'] for r in runs['vmap'] + runs['sequential']]} (expected {expected} "
            f"a run); mean AUROC vmapped vs sequential {max(diffs):.3g}; host s from upload to "
            f"readback in the vmapped runs {guarded['host_s']}")
        check(guarded["calls"] == 2, f"a vmapped sweep ran unguarded: {guarded}")
        for mode, rs in runs.items():
            for r in rs:
                check(r["k1_launches"] == expected,
                      f"sweep ({mode}): K1 launched {r['k1_launches']} times, the eval "
                      f"batches imply {expected}")
                check(len(r["aurocs"]) == points and all(np.isfinite(r["aurocs"])),
                      f"sweep ({mode}): {r['aurocs']}")
            check(rs[0]["aurocs"] == rs[1]["aurocs"], f"sweep ({mode}): two runs differ")
        check(max(diffs) <= SWEEP_ATOL, f"vmapped sweep vs sequential: {max(diffs)} > {SWEEP_ATOL}")

        # the vmapped sweep at a small size, the card against its own CPU
        rng = np.random.default_rng(27)
        dirs = rng.normal(size=(5, 128)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        train, val = (synthetic_dataset(n, seed=s, class_directions=dirs)
                      for n, s in zip(SWEEP_SMALL_ROWS, (1, 2)))
        cfgs = [ExperimentConfig(mode="joint", lr=float(lr), seed=int(seed), epochs=SWEEP_EPOCHS,
                                 plot_figures="off") for seed in SWEEP_SEEDS for lr in SWEEP_LRS]
        card = sweep.run_vmapped_sweep(cfgs, train, val, bank, device="cuda")
        threads = torch.get_num_threads()
        torch.set_num_threads(min(threads, CPU_REFERENCE_THREADS))
        try:
            cpu = sweep.run_vmapped_sweep(cfgs, train, val, bank, device="cpu")
        finally:
            torch.set_num_threads(threads)
        out["small_card_vs_cpu_max_abs"] = float(np.abs(card - cpu).max())
        log(f"  (a) vmapped sweep at {SWEEP_SMALL_ROWS} rows, the card vs its CPU: per-class "
            f"AUROC {out['small_card_vs_cpu_max_abs']:.3g}")
        check(out["small_card_vs_cpu_max_abs"] <= CPU_AUROC_ATOL,
              f"vmapped sweep, card vs CPU: {out['small_card_vs_cpu_max_abs']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    results["sweep"] = out
    return out


def row_cos_min(a, b) -> float:
    import torch.nn.functional as F

    return float(F.cosine_similarity(a.float(), b.float(), dim=-1).min())


def scaled_grad_err(got: dict, ref: dict) -> float:
    scale = max(float(v.abs().max()) for v in ref.values()) + 1e-12
    return max(float((got[k] - ref[k]).abs().max()) for k in ref) / scale


def partition_rank(refs: dict, vocab: str, reps: int) -> dict:
    """One rank of phase 16b/c's group of two: TP (``model=2``), SP
    (``seq=2``) and PP (``pipe=2``, 4 microbatches) at BERT-base width and
    depth against the one-rank dense encodes ``refs`` (report length; TP
    also at the bank's shape), fp32 and bf16; the prompt bank through
    ``TextInferenceEngine(mesh=)``; gradients at 2 layers against the dense
    path's on this rank; prompts/s in bf16 at report length."""
    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import (
        BertDims,
        get_projected_text_embeddings,
        init_cxr_bert,
    )
    from incremental_multimodal_medical_learning_ii_torch.parallel import pp, sp, tp
    from incremental_multimodal_medical_learning_ii_torch.text.bank import build_prompt_bank
    from incremental_multimodal_medical_learning_ii_torch.text.engine import TextInferenceEngine
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
    from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import PromptTokenizer
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
    )

    meshes = {"tp": tp.create_mesh_2d(1, 2), "sp": sp.create_mesh_sp(1, 2),
              "pp": pp.create_mesh_pp(1, 2)}
    mesh = meshes["tp"]
    model = init_cxr_bert(torch.Generator().manual_seed(0), BertDims()).to(mesh.device)
    dims = model.dims

    def encoder(part, m, dtype, d=dims):
        if part == "tp":
            return tp.make_tp_text_encode(d, meshes[part], dtype=dtype)
        if part == "sp":
            return sp.make_sp_text_encode(d, meshes[part], dtype=dtype)
        return pp.make_pp_text_encode(d, meshes[part], PP_MICROBATCHES, dtype=dtype)

    shard = tp.shard_bert_tp(model, meshes["tp"])
    held = {"tp": shard, "sp": model, "pp": model}
    inputs = {name: (torch.from_numpy(i).to(mesh.device), torch.from_numpy(m).to(mesh.device))
              for name, (i, m) in refs["inputs"].items()}
    out = {"backend": mesh.backend, "transport": mesh.transport, "checks": {}, "times": {}}
    with torch.no_grad():
        for part in ("tp", "sp", "pp"):
            shapes = ("report", "bank") if part == "tp" else ("report",)
            for shape in shapes:
                ids, mask = inputs[shape]
                f32 = encoder(part, held[part], torch.float32)(held[part], ids, mask)
                bf = encoder(part, held[part], torch.bfloat16)(held[part], ids, mask)
                out["checks"][f"{part} {shape}"] = dict(
                    fp32_max_abs=float((f32.cpu() - torch.from_numpy(refs[f"{shape} fp32"]))
                                       .abs().max()),
                    bf16_row_cos_min=row_cos_min(bf.cpu(), torch.from_numpy(refs[f"{shape} bf16"])),
                    finite=bool(torch.isfinite(f32).all() and torch.isfinite(bf).all()))
            ids, mask = inputs["report"]
            encode = encoder(part, held[part], torch.bfloat16)
            encode(held[part], ids, mask)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                encode(held[part], ids, mask)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / reps * 1e3
            out["times"][part] = dict(ms=ms, prompts_per_s=ids.shape[0] / ms * 1e3)
        # the prompt bank through the engine with mesh=
        tokenizer = PromptTokenizer(vocab)
        prompts = create_prompts(CHEXPERT_COMPETITION_TASKS)
        for part in ("tp", "sp", "pp"):
            engine = TextInferenceEngine(model, tokenizer, mesh=meshes[part], partition=part,
                                         n_microbatches=PP_MICROBATCHES)
            bank = build_prompt_bank(engine.encode_fn(), prompts, CHEXPERT_COMPETITION_TASKS)
            out["checks"][f"{part} prompt bank"] = dict(bank_max_abs=max(
                float((getattr(bank, f) - torch.from_numpy(refs[f"bank {f}"])).abs().max())
                for f in ("pos", "neg")))
    del model, shard, held
    # gradients at 2 layers of full width
    two = BertDims(num_layers=2)
    ids, mask = (t[:GRAD_BATCH] for t in inputs["report"])
    dense = init_cxr_bert(torch.Generator().manual_seed(1), two).to(mesh.device).requires_grad_(True)
    w = torch.randn(GRAD_BATCH, two.projection_size, generator=torch.Generator().manual_seed(7))
    w = w.to(mesh.device)
    (get_projected_text_embeddings(dense, ids, mask, normalize=True) * w).sum().backward()
    ref = {k: p.grad if p.grad is not None else torch.zeros_like(p)
           for k, p in dense.named_parameters()}
    for part, mod in (("tp", tp), ("sp", sp), ("pp", pp)):
        m = init_cxr_bert(torch.Generator().manual_seed(1), two).to(mesh.device)
        m = tp.shard_bert_tp(m, meshes["tp"]) if part == "tp" else m
        m.requires_grad_(True)
        (encoder(part, m, torch.float32, two)(m, ids, mask) * w).sum().backward()
        out["checks"][f"{part} grad"] = dict(
            grad_scaled_max_abs=scaled_grad_err(mod.full_gradients(meshes[part], m), ref))
    return out


def partition_phase(bert, results) -> dict:
    """Phase 16b: TP, SP and PP on two gloo ranks sharing the card, against
    the one-rank dense encodes computed here; 16c: the same on two NCCL
    ranks where two cards are visible."""
    import tempfile

    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import (
        get_projected_text_embeddings,
    )
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import spawn_ranks
    from incremental_multimodal_medical_learning_ii_torch.text.bank import build_prompt_bank
    from incremental_multimodal_medical_learning_ii_torch.text.engine import TextInferenceEngine
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
    from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import (
        PromptTokenizer,
        write_test_vocab,
    )
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
    )

    out: dict = {}
    ids, mask = report_batch(bert.dims.vocab_size, seed=2)
    g = np.random.default_rng(3)
    lengths = g.integers(8, 33, size=256)
    bank_mask = (np.arange(32)[None, :] < lengths[:, None]).astype(np.int32)
    bank_ids = (g.integers(5, 30000, size=(256, 32)) * bank_mask).astype(np.int32)
    bank_ids[:, 0] = 2
    refs = {"inputs": {"report": (ids.cpu().numpy(), mask.cpu().numpy()),
                       "bank": (bank_ids, bank_mask)}}
    with torch.no_grad():
        for shape, (i, m) in refs["inputs"].items():
            i, m = torch.from_numpy(i).cuda(), torch.from_numpy(m).cuda()
            for dtype in ("fp32", "bf16"):
                refs[f"{shape} {dtype}"] = get_projected_text_embeddings(
                    bert, i, m, normalize=True,
                    dtype=torch.bfloat16 if dtype == "bf16" else torch.float32).cpu().numpy()
        dense_ms = cuda_time_ms(lambda: get_projected_text_embeddings(bert, ids, mask,
                                                                      dtype=torch.bfloat16), 5)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parts_") as tmp:
        vocab = write_test_vocab(Path(tmp) / "vocab.txt")
        engine = TextInferenceEngine(bert, PromptTokenizer(vocab))
        bank = build_prompt_bank(engine.encode_fn(), create_prompts(CHEXPERT_COMPETITION_TASKS),
                                 CHEXPERT_COMPETITION_TASKS)
        refs.update({f"bank {f}": getattr(bank, f).numpy() for f in ("pos", "neg")})
        out["one_rank_dense_bf16"] = dict(ms=dense_ms, prompts_per_s=ids.shape[0] / dense_ms * 1e3)
        groups = [("gloo2", GLOO_ON_ONE_CARD, "gloo")]
        if torch.cuda.device_count() >= 2:
            groups.append(("nccl2", "cuda", "nccl"))
        for name, devices, backend in groups:
            t0 = time.perf_counter()
            ranks = spawn_ranks(partition_rank, 2, devices, refs, str(vocab), 2, backend=backend)
            r = ranks[0]
            out[name] = dict(wall_s=time.perf_counter() - t0, backend=r["backend"],
                             transport=r["transport"], checks=r["checks"], times=r["times"])
            tag = "(b)" if backend == "gloo" else "(c)"
            log(f"  {tag} two {backend} ranks ({r['transport']}): {json.dumps(r['checks'])}")
            log(f"  {tag} bf16 report encodes: "
                + ", ".join(f"{p} {t['prompts_per_s']:.1f} prompts/s" for p, t in r["times"].items())
                + f"; one rank dense {out['one_rank_dense_bf16']['prompts_per_s']:.1f} prompts/s "
                f"({card_line()})")
            for rank, rr in enumerate(ranks):
                for key, c in rr["checks"].items():
                    check(c.get("fp32_max_abs", 0.0) <= PART_F32_ATOL
                          and c.get("bf16_row_cos_min", 1.0) > PART_BF16_COS
                          and c.get("finite", True)
                          and c.get("bank_max_abs", 0.0) <= BANK_ATOL
                          and c.get("grad_scaled_max_abs", 0.0) <= GRAD_ATOL,
                          f"{name} rank {rank}, {key}: {c}")
        if "nccl2" not in out:
            out["nccl2"] = (f"not run: {torch.cuda.device_count()} card visible; NCCL needs one "
                            "card a rank (two gloo ranks share the card in (b))")
            log(f"  (c) two ranks over NCCL: {out['nccl2']}")
    results["partitions"] = out
    return out


# ----------------------------------------------------------------------
# K3b, the flash-attention backward, under the text tower's gradient; the
# profiling tools (utils/profiling.py, chained_timing.py, device_bench.py)
# ----------------------------------------------------------------------
K3B_F32_REL = 1e-5  # of each gradient's largest entry, kernel vs plain backward, fp32 (TF32 off)
K3B_BF16_KERNELS = ("flash_bwd_dkv_bf16_kernel", "flash_bwd_dq_bf16_kernel")  # on wgmma
K3B_BF16_COS = 0.999  # per gradient tensor in bf16 (p and ds rounded to bf16 on both sides)
LSE_REL = 1e-5  # the kernel's log-sum-exp vs the plain forward's, per row, of max(|lse|, 1)
TEXT_GRAD_F32_ATOL = 5e-5  # of the largest gradient, flash vs dense (tests/test_sp.py:199)
TEXT_GRAD_BF16_COS = 0.999  # per parameter, flash vs dense in bf16
BENCH_SHAPE = dict(batch=256, img_h=390, img_w=320, size=512, crop=512, channels=1)  # root bench.py's


def flash_bwd_bound_ms(q, seg):
    """Bytes: q, k, v, o and do read once, the lse and the ids, dq, dk and
    dv written once.  Operations: 10*hd for every (query, key) pair of one
    segment, per head: the five products QK^T, dO V^T, P^T dO, dS^T Q and
    dS K, 2.5x the forward's (a key of another segment adds nothing)."""
    import torch

    b, nh, s, hd = q.shape
    bytes_ = 8 * b * nh * s * hd * q.element_size() + b * nh * s * 4 + 2 * seg.numel() * 4
    pairs = int((seg[:, :, None] == seg[:, None, :]).sum())
    flops = 10 * nh * hd * pairs
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    tb, tf = bytes_ / HBM_BYTES_PER_S, flops / peak
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations"), flops


def flash_lse_bound_ms(q, seg):
    """K3 with its lse output: ``flash_bound_ms``'s bytes plus the (B, nh,
    S) fp32 log-sum-exp written once; the same operations."""
    import torch

    b, nh, s, hd = q.shape
    _, _, flops, _ = flash_bound_ms(q, seg)
    bytes_ = 4 * b * nh * s * hd * q.element_size() + 2 * seg.numel() * 4 + b * nh * s * 4
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    tb, tf = bytes_ / HBM_BYTES_PER_S, flops / peak
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def grad_metrics(got, ref) -> dict:
    """max |got - ref|, the same over the largest |ref|, and the cosine, in fp32."""
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    return dict(max_abs=err, rel=err / max(float(ref.abs().max()), 1e-30),
                cos=float((got * ref).sum() / (got.norm() * ref.norm())))


def k3b_pairs(q, seg_q, seg_kv) -> tuple:
    """(predicted, total): the (64-query block, 64-key tile) pairs, summed
    over heads, that each of K3b's passes computes by its predicate
    (``key_tiles_needed``; every pair with two id arrays), and all pairs."""
    from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import (
        key_tiles_needed,
    )

    needed = key_tiles_needed(seg_q, seg_kv, self_segments=seg_q is seg_kv)
    return q.shape[1] * int(needed.sum()), q.shape[1] * needed.numel()


def k3b_checks(results) -> dict:
    """(17a) K3b against its plain backward on the card, at phase 8's
    cases, fp32 (TF32 off) and bf16, from the kernel forward's own o and
    log-sum-exp; the forward's o with the lse output equals o without it
    bit for bit, and its lse equals the plain forward's.  Each pass's
    computed pairs, counted on the card, are the predicate's; with one id
    array the gradients with skipping equal those without (a copy of the
    ids as kv) bit for bit, and a second launch gives the same bits."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.ops import flash_attention as fa

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, shape, lengths) in enumerate(flash_cases()):
            q, k, v, seg, scale = flash_inputs(shape, lengths, dtype, seed=40 + i)
            do = torch.randn(*shape, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(60 + i)).to(dtype)
            seg_kv = seg
            if name.startswith("lonely"):  # kv ids no query shares: each averages every key
                seg_kv = seg.clone()
                seg_kv[1] = 7
            with torch.no_grad():
                plain_o = fa.flash_attention(q, k, v, seg, seg_kv, scale)
            o, lse = fa._forward_kernel(q, k, v, seg, seg_kv, scale, None, with_lse=True)
            _, ref_lse = fa.mha_reference_with_lse(q.float(), k.float(), v.float(), seg, seg_kv,
                                                   scale)
            before = fa.flash_attention_bwd.launches
            tiles = torch.zeros(2, dtype=torch.int32, device="cuda")
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, seg, seg_kv, scale,
                                         computed_tiles=tiles)
            launched = fa.flash_attention_bwd.launches - before
            ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, seg, seg_kv, scale)
            torch.cuda.synchronize()
            key = f"{name} {str(dtype).split('.')[-1]}"
            m = {g: grad_metrics(a, b) for g, a, b in zip(("dq", "dk", "dv"), got, ref)}
            lse_rel = float(((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max())
            predicted, total = k3b_pairs(q, seg, seg_kv)
            out[key] = dict(o_bit_equal=torch.equal(o, plain_o), lse_rel=lse_rel, **m,
                            computed_tiles=tiles.tolist(), predicted_tiles=predicted,
                            tiles=total)
            if seg_kv is seg:  # skipping on against off (a copy as kv), and a second launch
                off = fa.flash_attention_bwd(q, k, v, o, lse, do, seg, seg.clone(), scale)
                again = fa.flash_attention_bwd(q, k, v, o, lse, do, seg, seg, scale)
                out[key]["skipping_bit_equal"] = all(torch.equal(a, b) for a, b in zip(got, off))
                out[key]["twice_bit_equal"] = all(torch.equal(a, b) for a, b in zip(got, again))
            log(f"  (a) K3b {key}: " + ", ".join(f"{g} rel {v['rel']:.3e} cos {v['cos']:.8f}"
                                                 for g, v in m.items())
                + f"; lse {lse_rel:.3e}; o with lse == o without: {out[key]['o_bit_equal']}; "
                f"pairs computed {tiles.tolist()} of {total} (predicate {predicted}); skipping "
                f"== not: {out[key].get('skipping_bit_equal')}; twice equal: "
                f"{out[key].get('twice_bit_equal')}")
            check(out[key]["o_bit_equal"], f"K3 {key}: the lse output changed o")
            check(lse_rel <= LSE_REL, f"K3 {key}: lse off by {lse_rel}")
            check(launched == 1, f"K3b {key} did not launch")
            check(tiles.tolist() == [predicted, predicted],
                  f"K3b {key}: pairs computed {tiles.tolist()}, the predicate keeps {predicted}")
            check(out[key].get("skipping_bit_equal", True), f"K3b {key}: skipping changed a bit")
            check(out[key].get("twice_bit_equal", True), f"K3b {key}: two launches differ")
            check(all(bool(torch.isfinite(t).all()) for t in got), f"K3b {key} not finite")
            for g, v in m.items():
                if dtype == torch.float32:
                    check(v["rel"] <= K3B_F32_REL, f"K3b {key} {g}: rel {v['rel']}")
                else:
                    check(v["cos"] > K3B_BF16_COS, f"K3b {key} {g}: cos {v['cos']}")
    results["k3b_check"] = out
    return out


def text_tower_gradients(model, ids, mask, results, profile: bool = False) -> dict:
    """(17b) The gradient of sum(w * get_projected_text_embeddings(
    use_flash_attention=True)) at BERT-base, phase 9's batch, with respect
    to every parameter and to the input embeddings (the embedding layer's
    output), against the dense path: fp32 (TF32 off) and bf16; K3's and
    K3b's launches read around one forward and backward (12 each)."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.models import cxr_bert
    from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )

    w = torch.randn(ids.shape[0], model.dims.projection_size, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(17))
    params = dict(model.named_parameters())
    embed_inputs = cxr_bert.embed_inputs
    captured = {}

    def capture(*a, **kw):  # the input embeddings, kept for their gradient
        x = embed_inputs(*a, **kw)
        captured["x"] = x
        return x

    def grads(dtype, flash):
        loss = (cxr_bert.get_projected_text_embeddings(model, ids, mask, dtype=dtype,
                                                       use_flash_attention=flash) * w).sum()
        names = [n for n, p in params.items() if p.requires_grad]
        gs = torch.autograd.grad(loss, [params[n] for n in names] + [captured["x"]],
                                 allow_unused=True)
        out = {n: g for n, g in zip(names, gs[:-1]) if g is not None}
        out["input embeddings"] = gs[-1]
        return out

    was = {n: p.requires_grad for n, p in params.items()}
    model.requires_grad_(True)
    for p in model.mlm_head.parameters():  # off the projection's path
        p.requires_grad_(False)
    cxr_bert.embed_inputs = capture
    out = {}
    try:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            for fn in (flash_attention, flash_attention_bwd):
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flash = grads(dtype, True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"flash_attention": flash_attention.launches,
                        "flash_attention_bwd": flash_attention_bwd.launches}
            dense = grads(dtype, False)
            torch.cuda.synchronize()
            check(sorted(flash) == sorted(dense), "flash and dense differ in what has a gradient")
            check(all(bool(torch.isfinite(g).all()) for g in flash.values()), f"{dname}: not finite")
            scale = max(float(g.abs().max()) for n, g in dense.items() if n != "input embeddings")
            per = {n: grad_metrics(flash[n], dense[n]) for n in dense}
            rel = max(float((flash[n] - dense[n]).abs().max()) / scale
                      for n in dense if n != "input embeddings")
            # the key projection's bias moves every logit of a row by the
            # same q.b_k, which the softmax cancels: its gradient is zero in
            # exact arithmetic, rounding noise on both paths, and has no
            # direction to compare (it is held to the largest-gradient bar)
            directed = [n for n in per if not n.endswith(".k.bias")]
            worst = min(directed, key=lambda n: per[n]["cos"])
            cos_min = per[worst]["cos"]
            k_bias = max(float(flash[n].abs().max()) / scale for n in per if n not in directed)
            out[dname] = dict(launches=launches, flash_grad_wall_s=wall, params=len(dense) - 1,
                              max_rel_of_largest=rel,
                              input_embeddings=per["input embeddings"], cos_min=cos_min,
                              cos_min_param=worst, key_bias_max_of_largest=k_bias)
            log(f"  (b) {dname}: {json.dumps(out[dname])}")
            check(launches == {"flash_attention": model.dims.num_layers,
                               "flash_attention_bwd": model.dims.num_layers},
                  f"{dname}: launches {launches}, not {model.dims.num_layers} of each")
            if dtype == torch.float32:
                check(rel <= TEXT_GRAD_F32_ATOL, f"fp32 gradients, flash vs dense: {rel}")
                check(per["input embeddings"]["rel"] <= TEXT_GRAD_F32_ATOL,
                      f"fp32 input-embedding gradient: {per['input embeddings']}")
            else:
                check(cos_min > TEXT_GRAD_BF16_COS, f"bf16 gradients: cos {cos_min} ({worst})")
            del flash, dense
        # one gradient of the batch, flash against dense, in turns: bf16, then fp32
        out["grad_ms"] = alternating_ms(
            {"flash": lambda: grads(torch.bfloat16, True),
             "dense": lambda: grads(torch.bfloat16, False)}, rounds=3, iters=2)
        log(f"  (b) bf16 gradient of the (32, 512) batch: {json.dumps(out['grad_ms'])} ms")
        out["grad_ms_fp32"] = alternating_ms(
            {"flash": lambda: grads(torch.float32, True),
             "dense": lambda: grads(torch.float32, False)}, rounds=3, iters=2)
        log(f"  (b) fp32 gradient of the (32, 512) batch: {json.dumps(out['grad_ms_fp32'])} ms")
        if profile:
            for flash in (True, False):
                profile_window(f"one bf16 gradient of the (32, 512) batch, "
                               f"{'flash (K3 + K3b)' if flash else 'dense'} attention",
                               lambda: grads(torch.bfloat16, flash), results)
    finally:
        cxr_bert.embed_inputs = embed_inputs
        for n, p in params.items():
            p.requires_grad_(was[n])
        torch.cuda.empty_cache()
    results["text_tower_gradients"] = out
    return out


def k3b_times(results) -> dict:
    """(17c) K3b (CUDA events, medians of 5 rounds in turns with itself
    with skipping off and with the backward of SDPA through a graph built
    beforehand), the plain backward, the forward with and without its lse
    output, and the profiler's device time, at report length in bf16 and
    fp32 and at hd 128; the TFLOP/s on the pairs the masks need and on the
    64 x 64 pairs computed; each K3b kernel's ``ptxas -v`` line."""
    import torch
    import torch.nn.functional as F

    from incremental_multimodal_medical_learning_ii_torch.ops import flash_attention as fa

    times = {}
    report_lengths = ragged_lengths(REPORT[0], REPORT[2], seed=1)
    for name, shape, lengths, dtype in (
            ("bfloat16", REPORT, report_lengths, torch.bfloat16),
            ("float32", REPORT, report_lengths, torch.float32),
            ("bfloat16 hd128", (4, 4, 256, 128), [256, 200, 130, 17], torch.bfloat16)):
        q, k, v, seg, scale = flash_inputs(shape, lengths, dtype, seed=10)
        do = torch.randn(*shape, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(11)).to(dtype)
        o, lse = fa._forward_kernel(q, k, v, seg, seg, scale, None, with_lse=True)
        bound, by, flops = flash_bwd_bound_ms(q, seg)
        allowed = (seg[:, :, None] == seg[:, None, :])[:, None]  # (B, 1, S, S)
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=allowed, scale=scale)
        lib = torch.autograd.grad(lib_out, leaves, do, retain_graph=True)
        ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, seg, seg, scale)
        lib_rel = max(grad_metrics(a, b)["rel"] for a, b in zip(lib, ref))
        del lib
        seg_copy = seg.clone()  # kv ids that are another array: every pair computed
        tiles = torch.zeros(2, dtype=torch.int32, device="cuda")
        fa.flash_attention_bwd(q, k, v, o, lse, do, seg, seg, scale, computed_tiles=tiles)
        computed, total = int(tiles[0]), k3b_pairs(q, seg, seg)[1]
        med = alternating_ms(
            {"ms": lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, seg, seg, scale),
             "ms_skipping_off": lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, seg, seg_copy,
                                                               scale),
             "library_ms": lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True)},
            iters=10)
        # the five products of the backward over the 64 x 64 pairs computed
        flops_computed = computed * BLOCK_PAIR * shape[3] * 10
        lse_bound = flash_lse_bound_ms(q, seg)
        fwd = alternating_ms(
            {"forward_ms": lambda: fa._forward_kernel(q, k, v, seg, seg, scale, None, False),
             "forward_lse_ms": lambda: fa._forward_kernel(q, k, v, seg, seg, scale, None, True)},
            iters=50)
        times[name] = dict(
            **med, **fwd,
            plain_ms=cuda_time_ms(
                lambda: fa.flash_attention_bwd_reference(q, k, v, o, lse, do, seg, seg, scale), 3,
                warmup=1),
            bound_ms=bound, bound_by=by, flops_needed=flops, tflops_needed=flops / med["ms"] / 1e9,
            pairs_computed=computed, pairs=total, skipped_tile_share=1.0 - computed / total,
            forward_lse_bound_ms=lse_bound[0], forward_lse_bound_by=lse_bound[1],
            tflops_computed=flops_computed / med["ms"] / 1e9,
            shape=list(shape), library_max_rel_vs_plain=lib_rel,
            kernel_device_ms=profiled_device_ms(
                lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, seg, seg, scale),
                fa.flash_attention_bwd, "flash_bwd_", med["ms"], bound, iters=10, per_launch=3))
        log(f"  (c) K3b {name} {shape}: {json.dumps(times[name])}")
        del lib_out, leaves, ref
        torch.cuda.empty_cache()
    for entry, rep in results["ptxas"].items():
        if "flash_bwd_" in entry:
            log(f"  (c) ptxas -v {entry}: {rep}")
    results["k3b_times"] = times
    return times


def trace_contents(trace_dir: Path) -> dict:
    """The files, the named spans and the kernels (name: count) of the
    profiler traces in ``trace_dir``."""
    import collections

    spans, kernels = collections.Counter(), collections.Counter()
    files = sorted(Path(trace_dir).rglob("*.pt.trace.json"))
    check(bool(files), f"no trace written into {trace_dir}")
    for f in files:
        for e in json.loads(f.read_text())["traceEvents"]:
            if e.get("cat") == "user_annotation":
                spans[e["name"]] += 1
            elif e.get("cat") == "kernel":
                kernels[e["name"]] += 1
    return {"files": len(files), "spans": dict(spans), "kernels": dict(kernels)}


def tools_phase(model, results) -> dict:
    """(17d) The profiling tools on the card: ``cli/zero_joint_bounds.py
    --synthetic --epochs 2 --trace-dir`` (the spans and K1's kernel in the
    trace; the run's wall time beside the same run untraced),
    ``extract_embeddings(trace_dir=)`` (the extraction spans), and
    ``device_encode_rate`` at the root bench.py's shape with and without K2, beside
    phase 13e's rate."""
    import contextlib
    import shutil
    import tempfile

    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.cli import zero_joint_bounds
    from incremental_multimodal_medical_learning_ii_torch.engine.extract import (
        extract_embeddings,
    )
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        fold_grayscale_conv1,
    )
    from incremental_multimodal_medical_learning_ii_torch.utils.device_bench import (
        device_encode_rate,
    )

    out = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tools_"))
    try:
        walls = {}
        for traced in (False, True):
            flags = ["--synthetic", "--epochs", "2", "--mesh-devices", "1",
                     "--log-dir", str(tmp / f"runs-{traced}")]
            if traced:
                flags += ["--trace-dir", str(tmp / "trace")]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                zero_joint_bounds.main(flags)
            walls["traced" if traced else "untraced"] = time.perf_counter() - t0
        trace = trace_contents(tmp / "trace")
        k1 = sum(n for name, n in trace["kernels"].items() if "fused_cosine_kernel" in name)
        out["training_run"] = dict(wall_s=walls, files=trace["files"], spans=trace["spans"],
                             k1_kernel_rows=k1, kernel_rows=sum(trace["kernels"].values()))
        log(f"  (d) zero_joint_bounds --trace-dir: {json.dumps(out['training_run'])}")
        check(trace["spans"].get("fused-train-epoch", 0) + trace["spans"].get("fused-joint-run", 0)
              >= 1, f"no fused training span in the trace: {trace['spans']}")
        check(trace["spans"].get("eval-pass", 0) >= 4, f"eval spans: {trace['spans']}")
        check(k1 > 0, "K1's kernel is not in the trace")

        rng = np.random.default_rng(5)
        imgs = [(rng.integers(0, 256, (390, 320), dtype=np.uint8), np.zeros(5, np.float32))
                for _ in range(16)]
        ds = extract_embeddings(iter(imgs), model, batch_size=8, size=EXTRACT_SIZE,
                                readback_interval=1, trace_dir=str(tmp / "extract-trace"))
        trace = trace_contents(tmp / "extract-trace")
        out["extraction"] = dict(rows=len(ds), spans=trace["spans"],
                                 kernel_rows=sum(trace["kernels"].values()))
        log(f"  (d) extract_embeddings(trace_dir=): {json.dumps(out['extraction'])}")
        check(len(ds) == 16 and trace["spans"].get("extract_dispatch") == 2
              and trace["spans"].get("extract_readback", 0) >= 1
              and out["extraction"]["kernel_rows"] > 0, f"extraction trace {out['extraction']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    fm = fold_grayscale_conv1(model)
    rates = {}
    for fused in (False, True):
        rates["K2" if fused else "cuDNN"] = device_encode_rate(
            fm, **BENCH_SHAPE, fused_layer1=fused, k_short=2, k_long=8)
    del fm
    torch.cuda.empty_cache()
    out["device_encode_rate"] = dict(
        images_per_s=rates, **BENCH_SHAPE,
        phase_13e_images_per_s=results["device_encode"]["images_per_s"])
    log(f"  (d) device_encode_rate (chained, long minus short): "
        f"{json.dumps(out['device_encode_rate'])}")
    check(all(r is not None and r > 0 for r in rates.values()), f"device_encode_rate {rates}")
    results["tools"] = out
    return out


# ----------------------------------------------------------------------
# ----------------------------------------------------------------------
# the figures: evaluation/plots.py, evaluation/projection.py, the hooks
# ----------------------------------------------------------------------
FIGURE_ATOL = 1e-6  # the card against its CPU: eval scores, heatmap, ROC / PR and PCA data
# scores of one class closer than this on the card count as one score on
# both devices (a pair that close may swap between devices, which moves a
# curve point by a whole 1/n): 4x FIGURE_ATOL, so scores within their bar
# keep the groups' order and a row the two devices put more than 2e-6
# apart can reorder them
FIGURE_TIE = 4e-6
# eval predictions (pos > neg) the two devices may call differently: a
# margin within fp32 noise of 0; a fault in the scorer flips a share of them
FIGURE_PRED_FLIPS = 1e-4
# t-SNE, the card against its CPU.  Its steps on the same P and start (5
# of each stage) and its P from each device's own rows are held tightly;
# whole runs, 1000 iterations of fp64 that part chaotically on two devices
# and may end in different local minima, only by their KL and neighbours.
# Each bar is read against three faults planted on the card alone
# (TSNE_FAULTS), printed beside the sound run's readings.  On an H100 at
# the subsets' 1,000 and 800 rows (PERF.md): sound P 6.4e-6 / 6.6e-6,
# steps <= 1.3e-15, KL 4.6e-5 / 1.6e-2, 10-NN 0.98 / 0.68; planted P 1.3
# (perplexity / 3), steps 0.44-1.8 (no exaggeration, half gradient). The
# whole-run bars catch only perplexity / 3 (KL 7.7-8.5%): no exaggeration
# and half gradient end within 1.5% in KL and share 0.65-0.89 of the
# neighbours, so the step bars hold the arithmetic and the 10-NN floor
# only a gross fault (chance: 1%; one CPU at 1 vs 4 threads shares 0.35)
TSNE_STEPS = 5
TSNE_STEP_RTOL = 1e-9  # of the largest |y| after the steps
TSNE_P_RTOL = 1e-4  # of the largest P (fp32 cosine distances on each device)
TSNE_KL_REL = 0.05
TSNE_KNN_SHARE = 0.2
TSNE_KNN = 10
TSNE_FAULTS = ("no exaggeration", "half gradient", "perplexity / 3")
FIGURE_CUT_AFTER_S = 800.0  # past this, 18a's runs go to 2 epochs


def knn_share(a, b, k: int = TSNE_KNN) -> float:
    """The mean share of each row's ``k`` nearest neighbours that two
    embeddings of the same rows agree on."""
    import torch

    def nearest(y):
        d = torch.cdist(y, y)
        d.fill_diagonal_(float("inf"))
        return d.topk(k, largest=False).indices

    na, nb = nearest(a.double().cpu()), nearest(b.double().cpu())
    return float(sum(len(set(x.tolist()) & set(y.tolist())) for x, y in zip(na, nb))
                 / (k * len(na)))


@contextlib.contextmanager
def planted_tsne_fault(fault: str):
    """One fault in ``evaluation/projection.py``'s arithmetic, on CUDA
    tensors only (the CPU stays sound), undone on exit: the first stage's P
    not exaggerated, the gradient halved, or the perplexity a third."""
    from incremental_multimodal_medical_learning_ii_torch.evaluation import projection

    name, sound = {
        "no exaggeration": ("_descend", projection._descend),
        "half gradient": ("kl_divergence_and_gradient", projection.kl_divergence_and_gradient),
        "perplexity / 3": ("conditional_probabilities", projection.conditional_probabilities),
    }[fault]

    def faulty(first, *a):
        if not first.is_cuda:
            return sound(first, *a)
        if fault == "no exaggeration":  # (y, p, it, ...): the stage from iteration 0
            return sound(first, a[0] / projection.EARLY_EXAGGERATION if a[1] == 0 else a[0], *a[1:])
        if fault == "half gradient":
            kl, grad = sound(first, *a)
            return kl, grad * 0.5
        return sound(first, a[0] / 3)

    setattr(projection, name, faulty)
    try:
        yield
    finally:
        setattr(projection, name, sound)


def tsne_readings(x, cpu) -> dict:
    """The card's t-SNE of the rows ``x`` (on the card) against the CPU's
    (``cpu``: ``projection.tsne(x.cpu())``): P from each device's rows;
    TSNE_STEPS steps of each stage from the CPU's P and start on both; the
    whole run's KL and shared neighbours."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.evaluation import projection

    n = x.shape[0]
    perplexity = projection.perplexity_for(n)
    p_cpu = projection.joint_probabilities(x.cpu(), perplexity)
    p_card = projection.joint_probabilities(x, perplexity)
    out = dict(p_err=float((p_card.cpu() - p_cpu).abs().max() / p_cpu.abs().max()))
    y0 = projection.pca_2d(x.cpu()).to(torch.float32)
    y0 = (y0 / y0[:, 0].std(unbiased=False) * 1e-4).double()
    lr = max(n / projection.EARLY_EXAGGERATION / 4, 50.0)
    for stage, (p, it, momentum) in {
        "exploration": (p_cpu * projection.EARLY_EXAGGERATION, 0, 0.5),
        "convergence": (p_cpu, projection.EXPLORATION_ITERS + 1, 0.8),
    }.items():
        steps = [projection._descend(y, p.to(y.device), it, it + TSNE_STEPS, momentum, lr,
                                     projection.N_ITER_WITHOUT_PROGRESS)[0].cpu()
                 for y in (y0.cuda(), y0)]
        out[f"{stage}_step_err"] = float((steps[0] - steps[1]).abs().max() / steps[1].abs().max())
    run = projection.tsne(x)
    out.update(finite=bool(torch.isfinite(run.embedding).all()) and run.embedding.shape == (n, 2),
               kl=run.kl_divergence, n_iter=run.n_iter,
               kl_rel=abs(run.kl_divergence - cpu.kl_divergence) / cpu.kl_divergence,
               knn10_share=knn_share(run.embedding, cpu.embedding))
    return out


def tsne_failures(r: dict) -> list:
    """The t-SNE bars a reading of :func:`tsne_readings` fails."""
    return [name for name, bad in (
        ("finite", not r["finite"]),
        ("P", r["p_err"] > TSNE_P_RTOL),
        ("exploration steps", r["exploration_step_err"] > TSNE_STEP_RTOL),
        ("convergence steps", r["convergence_step_err"] > TSNE_STEP_RTOL),
        ("KL", r["kl_rel"] > TSNE_KL_REL),
        ("neighbours", r["knn10_share"] < TSNE_KNN_SHARE)) if bad]


def tie_merged(card, cpu, tau: float = FIGURE_TIE):
    """One class's scores from each device snapped to the card's tie
    groups (the card's sorted scores split where a gap exceeds ``tau``):
    each row takes its group's largest score on its own device.  Returns
    both columns and the number of rows in groups of more than one."""
    import numpy as np

    order = np.argsort(card, kind="stable")
    group = np.empty(len(card), np.int64)
    group[order] = np.concatenate([[0], np.cumsum(np.diff(card[order]) > tau)])
    snapped = []
    for s in (card, cpu):
        top = np.full(group.max() + 1, -np.inf)
        np.maximum.at(top, group, s)
        snapped.append(top[group])
    return snapped[0], snapped[1], int((np.bincount(group)[group] > 1).sum())


def eval_figure_data(records: list, trainer, test) -> dict:
    """The test passes a figure run drew from (``records``: epoch, labels,
    predictions, scores and the params of each), run again on the CPU with
    the same params: the scores, the predictions, and the data of the ROC
    and PR figures (every class, the last pass) and of the F1 and AUROC
    heatmaps (every pass) from each device's outputs; scores closer than
    FIGURE_TIE on the card are one score on both devices
    (:func:`tie_merged`), and F1 cells whose rows' predictions differ are
    counted, not compared."""
    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer
    from incremental_multimodal_medical_learning_ii_torch.evaluation import plots
    from incremental_multimodal_medical_learning_ii_torch.evaluation.metrics import (
        per_class_metrics,
    )

    def curve_err(a, b):
        if a.data["x"].shape != b.data["x"].shape:
            return float("inf")
        return float(max(np.abs(a.data["x"] - b.data["x"]).max(),
                         np.abs(a.data["y"] - b.data["y"]).max()))

    cpu = Trainer(trainer.cfg, trainer.bank.to("cpu"), device="cpu")
    rows = {"card": {"f1": [], "auroc": []}, "cpu": {"f1": [], "auroc": []}}
    score_err, flips, merged, flipped_cells = 0.0, 0, 0, np.zeros(0, bool)
    errs = {}
    for i, (epoch, y_true, y_pred, y_score, params) in enumerate(records):
        cpu.state = cpu.state._replace(params={k: v.cpu() for k, v in params.items()})
        t, pred, score = cpu._eval_pass(test, epoch, log_loss_prefix=None)
        check(np.array_equal(t, y_true), "18c: the CPU's eval pass read other labels")
        score_err = max(score_err, float(np.abs(score - y_score).max()))
        flip = pred != y_pred
        flips += int(flip.sum())
        flipped_cells = np.concatenate([flipped_cells, flip.any(axis=0)])
        snapped = [tie_merged(y_score[:, c], score[:, c]) for c in range(y_score.shape[1])]
        merged += sum(m for _, _, m in snapped)
        card_s, cpu_s = (np.stack([s[k] for s in snapped], axis=1) for k in (0, 1))
        for device, (p, s) in (("card", (y_pred, card_s)), ("cpu", (pred, cpu_s))):
            pc = per_class_metrics(y_true, p, s)
            rows[device]["f1"].append(pc["f1"])
            rows[device]["auroc"].append(pc["auroc"])
        if i == len(records) - 1:
            for fn in (plots.roc_curve_figure, plots.pr_curve_figure):
                errs[fn.__name__] = max(curve_err(fn(y_true[:, c], card_s[:, c], c),
                                                  fn(y_true[:, c], cpu_s[:, c], c))
                                        for c in range(y_true.shape[1]))
    labels = [str(e) for e, *_ in records]
    cols = list(trainer.class_names)
    for metric in ("f1", "auroc"):
        card_m, cpu_m = (plots.heatmap_figure(np.stack(rows[d][metric]), labels, cols, metric,
                                              metric.upper()).data["matrix"] for d in rows)
        keep = ~flipped_cells.reshape(card_m.shape) if metric == "f1" else np.ones(card_m.shape, bool)
        errs[f"heatmap {metric}"] = float(np.abs(card_m - cpu_m)[keep].max())
    errs["eval scores"] = score_err
    n_preds = sum(r[2].size for r in records)
    return dict(errs=errs, passes=len(records), pred_flips=flips, pred_flip_share=flips / n_preds,
                f1_cells_not_compared=int(flipped_cells.sum()), tied_rows=merged)


def figures_phase(results, elapsed_s: float) -> dict:
    """(18) The figures.  (a) ``zero_joint_bounds`` joint at phase 12's scale
    with ``--plot-figures reference --tsne-plots`` and with ``--plot-figures
    off``, in turns (figures, off, off, figures), the fused loops under sync
    debug mode: walls, image events, K1's launches (= phase 12's joint
    run's); (b) the t-SNE's time on the card at the 1,000 and 800 rows of
    the t-SNE subsets (adapted by the run's parameters), CUDA events; (c)
    the card against its CPU on the same inputs: the first figure run's test
    passes run again on the CPU with each pass's params (scores,
    predictions, the ROC / PR and heatmap data drawn from them), PCA, the
    prompt cosine matrix from each device's adapted means, and the t-SNE
    (:func:`tsne_readings`), sound and with each of TSNE_FAULTS planted on
    the card; (d) ``ground --out``, ``dataset_stats --patterns-png`` and
    ``analyze_prompts`` write decodable PNGs of the JAX figures' sizes."""
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from incremental_multimodal_medical_learning_ii_torch.cli import (
        analyze_prompts,
        dataset_stats,
        ground,
    )
    from incremental_multimodal_medical_learning_ii_torch.data.store import (
        EmbeddingDataset,
        filter_multiclass,
        filter_sani_malati,
    )
    from incremental_multimodal_medical_learning_ii_torch.engine import protocols
    from incremental_multimodal_medical_learning_ii_torch.engine.steps import adapt_bank, apply_image
    from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer
    from incremental_multimodal_medical_learning_ii_torch.evaluation import plots, projection
    from incremental_multimodal_medical_learning_ii_torch.evaluation.tb import read_images
    from incremental_multimodal_medical_learning_ii_torch.models.adapters import AdapterPair
    from incremental_multimodal_medical_learning_ii_torch.ops.cosine import masked_mean
    from incremental_multimodal_medical_learning_ii_torch.text.bank import (
        build_prompt_bank,
        synthetic_encode_fn,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
    )

    out: dict = {"runs": {}}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_figures_"))
    epochs = 10 if elapsed_s < FIGURE_CUT_AFTER_S else 2
    if epochs != 10:
        log(f"  (a) cut to {epochs} epochs: {elapsed_s:.0f} s have passed (> {FIGURE_CUT_AFTER_S})")
    out["epochs"] = epochs
    joint_k1 = results["training"]["runs"]["joint"]["launches"]["fused_pairwise_cosine"]
    calls: dict = {}
    host_s: dict = {}
    undo = guarded_loops(calls, host_s)
    # where the figure run's time goes: host seconds in the t-SNE subsets'
    # filters, in the figure functions (t-SNE on the card inside them,
    # synchronised by its stop checks) and in the PNG encoding at commit
    spent: dict = {}
    timed = [(protocols.DataBundle, "with_tsne_subsets", "subsets"),
             (projection, "tsne", "tsne"), (plots.Figure, "png", "png")]
    timed += [(plots, n, "figures") for n in (
        "heatmap_figure", "roc_curve_figure", "pr_curve_figure", "class_scatter_figure",
        "prompt_cosine_heatmap_figure", "prompt_projection_figures", "embedding_tsne_figure")]
    saved = [(owner, n, getattr(owner, n)) for owner, n, _ in timed]

    def clocked(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
        return run

    records: list = []  # the first figure run's test passes (18c) and its trainer
    records_of: list = []
    evaluate = Trainer.evaluate_model

    def recorded(self, y_true, y_pred, y_score, mode, epoch, val_test, *a, **k):
        if val_test == "test":
            records.append((epoch, y_true, y_pred, y_score,
                            {n: v.detach().cpu().clone() for n, v in self.state.params.items()}))
            records_of.append(self)
        return evaluate(self, y_true, y_pred, y_score, mode, epoch, val_test, *a, **k)

    try:
        data_dir = training_data(tmp / "data")
        flags = {"reference --tsne-plots": ["--plot-figures", "reference", "--tsne-plots"],
                 "off": ["--plot-figures", "off"]}
        walls: dict = {name: [] for name in flags}
        params = None
        # in turns, each order once: figures, off, off, figures
        for turn, name in enumerate(["reference --tsne-plots", "off", "off", "reference --tsne-plots"]):
            calls.clear()
            spent.clear()
            for (owner, n, key), (_, _, fn) in zip(timed, saved):
                setattr(owner, n, clocked(fn, key))
            if turn == 0:
                Trainer.evaluate_model = recorded
            log_dir = tmp / f"{turn}-{name.split()[0]}"
            try:
                r = run_driver("zero_joint_bounds", [*flags[name], "--epochs", str(epochs)], data_dir,
                               log_dir, "cuda", host_s)
            finally:
                for owner, n, fn in saved:
                    setattr(owner, n, fn)
                Trainer.evaluate_model = evaluate
            (events,) = sorted(log_dir.glob("**/events.out.tfevents.*"))
            images = read_images(events)
            k1 = r["launches"]["fused_pairwise_cosine"]
            walls[name].append(r["wall_s"])
            run = dict(wall_s=r["wall_s"], image_events=len(images), k1_launches=k1,
                       guarded_loop_calls=dict(calls), host_s=dict(spent),
                       image_sizes=sorted({(i["width"], i["height"]) for _, _, i in images}))
            out["runs"][f"{turn} {name}"] = run
            log(f"  (a) turn {turn}, joint {name}: {r['wall_s']:.2f} s, {len(images)} image events, "
                f"K1 launches {k1} (phase 12's joint: {joint_k1 * epochs // 10}), guarded loop calls "
                f"{json.dumps(calls)}, host s in the figure code {json.dumps(spent)}")
            check(k1 == joint_k1 * epochs // 10, f"18a {name}: K1 launched {k1} times")
            check(all(calls.get(n, 0) > 0 for n in ("build_fused_epoch", "build_fused_eval")),
                  f"18a {name}: a fused loop ran unguarded: {calls}")
            if name == "off":
                check(not images, "18a: --plot-figures off wrote figures")
            else:
                check(len(images) > 0 and all(i["colorspace"] == 3 for _, _, i in images),
                      "18a: no RGB figures")
                check({(640, 480)} == set(run["image_sizes"]), f"18a: figure sizes {run['image_sizes']}")
                if params is None:
                    params = {k: v.cuda() for k, v in r["params"].items()}
        ref, off = statistics.mean(walls["reference --tsne-plots"]), statistics.mean(walls["off"])
        out.update(walls_s=walls, figure_wall_s=ref - off)
        log(f"  (a) the figures cost {ref - off:.2f} s of the {ref:.2f} s run ({epochs} epochs; means "
            f"of two turns: figures {walls['reference --tsne-plots']}, off {walls['off']})")

        # (b) the t-SNE on the card, at the subsets' rows, adapted as in the run
        pair = AdapterPair(kind="mlp", shared=False, use_image=True, use_text=True)
        train = EmbeddingDataset.load(data_dir / "train.npz")
        subsets = {"5x1000": filter_multiclass(train), "sani-malati": filter_sani_malati(train)}
        adapted = {}
        with torch.no_grad():
            for kind, ds in subsets.items():
                adapted[kind] = apply_image(pair, params, torch.from_numpy(ds.embeddings).cuda())
        out["tsne"] = {}
        for kind, x in adapted.items():
            times, run = [], None
            for _ in range(3):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                run = projection.tsne(x)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            # (c) the same rows through the CPU; then three faults planted on the card
            t0 = time.perf_counter()
            cpu = projection.tsne(x.cpu())
            cpu_s = time.perf_counter() - t0
            sound = tsne_readings(x, cpu)
            faults = {}
            for fault in TSNE_FAULTS:
                with planted_tsne_fault(fault):
                    faults[fault] = tsne_readings(x, cpu)
                faults[fault]["fails"] = tsne_failures(faults[fault])
            out["tsne"][kind] = dict(rows=int(x.shape[0]), ms=statistics.median(times), all_ms=times,
                                     n_iter=run.n_iter, cpu_s=cpu_s, cpu_kl=cpu.kl_divergence,
                                     sound=sound, planted=faults)
            log(f"  (b) t-SNE {kind} ({x.shape[0]} rows): card {statistics.median(times):.1f} ms "
                f"(CUDA events, median of 3: {[round(t, 1) for t in times]}), KL {run.kl_divergence:.5f}"
                f" after {run.n_iter + 1} iterations; CPU {cpu_s:.2f} s, KL {cpu.kl_divergence:.5f}")
            log(f"  (c) t-SNE {kind}, the card against its CPU (bars: P {TSNE_P_RTOL}, steps "
                f"{TSNE_STEP_RTOL}, KL {TSNE_KL_REL}, 10-NN share >= {TSNE_KNN_SHARE}): sound "
                f"{json.dumps(sound)}")
            for fault, reading in faults.items():
                log(f"  (c) t-SNE {kind}, planted on the card, {fault}: {json.dumps(reading)}")
            check(not tsne_failures(sound), f"t-SNE {kind}: the card fails {tsne_failures(sound)}")
            check(all(r["fails"] for r in faults.values()),
                  f"t-SNE {kind}: a planted fault passes every bar: {faults}")

        # (c) the rest of the figure data, the card against its CPU
        errs = {}
        for kind, x in adapted.items():
            errs[f"pca {kind}"] = float((projection.pca_2d(x).cpu()
                                         - projection.pca_2d(x.cpu())).abs().max())
        bank = build_prompt_bank(synthetic_encode_fn(27), create_prompts(CHEXPERT_COMPETITION_TASKS),
                                 CHEXPERT_COMPETITION_TASKS)
        means = {}
        for device in ("cuda", "cpu"):
            with torch.no_grad():
                b = adapt_bank(pair, {k: v.to(device) for k, v in params.items()}, bank.to(device))
                means[device] = (masked_mean(b.pos, b.pos_count), masked_mean(b.neg, b.neg_count))
        figs = {d: plots.prompt_cosine_heatmap_figure(*means[d], single_prompt=False)
                for d in means}
        errs["prompt cosine matrix"] = float(np.abs(figs["cuda"].data["matrix"]
                                                    - figs["cpu"].data["matrix"]).max())
        for d in means:
            figs[d] = plots.prompt_projection_figures(*means[d])[0]
        errs["prompt PCA"] = float(np.abs(figs["cuda"].data["coords"]
                                          - figs["cpu"].data["coords"]).max())
        evals = eval_figure_data(records, records_of[0], EmbeddingDataset.load(data_dir / "test.npz"))
        errs.update(evals.pop("errs"))
        out["card_vs_cpu"] = dict(errs=errs, **evals)
        log(f"  (c) figure data, card against CPU (bar {FIGURE_ATOL}): {json.dumps(errs)}; the "
            f"{evals['passes']} test passes of turn 0: {evals['pred_flips']} predictions called "
            f"differently (share {evals['pred_flip_share']:.2e}, bar {FIGURE_PRED_FLIPS}; F1 cells "
            f"not compared {evals['f1_cells_not_compared']}), {evals['tied_rows']} rows in tie "
            f"groups of {FIGURE_TIE}")
        check(evals["passes"] == epochs, f"18c: {evals['passes']} test passes recorded")
        check(max(errs.values()) <= FIGURE_ATOL, f"18c: figure data differ: {errs}")
        check(evals["pred_flip_share"] <= FIGURE_PRED_FLIPS, f"18c: predictions differ: {evals}")

        # (d) the other entry points' PNGs
        png = write_cxr_png(tmp / "cxr.png")
        with contextlib.redirect_stdout(io.StringIO()):
            ground.main(["--image", str(png), "--query", GROUND_QUERY, "--random-weights",
                         *GROUND_FLAGS, "--out", str(tmp / "ground.png")])
        csv_path = tmp / "labels.csv"
        rng = np.random.default_rng(3)
        lab = rng.choice(["0.0", "1.0", "-1.0"], size=(2000, 5), p=[0.6, 0.3, 0.1])
        csv_path.write_text("\n".join([",".join(["Path", *CHEXPERT_COMPETITION_TASKS])]
                                      + [",".join([f"p{i}/view1_frontal.jpg", *row])
                                         for i, row in enumerate(lab)]) + "\n")
        with contextlib.redirect_stdout(io.StringIO()):
            dataset_stats.main(["--csv", str(csv_path), "--patterns-png",
                                str(tmp / "patterns.png")])
            prompt_pngs = analyze_prompts.main(["--out-dir", str(tmp / "prompts")])
        sizes = {}
        for path, want in ((tmp / "ground.png", (1500, 600)), (tmp / "patterns.png", (800, 600)),
                           *((p, (960, 720)) for p in prompt_pngs)):
            with Image.open(path) as im:
                im.load()
                sizes[path.name] = im.size
                check(im.format == "PNG" and im.size == want, f"18d: {path.name} is {im.size}")
        out["pngs"] = sizes
        log(f"  (d) ground --out, dataset_stats --patterns-png, analyze_prompts: {json.dumps(sizes)}")
    finally:
        undo()
        shutil.rmtree(tmp, ignore_errors=True)
    results["figures"] = out
    return out


# ----------------------------------------------------------------------
# link health (phase 19)

LH_UPLOAD_RATIO = 3.0  # the probe's median upload against the copy timed here, either way
LH_RTT_MAX_MS = 20.0  # the CLI's own slow-sync line
LH_COMPILE_MAX_S = 30.0  # the CLI's default --compile-slow-s
TOOLCHAIN = ("nvcc", "cicc", "ptxas", "cudafe++", "fatbinary", "nvlink")


def toolchain_pids() -> set:
    """The running (not zombie) processes of the CUDA toolchain."""
    pids = set()
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            text = stat.read_text()
        except OSError:  # gone while listed
            continue
        name, state = text[text.index("(") + 1:text.rindex(")")], text[text.rindex(")") + 2]
        if name in TOOLCHAIN and state != "Z":
            pids.add(int(stat.parent.name))
    return pids


def pageable_upload_mb_per_s(mb: int, samples: int = 5) -> float:
    """Median MiB/s of ``torch.from_numpy(buf).to("cuda")`` of a fresh
    pageable ``mb`` MiB uint8 buffer, CUDA events around the copy."""
    import statistics

    import numpy as np
    import torch

    n = mb * 1024 * 1024
    rng = np.random.default_rng(0)
    torch.from_numpy(np.zeros(n, np.uint8)).to("cuda")
    rates = []
    for _ in range(samples):
        buf = torch.from_numpy(rng.integers(0, 256, size=n, dtype=np.uint8))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        buf.to("cuda")
        end.record()
        end.synchronize()
        rates.append(mb / (start.elapsed_time(end) / 1e3))
    return statistics.median(rates)


def linkhealth_phase(card: str, results) -> dict:
    """(19) ``cli/linkhealth.py`` through ``main`` and ``quick_probe`` as a
    user calls them; each leg's raw result is recorded by wrapping
    ``_run_probe`` (the compile leg's salt among them)."""
    from incremental_multimodal_medical_learning_ii_torch.cli import linkhealth
    from incremental_multimodal_medical_learning_ii_torch.ops import cuda_build

    legs = []
    run_probe = linkhealth._run_probe

    def recorded(code, timeout_s, env_extra):
        legs.append((code, *run_probe(code, timeout_s, env_extra)))
        return legs[-1][1:]

    def cli(*argv):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            line = linkhealth.main(list(argv))
        check(printed.getvalue() == json.dumps(line) + "\n",
              f"linkhealth printed {printed.getvalue()!r}")
        return line, time.perf_counter() - t0

    sources = dict(cuda_build.SOURCES)
    build_before = sorted(p.name for p in cuda_build.BUILD_DIR.iterdir())
    tools_before = toolchain_pids()
    linkhealth._run_probe = recorded
    try:
        ok, ok_s = cli()
        slow, slow_s = cli("--compile-slow-s", "0")
        salts = [r["salt"] for code, r, _ in legs if code is linkhealth._COMPILE and r]
        dead, dead_s = cli("--probe-timeout", "0.01", "--compile-timeout", "0.01")
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            t0 = time.perf_counter()
            quick = linkhealth.quick_probe(timeout_s=45)
            quick_s = time.perf_counter() - t0
    finally:
        linkhealth._run_probe = run_probe
    t0 = time.perf_counter()
    while toolchain_pids() - tools_before and time.perf_counter() - t0 < 5:
        time.sleep(0.05)
    left = sorted(toolchain_pids() - tools_before)
    in_process = pageable_upload_mb_per_s(8)
    r = dict(default=ok, default_s=ok_s, compile_slow_s_0=slow, compile_slow_s_0_s=slow_s,
             salts=salts, deadlines=dead, deadlines_s=dead_s, quick_probe=quick, quick_s=quick_s,
             in_process_upload_mb_per_s=in_process,
             upload_ratio=ok["upload_mb_per_s"] / in_process if ok["upload_mb_per_s"] else None,
             toolchain_left=left)
    results["linkhealth"] = r
    log(f"  linkhealth on {card}: {json.dumps(r)}")
    check(ok["backend"] == "cuda" and ok["verdict"] == "ok", f"linkhealth at its defaults: {ok}")
    check(0 < ok["rtt_ms"] <= LH_RTT_MAX_MS, f"rtt_ms {ok['rtt_ms']}")
    check(ok["upload_mb_per_s"] > 0, f"upload_mb_per_s {ok['upload_mb_per_s']}")
    check(0 < ok["compile_s"] < LH_COMPILE_MAX_S, f"compile_s {ok['compile_s']}")
    check(slow["verdict"] == "degraded-compile" and slow["compile_s"] > 0
          and "compile_error" not in slow, f"--compile-slow-s 0: {slow}")
    check(len(salts) == 2 and salts[0] != salts[1], f"compile salts {salts}")
    check(sorted(p.name for p in cuda_build.BUILD_DIR.iterdir()) == build_before,
          "the compile leg wrote into _build/")
    check(cuda_build.SOURCES == sources, "cuda_build.SOURCES changed")
    check(dead == {"backend": None, "rtt_ms": None, "upload_mb_per_s": None, "compile_s": None,
                   "verdict": "degraded-compile", "probe_error": "timeout",
                   "compile_error": "timeout"}, f"deadlines of 0.01 s: {dead}")
    check(not left, f"toolchain processes left running: {left}")
    check(set(quick) == {"rtt_ms", "upload_mb_per_s"} and quick["rtt_ms"] > 0
          and quick["upload_mb_per_s"] > 0, f"quick_probe: {quick}")
    check(printed.getvalue() == "", f"quick_probe printed {printed.getvalue()!r}")
    check(1 / LH_UPLOAD_RATIO <= r["upload_ratio"] <= LH_UPLOAD_RATIO,
          f"probe upload {ok['upload_mb_per_s']} MiB/s against {in_process:.1f} in process")
    return r


# ----------------------------------------------------------------------
# phase 21: a training epoch as a CUDA graph
# ----------------------------------------------------------------------
GRAPH_RUNS = {  # name: (protocol, config, units), phase 12's scale and flags, one Trainer each
    "joint": ("run_zero_joint", dict(mode="joint"), 1),
    "data-inc --fused-unit": ("run_data_incremental",
                              dict(mode="data-inc", parts=20, continual_learning="myCL"), 20),
    "class-pos-neg MORE_LABELS MAX": ("run_class_incremental",
                                      dict(mode="class-pos-neg", more_labels=True,
                                           prompt_mode="max"), 5),
}
GRAPH_EPOCHS_TIMED = 5  # epochs a turn in the eager / graphed epoch times
GRAPH_PEAK_BYTES = 2 * 2**30  # a graphed joint run's device memory peak


def staged_fused_calls(kept: list):
    """Wrap the trainer's whole-run folds so each call's staging lands in
    ``kept``, on the host: the metrics and evals it read back and the
    per-epoch (joint) or per-unit states it left on the card.  Returns
    the undo function."""
    import numpy as np
    import torch
    from torch.utils._pytree import tree_map

    from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer

    originals = {n: getattr(Trainer, n) for n in ("train_joint_run", "train_incremental_run")}

    def staging(trainer, name):
        if name == "train_joint_run":
            return trainer._joint_fetched, trainer._joint_evals, trainer._joint_states
        s = trainer._run_staging
        return s["fetched"], s["evals"], s["unit_states"]

    def keep(name, fn):
        def wrapped(self, *a, **k):
            out = fn(self, *a, **k)
            kept.append(tree_map(lambda x: x.cpu() if torch.is_tensor(x) else np.copy(x),
                                 staging(self, name)))
            return out
        return wrapped

    for n, fn in originals.items():
        setattr(Trainer, n, keep(n, fn))
    return lambda: [setattr(Trainer, n, fn) for n, fn in originals.items()]


def leaf_gaps(a, b) -> dict:
    """Two staged trees: whether every leaf is equal bit for bit, the
    largest |difference| and the number of leaves."""
    import numpy as np
    import torch
    from torch.utils._pytree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    check(len(la) == len(lb), f"the staged outputs differ in structure: {len(la)} / {len(lb)}")
    arrays = [(np.asarray(x, np.float64), np.asarray(y, np.float64)) for x, y in
              ((x.numpy() if torch.is_tensor(x) else x, y.numpy() if torch.is_tensor(y) else y)
               for x, y in zip(la, lb))]
    check(all(x.shape == y.shape for x, y in arrays), "the staged outputs differ in shape")
    return dict(equal=all(np.array_equal(x, y) for x, y in arrays),
                max_abs=max(float(np.max(np.abs(x - y), initial=0.0)) for x, y in arrays),
                leaves=len(la))


def graph_run(name: str, data, bank, graphed: bool, mesh=None) -> dict:
    """One driver of ``GRAPH_RUNS`` on the card, its fused loops under sync
    debug mode (``guarded_loops``), on the graphed path or forced onto the
    eager loop: the staging of its fused call, its final state, the
    recorder's counters and spans, its wall and device memory peak."""
    import collections
    import gc

    import torch

    from incremental_multimodal_medical_learning_ii_torch.engine import protocols, steps
    from incremental_multimodal_medical_learning_ii_torch.utils.config import ExperimentConfig
    from incremental_multimodal_medical_learning_ii_torch.utils.profiling import recording

    proto, kw, _ = GRAPH_RUNS[name]
    cfg = ExperimentConfig(batch_size=TRAIN_BS, eval_batch_size=EVAL_BS, lr=1e-4,
                           epochs=TRAIN_EPOCHS, fused_unit=True, plot_figures="off", **kw)
    kept: list = []
    calls: dict = {}
    host_s: dict = {}
    undo = [staged_fused_calls(kept), guarded_loops(calls, host_s)]
    rule = steps._graphs_epoch
    if not graphed:
        steps._graphs_epoch = lambda mesh, embs: False
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        with recording() as rec:
            res = getattr(protocols, proto)(cfg, data, bank, log_dir=None,
                                            device="cuda" if mesh is None else mesh.device,
                                            mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        steps._graphs_epoch = rule
        for u in undo:
            u()
    check(len(kept) == 1, f"{name}: {len(kept)} whole-run folds, not one")
    final = {k: v.cpu() for k, v in res["trainer"].state.params.items()}
    peak = torch.cuda.max_memory_allocated()
    del res
    gc.collect()
    torch.cuda.synchronize()
    names = collections.Counter(s.name for s in rec.spans)

    def span_ms(span):
        return [round((s.t1_ns - s.t0_ns) / 1e6, 3) for s in rec.named(span)]

    fold = "fused-joint-run" if name == "joint" else "fused-incremental-run"
    return dict(staged=kept[0], final=final, wall_s=wall, counters=dict(rec.counters),
                spans={n: names[n] for n in ("train-step", "train-graph-capture",
                                             "train-epoch-replay", "eval-batch")},
                fold_ms=span_ms(fold), capture_ms=span_ms("train-graph-capture"),
                replay_ms=span_ms("train-epoch-replay"), peak_bytes=peak,
                allocated_before=before, allocated_after_trainer=torch.cuda.memory_allocated(),
                guarded_calls=dict(calls))


def epoch_times(data, bank) -> dict:
    """ms an epoch of the joint run (32 steps of 6,144 rows), the fused
    epoch callable eager and graphed in turns on one Trainer's state and
    data (CUDA events over ``GRAPH_EPOCHS_TIMED`` epochs a turn); the
    graph's capture (host clock, synchronised) apart."""
    import numpy as np
    import torch

    from incremental_multimodal_medical_learning_ii_torch.engine import steps
    from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer
    from incremental_multimodal_medical_learning_ii_torch.utils.config import ExperimentConfig

    trainer = Trainer(ExperimentConfig(batch_size=TRAIN_BS, eval_batch_size=EVAL_BS, lr=1e-4,
                                       plot_figures="off"), bank, device="cuda")
    embs, labels, valid = trainer._device_data(data.train)
    n, n_pad = len(data.train), int(embs.shape[0])
    perms = [trainer._up(steps.epoch_permutation(27, e, n, n_pad).numpy())
             for e in range(GRAPH_EPOCHS_TIMED)]
    mask, thr = torch.ones(5, device=trainer.device), torch.zeros((), device=trainer.device)
    rule = steps._graphs_epoch
    state = trainer.state

    def turn(graphed: bool) -> float:
        nonlocal state
        if not graphed:
            steps._graphs_epoch = lambda mesh, e: False
        try:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for perm in perms:
                state, _ = trainer._fused_epoch(state, embs, labels, valid, trainer.bank, mask,
                                                thr, perm)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / len(perms)
        finally:
            steps._graphs_epoch = rule

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = trainer._fused_epoch(state, embs, labels, valid, trainer.bank, mask, thr, perms[0])
    torch.cuda.synchronize()
    first_graphed_s = time.perf_counter() - t0  # the capture and one replay
    turn(False)  # the eager loop's first launches
    ms = {"eager": [], "graphed": []}
    for graphed in (False, True, True, False, False, True):
        ms["graphed" if graphed else "eager"].append(turn(graphed))
    out = {k: float(np.median(v)) for k, v in ms.items()}
    return dict(ms_per_epoch=out, turns=ms, first_graphed_call_s=first_graphed_s,
                speedup=out["eager"] / out["graphed"])


def train_graph_phase(results) -> dict:
    """Phase 21: the graphed fused drivers against the same drivers forced
    onto the eager loop, at phase 12's scale, on the same inputs: the
    staged losses, evals and per-epoch / per-unit states and the final
    parameters bit for bit; one capture a Trainer (one signature each) and
    a replay an epoch; the graph and its pool freed with the Trainer; one
    NCCL rank (a mesh) stays eager; ms an epoch both ways."""
    import shutil
    import tempfile

    from incremental_multimodal_medical_learning_ii_torch.data.store import EmbeddingDataset
    from incremental_multimodal_medical_learning_ii_torch.engine.protocols import DataBundle
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import create_mesh
    from incremental_multimodal_medical_learning_ii_torch.text.bank import (
        build_prompt_bank,
        synthetic_encode_fn,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
    )

    bank = build_prompt_bank(synthetic_encode_fn(27), create_prompts(CHEXPERT_COMPETITION_TASKS),
                             CHEXPERT_COMPETITION_TASKS)
    out: dict = {"runs": {}}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_graph_"))
    try:
        data_dir = training_data(tmp / "data")
        data = DataBundle(*(EmbeddingDataset.load(data_dir / f"{s}.npz")
                            for s in ("train", "val", "test")))
        for name, (_, kw, units) in GRAPH_RUNS.items():
            runs = {kind: graph_run(name, data, bank, kind == "graphed")
                    for kind in ("eager", "graphed")}
            eager, graphed = runs["eager"], runs["graphed"]
            staged = leaf_gaps(graphed["staged"], eager["staged"])
            final = leaf_gaps(graphed["final"], eager["final"])
            epochs = units * TRAIN_EPOCHS
            c = graphed["counters"]
            r = dict(staged=staged, final=final,
                     **{f"{k}_{kind}": runs[kind][k] for kind in runs
                        for k in ("wall_s", "fold_ms", "spans", "peak_bytes", "guarded_calls")},
                     counters_graphed={k: c.get(k, 0) for k in ("train_graph_captures",
                                                               "train_graph_replays",
                                                               "train_steps")},
                     capture_ms=graphed["capture_ms"], replay_ms=graphed["replay_ms"],
                     allocated=[graphed["allocated_before"], graphed["allocated_after_trainer"]])
            out["runs"][name] = r
            log(f"  {name}: graphed vs eager staged {json.dumps(staged)}, final {json.dumps(final)}; "
                f"fold {graphed['fold_ms']} / {eager['fold_ms']} ms, wall {graphed['wall_s']:.3f} / "
                f"{eager['wall_s']:.3f} s; capture {graphed['capture_ms']} ms, replays "
                f"{graphed['replay_ms'][:3]}... ms; counters {json.dumps(r['counters_graphed'])}; "
                f"spans {json.dumps(graphed['spans'])} / {json.dumps(eager['spans'])}; peak "
                f"{graphed['peak_bytes'] / 2**20:.1f} / {eager['peak_bytes'] / 2**20:.1f} MiB; "
                f"allocated before / after the Trainer {r['allocated']}")
            check(staged["equal"] and final["equal"],
                  f"{name}: the graphed run differs from the eager one: {staged} {final}")
            check(r["counters_graphed"] == {"train_graph_captures": 1,
                                            "train_graph_replays": epochs,
                                            "train_steps": eager["counters"]["train_steps"]},
                  f"{name}: captures / replays / steps {r['counters_graphed']}, want 1 / {epochs} / "
                  f"{eager['counters']['train_steps']}")
            check(graphed["spans"]["train-step"] == 0
                  and graphed["spans"]["train-graph-capture"] == 1
                  and graphed["spans"]["train-epoch-replay"] == epochs
                  and eager["spans"]["train-step"] == eager["counters"]["train_steps"]
                  and "train_graph_captures" not in eager["counters"],
                  f"{name}: spans {graphed['spans']} (graphed) / {eager['spans']} (eager)")
            # the first capture of the process gives the side stream its cuBLAS workspaces,
            # which the library keeps; every later Trainer must leave nothing behind
            check(name == "joint" or graphed["allocated_after_trainer"] <= graphed["allocated_before"],
                  f"{name}: {r['allocated']} bytes allocated before / after the graphed Trainer: "
                  "its graph or pool outlived it")
            if name == "joint":
                joint_eager_final = eager["final"]
            check(all(runs[k]["guarded_calls"] for k in runs), f"{name}: a fused loop ran unguarded")
        joint = out["runs"]["joint"]
        joint_steps = TRAIN_EPOCHS * -(-TRAIN_ROWS // TRAIN_BS)  # 320 at the reference's scale
        check(joint["counters_graphed"]["train_steps"] == joint_steps,
              f"joint: {joint['counters_graphed']}, want {joint_steps} steps")
        check(joint["peak_bytes_graphed"] < GRAPH_PEAK_BYTES,
              f"joint: device memory peak {joint['peak_bytes_graphed']} bytes")
        mesh = create_mesh(1)
        one = graph_run("joint", data, bank, True, mesh=mesh)
        out["nccl1_joint"] = dict(counters={k: v for k, v in one["counters"].items()
                                            if k.startswith("train")}, spans=one["spans"],
                                  vs_no_mesh=leaf_gaps(one["final"], joint_eager_final))
        log(f"  joint on one NCCL rank: {json.dumps(out['nccl1_joint'])}")
        check("train_graph_captures" not in one["counters"]
              and "train_graph_replays" not in one["counters"]
              and one["spans"]["train-step"] == one["counters"]["train_steps"] == joint_steps,
              f"one NCCL rank took the graph: {out['nccl1_joint']}")
        out["epoch_times"] = epoch_times(data, bank)
        log(f"  ms an epoch of the joint run, eager / graphed: {json.dumps(out['epoch_times'])}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        out_dir = REPO / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_train_graph.json").write_text(json.dumps(out, indent=1, default=str))
    results["train_graph"] = out
    return out


# ----------------------------------------------------------------------
# the conv epilogue (phase 22)
# ----------------------------------------------------------------------
EPILOGUE_KERNEL = "conv_epilogue_kernel"
EPILOGUE_BATCHES = (2, 512)  # the card test's batch and the extraction cell's
EPILOGUE_LAUNCHES = 50  # a BioViL forward: 49 in the trunk, 1 in the projector
EPILOGUE_LAUNCHES_K2 = EPILOGUE_LAUNCHES - 9  # K2's layer1 hook takes layer1's nine
# two bf16 forwards rounding in different places, relative L2 of the global
# embeddings; the fused one no further from fp32 than this share over the chain's
EPILOGUE_FORWARD_REL = 2e-2
EPILOGUE_NO_WORSE = 1.25


def epilogue_cases(model, images) -> dict:
    """Every (C, H, W, residual, relu) one fused forward gives the epilogue,
    with how often, read by a spy on the wrapper (launch counts are read
    from a forward without it: the wrapper counts on the name its module
    holds, which is the spy's while it is in place)."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        biovil_image_forward,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops import conv_epilogue as ce

    seen: dict = {}
    wrapped = ce.conv_epilogue_

    def spy(a, scale, shift, residual=None, residual_scale=None, relu=True):
        kind = "none" if residual is None else ("identity" if residual_scale is None else "scaled")
        key = (a.shape[1], a.shape[2], a.shape[3], kind, relu)
        seen[key] = seen.get(key, 0) + 1
        return wrapped(a, scale, shift, residual, residual_scale, relu)

    spy.launches = 0  # counted here while the spy is in place, and dropped
    ce.conv_epilogue_ = spy
    try:
        with torch.no_grad():
            biovil_image_forward(model, images, dtype=torch.bfloat16)
    finally:
        ce.conv_epilogue_ = wrapped
    return seen


def epilogue_bound_ms(n: int, c: int, h: int, w: int, kind: str) -> float:
    """Bytes at the HBM peak: a read and written, r read (2 bytes a value)."""
    return n * c * h * w * 2 * (3 if kind != "none" else 2) / HBM_BYTES_PER_S * 1e3


def conv_epilogue_phase(results) -> dict:
    """Phase 22: the conv epilogue (``csrc/conv_epilogue.cu``) against its
    plain version bit for bit at every case a 512^2 BioViL forward gives
    it, at batch 2 and 512; its refusals; a whole bf16 forward with it
    against the chain of torch ops (and both against fp32, TF32 off), its
    launches, the forward's ms and memory peak both ways at batch 512;
    each case's time at batch 512 (CUDA events, in turns with the chain of
    torch ops it replaces) against its byte bound, with the profiler's
    device time at the largest."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.models import resnet as tr
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        biovil_image_forward,
        init_biovil_image_model,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops import conv_epilogue as ce

    out: dict = {}
    g = torch.Generator().manual_seed(4)
    model = init_biovil_image_model(torch.Generator().manual_seed(3))
    with torch.no_grad():  # trained nets' batch-norm ranges
        for m in model.modules():
            if isinstance(m, tr.FrozenBatchNorm):
                c = m.scale.shape[0]
                m.scale.copy_(torch.rand(c, generator=g) * 0.5 + 0.5)
                m.bias.copy_((torch.rand(c, generator=g) - 0.5) * 0.2)
                m.mean.copy_((torch.rand(c, generator=g) - 0.5) * 0.2)
                m.var.copy_(torch.rand(c, generator=g) + 0.5)
    model = model.cuda()
    gd = torch.Generator(device="cuda").manual_seed(5)
    images = torch.rand(4, 512, 512, 3, device="cuda", generator=gd)

    cases = epilogue_cases(model, images)
    zero_counts()
    with torch.no_grad():
        biovil_image_forward(model, images, dtype=torch.bfloat16)
    launches = read_counts()["conv_epilogue"]
    out["cases"] = {f"{c}x{h}x{w} {kind}{' relu' if relu else ''}": n
                    for (c, h, w, kind, relu), n in sorted(cases.items())}
    out["launches_per_forward"] = launches
    log(f"  cases of one 512^2 forward: {json.dumps(out['cases'])}")
    check(launches == sum(cases.values()) == EPILOGUE_LAUNCHES,
          f"{launches} launches a forward, want {EPILOGUE_LAUNCHES}")

    def operands(n, c, h, w, kind, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        mk = lambda: (torch.randn(n, h, w, c, device="cuda", generator=gen) * 3  # noqa: E731
                      ).to(torch.bfloat16).permute(0, 3, 1, 2)
        a, r = mk(), (mk() if kind != "none" else None)
        s = torch.rand(c, device="cuda", generator=gen) + 0.5
        b = (torch.rand(c, device="cuda", generator=gen) - 0.5) * 0.2
        sr = torch.rand(c, device="cuda", generator=gen) + 0.5 if kind == "scaled" else None
        return a, r, s, b, sr

    checked, max_abs_err = {}, 0.0
    for n in EPILOGUE_BATCHES:
        for i, (c, h, w, kind, relu) in enumerate(sorted(cases)):
            a, r, s, b, sr = operands(n, c, h, w, kind, i)
            want = ce.conv_epilogue_reference(a, s, b, r, sr, relu)
            got = ce.conv_epilogue_(a, s, b, r, sr, relu)
            torch.cuda.synchronize()
            equal = bool(torch.equal(got, want))
            max_abs_err = max(max_abs_err, float((got.float() - want.float()).abs().max()))
            checked[f"{n}x{c}x{h}x{w} {kind}{' relu' if relu else ''}"] = equal
            if not equal:
                check(False, f"conv_epilogue at ({n}, {c}, {h}, {w}) {kind} relu={relu}: "
                             f"{int(torch.count_nonzero(got != want))} values differ")
            del a, r, want, got
    out["bit_equal"] = checked
    out["max_abs_err"] = max_abs_err
    torch.cuda.empty_cache()

    t = torch.zeros(1, 16, 3, 3, dtype=torch.bfloat16, device="cuda")
    one, zero = torch.ones(16, device="cuda"), torch.zeros(16, device="cuda")
    buf = torch.zeros(2 * 16 * 9 + 1, dtype=torch.bfloat16, device="cuda")
    refused = {
        "float32": t.float(), "nchw": t.contiguous(),
        "channels 12": torch.zeros(1, 12, 3, 3, dtype=torch.bfloat16, device="cuda"),
        "misaligned": buf[1:].view(2, 3, 3, 16).permute(0, 3, 1, 2),
    }
    for name, x in refused.items():
        x = x.contiguous(memory_format=torch.channels_last) if name != "nchw" else x
        check(not ce.applies(x) and raises(lambda: ce.conv_epilogue_(x, one[:x.shape[1]],
                                                                   zero[:x.shape[1]]),
                                           ValueError), f"conv_epilogue_ took {name}")
    x = t.contiguous(memory_format=torch.channels_last).requires_grad_()
    check(not ce.applies(x) and raises(lambda: ce.conv_epilogue_(x, one, zero)),
          "conv_epilogue_ took an operand that requires grad under grad mode")
    out["refused"] = sorted(refused) + ["requires grad"]

    def embed(m, imgs, dtype):
        with torch.no_grad():
            return biovil_image_forward(m, imgs, dtype=dtype).projected_global_embedding.double()

    def rel(x, y):
        return float(torch.linalg.vector_norm(x - y) / torch.linalg.vector_norm(y))

    applies = ce.applies
    fused = embed(model, images, torch.bfloat16)
    ce.applies = lambda a, residual=None: False
    try:
        chain = embed(model, images, torch.bfloat16)
    finally:
        ce.applies = applies
    want32 = embed(model, images, torch.float32)
    out["forward"] = dict(fused_vs_chain=rel(fused, chain), fused_vs_fp32=rel(fused, want32),
                          chain_vs_fp32=rel(chain, want32))
    log(f"  forward (4, 512, 512) bf16: {json.dumps(out['forward'])}")
    check(0 < out["forward"]["fused_vs_chain"] < EPILOGUE_FORWARD_REL
          and out["forward"]["fused_vs_fp32"] <= EPILOGUE_NO_WORSE * out["forward"]["chain_vs_fp32"],
          f"the fused forward against the chain: {out['forward']}")

    # the forward at the extraction cell's batch, both ways in turns, and its memory peak
    big = torch.rand(512, 512, 512, 1, device="cuda", generator=gd)
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        fold_grayscale_conv1,
    )

    grey = fold_grayscale_conv1(model)

    def forward():
        with torch.no_grad():
            biovil_image_forward(grey, big, dtype=torch.bfloat16)

    def unfused():
        ce.applies = lambda a, residual=None: False
        try:
            forward()
        finally:
            ce.applies = applies

    peaks = {}
    for name, fn in (("fused", forward), ("chain", unfused)):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
    med = alternating_ms({"fused": forward, "chain": unfused}, rounds=3, iters=3)
    out["forward_512"] = dict(ms=med, images_per_s={k: 512e3 / v for k, v in med.items()},
                              peak_bytes=peaks)
    log(f"  forward (512, 512, 512, 1) bf16: {json.dumps(out['forward_512'])}")
    check(peaks["fused"] <= peaks["chain"], f"the fused forward's memory peak rose: {peaks}")
    del big
    torch.cuda.empty_cache()

    times = {}
    n = EPILOGUE_BATCHES[-1]
    largest = max(cases, key=lambda k: epilogue_bound_ms(n, *k[:4]))
    for i, key in enumerate(sorted(cases)):
        c, h, w, kind, relu = key
        a, r, s, b, sr = operands(n, c, h, w, kind, 1000 + i)
        bn = tr.FrozenBatchNorm(c).cuda()
        bn.scale.copy_(s)
        bn.bias.copy_(b)
        rbn = None
        if kind == "scaled":
            rbn = tr.FrozenBatchNorm(c).cuda()
            rbn.scale.copy_(sr)
        with torch.no_grad():
            med = alternating_ms({"ms": lambda: ce.conv_epilogue_(a, s, b, r, sr, relu),
                                  "library_ms": lambda: tr.bn_epilogue(a, bn, relu, r, rbn)},
                                 rounds=3, iters=10)
        bound = epilogue_bound_ms(n, c, h, w, kind)
        row = dict(**med, bound_ms=bound, bound_by="bytes", bound_share=bound / med["ms"],
                   per_forward=cases[key])
        if key == largest:
            row["plain_ms"] = cuda_time_ms(lambda: ce.conv_epilogue_reference(a, s, b, r, sr, relu),
                                           3)
            row["kernel_device_ms"] = profiled_device_ms(
                lambda: ce.conv_epilogue_(a, s, b, r, sr, relu), ce.conv_epilogue_,
                EPILOGUE_KERNEL, med["ms"], bound, iters=10)
        times[f"{n}x{c}x{h}x{w} {kind}{' relu' if relu else ''}"] = row
        log(f"  conv_epilogue {n}x{c}x{h}x{w} {kind} relu={relu}: {json.dumps(row)}")
        del a, r
        torch.cuda.empty_cache()
    out["times"] = times
    out["largest"] = "{}x{}x{}x{} {}{}".format(n, *largest[:4], " relu" if largest[4] else "")
    per_forward = {k: sum(row[k] * row["per_forward"] for row in times.values())
                   for k in ("ms", "library_ms", "bound_ms")}
    out["per_forward_ms"] = per_forward
    log(f"  a batch-512 forward's epilogues, ms: {json.dumps(per_forward)}")
    results["conv_epilogue"] = out
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler windows over one served batch, one "
                         "report-length text encode (flash and dense), one extraction "
                         "encode (K2 and cuDNN layer1), one grounding query and one "
                         "text-tower gradient (flash and dense)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="phases 1, 2 and 15 alone (the mesh), printing no result line")
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

    def phase(msg: str) -> None:  # a phase's header, with the script's elapsed seconds
        log(f"{msg} (at {time.perf_counter() - t_start:.1f} s)")

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    results: dict = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    phase(f"[1] card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    t0 = time.perf_counter()
    cuda_build.build()
    results["build_s"] = time.perf_counter() - t0
    phase(f"[2] built {sorted(cuda_build.SOURCES)} in {results['build_s']:.1f} s")
    ptxas = ptxas_report(cuda_build)
    results["ptxas"] = ptxas
    for entry, rep in ptxas.items():
        log(f"  {entry}: {rep}")
    for entry, rep in ptxas.items():
        if (any(n in entry for n in K3_KERNELS) or K2_KERNEL in entry
                or any(n in entry for n in K3B_BF16_KERNELS) or EPILOGUE_KERNEL in entry):
            check(rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0,
                  f"{entry} spills: {rep}")
    for name in K3_KERNELS:
        check(sum(name in e for e in ptxas) == 2, f"no ptxas report for {name}'s two head widths")
    check(sum(K2_KERNEL in e for e in ptxas) == 2, "no ptxas report for K2's two instantiations")
    check(sum("flash_bwd_" in e for e in ptxas) == 10, "no ptxas report for K3b's ten kernels")
    check(sum(any(n in e for n in K3B_BF16_KERNELS) for e in ptxas) == 4,
          "no ptxas report for K3b's four bf16 kernels")
    check(sum(EPILOGUE_KERNEL in e for e in ptxas) == 6,
          "no ptxas report for the conv epilogue's six instantiations")

    if args.mesh_only:
        log("[15] the data-parallel mesh alone")
        mesh_phase(results)
        log(f"total {time.perf_counter() - t_start:.1f} s; --mesh-only prints no result line")
        return 0

    bank = build_prompt_bank(synthetic_encode_fn(27), create_prompts(CHEXPERT_COMPETITION_TASKS),
                             CHEXPERT_COMPETITION_TASKS)
    model = init_biovil_image_model(torch.Generator().manual_seed(0))

    phase("[3] kernels vs plain versions")
    folded, cases = kernel_checks(model, bank, results)
    phase("[4] small-input check")
    results["small_card_vs_cpu"] = small_parity(model, bank)
    phase("[5] serving path at full width")
    clfs, plain, images = serving(model, bank, results)
    phase("[6] HTTP")
    http_phase(clfs["mean"], images)
    phase("[7] times")
    time_kernels(folded, cases, results)
    serving_times(clfs, plain, images, results)
    if args.profile:
        profile_window("one batch of 16", lambda: clfs["mean"].predict_arrays(images[:16]), results)
    phase("[8] flash attention vs its plain version, then at the DINOv2 tower's shape")
    flash_checks(results)
    vit_flash = vit_flash_phase(results)
    phase("[9] text tower at full width, report length")
    bert, ids, mask = text_tower(results)
    phase("[10] prompt bank from weights through the CLI")
    bank_from_weights(bert, images, results)
    phase("[11] times: flash attention, text encodes")
    text_times(bert, ids, mask, results)
    if args.profile:
        profile_text(bert, ids, mask, results)
    phase("[12] the paper's experiment at the reference's scale: K1 at the eval shapes, then the "
        "three drivers on the card (loops under sync debug mode) and on the CPU")
    eval_names = eval_kernel_checks(bank, results)
    train = training(bank, results)
    phase("[13] extraction on the card: the CLI at its defaults and a resumed run, the indexed "
        "path, the card against its CPU, the int8 trunk, the device encode with K2 against "
        "cuDNN, reproduce --rehearsal, serving --adapter-checkpoint")
    k2x = extraction(model, results, args.profile)
    phase("[14] phrase grounding through the CLI at full width (BioViL ResNet-50 at 480^2, "
        "BERT-base), the card against its CPU; dilated ResNet-50, ResNet-18 and the "
        "space-to-depth stem; the native store at the reference's scale")
    grounding(bert, results, args.profile)
    model_surface(results)
    native_store(bank, results)
    phase("[15] the data-parallel mesh: K1-mesh at two gloo ranks on the card; one NCCL rank "
        "through the three drivers against no mesh (loops under sync debug mode); the same at "
        "two gloo ranks; extraction with mesh=; two NCCL ranks where two cards are visible")
    mesh = mesh_phase(results)
    phase("[16] sweeps at phase 12's scale (--vmap under sync debug mode, then sequentially; the "
        "card against its CPU) and the text tower's partitions at BERT-base on two ranks")
    swept = sweep_phase(bank, results)
    partition_phase(bert, results)
    phase("[17] K3b, the flash-attention backward: against its plain version, the text tower's "
        "gradient at BERT-base through it against the dense path, times; the profiling tools")
    k3b_checks(results)
    grads = text_tower_gradients(bert, ids, mask, results, args.profile)
    k3b = k3b_times(results)["bfloat16"]
    tools_phase(model, results)
    phase("[18] the figures: the joint driver at phase 12's scale with and without figures "
          "(loops under sync debug mode), the t-SNE on the card, the card against its CPU, the "
          "PNG-writing entry points")
    figures_phase(results, time.perf_counter() - t_start)
    phase("[19] link health on the card: cli/linkhealth.py at its defaults, a second fresh build, "
          "deadlines, quick_probe, the upload against an in-process copy")
    linkhealth_phase(card, results)
    phase("[21] a training epoch as a CUDA graph: the three drivers graphed against the eager "
          "loop on the same inputs (loops under sync debug mode), captures and replays, memory "
          "freed with the Trainer, one NCCL rank eager, ms an epoch both ways")
    train_graph_phase(results)
    phase("[22] the conv epilogue: against its plain version at every case of a 512^2 forward, "
          "its refusals, a whole bf16 forward against the chain of torch ops, times")
    epi = conv_epilogue_phase(results)

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
    k3f = results["flash_times"]["float32"]
    kernels.append(dict(  # K3 fp32 under the fp32 report-length encode (phase 9), timed at REPORT
        name="flash_attention (fp32)", route="cuda", source=f"{PACKAGE}/csrc/flash_attention.cu",
        replaces="incremental_multimodal_medical_learning_ii_tpu/models/cxr_bert.py:197",
        launches=results["text_tower"]["launches"]["flash_attention fp32 encode"],
        max_abs_err=results["flash_check"]["report (32,12,512,64) float32"]["max_abs_err"],
        ms=k3f["ms"], plain_ms=k3f["plain_ms"], bound_ms=k3f["bound_ms"],
        bound_by=k3f["bound_by"], library_ms=k3f["library_ms"],
        kernel_device_ms=k3f["kernel_device_ms"], no_skip_ms=k3f["no_skip_ms"],
        skipped_tile_share=k3f["skipped_tile_share"], tflops_needed=k3f["tflops_needed"],
        tflops_computed=k3f["tflops_computed"]))
    for name in eval_names:  # K1 at the eval passes' shapes, launched by the training runs
        k = results["cosine_eval"][name]
        kernels.append(dict(
            name=f"fused_cosine ({name})", route="cuda", source=f"{PACKAGE}/csrc/fused_cosine.cu",
            replaces="incremental_multimodal_medical_learning_ii_tpu/ops/pallas_cosine.py:32",
            launches=train["k1_launches"][name], max_abs_err=k["max_abs_err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            library_ms=k["library_ms"], kernel_device_ms=k["kernel_device_ms"]))
    kernels.append(dict(  # K2 in the extraction encode (phase 13e)
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
    k1m = mesh["k1_mesh_times"]  # K1-mesh: one rank's rows of an eval batch at two ranks (15f)
    kernels.append(dict(
        name=f"fused_cosine mesh (one rank of 2, {k1m['shape']})", route="cuda",
        source=f"{PACKAGE}/csrc/fused_cosine.cu",
        replaces="incremental_multimodal_medical_learning_ii_tpu/ops/pallas_cosine.py:84",
        launches=mesh["k1_mesh_launches"], max_abs_err=max(mesh["k1_mesh_check"].values()),
        ms=k1m["ms"], plain_ms=k1m["plain_ms"], bound_ms=k1m["bound_ms"], bound_by=k1m["bound_by"],
        library_ms=k1m["library_ms"], kernel_device_ms=k1m["kernel_device_ms"],
        whole_batch_ms=k1m["whole_batch_ms"], sharded_gloo_ms=mesh["k1_mesh_sharded_gloo_ms"]))
    k1s = results["cosine_eval"][eval_names[0]]  # K1 scoring the sweep's eval batches (16a)
    kernels.append(dict(
        name=f"fused_cosine (sweep {eval_names[0]})", route="cuda",
        source=f"{PACKAGE}/csrc/fused_cosine.cu",
        replaces="incremental_multimodal_medical_learning_ii_tpu/ops/pallas_cosine.py:32",
        launches=swept["runs"]["vmap"][0]["k1_launches"], max_abs_err=k1s["max_abs_err"],
        ms=k1s["ms"],
        plain_ms=k1s["plain_ms"], bound_ms=k1s["bound_ms"], bound_by=k1s["bound_by"],
        library_ms=k1s["library_ms"], kernel_device_ms=k1s["kernel_device_ms"]))
    kernels.append(dict(  # K3b under the text tower's bf16 gradient (17b), timed at (32,12,512,64)
        name="flash_attention_bwd", route="cuda", source=f"{PACKAGE}/csrc/flash_attention_bwd.cu",
        replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:1121,1456 (jax 0.9.0; "
                 "the custom VJP of the call at "
                 "incremental_multimodal_medical_learning_ii_tpu/models/cxr_bert.py:197)",
        launches=grads["bfloat16"]["launches"]["flash_attention_bwd"],
        max_abs_err=max(results["k3b_check"]["report (32,12,512,64) bfloat16"][g]["max_abs"]
                        for g in ("dq", "dk", "dv")),
        ms=k3b["ms"], plain_ms=k3b["plain_ms"], bound_ms=k3b["bound_ms"],
        bound_by=k3b["bound_by"], library_ms=k3b["library_ms"],
        kernel_device_ms=k3b["kernel_device_ms"], tflops_needed=k3b["tflops_needed"],
        tflops_computed=k3b["tflops_computed"], skipped_tile_share=k3b["skipped_tile_share"],
        ms_skipping_off=k3b["ms_skipping_off"],
        forward_lse_ms=k3b["forward_lse_ms"], forward_ms=k3b["forward_ms"]))
    kernels.append(dict(  # K3 in the DINOv2 tower's extraction (phase 8), 40 launches a batch
        name=f"flash_attention (DINOv2 {'x'.join(map(str, vit_flash['shape']))})", route="cuda",
        source=f"{PACKAGE}/csrc/flash_attention.cu",
        replaces="incremental_multimodal_medical_learning_ii_tpu/models/cxr_bert.py:197",
        launches=vit_flash["launches_per_forward"], max_abs_err=vit_flash["max_abs_err"],
        ms=vit_flash["ms"], plain_ms=vit_flash["plain_ms"], bound_ms=vit_flash["bound_ms"],
        bound_by=vit_flash["bound_by"], library_ms=vit_flash["library_ms"],
        kernel_device_ms=vit_flash["kernel_device_ms"], tflops=vit_flash["tflops"]))
    big = epi["times"][epi["largest"]]
    kernels.append(dict(  # each conv's BN, residual and ReLU: launches in 13a's run, the rest 22
        name=f"conv_epilogue ({epi['largest']})", route="cuda",
        source=f"{PACKAGE}/csrc/conv_epilogue.cu",
        replaces="none: XLA fuses each conv's batch norm, residual add and ReLU on the TPU",
        launches=results["extraction_cli"]["launches"]["conv_epilogue"],
        launches_per_forward=epi["launches_per_forward"], max_abs_err=epi["max_abs_err"],
        ms=big["ms"],
        plain_ms=big["plain_ms"], bound_ms=big["bound_ms"], bound_by=big["bound_by"],
        library_ms=big["library_ms"], kernel_device_ms=big["kernel_device_ms"]))
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
