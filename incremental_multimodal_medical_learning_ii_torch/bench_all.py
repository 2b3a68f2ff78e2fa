"""Extended benchmark suite (the headline is ``bench.py``; this prints the
full performance story as JSON lines, one per workload).

    python -m incremental_multimodal_medical_learning_ii_torch.bench_all [--quick]
        [--text] [--text-long] [--fused-layer1] [--s2d-stem]
    python -m incremental_multimodal_medical_learning_ii_torch.bench_all --stages [--quick] [--s2d-stem]
    python -m incremental_multimodal_medical_learning_ii_torch.bench_all --serve [--quick]
    python -m incremental_multimodal_medical_learning_ii_torch.bench_all --roofline [--quick]
    python -m incremental_multimodal_medical_learning_ii_torch.bench_all --parallel-model

Counterpart of the JAX repo's ``bench_all.py``, with its function names,
metric names, JSON fields and flags, except: the K1 section's metrics are
``cuda_cosine_6144x10_us`` and ``torch_cosine_6144x10_us``; the analytic
models default to the H100's peaks and ``parallel_model`` speaks of NVLink
(``hw_flops_per_link_byte``, bound ``"NVLink"``); every line carries
``"device"`` (the card's name, or ``"cpu"``) and each measured line the
kernels' ``"launches"`` counted while it was measured; ``--device`` is
the port's flag (default CUDA, no fallback; ``cpu`` runs the plain
versions, for the tests).

Device-side rates are long-minus-short chained runs
(``utils/chained_timing.py``): each iteration waits on the previous one's
accumulator, and a CUDA synchronisation ends each run.  Where one
iteration's kernels take less device time than the host takes to launch
them (the text tower at the prompt bank's shape, the train epoch's
6,144-row steps, K1 alone), the chained loop is a CUDA graph on the card,
captured once and replayed, as the JAX suite's loop is one compiled
program; those lines carry ``"cuda_graph": true``.  The image encodes
(``utils/device_bench.py``, ``--stages``) run tens of milliseconds of
device time an iteration and stay eager.  A graph's launches are counted
where they happen: its capture launches nothing, and each replay adds the
kernels it recorded (:func:`_graphed`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import BertDims

_QUICK = False  # set by main(--quick); stamps every line (see report())
_DEVICE: Optional[str] = None  # set by main(--device); every line names it


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Every size a section measures at (the JAX suite's inline numbers);
    :data:`FULL` by default, :data:`QUICK` under ``--quick``.  Chain
    lengths are (k_long, k_short)."""

    img_h: int = 390  # CheXpert-small frontal geometry
    img_w: int = 320
    size: int = 512  # resize and crop
    pad_to: int = 512  # the classifier's largest accepted image side (--serve)
    extract_batch: int = 256
    extract_rounds: int = 3
    extract_batches_per_round: int = 4
    encode_k: tuple = (24, 4)
    text_shape: tuple = (256, 32)  # (batch, seq): the prompt bank's shape
    text_k: tuple = (24, 4)
    text_long_shape: tuple = (32, 512)  # radiology-report length
    text_long_k: tuple = (10, 2)
    bert_dims: BertDims = dataclasses.field(default_factory=BertDims)
    train_rows: int = 191027
    train_batch: int = 6144
    epoch_k: tuple = (64, 8)
    eval_rows: int = 30000
    cosine_rows: int = 6144  # K1 at (6144, 128) x (10, 128)
    cosine_k: tuple = (16384, 2048)
    serve_clients: int = 4
    serve_reqs: int = 16  # requests per client
    serve_batch: int = 8
    stage_batch: int = 256
    stage_k: tuple = (24, 4)


FULL = Sizes()
QUICK = dataclasses.replace(
    FULL, extract_batch=128, extract_rounds=2, extract_batches_per_round=2, encode_k=(8, 2),
    text_shape=(64, 32), text_k=(8, 2), text_long_shape=(8, 128), train_rows=24576,
    epoch_k=(32, 4), eval_rows=4096, cosine_k=(4096, 512), serve_reqs=4, stage_batch=128,
    stage_k=(8, 2),
)


# each run of the suite: its flags, then the metric names it prints, in
# order (the JAX suite's names with the port's renames)
SECTIONS = {
    "main": (["--quick", "--text", "--text-long", "--fused-layer1", "--s2d-stem"], [
        "extraction_images_per_sec_per_chip", "extraction_device_images_per_sec_per_chip",
        "extraction_device_int8_images_per_sec_per_chip",
        "extraction_device_fused_layer1_images_per_sec_per_chip",
        "extraction_device_s2d_stem_images_per_sec_per_chip",
        "text_roofline_cap_prompts_per_sec", "text_device_prompts_per_sec_per_chip",
        "text_device_bf16_prompts_per_sec_per_chip", "text_roofline_cap_prompts_per_sec",
        "text_long_device_bf16_dense_prompts_per_sec",
        "text_long_device_bf16_flash_prompts_per_sec",
        "fused_train_epoch_samples_per_sec", "fused_train_epoch_device_samples_per_sec",
        "eval_samples_per_sec", "cuda_cosine_6144x10_us", "torch_cosine_6144x10_us"]),
    "serve": (["--serve", "--quick"], [
        f"serve_{mode}_{m}" for mode in ("microbatch", "locked")
        for m in ("requests_per_sec", "latency_p50_ms", "latency_p99_ms", "requests_per_dispatch")
        if (mode, m) != ("locked", "requests_per_dispatch")]),
    "stages": (["--stages", "--quick"], [f"stage_{n}_ms_per_batch" for n in (
        "preprocess", "stem", "layer1", "layer2", "layer3", "layer4", "projector_pool")]),
    "roofline": (["--roofline", "--quick"], [f"roofline_{n}_cap_ms" for n in (
        "stem", "layer1", "layer2", "layer3", "layer4")]),
    "parallel-model": (["--parallel-model"], [f"parallel_model_{a}_flops_per_comm_byte"
                                              for a in ("tp", "sp", "pp")]),
}


def _kernel_wrappers() -> dict:
    """Every hand-written kernel's wrapper, by the name its count goes by."""
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
            "flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd}


def launch_counts() -> dict:
    """Every hand-written kernel's launch count, as its wrapper counts it."""
    return {name: fn.launches for name, fn in _kernel_wrappers().items()}


def launches_since(start: dict) -> dict:
    now = launch_counts()
    return {k: now[k] - start[k] for k in now}


def make_bert_chained_loop(k, n_slabs, dtype, use_flash=False):
    """Chained BERT-encode loop (ONE definition of the chaining idiom, the
    ``mask + (0*acc)`` perturbation that makes each encode wait for the
    last, shared by --text and --text-long): ``loop(ids, mask, model)``
    runs k encodes of ``ids[i % n_slabs]``.  The model carries its dims,
    so the JAX loop's ``bert_dims`` argument has no counterpart."""
    from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import (
        get_projected_text_embeddings,
    )

    @torch.no_grad()
    def loop(ids_, mask_, model):
        acc = torch.zeros((), device=ids_.device)
        for i in range(k):
            m = mask_ + (0 * acc).to(torch.int32)
            emb = get_projected_text_embeddings(
                model, ids_[i % n_slabs], m, normalize=True, dtype=dtype,
                use_flash_attention=use_flash,
            )
            acc = acc + emb.sum()
        return acc

    return loop


def report(metric, value, unit, baseline=None, **extras):
    """value=None marks an invalid chained sample (the long run timed no
    slower than the short one: the two straddled a change of the card's or
    the host's state, see utils/chained_timing.py); it is reported as null,
    never clamped.

    --quick runs stamp ``"quick": true`` on every line: their chained
    windows are short (tens of milliseconds at some shapes), so the numbers
    are smoke-test signals, not comparable measurements."""
    line = {"metric": metric, "value": None, "unit": unit,
            "note": "invalid sample (link phase straddle)"}
    if value is not None:
        line = {"metric": metric, "value": round(value, 3), "unit": unit}
        if baseline:
            line["vs_baseline"] = round(value / baseline, 2)
        line.update(extras)
    if _QUICK:
        line["quick"] = True
    line["device"] = _DEVICE
    print(json.dumps(line), flush=True)


def _init_image_model():
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        init_biovil_image_model,
    )

    return init_biovil_image_model(torch.Generator().manual_seed(0))


def stage_attribution(quick: bool = False, s2d_stem: bool = False, device=None) -> None:
    """Attribute the device-side extraction forward across ResNet stages.

    Chained methodology (see the kernel section of :func:`main`): each loop
    runs the preprocess + the forward truncated after stage S, K times
    sequenced through an accumulator; long-minus-short isolates device
    time; stage cost = successive differences between truncation levels.
    Emits one JSON line per stage.
    """
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        _projector_forward,
        fold_grayscale_conv1,
    )
    from incremental_multimodal_medical_learning_ii_torch.models.resnet import (
        _bottleneck_forward,
        _to_nchw,
        max_pool_3x3_s2,
        stem_conv_apply,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.preprocess import (
        SharedSizePreprocessPlan,
        preprocess_device_shared,
    )
    from incremental_multimodal_medical_learning_ii_torch.utils.chained_timing import (
        time_chained,
    )
    from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device

    dev = resolve_device(device)
    sz = QUICK if quick else FULL
    rng = np.random.default_rng(0)
    model = fold_grayscale_conv1(_init_image_model())
    if s2d_stem:
        from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
            space_to_depth_stem,
        )

        model = space_to_depth_stem(model)
    model = model.to(dev)
    batch = sz.stage_batch
    plan = SharedSizePreprocessPlan(sz.img_h, sz.img_w, size=sz.size, crop=sz.size)
    n_slabs = 4
    raw_all = torch.from_numpy(
        rng.integers(0, 256, size=(n_slabs, batch, sz.img_h, sz.img_w), dtype=np.uint8)
    ).to(dev)
    w_h = torch.from_numpy(plan.w_h).to(dev)
    w_w = torch.from_numpy(plan.w_w).to(dev)

    def truncated_forward(m, imgs, upto):
        # upto: 0=preprocess only, 1=+stem, 2..5=+layer1..4, 6=+projector
        if upto == 0:
            return imgs.to(torch.bfloat16).float().sum()
        enc = m.encoder
        x = stem_conv_apply(enc.conv1, _to_nchw(imgs, torch.bfloat16))  # shape-dispatches s2d
        x = max_pool_3x3_s2(torch.relu(enc.bn1(x)))
        if upto == 1:
            return x.float().sum()
        for li in range(4):
            for block in getattr(enc, f"layer{li + 1}"):
                x = _bottleneck_forward(block, x)  # each block at its own stride
            if upto == 2 + li:
                return x.float().sum()
        proj = _projector_forward(m.projector, x)
        return torch.mean(proj.float(), dim=(2, 3)).sum()

    def make_loop(k, upto):
        @torch.no_grad()
        def loop(raw_, w_h_, w_w_):
            acc = torch.zeros((), device=dev)
            for i in range(k):
                wh = w_h_ + 0.0 * acc  # chain: each iteration waits for the last
                imgs = preprocess_device_shared(raw_[i % n_slabs], wh, w_w_, channels=1)
                acc = acc + truncated_forward(model, imgs, upto)
            return acc

        return loop

    k_long, k_short = sz.stage_k
    names = [
        "preprocess", "stem", "layer1", "layer2", "layer3", "layer4", "projector_pool",
    ]
    prev = 0.0
    for upto, name in enumerate(names):
        start = launch_counts()
        cum = time_chained(
            lambda k: make_loop(k, upto),
            lambda r: (torch.bitwise_xor(raw_all, (r + 1) % 256), w_h, w_w),
            k_short=k_short, k_long=k_long,
        )
        if cum is None:
            # no cumulative sample: neither this stage nor the NEXT one is
            # attributable (the next delta would silently include this
            # stage's cost if prev stayed at the last valid cumulative)
            report(f"stage_{name}_ms_per_batch", None, "ms")
            prev = None
            continue
        if prev is None:
            report(f"stage_{name}_ms_per_batch", None, "ms")
        else:
            report(f"stage_{name}_ms_per_batch", (cum - prev) * 1e3, "ms",
                   launches=launches_since(start))
        prev = cum


def _peaks():
    """(bf16 dense FLOP/s, HBM bytes/s): the H100 SXM data sheet's, or
    ``IMML_PEAK_FLOPS`` / ``IMML_HBM_BW`` (the same overrides bench.py
    honours, so measured-vs-cap stays consistent across cards)."""
    import os

    return (float(os.environ.get("IMML_PEAK_FLOPS", 989e12)),
            float(os.environ.get("IMML_HBM_BW", 3.35e12)))


def roofline_model(batch: int = 256) -> None:
    """Analytic per-stage roofline for the BioViL ResNet-50 forward at 512²
    (pure host math).  Per conv: flops = 2·MACs; essential HBM bytes =
    input read + output write + weights (bf16) + the residual-add identity
    read per block (conv epilogues fuse BN/ReLU/add, so the only extra
    traffic a block's skip path costs is re-reading the identity).  Stage
    cap = Σ_conv max(t_compute, t_memory), plus the identity reads' memory
    time.

    The JAX model derated compute by the TPU's systolic feed,
    min(K/128,1)·min(N/128,1); the H100's tensor cores have no such feed
    limit at these K and N, so there is no derate here.  FLOPs and bytes
    per stage are the JAX model's (43.17 GF/img over the forward).
    """
    peak, bw = _peaks()

    def conv_cost(h, w, cin, cout, k, stride):
        ho, wo = h // stride, w // stride
        flops = 2 * ho * wo * cin * cout * k * k * batch
        byts = (h * w * cin + ho * wo * cout + k * k * cin * cout) * 2 * batch
        return flops, byts, max(flops / peak, byts / bw), (ho, wo)

    def bottleneck_layer(h, w, cin, cmid, cout, stride, blocks):
        f = b = t = 0.0
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            ci = cin if bi == 0 else cout
            ch, cw = h, w  # conv3 runs at the post-stride resolution
            for (kk, ss, a, z) in ((1, 1, ci, cmid), (3, s, cmid, cmid), (1, 1, cmid, cout)):
                df, db, dt, (ch, cw) = conv_cost(ch, cw, a, z, kk, ss)
                f, b, t = f + df, b + db, t + dt
            if bi == 0:
                df, db, dt, _ = conv_cost(h, w, ci, cout, 1, s)
                f, b, t = f + df, b + db, t + dt
            # residual identity read (the add itself fuses into conv3)
            id_bytes = ch * cw * cout * 2 * batch
            b, t = b + id_bytes, t + id_bytes / bw
            h, w = ch, cw
        return f, b, t, h, w

    stages = {}
    f, b, t, _ = conv_cost(512, 512, 1, 64, 7, 2)
    stages["stem"] = (f, b, t)
    h = w = 128
    for name, (cin, cmid, cout, stride, blocks) in {
        "layer1": (64, 64, 256, 1, 3),
        "layer2": (256, 128, 512, 2, 4),
        "layer3": (512, 256, 1024, 2, 6),
        "layer4": (1024, 512, 2048, 2, 3),
    }.items():
        f, b, t, h, w = bottleneck_layer(h, w, cin, cmid, cout, stride, blocks)
        stages[name] = (f, b, t)
    for name, (f, b, t) in stages.items():
        report(f"roofline_{name}_cap_ms", t * 1e3, "ms",
               gflops_per_img=round(f / batch / 1e9, 2),
               mb_per_img=round(b / batch / 1e6, 1))


def text_roofline(batch: int, seq: int, dims=None):
    """Analytic roofline for one CXR-BERT projected-embedding forward
    (BERT-base dims by default) at the prompt-bank shape: the text-tower
    counterpart of :func:`roofline_model` (pure host math).

    Per layer (2·MACs convention, matching the image tower): QKVO
    projections 2·4·S·H², attention scores+context 2·2·S²·H, FFN 2·2·S·H·I.
    HBM side: the layer stack's weights stream once per batch (amortised
    over the batch) plus ~per-token activation traffic.  Returns
    (cap_prompts_per_sec, gflops_per_prompt).
    """
    d = dims or BertDims()
    peak, bw = _peaks()
    h, i, s, L = d.hidden_size, d.intermediate_size, seq, d.num_layers
    flops_per_prompt = L * 2 * (4 * s * h * h + 2 * s * s * h + 2 * s * h * i)
    flops_per_prompt += 2 * (h * d.projection_size + d.projection_size ** 2)
    params = L * (4 * h * h + 2 * h * i + 13 * h) + d.vocab_size * h
    # weights read once per BATCH (bf16) + ~16 S×H activation tensors/layer
    bytes_per_batch = params * 2 + batch * L * 16 * s * h * 2
    t_compute = batch * flops_per_prompt / peak
    t_memory = bytes_per_batch / bw
    cap = batch / max(t_compute, t_memory)
    bound = "compute" if t_compute >= t_memory else "memory"
    report(
        "text_roofline_cap_prompts_per_sec", cap, "prompts/sec",
        gflops_per_prompt=round(flops_per_prompt / 1e9, 2),
        bound=bound, batch=batch, seq=seq,
    )
    return cap, flops_per_prompt / 1e9


def parallel_model(batch: int = 32, seq: int = 512, ways: int = 4,
                   microbatches: int = 8) -> None:
    """Analytic per-axis scaling model for the text tower (host math only).

    For each partition axis of a BERT-base-dims encoder layer it prints the
    per-device comm bytes, per-device matmul FLOPs, the resulting
    arithmetic intensity over the link, and the hardware's FLOPs-per-link-
    byte ratio; whichever is smaller decides compute- vs NVLink-bound.  pp
    additionally reports its fill/drain bubble fraction.  Peak and link
    rate are overridable via IMML_PEAK_FLOPS / IMML_ICI_BW (defaults: the
    H100 SXM's 989 TFLOP/s bf16 and NVLink 4's 450 GB/s a direction, half
    of the data sheet's 900 GB/s total).
    """
    import os

    d = BertDims()
    peak = float(os.environ.get("IMML_PEAK_FLOPS", 989e12))
    link = float(os.environ.get("IMML_ICI_BW", 450e9))
    hw_ratio = peak / link
    h, i_sz, b = d.hidden_size, d.intermediate_size, 2  # bf16 bytes
    B, S, T = batch, seq, ways
    # per-layer matmul FLOPs (2xMACs): QKVO 8BSH^2, FFN 4BSHI, attn 4BS^2H
    layer_flops = 8 * B * S * h * h + 4 * B * S * h * i_sz + 4 * B * S * S * h
    rows = []
    # tp: 2 ring all-reduces per layer on (B,S,H) activations
    tp_bytes = 4 * (T - 1) / T * B * S * h * b
    rows.append(("tp", layer_flops / T, tp_bytes, None))
    # sp: P-1 K/V+validity hops per layer (ops/ring_attention.py, no
    # homecoming hop)
    sp_bytes = (T - 1) * (2 * B * (S // T) * h * b + B * (S // T) * 4)
    rows.append(("sp", layer_flops / T, sp_bytes, None))
    # pp: per LAYER share of the per-boundary microbatch handoffs: each
    # non-last stage sends M activations of (B/M,S,H) per batch, i.e.
    # B*S*H*b per stage boundary, amortised over L/P layers of compute
    pp_bytes = B * S * h * b / (d.num_layers / T)
    bubble = (T - 1) / (microbatches + T - 1)
    rows.append(("pp", layer_flops / T, pp_bytes, bubble))
    for axis, flops, comm, extra in rows:
        ai = flops / comm
        extras = {"per_device_layer_gflops": round(flops / 1e9, 2),
                  "comm_mb_per_layer": round(comm / 1e6, 3),
                  "hw_flops_per_link_byte": round(hw_ratio, 0),
                  "bound": "compute" if ai >= hw_ratio else "NVLink",
                  "batch": B, "seq": S, "ways": T}
        if extra is not None:
            extras["bubble_fraction"] = round(extra, 3)
            extras["microbatches"] = microbatches
        report(f"parallel_model_{axis}_flops_per_comm_byte", ai, "flops/byte",
               **extras)


def serving_benchmark(quick: bool = False, device=None) -> None:
    """Live-endpoint serving benchmark: concurrent clients POSTing PNG CXRs
    against cli.serve, micro-batching ON (5 ms window) vs OFF (plain lock).

    Emits req/s + latency percentiles per config and the device-dispatch
    count (how many requests each device call served).  Wall latencies
    include the HTTP round trip and the PNG decode on the host; the
    microbatch-vs-lock DELTA is the signal.
    """
    import http.client
    import io
    import threading

    from PIL import Image

    from incremental_multimodal_medical_learning_ii_torch.cli.serve import make_server
    from incremental_multimodal_medical_learning_ii_torch.inference import ChexpertClassifier
    from incremental_multimodal_medical_learning_ii_torch.text.bank import (
        build_prompt_bank,
        synthetic_encode_fn,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
    )

    sz = QUICK if quick else FULL
    rng = np.random.default_rng(0)
    # production preprocessing geometry (512 resize/crop); pad_to bounds the
    # accepted raw size: CheXpert-small images are 390x320
    clf = ChexpertClassifier(
        _init_image_model(),
        build_prompt_bank(
            synthetic_encode_fn(), create_prompts(CHEXPERT_COMPETITION_TASKS),
            CHEXPERT_COMPETITION_TASKS,
        ),
        batch_size=sz.serve_batch, size=sz.size, pad_to=sz.pad_to, dtype=torch.bfloat16,
        device=device,
    )
    n_clients = sz.serve_clients
    reqs_per_client = sz.serve_reqs

    pngs = []
    for i in range(n_clients * reqs_per_client):
        buf = io.BytesIO()
        Image.fromarray(
            rng.integers(0, 256, size=(sz.img_h, sz.img_w), dtype=np.uint8), "L"
        ).save(buf, "PNG")
        pngs.append(buf.getvalue())

    # the first batch outside the HTTP path: first launches, cuDNN's choice
    clf.predict_arrays([np.asarray(Image.open(io.BytesIO(pngs[0])))])

    for metric, window_s in (("serve_microbatch", 0.005), ("serve_locked", 0.0)):
        start = launch_counts()
        srv = make_server(clf, "127.0.0.1", 0, microbatch_s=window_s)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        port = srv.server_address[1]

        def one_request(body):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            t0 = time.perf_counter()
            conn.request("POST", "/classify", body=body,
                         headers={"Content-Type": "image/png"})
            resp = conn.getresponse()
            resp.read()
            conn.close()
            if resp.status != 200:
                raise RuntimeError(f"HTTP {resp.status}")
            return time.perf_counter() - t0

        one_request(pngs[0])  # warm-up outside the timed window
        latencies: list = []
        errors: list = []
        lock = threading.Lock()

        def client(idx):
            for r in range(reqs_per_client):
                # a failed request must surface in the REPORT, not die with
                # the daemon thread: otherwise req/s and percentiles are
                # silently computed over a shrunken request set
                try:
                    lat = one_request(pngs[idx * reqs_per_client + r])
                except Exception as e:  # noqa: BLE001 - recorded, not hidden
                    with lock:
                        errors.append(f"{type(e).__name__}: {e}")
                    continue
                with lock:
                    latencies.append(lat)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        srv.shutdown()
        srv.server_close()
        if errors:
            print(f"# {metric}: {len(errors)} request(s) FAILED "
                  f"(first: {errors[0]}) — rates below cover the "
                  f"{len(latencies)} completed requests only")
        if not latencies:
            report(f"{metric}_requests_per_sec", None, "req/s",
                   failed_requests=len(errors))
            continue
        lat_ms = np.sort(np.asarray(latencies)) * 1e3
        extras = {"failed_requests": len(errors)} if errors else {}
        report(f"{metric}_requests_per_sec", len(latencies) / wall, "req/s",
               launches=launches_since(start), **extras)
        report(f"{metric}_latency_p50_ms", float(np.percentile(lat_ms, 50)), "ms")
        report(f"{metric}_latency_p99_ms", float(np.percentile(lat_ms, 99)), "ms")
        if srv.microbatcher is not None:
            # how many requests each device call served (incl. warm-up req)
            report(f"{metric}_requests_per_dispatch",
                   (len(latencies) + 1) / max(srv.microbatcher.dispatches, 1), "req")


def _graphed(body, *example):
    """``body(*args)`` as a CUDA graph: run once eagerly on a side stream
    (the first calls: kernel builds, library handles), then captured once on
    static copies of ``example``'s tensors; its other arguments (a model)
    are bound at the capture.  The returned callable copies its tensor
    arguments into the static copies, replays, and returns the graph's
    outputs (the same tensors every replay).

    The wrappers' launch counts stay true: the capture launches nothing, so
    each count is set back to its value before the capture, and each replay
    adds the launches the capture recorded."""
    static = [a.clone() if isinstance(a, torch.Tensor) else a for a in example]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = launch_counts()
    with torch.cuda.graph(graph):
        out = body(*static)
    per_replay = launches_since(before)
    wrappers = _kernel_wrappers()
    for name, n in before.items():
        wrappers[name].launches = n

    def replay(*args):
        for s, a in zip(static, args):
            if isinstance(s, torch.Tensor):
                s.copy_(a)
        graph.replay()
        for name, n in per_replay.items():
            wrappers[name].launches += n
        return out

    return replay


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true",
                   help="small shapes/chain lengths for smoke runs; every JSON line is "
                   "stamped 'quick': true because some chained windows are tens of "
                   "milliseconds; do not compare quick numbers against full runs")
    p.add_argument(
        "--stages", action="store_true",
        help="per-ResNet-stage device-time attribution only",
    )
    p.add_argument(
        "--fused-layer1", action="store_true", dest="fused_layer1",
        help="also time the encode with layer1 through the fused bottleneck kernel (K2)",
    )
    p.add_argument(
        "--s2d-stem", action="store_true", dest="s2d_stem",
        help="use / also time the space-to-depth stem reformulation "
        "(models/biovil_image.py::space_to_depth_stem; exact math)",
    )
    p.add_argument(
        "--text", action="store_true",
        help="also time the CXR-BERT text tower (BERT-base at the prompt bank's shape)",
    )
    p.add_argument(
        "--text-long", action="store_true", dest="text_long",
        help="also time the text tower at radiology-REPORT length (seq 512, "
        "batch 32, bf16): dense attention vs the flash-attention kernel (K3)",
    )
    p.add_argument(
        "--serve", action="store_true",
        help="serving latency/throughput only: concurrent HTTP clients vs "
        "the live endpoint, micro-batching on vs off",
    )
    p.add_argument(
        "--roofline", action="store_true",
        help="print the analytic per-stage roofline caps (host math only; "
        "compare against --stages measurements)",
    )
    p.add_argument(
        "--parallel-model", action="store_true", dest="parallel_model",
        help="print the analytic per-axis scaling model for the text tower "
        "(tp/sp/pp comm bytes, arithmetic intensity vs the hardware "
        "FLOPs-per-link-byte ratio, pp bubble; host math only)",
    )
    p.add_argument("--pm-batch", type=int, default=32)
    p.add_argument("--pm-seq", type=int, default=512)
    p.add_argument("--pm-ways", type=int, default=4)
    p.add_argument("--pm-microbatches", type=int, default=8)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where the measured sections run: cuda (default; raises "
                   "without it) or cpu (the plain versions, for the tests)")
    args = p.parse_args(argv)
    global _QUICK, _DEVICE
    _QUICK = args.quick
    sz = QUICK if args.quick else FULL

    from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device

    if (args.roofline or args.parallel_model) and args.device is None \
            and not torch.cuda.is_available():
        _DEVICE = None  # host math needs no card
    else:
        dev = resolve_device(args.device)
        _DEVICE = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    if args.roofline:
        # batch must track --stages' (--quick measures batch 128) or the
        # ms-per-batch comparison the help text points at is off by 2x
        roofline_model(batch=sz.stage_batch)
        return
    if args.parallel_model:
        parallel_model(batch=args.pm_batch, seq=args.pm_seq,
                       ways=args.pm_ways, microbatches=args.pm_microbatches)
        return
    if args.stages:
        stage_attribution(quick=args.quick, s2d_stem=args.s2d_stem, device=dev)
        return
    if args.serve:
        serving_benchmark(quick=args.quick, device=dev)
        return

    from incremental_multimodal_medical_learning_ii_torch.utils.chained_timing import (
        rate_or_none,
        time_chained,
    )

    rng = np.random.default_rng(0)
    cuda = dev.type == "cuda"

    def chained(loop, *example):
        """A chained loop as a CUDA graph on the card (module docstring)."""
        return _graphed(loop, *example) if cuda else loop

    graph_extra = {"cuda_graph": True} if cuda else {}

    # ------------------------------------------------------------------
    # 1. extraction throughput (the headline's loop, at the suite's batch)
    # ------------------------------------------------------------------
    from incremental_multimodal_medical_learning_ii_torch.engine.extract import (
        extract_embeddings,
    )

    model = _init_image_model().to(dev)
    batch = sz.extract_batch

    def images(n):
        for _ in range(n):
            yield (
                rng.integers(0, 256, size=(sz.img_h, sz.img_w), dtype=np.uint8),
                np.zeros(5, np.float32),
            )

    def extract(n):
        return extract_embeddings(images(n), model, batch_size=batch, size=sz.size,
                                  dtype=torch.bfloat16, device=dev)

    extract(batch)
    best = 0.0
    for _ in range(sz.extract_rounds):
        n = batch * sz.extract_batches_per_round
        t0 = time.perf_counter()
        extract(n)
        best = max(best, n / (time.perf_counter() - t0))
    report("extraction_images_per_sec_per_chip", best, "images/sec", baseline=1.509)

    # device-only encode throughput: the canonical chained loop
    # (utils/device_bench.py, shared with bench.py), without the host's
    # part of the wall loop (drawing, pinning, uploading, reading back).
    n_slabs = 4  # also used by the text section below
    from incremental_multimodal_medical_learning_ii_torch.utils.device_bench import (
        device_encode_rate,
    )

    def time_encode_loop(metric, m, channels=3, int8=False, fused_layer1=False):
        ek_long, ek_short = sz.encode_k
        start = launch_counts()
        rate = device_encode_rate(
            m, batch=batch, img_h=sz.img_h, img_w=sz.img_w, size=sz.size, crop=sz.size,
            channels=channels, int8=int8, fused_layer1=fused_layer1,
            k_short=ek_short, k_long=ek_long, device=dev,
        )
        report(metric, rate, "images/sec", baseline=1.509, launches=launches_since(start))

    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        fold_grayscale_conv1,
        quantize_biovil_int8,
    )

    model_gray = fold_grayscale_conv1(model)
    time_encode_loop("extraction_device_images_per_sec_per_chip", model_gray, channels=1)
    # opt-in int8 trunk (ops/quant.py): int8 products with int32 sums (torch._int_mm
    # on the card); embeddings shift by quantization error (~0.999 cosine)
    time_encode_loop(
        "extraction_device_int8_images_per_sec_per_chip",
        quantize_biovil_int8(model_gray), channels=1, int8=True,
    )
    if args.fused_layer1:
        time_encode_loop(
            "extraction_device_fused_layer1_images_per_sec_per_chip",
            model_gray, channels=1, fused_layer1=True,
        )
    if args.s2d_stem:
        from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
            space_to_depth_stem,
        )

        time_encode_loop(
            "extraction_device_s2d_stem_images_per_sec_per_chip",
            space_to_depth_stem(model_gray), channels=1,
        )

    # ------------------------------------------------------------------
    # 1b. text tower: CXR-BERT (BERT-base dims) sequence encode throughput
    # ------------------------------------------------------------------
    if args.text:
        from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import (
            init_cxr_bert,
        )

        dims = sz.bert_dims
        bert = init_cxr_bert(torch.Generator().manual_seed(7), dims).to(dev).eval()
        tb, ts = sz.text_shape  # batch, seq (prompt-bank shape)
        ids_all = torch.from_numpy(
            rng.integers(0, dims.vocab_size, size=(n_slabs, tb, ts))).to(dev)
        mask = torch.ones((tb, ts), dtype=torch.int32, device=dev)

        def make_text_loop(k, dtype):
            return chained(make_bert_chained_loop(k, n_slabs, dtype), ids_all, mask, bert)

        tk_long, tk_short = sz.text_k
        # analytic cap first so each measured number gets a %-of-cap (the
        # text-tower counterpart of the image roofline; at this shape the
        # tower is compute-bound, so pct_of_cap reads as MFU)
        text_cap, _ = text_roofline(tb, ts, dims)
        for metric, dtype in (
            ("text_device_prompts_per_sec_per_chip", torch.float32),
            ("text_device_bf16_prompts_per_sec_per_chip", torch.bfloat16),
        ):
            start = launch_counts()
            per_batch = time_chained(
                lambda k: make_text_loop(k, dtype),
                lambda r: ((ids_all + r + 1) % dims.vocab_size, mask, bert),
                k_short=tk_short, k_long=tk_long,
            )
            rate = rate_or_none(per_batch, tb)
            extras = dict(graph_extra)
            if rate is not None:
                # fp32 runs with TF32 off (full fp32 products), so its % of
                # the bf16 peak understates utilisation by design
                extras["pct_of_cap"] = round(100 * rate / text_cap, 1)
            report(metric, rate, "prompts/sec", launches=launches_since(start), **extras)

    # ------------------------------------------------------------------
    # 1c. text tower at radiology-REPORT length: dense vs flash attention
    # ------------------------------------------------------------------
    if args.text_long:
        from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import (
            init_cxr_bert,
        )

        ldims = sz.bert_dims
        lbert = init_cxr_bert(torch.Generator().manual_seed(7), ldims).to(dev).eval()
        lb, ls = sz.text_long_shape
        lids_all = torch.from_numpy(
            rng.integers(0, ldims.vocab_size, size=(2, lb, ls))).to(dev)
        lmask = torch.ones((lb, ls), dtype=torch.int32, device=dev)

        def make_long_loop(k, use_flash):
            return chained(make_bert_chained_loop(k, 2, torch.bfloat16, use_flash=use_flash),
                           lids_all, lmask, lbert)

        lk_long, lk_short = sz.text_long_k
        long_cap, _ = text_roofline(lb, ls, ldims)
        for metric, use_flash in (
            ("text_long_device_bf16_dense_prompts_per_sec", False),
            ("text_long_device_bf16_flash_prompts_per_sec", True),
        ):
            # no skip: on the card the flash path launches K3 or raises,
            # and on the CPU it is the plain version
            start = launch_counts()
            per_batch = time_chained(
                lambda k: make_long_loop(k, use_flash),
                lambda r: ((lids_all + r + 1) % ldims.vocab_size, lmask, lbert),
                k_short=lk_short, k_long=lk_long,
            )
            rate = rate_or_none(per_batch, lb)
            extras = {"seq": ls, "batch": lb, **graph_extra}
            if rate is not None:
                extras["pct_of_cap"] = round(100 * rate / long_cap, 1)
            report(metric, rate, "prompts/sec", launches=launches_since(start), **extras)

    # ------------------------------------------------------------------
    # 2. fused training epoch
    # ------------------------------------------------------------------
    from incremental_multimodal_medical_learning_ii_torch.data.store import (
        num_batches,
        synthetic_dataset,
    )
    from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer
    from incremental_multimodal_medical_learning_ii_torch.text.bank import (
        build_prompt_bank,
        synthetic_encode_fn,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
        joint_config,
    )

    n_train = sz.train_rows
    bank = build_prompt_bank(
        synthetic_encode_fn(), create_prompts(CHEXPERT_COMPETITION_TASKS),
        CHEXPERT_COMPETITION_TASKS,
    )
    cfg = joint_config(batch_size=sz.train_batch, epochs=1, lr=1e-3, plot_figures="off")
    trainer = Trainer(cfg, bank, device=dev)
    ds = synthetic_dataset(n_train, seed=0)
    trainer.train(ds, epoch=1)  # first launches, the device copy of the data
    start = launch_counts()
    t0 = time.perf_counter()
    for e in (2, 3, 4):
        trainer.train(ds, epoch=e)
    dt = (time.perf_counter() - t0) / 3
    report("fused_train_epoch_samples_per_sec", n_train / dt, "samples/sec",
           launches=launches_since(start))

    # device-side epoch time: chain K epochs, each on the state the last one
    # left, and take the long-minus-short difference so the per-call host
    # work cancels.  On the card the K epochs are one CUDA graph, as they
    # are one program in the JAX suite: the state's tensors go in as its
    # arguments and come out as its outputs, which the next call takes in.
    from torch.utils._pytree import tree_flatten, tree_unflatten

    fe = trainer._fused_epoch
    d_embs, d_labels, d_valid = trainer._device_data(ds)
    class_mask = torch.ones(5, dtype=torch.float32, device=dev)
    threshold = torch.zeros((), dtype=torch.float32, device=dev)
    n_pad = int(d_embs.shape[0])
    tail = torch.arange(n_train, n_pad, device=dev)
    k_long, k_short = sz.epoch_k

    # state threads through the repeats (evolving params); timing/guarding
    # via utils/chained_timing
    holder = {"state": trainer.state, "seed": 0, "epochs": 0}
    step0 = int(holder["state"].step)
    state_leaves, state_spec = tree_flatten(holder["state"])

    def epoch_orders(seed):
        """k_long epochs' row orders, drawn on the device (the padding rows
        last); a loop of k epochs reads the first k."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.stack([torch.cat([torch.randperm(n_train, generator=gen, device=dev), tail])
                            for _ in range(k_long)])

    def epochs_loop_factory(k):
        def epochs(perms, *leaves):
            st = tree_unflatten(list(leaves), state_spec)
            for i in range(k):
                st, _ = fe(st, d_embs, d_labels, d_valid, trainer.bank, class_mask, threshold,
                           perms[i])
            return tree_flatten(st)[0]

        run = chained(epochs, epoch_orders(0), *state_leaves)

        def loop(perms):
            leaves = run(perms, *tree_flatten(holder["state"])[0])
            holder["state"] = tree_unflatten(list(leaves), state_spec)
            holder["epochs"] += k
            return holder["state"].step  # time_chained synchronises on it: the barrier

        return loop

    def epochs_args(_r):
        holder["seed"] += 1
        return (epoch_orders(holder["seed"]),)

    start = launch_counts()
    per_epoch = time_chained(epochs_loop_factory, epochs_args, k_short=k_short, k_long=k_long)
    steps = int(holder["state"].step) - step0
    if steps != holder["epochs"] * num_batches(n_train, sz.train_batch):
        raise RuntimeError(f"the chained epochs took {steps} steps over {holder['epochs']} "
                           "epochs: the state did not thread through")
    report("fused_train_epoch_device_samples_per_sec", rate_or_none(per_epoch, n_train),
           "samples/sec", launches=launches_since(start), **graph_extra)

    # ------------------------------------------------------------------
    # 3. fused eval (its scoring is K1 on the card)
    # ------------------------------------------------------------------
    ev = synthetic_dataset(sz.eval_rows, seed=1)
    trainer.validate(ev, 1, 1)  # first launches, the device copy of the data
    trainer.train(ds, epoch=5)  # the timed pass scores a state just trained, as a driver's
    start = launch_counts()
    t0 = time.perf_counter()
    trainer.validate(ev, 2, 2)
    report("eval_samples_per_sec", len(ev) / (time.perf_counter() - t0), "samples/sec",
           launches=launches_since(start))

    # ------------------------------------------------------------------
    # 4. the fused cosine kernel (K1) vs the plain PyTorch version
    # ------------------------------------------------------------------
    from incremental_multimodal_medical_learning_ii_torch.ops.cosine import pairwise_cosine
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
        fused_pairwise_cosine,
    )

    # One launch is microseconds of device time, below the host's time to
    # launch it, so on the card each chained loop is a CUDA graph: iterations
    # chained through an accumulator that perturbs the next input,
    # per-iteration cost the difference between a long and a short loop,
    # which cancels the replay's fixed cost.
    k_long, k_short = sz.cosine_k
    xs = torch.from_numpy(rng.normal(size=(8, sz.cosine_rows, 128)).astype(np.float32)).to(dev)
    t = torch.from_numpy(rng.normal(size=(10, 128)).astype(np.float32)).to(dev)

    def make_loop(fn, k):
        @torch.no_grad()
        def loop(xs_, t_):
            acc = torch.zeros((), device=xs_.device)
            for i in range(k):
                x = xs_[i % xs_.shape[0]] + 0.0 * acc
                acc = acc + fn(x, t_).sum()
            return acc

        return chained(loop, xs, t)

    for name, fn in (("cuda_cosine_6144x10_us", fused_pairwise_cosine),
                     ("torch_cosine_6144x10_us", pairwise_cosine)):
        start = launch_counts()
        per_iter = time_chained(
            lambda k: make_loop(fn, k),
            lambda r: (xs + np.float32(r + 1), t),  # fresh buffers every repeat
            k_short=k_short, k_long=k_long,
        )
        report(name, per_iter * 1e6 if per_iter else None, "us",
               launches=launches_since(start), **graph_extra)


if __name__ == "__main__":
    main()
