#!/usr/bin/env python3
"""Where the fused layer1 kernel's time goes, on one NVIDIA GPU.

    python3 k2_breakdown.py     # from the root of a checkout, one card

Builds variants of ``csrc/fused_bottleneck.cu`` with one part disabled
(the output stores, the residual loads, a product, every product), one
``nvcc`` each in parallel, and times each of the three bottleneck blocks
of layer1 at the 512^2 serving batch, (16, 128, 128, 64), with CUDA
events, every variant in turns (base first and last), as the medians of
5 rounds.  A variant computes wrong numbers; only its time means
anything.  Prints one JSON line and writes it to
``chiprun_out/k2_breakdown.json``.  Exits 2 without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent
SHAPE = (16, 128, 128, 64)
ROUNDS, ITERS = 5, 20

_STORE = "      if (off >= 0)\n        *reinterpret_cast<uint4*>(p.out"
_RES0 = "if (!kDown) load_residual(p, 0"
_RES1 = "if (!kDown) load_residual(p, 1"
_CONV1 = "          wgmma_ss_n64(c1[m],"
_CONV2 = "for (int tap = 0; tap < 9; ++tap) {"
_CONV3 = "        wgmma_ss_n128(c3[h],"
# name -> (text in the kernel source, its replacement)
VARIANTS = {
    "no output stores": [(_STORE, _STORE.replace("off >= 0", "off == -7"))],
    "no residual loads": [(_RES0, _RES0.replace("!kDown", "false")),
                          (_RES1, _RES1.replace("!kDown", "false"))],
    "no conv1": [(_CONV1, "          if (p.H < 0) " + _CONV1.strip())],
    "no conv2": [(_CONV2, _CONV2.replace("tap < 9", "tap < 0"))],
    "no conv3": [(_CONV3, "        if (p.H < 0) " + _CONV3.strip())],
    "residual by __ldg": [("__ldcs(reinterpret_cast<const uint4*>(p.x", "__ldg(reinterpret_cast<const uint4*>(p.x")],
}
VARIANTS["no stores, no residual"] = VARIANTS["no output stores"] + VARIANTS["no residual loads"]
VARIANTS["no products"] = VARIANTS["no conv1"] + VARIANTS["no conv2"] + VARIANTS["no conv3"]


def build(cuda_build, tmp: Path) -> dict:
    src = (cuda_build.CSRC_DIR / "fused_bottleneck.cu").read_text()
    procs = {}
    for name, reps in {"base": [], **VARIANTS}.items():
        text = src
        for old, new in reps:
            if old not in text:
                raise SystemExit(f"k2_breakdown: variant {name!r}: {old!r} not in the kernel source")
            text = text.replace(old, new)
        cu, so = tmp / f"v{len(procs)}.cu", tmp / f"v{len(procs)}.so"
        cu.write_text(text)
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC_DIR),
               "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so)
    fns = {}
    for name, (proc, so) in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise SystemExit(f"k2_breakdown: nvcc failed for {name!r}:\n{out}")
        fns[name] = ctypes.CDLL(str(so)).bottleneck_block_launch
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k2_breakdown: CUDA is not available; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        init_biovil_image_model,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops import cuda_build
    from incremental_multimodal_medical_learning_ii_torch.ops import fused_bottleneck as fb

    with tempfile.TemporaryDirectory(prefix="k2_breakdown_") as tmp:
        fns = build(cuda_build, Path(tmp))
        for fn in fns.values():
            fn.argtypes, fn.restype = fb._ARGTYPES, ctypes.c_int
        model = init_biovil_image_model(torch.Generator().manual_seed(0))
        folded = fb.fold_bottleneck_layer(model.encoder.layer1)
        weights = fb._kernel_weights(folded, torch.device("cuda"))
        g = torch.Generator(device="cuda").manual_seed(0)
        b, h, w, cin = SHAPE
        inputs = [torch.randn(b, h, w, c, device="cuda", generator=g).abs().to(torch.bfloat16)
                  for c in (cin, 256, 256)]
        outs = [torch.empty(b, h, w, 256, device="cuda", dtype=torch.bfloat16) for _ in range(3)]
        stream = torch.cuda.current_stream().cuda_stream

        def run(fn, bi):
            wt = weights[bi]
            x = inputs[bi]
            rc = fn(x.data_ptr(), wt.image.data_ptr(), wt.b1.data_ptr(), wt.b2.data_ptr(),
                    wt.b3.data_ptr(), outs[bi].data_ptr(), b, h, w, x.shape[3], int(wt.downsample),
                    stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        def ms(fn, bi):
            for _ in range(3):
                run(fn, bi)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                run(fn, bi)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / ITERS

        names = list(fns)
        times = {n: [[] for _ in range(3)] for n in names}
        for r in range(ROUNDS):
            for name in (names if r % 2 == 0 else names[::-1]):
                for bi in range(3):
                    times[name][bi].append(ms(fns[name], bi))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"card": card, "shape": list(SHAPE),
              "block_ms": {n: [statistics.median(t) for t in times[n]] for n in names}}
    for n, v in result["block_ms"].items():
        print(f"{n:24s} blocks 0, 1, 2: {', '.join(f'{x:.4f}' for x in v)} ms; layer {sum(v):.4f} ms")
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "k2_breakdown.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
