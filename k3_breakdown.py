#!/usr/bin/env python3
"""Where the fp32 flash-attention kernel's time goes, on one NVIDIA GPU.

    python3 k3_breakdown.py                         # from the root of a checkout, one card
    python3 k3_breakdown.py --baseline OTHER/csrc   # also another tree's kernel, end to end

Builds variants of ``csrc/flash_attention.cu`` with one part of the fp32
kernel disabled or changed (the S product, the P V product, ``expf``, the
8 x 4 micro-tile of hd 128 used at hd 64), one ``nvcc`` each in parallel,
and times each at BERT-base report length, (32, 12, 512, 64) fp32 with
``chip_smoke.py``'s ragged lengths 64-512, and with every row full, with
CUDA events, every variant in turns (medians of 5 rounds), beside SDPA.  A
variant that disables a part computes wrong numbers; only its time means
anything.  With ``--baseline`` (the ``csrc/`` directory of another tree,
for example the parent commit unpacked by ``git archive``) that tree's
kernel is built too, held against the plain version, timed beside the
others, and the fp32 report-length encode and the fp32 gradient of the
text tower at BERT-base are timed with each of the two kernels, in turns.
Prints JSON lines and writes ``chiprun_out/k3_breakdown.json``.  Exits 2
without CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent

_S_LOOP = "for (int d = 0; d < HD; d += 4) {"
_PV_LOOP = "for (int t = 0; t < kBlockK; ++t) {"
_ALPHA = "alpha[i] = expf(m[i] - mx[i]);"
_P = "s[i][jj] = expf(s[i][jj] - mx[i]);"
_TX = "static constexpr int kTx = HD == 64 ? 8 : 16;"
# name -> (text in the kernel source, its replacement)
VARIANTS = {
    "no S product": [(_S_LOOP, _S_LOOP.replace("d < HD", "d < 0"))],
    "no P V product": [(_PV_LOOP, _PV_LOOP.replace("t < kBlockK", "t < 0"))],
    "no expf": [(_ALPHA, "alpha[i] = m[i] - mx[i];"), (_P, "s[i][jj] = s[i][jj] - mx[i];")],
    "8 x 4 micro-tile at hd 64": [(_TX, "static constexpr int kTx = 16;")],
}


def build(cuda_build, tmp: Path, baseline: Path | None) -> dict:
    """{name: launcher} of the base kernel, each variant and the baseline."""
    src = (cuda_build.CSRC_DIR / "flash_attention.cu").read_text()
    jobs = {}
    for name, reps in {"base": [], **VARIANTS}.items():
        text = src
        for old, new in reps:
            if old not in text:
                raise SystemExit(f"k3_breakdown: variant {name!r}: {old!r} not in the kernel source")
            text = text.replace(old, new)
        jobs[name] = (text, cuda_build.CSRC_DIR)
    if baseline is not None:
        jobs["baseline"] = ((baseline / "flash_attention.cu").read_text(), baseline)
    procs = {}
    for i, (name, (text, include)) in enumerate(jobs.items()):
        cu, so = tmp / f"v{i}.cu", tmp / f"v{i}.so"
        cu.write_text(text)
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", str(include), "-o", str(so),
               str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so)
    fns = {}
    for name, (proc, so) in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise SystemExit(f"k3_breakdown: nvcc failed for {name!r}:\n{out}")
        spills = [line.strip() for line in out.splitlines()
                  if re.search(r"[1-9]\d* bytes spill stores", line)]
        if spills:  # a variant may spill; its time then says so too
            print(f"{name}: {spills}", flush=True)
        fns[name] = ctypes.CDLL(str(so)).flash_attention_launch
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--baseline", type=Path, default=None,
                    help="the csrc/ directory of another tree whose fp32 kernel is timed beside "
                         "this one's, with the fp32 encode and gradient end to end")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("k3_breakdown: CUDA is not available; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from incremental_multimodal_medical_learning_ii_torch.models import cxr_bert
    from incremental_multimodal_medical_learning_ii_torch.ops import cuda_build
    from incremental_multimodal_medical_learning_ii_torch.ops import flash_attention as fa

    result: dict = {"card": cs.card_line()}
    with tempfile.TemporaryDirectory(prefix="k3_breakdown_") as tmp:
        fns = build(cuda_build, Path(tmp), args.baseline)
        for fn in fns.values():
            fn.argtypes, fn.restype = fa._ARGTYPES, ctypes.c_int
        real = fa.launcher

        @contextlib.contextmanager
        def forward_with(name):  # K3 from the named build; K3b as built by the package
            fa.launcher = lambda lib, symbol, argtypes: (
                fns[name] if symbol == "flash_attention_launch" else real(lib, symbol, argtypes))
            try:
                yield
            finally:
                fa.launcher = real

        def call(name, *operands):
            def run():
                with forward_with(name):
                    return fa.flash_attention(*operands)
            return run

        lengths = cs.ragged_lengths(cs.REPORT[0], cs.REPORT[2], seed=1)
        for shape_name, ls in (("report", lengths), ("full rows", [cs.REPORT[2]] * cs.REPORT[0])):
            q, k, v, seg, scale = cs.flash_inputs(cs.REPORT, ls, torch.float32, seed=10)
            ref = fa.mha_reference(q, k, v, seg, seg, scale)
            errors = {n: float((call(n, q, k, v, seg, seg, scale)() - ref).abs().max())
                      for n in fns if n in ("base", "baseline")}
            allowed = (seg[:, :, None] == seg[:, None, :])[:, None]
            timed = {n: call(n, q, k, v, seg, seg, scale) for n in fns}
            timed["SDPA"] = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed,
                                                                   scale=scale)
            result[shape_name] = dict(ms=cs.alternating_ms(timed, iters=30), max_abs_err=errors,
                                      bound_ms=cs.flash_bound_ms(q, seg)[0])
            print(json.dumps({shape_name: result[shape_name]}), flush=True)
            if errors["base"] > cs.FLASH_F32_ATOL or errors.get("baseline", 0.0) > cs.FLASH_F32_ATOL:
                raise SystemExit(f"k3_breakdown: a kernel disagrees with the plain version: {errors}")

        if args.baseline is not None:  # end to end: the fp32 encode and gradient, each kernel
            model = cxr_bert.init_cxr_bert(torch.Generator().manual_seed(0),
                                           cxr_bert.BertDims()).cuda()
            ids, mask = cs.report_batch(model.dims.vocab_size, seed=2)
            w = torch.randn(ids.shape[0], model.dims.projection_size, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(17))
            model.requires_grad_(True)
            for p in model.mlm_head.parameters():
                p.requires_grad_(False)
            params = [p for p in model.parameters() if p.requires_grad]

            def encode(name):
                def run():
                    with forward_with(name), torch.no_grad():
                        return cxr_bert.get_projected_text_embeddings(model, ids, mask,
                                                                      use_flash_attention=True)
                return run

            def gradient(name):
                def run():
                    with forward_with(name):
                        out = cxr_bert.get_projected_text_embeddings(model, ids, mask,
                                                                     use_flash_attention=True)
                        return torch.autograd.grad((out * w).sum(), params, allow_unused=True)
                return run

            names = ("baseline", "base")
            result["fp32 encode (32, 512)"] = dict(
                ms=cs.alternating_ms({n: encode(n) for n in names}, iters=10),
                max_abs_diff=float((encode("base")() - encode("baseline")()).abs().max()))
            result["fp32 gradient (32, 512)"] = dict(
                ms=cs.alternating_ms({n: gradient(n) for n in names}, rounds=3, iters=2))
            for key in ("fp32 encode (32, 512)", "fp32 gradient (32, 512)"):
                print(json.dumps({key: result[key]}), flush=True)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "k3_breakdown.json").write_text(json.dumps(result, indent=1))
    print(result["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
