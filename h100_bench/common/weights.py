"""Inputs made from ``--seed``: the BioViL weights, the prompt bank and the
cached embeddings of the adapter experiment.

Everything is drawn on the run's device by one ``torch.Generator`` there, in
a few large calls, and handed the same to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from h100_bench.reference.biovil import BN_EPS, param_specs

SEED_MASK = 2**63 - 1
OUTLIER_SHARE, OUTLIER_GAIN = 0.03, 4.0  # batch-norm channels with large activations


def generator(seed: int, stream: int, device) -> torch.Generator:
    """One generator per input kind, so adding an input never shifts another."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) & SEED_MASK)
    return g


def biovil_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    """Random BioViL image weights at the published shapes, on ``device``,
    float32 tensors holding bfloat16 values: the type they are served in.

    Batch norms come in their served, frozen form: mean 0 and variance
    ``1 - eps`` (so ``var + eps`` is exactly 1 in float32) and a scale and
    bias that are the folded multiply and add, exact in bfloat16.  A program
    that folds them in float32 and serves them in bfloat16 then serves the
    drawn values; drawn otherwise, each channel's scale would be rounded once
    and for all, a gain error of up to 2^-9 that no average over the patch
    grid removes, and that alone would read as most of a bf16 program's gap.

    Drawn with a trained network's statistics in the two ways that decide
    what a lower precision costs: convolution kernels are Laplace (heavy
    tailed) at the kaiming fan-out variance, and 3% of each batch norm's
    channels, drawn at random, get four times the scale of the others (the
    few large activation channels of trained networks).  Otherwise each batch
    norm gets a scale in [0.5, 1) (the last of a residual branch [0.3, 0.7),
    so the activations stay bounded through sixteen residual sums) and a bias
    within +-0.01.  Larger biases, or a shortcut scaled down as far as the
    branch, would drown the image in constants: the global embeddings of
    different images would agree to 1e-4, and no comparison could tell one
    image's answer from another's."""
    g = generator(seed, 1, device)
    specs = param_specs(3)
    n_conv = sum(math.prod(s) for _, s, k in specs if k == "conv")
    n_vec = sum(3 * s[0] if k == "bn" else s[0] for _, s, k in specs if k != "conv")
    v = torch.rand(n_conv, generator=g, device=device) - 0.5
    z = -torch.sign(v) * torch.log1p(-2 * v.abs().clamp(max=0.4999999)) / math.sqrt(2.0)  # Laplace, variance 1
    u = torch.rand(n_vec, generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    zi = ui = 0
    for name, shape, kind in specs:
        if kind == "conv":
            n = math.prod(shape)
            std = math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
            out[name] = _bf16((z[zi:zi + n] * std).view(shape))
            zi += n
            continue
        c = shape[0]
        if kind == "bias":
            out[name] = _bf16((u[ui:ui + c] - 0.5) * 0.02)
            ui += c
            continue
        s = u[ui:ui + c]
        scale = (0.3 + 0.4 * s) if name.endswith("bn3") else (0.5 + 0.5 * s)
        out[name + ".scale"] = _bf16(torch.where(u[ui + 2 * c:ui + 3 * c] < OUTLIER_SHARE, OUTLIER_GAIN * scale, scale))
        out[name + ".bias"] = _bf16((u[ui + c:ui + 2 * c] - 0.5) * 0.02)
        out[name + ".mean"] = torch.zeros(c, device=device)
        out[name + ".var"] = torch.full((c,), 1.0 - BN_EPS, device=device)
        ui += 3 * c
    return out


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def prompt_bank(seed: int, device, classes: int = 5, prompts: int = 4, dim: int = 128):
    """The CheXpert bank's shape: per class ``prompts`` positive and negative
    128-d prompt embeddings (CXR-BERT projections are not unit vectors: a
    shared offset plus noise), with their counts."""
    g = generator(seed, 2, device)
    common = torch.randn(dim, generator=g, device=device)
    raw = torch.randn(2, classes, prompts, dim, generator=g, device=device) + 0.5 * common
    count = torch.full((classes,), prompts, dtype=torch.int32, device=device)
    return raw[0].contiguous(), raw[1].contiguous(), count, count.clone()


# the five competition tasks' prevalence (an assumption of the configuration,
# near CheXpert's frontal train set with uncertain labels as negative)
PREVALENCE = (0.15, 0.12, 0.07, 0.24, 0.39)


def joint_data(seed: int, device, rows, dim: int = 128):
    """Cached-embedding stand-ins for (train, val, test): labels drawn at
    :data:`PREVALENCE`; each embedding is a fixed direction per positive
    label plus noise, unit-normalised as BioViL's projections are scored."""
    g = generator(seed, 3, device)
    total = sum(rows)
    prev = torch.tensor(PREVALENCE, device=device)
    labels = (torch.rand(total, len(PREVALENCE), generator=g, device=device) < prev).float()
    dirs = torch.randn(len(PREVALENCE), dim, generator=g, device=device)
    x = torch.randn(total, dim, generator=g, device=device) + 0.6 * labels @ dirs
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    out, start = [], 0
    for n in rows:
        out.append((x[start:start + n], labels[start:start + n]))
        start += n
    return out
