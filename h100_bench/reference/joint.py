"""Plain replay of a joint run of the adapter experiment (RE-tune's MLP
double adapters over cached embeddings), in float32 with TF32 off.

Written from the experiment's stated setup, not from the port: two MLP
adapters 128 -> 256 -> ReLU -> 128 (image, then text), each ``nn.Linear``
initialised U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight then bias from one
CPU ``torch.Generator`` seeded with the run's seed; the text adapter on
every prompt, then the mean prompt per class and polarity; the train logit
cos(image, mean positive) - cos(image, mean negative) with rows normalised
as x / max(||x||, 1e-8); binary cross-entropy with logits averaged over the
batch's real rows and the classes; Adam (0.9, 0.999, 1e-8, bias-corrected,
optax's order); each epoch's rows in the order ``torch.randperm`` draws from
a generator seeded by ``SeedSequence([seed + 1, epoch])`` (padding rows at the
tail of the last batch), then a val and a test pass in fixed batches.

``tf32=True`` lets the matmuls run in TF32: the control.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

NAMES = ("dense1.weight", "dense1.bias", "dense2.weight", "dense2.bias")


def init_adapters(seed: int, d: int = 128, hidden: int = 256) -> Dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(int(seed))
    out = {}
    for tower in ("image", "text"):
        for name, shape, fan_in in (("dense1.weight", (hidden, d), d), ("dense1.bias", (hidden,), d),
                                    ("dense2.weight", (d, hidden), hidden), ("dense2.bias", (d,), hidden)):
            b = 1.0 / math.sqrt(fan_in)
            out[f"{tower}.{name}"] = torch.empty(shape).uniform_(-b, b, generator=g)
    return out


def epoch_order(seed: int, epoch: int, n: int, n_pad: int) -> torch.Tensor:
    st = np.random.SeedSequence([int(seed) + 1, int(epoch)]).generate_state(2, np.uint32)
    g = torch.Generator().manual_seed(int(st[0]) << 32 | int(st[1]))
    return torch.cat([torch.randperm(n, generator=g), torch.arange(n, n_pad)])


def _unit(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)


def _mlp(p, tower, x):
    h = torch.relu(x @ p[f"{tower}.dense1.weight"].T + p[f"{tower}.dense1.bias"])
    return h @ p[f"{tower}.dense2.weight"].T + p[f"{tower}.dense2.bias"]


def logits(p, x, pos, neg):
    c, k, d = pos.shape
    tp = _mlp(p, "text", pos.reshape(c * k, d)).reshape(c, k, d).mean(1)
    tn = _mlp(p, "text", neg.reshape(c * k, d)).reshape(c, k, d).mean(1)
    xi = _unit(_mlp(p, "image", x))
    return xi @ _unit(tp).T - xi @ _unit(tn).T


def bce(z, y, mask):
    per = torch.relu(z) - z * y + torch.log1p(torch.exp(-torch.abs(z)))
    return torch.sum(per * mask) / torch.clamp(torch.sum(mask), min=1.0)


def replay(seed: int, data, bank, p, device, tf32: bool = False, fault=None) -> dict:
    """A whole joint run: per-step train losses, val losses per eval batch and
    epoch, the initial and final parameters and the first step's gradients.

    ``fault`` plants one of the faults ``correct`` must catch, for reading
    what they score: ``("half",)`` trains each step on the first half of its
    rows, the mean taken over them; ``("no_exchange", n)`` is rank 0 of ``n``
    ranks without the gradients' sum: its own rows' share of the loss over
    the whole batch's count."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return _replay(seed, data, bank, p, device, fault)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _step_loss(z, y, mask, fault):
    if fault is None:
        return bce(z, y, mask)
    rows = z.shape[0]
    if fault[0] == "half":
        h = rows // 2
        return bce(z[:h], y[:h], mask[:h])
    if fault[0] == "no_exchange":
        k = rows // fault[1]
        per = torch.relu(z[:k]) - z[:k] * y[:k] + torch.log1p(torch.exp(-torch.abs(z[:k])))
        return torch.sum(per * mask[:k]) / torch.clamp(torch.sum(mask), min=1.0)
    raise ValueError(f"unknown fault {fault!r}")


def _replay(seed, data, bank, p, device, fault=None):
    (tx, ty), (vx, vy), _ = data
    pos, neg = bank[0], bank[1]
    dtype = tx.dtype
    init = {k: v.to(device=device, dtype=dtype) for k, v in init_adapters(seed).items()}
    params = {k: v.clone() for k, v in init.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    b, eb = p["batch"], p["eval_batch"]
    n = tx.shape[0]
    n_pad = -(-n // b) * b
    x = torch.zeros(n_pad, tx.shape[1], device=device, dtype=dtype)
    y = torch.zeros(n_pad, ty.shape[1], device=device, dtype=dtype)
    valid = torch.zeros(n_pad, device=device, dtype=dtype)
    x[:n], y[:n], valid[:n] = tx, ty, 1.0
    losses: List[float] = []
    val_losses: List[float] = []
    first_grads = None
    count = 0
    for epoch in range(1, p["epochs"] + 1):
        order = epoch_order(seed, epoch, n, n_pad).to(device)
        xs, ys, vs = x[order], y[order], valid[order]
        for i in range(0, n_pad, b):
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            mask = vs[i:i + b, None].expand(-1, ys.shape[1])
            loss = _step_loss(logits(leaves, xs[i:i + b], pos, neg), ys[i:i + b], mask, fault)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            losses.append(loss.detach())
            count += 1
            with torch.no_grad():
                for (k, w), g in zip(leaves.items(), grads):
                    mu[k] = 0.1 * g + 0.9 * mu[k]
                    nu[k] = 0.001 * g * g + 0.999 * nu[k]
                    upd = (mu[k] / (1 - 0.9 ** count)) / (torch.sqrt(nu[k] / (1 - 0.999 ** count)) + 1e-8)
                    params[k] = w.detach() - p["lr"] * upd
                if first_grads is None:
                    first_grads = {k: g.detach().clone() for k, g in zip(leaves, grads)}
        with torch.no_grad():
            for i in range(0, vx.shape[0], eb):
                z = logits(params, vx[i:i + eb], pos, neg)
                val_losses.append(bce(z, vy[i:i + eb], torch.ones_like(z)))
    return {"losses": torch.stack(losses).double().cpu(), "val_losses": torch.stack(val_losses).double().cpu(),
            "init": init, "final": params, "first_grads": first_grads}


def leaf_gaps(got: dict, want: dict) -> Dict[str, float]:
    """Per leaf, the gap between the norms of the parameters' change over the
    run, program (or control) against reference, over the larger of that
    leaf's and the median leaf's change; leaves whose first gradient is under
    a thousandth of the median leaf's are left out."""
    g_norm = {k: float(torch.linalg.vector_norm(v.double())) for k, v in want["first_grads"].items()}
    g_med = float(np.median(list(g_norm.values())))
    keep = [k for k in want["final"] if g_norm[k] >= 1e-3 * g_med]
    d_ref = {k: float(torch.linalg.vector_norm((want["final"][k] - want["init"][k]).double())) for k in keep}
    d_got = {k: float(torch.linalg.vector_norm((got["final"][k].to(want["init"][k].device)
                                                - want["init"][k]).double())) for k in keep}
    d_med = float(np.median(list(d_ref.values())))
    return {k: abs(d_got[k] - d_ref[k]) / max(d_ref[k], d_med) for k in keep}


def compare(got: dict, want: dict) -> Dict[str, float]:
    """The numbers ``correct`` holds a run to, program (or control) against
    the reference: the worst relative gap of the first three steps' losses;
    the median leaf's gap in the parameters' change over the run
    (:func:`leaf_gaps`; the worst leaf's is reported beside it); the worst
    relative gap of the val losses of every epoch's eval batches."""
    wl, gl = want["losses"], got["losses"].to(torch.float64)
    loss3 = float(((gl[:3] - wl[:3]).abs() / wl[:3].abs()).max()) if len(gl) >= 3 else math.inf
    gaps = leaf_gaps(got, want)
    wv, gv = want["val_losses"], got["val_losses"].to(torch.float64)
    val = float(((gv - wv).abs() / wv.abs()).max()) if gv.shape == wv.shape else math.inf
    return {"loss3_gap": loss3, "delta_median_gap": float(np.median(list(gaps.values()))),
            "delta_worst_leaf_gap": max(gaps.values()), "val_loss_gap": val}
