"""Plain replay of a class-incremental run of the adapter experiment
(RE-tune's class-incremental protocol with myCL), in float32 with TF32 off,
built on ``reference/joint.py``'s pieces.

Written from the protocol's stated setup, not from the port: the train
rows split by label into one unit a disease (the rows positive for it, in
their order; a row positive for several diseases is in each of their
units), trained in ``tasks_order``; unit u trains the logits of the first
u + 1 diseases (MORE_LABELS), its rows' other labels masked out of the
BCE; MAX prompts: each logit is the largest cosine to the class's adapted
positive prompts less the largest to its negative ones; after each Adam
step of every unit but the first, myCL resets, in every parameter tensor,
the weights whose change in the step is below min + threshold * (max -
min) of the tensor's changes (strictly) to their value before the step,
the moments kept; the threshold grows by ``adder`` every epoch of the run
from ``threshold``.  The epochs' row orders continue one counter over the
units (``joint.epoch_order``).  After each unit a val pass over every
disease.  ``tf32=True`` is the control, ``fault=("half",)`` trains each
step on the first half of its rows.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from h100_bench.reference.joint import _mlp, _unit, bce, epoch_order, init_adapters, leaf_gaps


def max_logits(p, x, pos, neg):
    """(B, C) MAX-prompt logits: max_k cos(x, pos_ck) - max_k cos(x, neg_ck)."""
    c, k, d = pos.shape
    xi = _unit(_mlp(p, "image", x))
    tp = _unit(_mlp(p, "text", pos.reshape(c * k, d)).reshape(c, k, d))
    tn = _unit(_mlp(p, "text", neg.reshape(c * k, d)).reshape(c, k, d))
    return (torch.einsum("bd,ckd->bck", xi, tp).amax(-1)
            - torch.einsum("bd,ckd->bck", xi, tn).amax(-1))


def units_of(tx: torch.Tensor, ty: torch.Tensor, order) -> List[tuple]:
    """The train rows positive for each disease, in ``order``."""
    return [(tx[ty[:, c] == 1], ty[ty[:, c] == 1]) for c in order]


def replay(seed: int, data, bank, p, device, starts=None, tf32: bool = False, fault=None,
           scored=None) -> dict:
    """A whole run: per unit its per-step train losses, the resets of the
    last step of each of its epochs (myCL units), its val losses per eval
    batch, its start and end parameters and its end state (``params``,
    ``mu``, ``nu``, ``count``); the first step's gradients.

    ``starts``, if given, is the program's state (``params``, ``mu``,
    ``nu``, ``count``) at the start of each unit after the first: each unit
    is then replayed from the state the program began it with, so a myCL
    reset that a rounding difference tips one way in the program and the
    other here (a weight whose change lies at the cutoff) moves one unit's
    numbers, not every later unit's.  ``scored``, if given, is the
    program's state at the end of each unit: the val pass after a unit then
    scores the program's parameters, so that its losses hold the eval
    arithmetic (the adapters, MAX scoring, the BCE) alone, and a reset
    tipped the other way inside the unit moves them not at all."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return _replay(seed, data, bank, p, device, starts, fault, scored)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _replay(seed, data, bank, p, device, starts, fault, scored):
    (tx, ty), (vx, vy), _ = data
    pos, neg = bank[0], bank[1]
    dtype = tx.dtype
    init = {k: v.to(device=device, dtype=dtype) for k, v in init_adapters(seed).items()}
    params = {k: v.clone() for k, v in init.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    b, eb, n_cls = p["batch"], p["eval_batch"], ty.shape[1]
    out = {"unit_losses": [], "unit_val_losses": [], "unit_resets": [], "unit_starts": [], "unit_ends": [],
           "unit_states": []}
    first_grads = None
    count = epoch_counter = 0
    threshold = p["threshold"]
    for u, (ux, uy) in enumerate(units_of(tx, ty, p["tasks_order"][:p["units"]])):
        if u and starts is not None and u <= len(starts):
            st = starts[u - 1]
            params, mu, nu = ({k: v.to(device=device, dtype=dtype) for k, v in st[n].items()}
                              for n in ("params", "mu", "nu"))
            count = int(st["count"])
        out["unit_starts"].append(dict(params))
        task = p["tasks_order"][u]
        class_mask = torch.zeros(n_cls, device=device, dtype=dtype)
        if p["more_labels"]:
            class_mask[:task + 1] = 1.0
        else:
            class_mask[task] = 1.0
        my_cl = p["continual_learning"] == "myCL" and u > 0
        n = ux.shape[0]
        n_pad = -(-n // b) * b
        x = torch.zeros(n_pad, ux.shape[1], device=device, dtype=dtype)
        y = torch.zeros(n_pad, n_cls, device=device, dtype=dtype)
        valid = torch.zeros(n_pad, device=device, dtype=dtype)
        x[:n], y[:n], valid[:n] = ux, uy, 1.0
        losses, resets = [], []
        for _ in range(p["epochs"]):
            threshold += p["adder"]
            epoch_counter += 1
            thr = torch.tensor(threshold, dtype=torch.float32, device=device)
            order = epoch_order(seed, epoch_counter, n, n_pad).to(device)
            xs, ys, vs = x[order], y[order], valid[order]
            for i in range(0, n_pad, b):
                leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                rows = b // 2 if fault == ("half",) else b
                mask = vs[i:i + rows, None] * class_mask[None, :]
                loss = bce(max_logits(leaves, xs[i:i + rows], pos, neg), ys[i:i + rows], mask)
                grads = torch.autograd.grad(loss, list(leaves.values()))
                losses.append(loss.detach())
                count += 1
                n_reset = 0
                with torch.no_grad():
                    for (k, w), g in zip(leaves.items(), grads):
                        mu[k] = 0.1 * g + 0.9 * mu[k]
                        nu[k] = 0.001 * g * g + 0.999 * nu[k]
                        upd = (mu[k] / (1 - 0.9 ** count)) / (torch.sqrt(nu[k] / (1 - 0.999 ** count)) + 1e-8)
                        new = w.detach() - p["lr"] * upd
                        if my_cl:
                            diff = torch.abs(new - w.detach())
                            lo, hi = diff.min(), diff.max()
                            keep = diff < lo + thr * (hi - lo)
                            new = torch.where(keep, w.detach(), new)
                            n_reset = n_reset + keep.sum()
                        params[k] = new
                    if first_grads is None:
                        first_grads = {k: g.detach().clone() for k, g in zip(leaves, grads)}
            if my_cl:
                resets.append(int(n_reset))  # the epoch's last step's, as the program logs it
        out["unit_losses"].append(torch.stack(losses).double().cpu())
        out["unit_resets"].append(resets)
        out["unit_ends"].append(dict(params))
        out["unit_states"].append({"params": dict(params), "mu": dict(mu), "nu": dict(nu), "count": count})
        at = params if scored is None or u >= len(scored) else {k: v.to(device=device, dtype=dtype)
                                            for k, v in scored[u]["params"].items()}
        with torch.no_grad():
            val = [bce(z, vy[i:i + eb], torch.ones_like(z))
                   for i in range(0, vx.shape[0], eb) for z in [max_logits(at, vx[i:i + eb], pos, neg)]]
        out["unit_val_losses"].append(torch.stack(val).double().cpu())
    return {**out, "init": init, "final": params, "first_grads": first_grads}


def unit_loss3_gaps(got: dict, want: dict) -> List[float]:
    """Per unit, the worst relative gap of its first three step losses (all
    of them, where it has fewer; inf where the units' step counts differ)."""
    if len(got["unit_losses"]) != len(want["unit_losses"]):
        return [math.inf]
    out = []
    for gl, wl in zip(got["unit_losses"], want["unit_losses"]):
        gl = gl.to(torch.float64)
        ok = len(gl) == len(wl) > 0
        out.append(float(((gl[:3] - wl[:3]).abs() / wl[:3].abs()).max()) if ok else math.inf)
    return out


def moment_gaps(got: dict, want: dict) -> List[float]:
    """Per unit, the worse of the two Adam moments' median-leaf gaps at the
    unit's end, as ``joint.leaf_gaps`` measures the parameters' change: per
    leaf the gap between the norms of the program's (or control's) moment
    and the reference's, over the larger of the reference's norm and the
    median leaf's."""
    out = []
    for g, w in zip(got["unit_states"], want["unit_states"]):
        worst = 0.0
        for m in ("mu", "nu"):
            ref = {k: float(torch.linalg.vector_norm(v.double())) for k, v in w[m].items()}
            med = float(np.median(list(ref.values())))
            gaps = [abs(float(torch.linalg.vector_norm(g[m][k].double())) - ref[k]) / max(ref[k], med, 1e-30)
                    for k in ref]
            worst = max(worst, float(np.median(gaps)))
        out.append(worst)
    return out


def compare(got: dict, want: dict) -> Dict[str, float]:
    """The numbers ``correct`` holds a run to, program (or control) against
    the reference replayed from the program's unit starts: the worst
    relative gap of each unit's first three step losses (all of a unit's,
    where it has fewer); the worst unit's median-leaf gap in the
    parameters' change over the unit (``joint.leaf_gaps``; the worst leaf's
    is reported beside it); the worst relative gap of the val losses after
    every unit (the program's own parameters scored, where the replay was
    given them); the worst myCL unit's relative gap in the resets its
    epochs' last steps made.  The state each unit hands on is held too, so
    that what the next unit is replayed from is the reference's own
    arithmetic: the worst unit's gap in the Adam moments at its end
    (:func:`moment_gaps`) and the most by which its update count differs."""
    n = len(want["unit_ends"])
    if (len(got.get("unit_states", [])) != n or len(got["unit_resets"]) != n
            or len(got["unit_losses"]) != n or len(got["unit_val_losses"]) != n):
        return {"loss3_gap": math.inf, "delta_median_gap": math.inf, "delta_worst_leaf_gap": math.inf,
                "val_loss_gap": math.inf, "resets_gap": math.inf, "moments_gap": math.inf,
                "count_gap": math.inf}
    medians, worst = [], []
    for u in range(n):
        gaps = leaf_gaps({"final": got["unit_states"][u]["params"]},
                         {"init": want["unit_starts"][u], "final": want["unit_ends"][u],
                          "first_grads": want["first_grads"]})
        medians.append(float(np.median(list(gaps.values()))))
        worst.append(max(gaps.values()))
    val = 0.0
    for gv, wv in zip(got["unit_val_losses"], want["unit_val_losses"]):
        gv = gv.to(torch.float64)
        val = max(val, float(((gv - wv).abs() / wv.abs()).max()) if gv.shape == wv.shape else math.inf)
    resets = 0.0
    for gr, wr in zip(got["unit_resets"], want["unit_resets"]):
        if len(gr) != len(wr):
            resets = math.inf
        elif wr:
            resets = max(resets, abs(sum(gr) - sum(wr)) / max(sum(wr), 1))
    counts = max(abs(int(g["count"]) - int(w["count"])) for g, w in zip(got["unit_states"], want["unit_states"]))
    return {"loss3_gap": max(unit_loss3_gaps(got, want)), "delta_median_gap": max(medians),
            "delta_worst_leaf_gap": max(worst), "val_loss_gap": val, "resets_gap": resets,
            "moments_gap": max(moment_gaps(got, want)), "count_gap": float(counts)}
