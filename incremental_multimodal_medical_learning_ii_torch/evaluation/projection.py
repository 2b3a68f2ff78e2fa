"""2-D projections for the figures: PCA and exact t-SNE in torch, on the
device of the tensor given (the JAX package calls scikit-learn, which the
card's machine lacks).

:func:`pca_2d` is ``sklearn.decomposition.PCA(n_components=2)
.fit_transform`` with the full SVD, in float64: the centred data's SVD,
signs by sklearn's ``svd_flip(u_based_decision=False)`` (each component's
largest |loading| positive), scores ``U[:, :2] * S[:2]``.

:func:`tsne` is ``sklearn.manifold.TSNE`` at the arguments the JAX
package's figures pass (``metric="cosine"``, ``init="pca"``,
``learning_rate="auto"``, two components), computed exactly: the
(n, n) objective sklearn's ``method="exact"`` minimises, where the JAX
package runs sklearn's default Barnes-Hut approximation of it.  It keeps
sklearn's semantics step by step:

* P: cosine distances (not squared by the metric, so squared here, as
  sklearn squares every metric but euclidean), rounded to float32; each
  row's Gaussian bandwidth by sklearn's binary search on the entropy (100
  steps at most, tolerance 1e-5, in float64); ``P = (P + P^T) / sum``,
  floored at the float64 epsilon;
* init: the PCA scores scaled so that the first column's standard
  deviation is 1e-4 (or ``init=`` as given);
* learning rate ``max(n / 12 / 4, 50)``; 250 iterations with P
  exaggerated 12 times and momentum 0.5, then momentum 0.8 up to 1000
  iterations; gains +0.2 / x0.8 floored at 0.01, the update and gains
  reset between the two stages; every 50 iterations the KL divergence and
  the gradient's norm decide a stop (no progress over 300 iterations, or
  a norm at most 1e-7); Student-t kernel with one degree of freedom.

The optimisation runs in float64 (sklearn computes the objective in
float64), one (n, n) step at a time; the stop checks read two numbers
back every 50 iterations.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

MACHINE_EPSILON = float(np.finfo(np.float64).eps)
EARLY_EXAGGERATION = 12.0
EXPLORATION_ITERS = 250  # sklearn's _EXPLORATION_MAX_ITER
N_ITER_CHECK = 50
MAX_ITER = 1000
N_ITER_WITHOUT_PROGRESS = 300
MIN_GRAD_NORM = 1e-7
MIN_GAIN = 0.01
_PERPLEXITY_STEPS = 100
_PERPLEXITY_TOLERANCE = float(np.float32(1e-5))  # sklearn's C float constants
_EPSILON_DBL = float(np.float32(1e-8))


class TSNEResult(NamedTuple):
    embedding: torch.Tensor  # (n, 2), on the input's device
    kl_divergence: float  # the exact objective at the last iteration checked
    n_iter: int  # index of the last iteration run (sklearn's n_iter_)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def pca_2d(x) -> torch.Tensor:
    """(n, d) -> (n, 2) float64 PCA scores on ``x``'s device."""
    x = _as_tensor(x).to(torch.float64)
    xc = x - x.mean(dim=0)
    u, s, vt = torch.linalg.svd(xc, full_matrices=False)
    signs = torch.sign(vt.gather(1, vt.abs().argmax(dim=1, keepdim=True)))[:, 0]
    return u[:, :2] * (s[:2] * signs[:2])


def perplexity_for(n: int) -> float:
    """The perplexity the JAX figures give sklearn: ``min(30, max(1, (n-1)/3))``."""
    return min(30.0, max(1.0, (n - 1) / 3))


def cosine_distances(x: torch.Tensor) -> torch.Tensor:
    """``sklearn.metrics.pairwise.cosine_distances(x)``: 1 - cosine of the
    L2-normalised rows (a zero row stays zero), clipped to [0, 2], zero
    diagonal."""
    norms = torch.sqrt((x * x).sum(dim=1, keepdim=True))
    xn = x / torch.where(norms == 0, torch.ones_like(norms), norms)
    d = torch.clamp(1.0 - xn @ xn.T, 0.0, 2.0)
    d.fill_diagonal_(0.0)
    return d


def conditional_probabilities(sqdist: torch.Tensor, perplexity: float) -> torch.Tensor:
    """sklearn's ``_binary_search_perplexity`` over every row at once, in
    float64: row i's P_j|i = exp(-d_ij beta_i) / sum, beta_i bisected until
    the entropy is within 1e-5 of log(perplexity); a row keeps the P of the
    step it converged at (or of the last step)."""
    d = sqdist.to(torch.float32).to(torch.float64)
    n = d.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=d.device)
    desired = math.log(float(np.float32(perplexity)))
    beta = torch.ones(n, dtype=torch.float64, device=d.device)
    beta_min = torch.full_like(beta, -math.inf)
    beta_max = torch.full_like(beta, math.inf)
    done = torch.zeros(n, dtype=torch.bool, device=d.device)
    p_final = torch.zeros_like(d)
    for _ in range(_PERPLEXITY_STEPS):
        p = torch.exp(-d * beta[:, None]) * off
        sum_p = p.sum(dim=1)
        sum_p = torch.where(sum_p == 0.0, torch.full_like(sum_p, _EPSILON_DBL), sum_p)
        p = p / sum_p[:, None]
        entropy = torch.log(sum_p) + beta * (d * p).sum(dim=1)
        diff = entropy - desired
        p_final = torch.where(done[:, None], p_final, p)
        step = ~done & (diff.abs() > _PERPLEXITY_TOLERANCE)
        up = step & (diff > 0.0)
        down = step & ~(diff > 0.0)
        beta_min = torch.where(up, beta, beta_min)
        beta_max = torch.where(down, beta, beta_max)
        beta = torch.where(up, torch.where(torch.isinf(beta_max), beta * 2.0, (beta + beta_max) / 2.0),
                           beta)
        beta = torch.where(down, torch.where(torch.isinf(beta_min), beta / 2.0,
                                             (beta + beta_min) / 2.0), beta)
        done = ~step
        if bool(done.all()):
            break
    return p_final


def joint_probabilities(x: torch.Tensor, perplexity: float) -> torch.Tensor:
    """The symmetric (n, n) float64 P of the cosine metric (zero diagonal)."""
    cond = conditional_probabilities(cosine_distances(x) ** 2, perplexity)
    p = cond + cond.T
    p = torch.clamp(p / torch.clamp(p.sum(), min=MACHINE_EPSILON), min=MACHINE_EPSILON)
    p.fill_diagonal_(0.0)
    return p


def kl_divergence_and_gradient(y: torch.Tensor, p: torch.Tensor, compute_error: bool = True):
    """sklearn's ``_kl_divergence`` with one degree of freedom, on full
    (n, n) matrices: KL(P || Q) (a 0-d tensor, ``None`` unless
    ``compute_error``) and its (n, 2) gradient."""
    diff = y[:, None, :] - y[None, :, :]
    w = 1.0 / (1.0 + (diff * diff).sum(dim=-1))
    w.fill_diagonal_(0.0)
    q = torch.clamp(w / w.sum(), min=MACHINE_EPSILON)
    kl = (p * torch.log(torch.clamp(p, min=MACHINE_EPSILON) / q)).sum() if compute_error else None
    grad = 4.0 * torch.einsum("ij,ijk->ik", (p - q) * w, diff)
    return kl, grad


def _descend(y, p, it, max_iter, momentum, learning_rate, n_iter_without_progress):
    """sklearn's ``_gradient_descent`` from iteration ``it``: returns
    (y, kl, last iteration)."""
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    best_error, best_iter, error, i = math.inf, it, math.inf, it
    for i in range(it, max_iter):
        check = (i + 1) % N_ITER_CHECK == 0
        kl, grad = kl_divergence_and_gradient(y, p, check or i == max_iter - 1)
        inc = update * grad < 0.0
        gains = torch.clamp(torch.where(inc, gains + 0.2, gains * 0.8), min=MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad
        y = y + update
        if check or i == max_iter - 1:
            error = float(kl)
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= MIN_GRAD_NORM:
                break
    return y, error, i


def tsne(x, *, init=None) -> TSNEResult:
    """Exact t-SNE of the (n, d) rows ``x`` to two dimensions on ``x``'s
    device (see the module docstring).  ``init``: an (n, 2) start in place
    of the scaled PCA (e.g. sklearn's own randomized-PCA start)."""
    x = _as_tensor(x)
    n = x.shape[0]
    p = joint_probabilities(x, perplexity_for(n))
    if init is None:
        y = pca_2d(x).to(torch.float32)
        y = y / y[:, 0].std(unbiased=False) * 1e-4
    else:
        y = _as_tensor(init)
    y = y.to(device=x.device, dtype=torch.float64)
    learning_rate = max(n / EARLY_EXAGGERATION / 4, 50.0)
    p = p * EARLY_EXAGGERATION
    y, kl, it = _descend(y, p, 0, EXPLORATION_ITERS, 0.5, learning_rate, EXPLORATION_ITERS)
    p = p / EARLY_EXAGGERATION  # as sklearn undoes it (not bit-equal to the unexaggerated P)
    y, kl, it = _descend(y, p, it + 1, MAX_ITER, 0.8, learning_rate, N_ITER_WITHOUT_PROGRESS)
    return TSNEResult(y, kl, it)
