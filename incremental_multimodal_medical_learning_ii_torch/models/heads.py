"""Downstream classification heads (counterpart of the JAX package's
``models/heads.py``).

Parity with the vendored ``MLP`` (non-conv variant) and ``MultiTaskModel``
(``health_multimodal/image/model/modules.py:12-88``): per-task heads over
pooled trunk features, returning (batch, num_classes, num_tasks) logits.
Unused on the reference's main path but part of its model surface.

The per-task heads are stacked on a leading task axis and run as one
batched ``einsum`` over it, as in the JAX package; the parameters keep the
JAX names and layouts (``w`` (T, D, C), ``b`` (T, C); or ``w1`` (T, D, H),
the frozen BN statistics (T, H), ``w2`` (T, H, C), ``b2`` (T, C)).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

BN_EPS = 1e-5

LINEAR_PARAMS = ("w", "b")
MLP_PARAMS = ("w1", "bn_scale", "bn_bias", "bn_mean", "bn_var", "w2", "b2")


class MultitaskHead(nn.Module):
    """Stacked per-task heads: linear (``w``, ``b``) or an MLP whose first
    projection has no bias, followed by a frozen BN, ReLU and a linear."""

    def __init__(self, input_dim: int, num_classes: int, num_tasks: int,
                 hidden_dim: Optional[int] = None):
        super().__init__()
        t = num_tasks
        if hidden_dim is None:
            shapes = {"w": (t, input_dim, num_classes), "b": (t, num_classes)}
        else:
            shapes = {"w1": (t, input_dim, hidden_dim), "w2": (t, hidden_dim, num_classes),
                      "b2": (t, num_classes)}
            for name, init in (("bn_scale", 1.0), ("bn_bias", 0.0), ("bn_mean", 0.0),
                               ("bn_var", 1.0)):
                self.register_buffer(name, torch.full((t, hidden_dim), init))
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.zeros(shape)))
        self.mlp = hidden_dim is not None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return multitask_head_forward(self, x)


@torch.no_grad()
def init_multitask_head(generator: Optional[torch.Generator], input_dim: int, num_classes: int,
                        num_tasks: int, hidden_dim: Optional[int] = None) -> MultitaskHead:
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights and biases (torch's
    ``nn.Linear`` bounds), identity BN, drawn from ``generator``; on the CPU."""
    generator = generator or torch.Generator().manual_seed(0)
    head = MultitaskHead(input_dim, num_classes, num_tasks, hidden_dim)
    fan_in = {"w": input_dim, "b": input_dim, "w1": input_dim, "w2": hidden_dim, "b2": hidden_dim}
    for name, p in head.named_parameters():
        bound = 1.0 / float(np.sqrt(fan_in[name]))
        p.uniform_(-bound, bound, generator=generator)
    return head.eval()


def multitask_head_forward(head: MultitaskHead, x: torch.Tensor) -> torch.Tensor:
    """(B, D) pooled features -> (B, num_classes, num_tasks) logits (the
    vendored output layout, ``modules.py:80-88``)."""
    if not head.mlp:
        logits = torch.einsum("bd,tdc->btc", x, head.w) + head.b[None]
    else:
        h = torch.einsum("bd,tdh->bth", x, head.w1)
        h = (h - head.bn_mean[None]) / torch.sqrt(head.bn_var[None] + BN_EPS)
        h = torch.relu(h * head.bn_scale[None] + head.bn_bias[None])
        logits = torch.einsum("bth,thc->btc", h, head.w2) + head.b2[None]
    return logits.transpose(1, 2)
