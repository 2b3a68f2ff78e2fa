"""Trainable adapter heads on the frozen 128-d joint space.

Counterpart of the JAX package's ``models/adapters.py``: ``MLPAdapter``
(Linear(128,256) + ReLU + Linear(256,128)), ``LinearAdapter``
(Linear(128,128)) and the shared / double / only-one / none wiring of
:class:`AdapterPair`.  Weights follow torch ``nn.Linear``'s default init,
U(-1/sqrt(in), 1/sqrt(in)) for weight and bias, drawn from an explicit
``torch.Generator``.  As in the JAX package, the wiring and the parameters
are separate: ``AdapterPair.init`` returns an ``nn.ModuleDict`` with
``"shared"`` or ``"image"``/``"text"`` entries, and ``apply_*`` take it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn

from incremental_multimodal_medical_learning_ii_torch.utils.config import (
    AdapterKind,
    JOINT_FEATURE_SIZE,
)


@torch.no_grad()
def _torch_linear_init_(layer: nn.Linear, generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(layer.in_features)
    layer.weight.uniform_(-bound, bound, generator=generator)
    layer.bias.uniform_(-bound, bound, generator=generator)


class MLPAdapter(nn.Module):
    def __init__(self, dim: int = JOINT_FEATURE_SIZE, hidden: int = 256):
        super().__init__()
        self.dense1 = nn.Linear(dim, hidden)
        self.dense2 = nn.Linear(hidden, dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _torch_linear_init_(self.dense1, generator)
        _torch_linear_init_(self.dense2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense2(torch.relu(self.dense1(x)))


class LinearAdapter(nn.Module):
    def __init__(self, dim: int = JOINT_FEATURE_SIZE):
        super().__init__()
        self.dense1 = nn.Linear(dim, dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _torch_linear_init_(self.dense1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense1(x)


def make_adapter(kind: AdapterKind) -> Optional[nn.Module]:
    kind = AdapterKind(kind)
    if kind == AdapterKind.MLP:
        return MLPAdapter()
    if kind == AdapterKind.DENSE:
        return LinearAdapter()
    return None  # no-head


@dataclasses.dataclass
class AdapterPair:
    """Image/text adapter wiring (shared / double / only-one / none).

    With ``shared`` both towers apply the same module, as the reference
    registers one module as both adapters.
    """

    kind: AdapterKind
    shared: bool
    use_image: bool
    use_text: bool

    def __post_init__(self) -> None:
        self.kind = AdapterKind(self.kind)
        if self.kind == AdapterKind.NO_HEAD:
            self.use_image = False
            self.use_text = False

    def init(self, generator: Optional[torch.Generator] = None) -> nn.ModuleDict:
        generator = generator or torch.Generator().manual_seed(0)
        params = nn.ModuleDict()
        if self.kind == AdapterKind.NO_HEAD:
            return params
        names = ["shared"] if self.shared else (
            (["image"] if self.use_image else []) + (["text"] if self.use_text else [])
        )
        for name in names:
            module = make_adapter(self.kind)
            module.reset_parameters(generator)
            params[name] = module
        return params

    def apply_image(self, params: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
        if not self.use_image:
            return x
        return params["shared" if self.shared else "image"](x)

    def apply_text(self, params: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
        if not self.use_text:
            return x
        return params["shared" if self.shared else "text"](x)
