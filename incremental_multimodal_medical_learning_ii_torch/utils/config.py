"""Experiment configuration: the part of the JAX package's
``utils/config.py`` that the serving path reads.

A copy, not an import: this package never imports the JAX package.  The
fields and their normalisation in ``__post_init__`` follow the JAX
``ExperimentConfig`` (enums accept plain strings; ``shared`` forces both
adapters on; ``no-head`` forces both off).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

CHEXPERT_COMPETITION_TASKS: Tuple[str, ...] = (
    "Atelectasis",
    "Cardiomegaly",
    "Consolidation",
    "Edema",
    "Pleural Effusion",
)

JOINT_FEATURE_SIZE = 128


class AdapterKind(str, enum.Enum):
    """Which trainable head sits on each tower (reference ``MODEL_USED``)."""

    MLP = "mlp"  # Linear(128,256) + ReLU + Linear(256,128)
    DENSE = "dense"  # Linear(128,128)
    NO_HEAD = "no-head"  # identity (zero-shot only)


class PromptMode(str, enum.Enum):
    """Prompt-ensemble reduction (reference ``basic_prompts`` / ``MAX_EMB``)."""

    SINGLE = "single"  # one prompt per polarity
    MEAN = "mean"  # mean of prompt embeddings after the adapter
    MAX = "max"  # per-prompt cosine, max over prompts


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """The adapter and scorer settings a served classifier runs under."""

    shared: bool = False  # one module serves as both adapters
    image_adapter: bool = True
    text_adapter: bool = True
    adapter: AdapterKind = AdapterKind.MLP
    prompt_mode: PromptMode = PromptMode.MEAN
    train_logit_diff: bool = True  # train logit = pos - neg, else pos only
    pred_logit_diff: bool = False  # score = (pos-neg+2)/4, else (pos+1)/2

    def __post_init__(self) -> None:
        object.__setattr__(self, "adapter", AdapterKind(self.adapter))
        object.__setattr__(self, "prompt_mode", PromptMode(self.prompt_mode))
        if self.shared:
            object.__setattr__(self, "image_adapter", True)
            object.__setattr__(self, "text_adapter", True)
        if self.adapter == AdapterKind.NO_HEAD and (self.image_adapter or self.text_adapter):
            object.__setattr__(self, "image_adapter", False)
            object.__setattr__(self, "text_adapter", False)


def joint_config(**kw) -> ExperimentConfig:
    """A trained-adapter configuration (the JAX ``joint_config`` defaults:
    MLP adapters on both towers, MEAN prompts)."""
    return ExperimentConfig(**kw)
