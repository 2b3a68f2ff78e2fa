"""Experiment configuration (counterpart of the JAX package's
``utils/config.py``).

A copy, not an import: this package never imports the JAX package.  The
fields, their normalisation and checks in ``__post_init__`` and
:meth:`ExperimentConfig.run_name` follow the JAX ``ExperimentConfig``
character for character, so a run of the port logs under the same
directory name as the same run of the JAX package.  The JAX fields that
only steer a TPU (``compute_dtype``, ``data_axis``) have no counterpart.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

CHEXPERT_COMPETITION_TASKS: Tuple[str, ...] = (
    "Atelectasis",
    "Cardiomegaly",
    "Consolidation",
    "Edema",
    "Pleural Effusion",
)

JOINT_FEATURE_SIZE = 128
NUM_CLASSES = 5
DEFAULT_SEED = 27  # reference: ZERO_JOINT_BOUNDS.py:9-14


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


class Optim(str, enum.Enum):
    ADAM = "adam"
    SGD = "sgd"


class ContinualLearning(str, enum.Enum):
    MY_CL = "myCL"  # per-step weight reset
    PROF_CL = "profCL"  # per-epoch weight reset


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Full configuration of a run (any of the three drivers) or of a served
    classifier."""

    # --- adapters ---
    shared: bool = False  # one module serves as both adapters
    image_adapter: bool = True
    text_adapter: bool = True
    adapter: AdapterKind = AdapterKind.MLP
    optim: Optim = Optim.ADAM

    # --- prompting ---
    prompt_mode: PromptMode = PromptMode.MEAN
    new_prompts: bool = False  # MedCLIP-style compositional bank
    # MAX-mode gap monitor: False logs one per-step pair (mean over the
    # trained classes); True one pair per trained class per batch
    max_gap_per_class: bool = False

    # --- logit construction ---
    train_logit_diff: bool = True  # train logit = pos - neg, else pos only
    pred_logit_diff: bool = False  # score = (pos-neg+2)/4, else (pos+1)/2
    change_labels: bool = False  # labels {0,1} -> {-1,+1}

    # --- data ---
    chex_competition: bool = True
    xrays_position: str = "all"  # "all" | "frontal"
    batch_size: int = 6144
    eval_batch_size: int = 1024

    # --- optimisation ---
    lr: float = 1e-4
    epochs: int = 10
    loss_name: str = "standard"
    seed: int = DEFAULT_SEED
    lr_schedule: Optional[str] = None  # None | "exponential" (per step)
    lr_gamma: float = 0.999

    # --- incremental protocol ---
    mode: str = "joint"  # "joint" | "zero" | "data-inc" | "class-pos" | "class-pos-neg"
    parts: int = 1  # data-incremental number of parts (5 / 10 / 20)
    more_labels: bool = False  # growing logit vector
    tasks_order: Tuple[int, ...] = (0, 1, 2, 3, 4)

    # --- continual learning (weight reset) ---
    continual_learning: Optional[ContinualLearning] = None
    threshold: float = 0.01
    ratio: bool = True
    adder: float = 0.001
    threshold_scheduling: bool = False

    # --- bookkeeping ---
    folder_name: Optional[str] = None  # run-dir root; default depends on mode
    run_dir_root: str = "runs"

    # --- execution ---
    # one training epoch as one call over device-resident data
    # (engine/steps.py::build_fused_epoch); False steps batch by batch
    fused_epoch: bool = True
    # all epochs of an incremental unit (and its post-unit evals) as one
    # call; joint mode folds its whole run with per-epoch evals, and the
    # incremental protocols fold every unit (build_fused_unit/_run)
    fused_unit: bool = False
    # reshuffle the train rows every epoch (padding rows stay at the tail)
    shuffle_train: bool = True
    # figure cadence: "reference" draws the ROC/PR/scatter/t-SNE/heatmap
    # figures at every eval, as the reference does; "final" only at the last
    # epoch/part/task; "off" logs scalars only
    plot_figures: str = "reference"

    def __post_init__(self) -> None:
        object.__setattr__(self, "adapter", AdapterKind(self.adapter))
        object.__setattr__(self, "optim", Optim(self.optim))
        object.__setattr__(self, "prompt_mode", PromptMode(self.prompt_mode))
        if self.continual_learning is not None:
            object.__setattr__(
                self, "continual_learning", ContinualLearning(self.continual_learning)
            )
        if self.shared:
            object.__setattr__(self, "image_adapter", True)
            object.__setattr__(self, "text_adapter", True)
        if self.adapter == AdapterKind.NO_HEAD and (self.image_adapter or self.text_adapter):
            object.__setattr__(self, "image_adapter", False)
            object.__setattr__(self, "text_adapter", False)
        if self.mode == "zero" and self.epochs > 0:
            raise ValueError("mode='zero' requires epochs=0")
        if self.epochs == 0 and self.mode in ("joint", "zero"):
            object.__setattr__(self, "mode", "zero")
            if not (self.shared or not (self.image_adapter or self.text_adapter)):
                raise ValueError(
                    "zero-shot (epochs=0) requires adapter='no-head' or shared=True"
                )
        if self.xrays_position not in ("all", "frontal"):
            raise ValueError(f"unsupported xrays_position {self.xrays_position!r}")
        if self.loss_name != "standard":
            raise ValueError("only loss_name='standard' (BCEWithLogits) is supported")
        if self.mode not in ("joint", "zero", "data-inc", "class-pos", "class-pos-neg"):
            raise ValueError(f"unsupported mode {self.mode!r}")

    # ------------------------------------------------------------------
    # Derived properties
    # ------------------------------------------------------------------
    @property
    def single_prompt(self) -> bool:
        return self.prompt_mode == PromptMode.SINGLE

    @property
    def max_emb(self) -> bool:
        return self.prompt_mode == PromptMode.MAX

    @property
    def class_names(self) -> Tuple[str, ...]:
        if not self.chex_competition:
            raise ValueError("only the CheXpert competition task set is supported")
        return CHEXPERT_COMPETITION_TASKS

    @property
    def trains_anything(self) -> bool:
        return self.image_adapter or self.text_adapter

    # ------------------------------------------------------------------
    # Reference-format run name (Trainer.py:256-523)
    # ------------------------------------------------------------------
    def _chex_str(self) -> str:
        return "-chex" if self.chex_competition else ""

    def _str_basic(self) -> str:
        if self.single_prompt:
            return "-single-prompt"
        return "-MAX-prompt" if self.max_emb else "-mean-prompt"

    def _suffix(self, incremental: bool) -> str:
        suffix = "-" + self.adapter.value
        if self.shared:
            suffix += "-SHARED-adapter"
        elif self.image_adapter and self.text_adapter:
            suffix += "-double-adapter"
        elif self.image_adapter:
            suffix += "-only-image-adapter"
        elif self.text_adapter:
            # sic: the reference misspells this on the incremental paths only
            suffix += "-only-text-adapeter" if incremental else "-only-text-adapter"
        return suffix

    def _flag_tail(self) -> str:
        tail = ""
        if self.new_prompts:
            tail += "-NEW-PROMPTS"
        tail += "-TRAIN-logit-DIFF" if self.train_logit_diff else "-TRAIN-logit-POS"
        tail += "-PRED-logit-DIFF" if self.pred_logit_diff else "-PRED-logit-POS"
        return tail

    def run_name(self) -> str:
        """Reference-format run-directory path for this configuration."""
        chex_str, str_basic = self._chex_str(), self._str_basic()
        if self.mode in ("joint", "zero"):
            folder = self.folder_name or "zero-and-joint"
            if self.epochs > 0:
                base = (
                    f"{folder}/joint-train-loss-{self.loss_name}-opt-{self.optim.value}"
                    f"-lr-{self.lr}-bs{self.batch_size}-ep{self.epochs}"
                    f"{chex_str}{str_basic}-{self.xrays_position}{self._suffix(False)}"
                )
            else:
                if self.shared and self.image_adapter and self.text_adapter:
                    suffix = "-SHARED-adapter-" + self.adapter.value
                else:
                    suffix = "-no-head"
                base = (
                    f"{folder}/zero-shot-model{chex_str}{str_basic}"
                    f"-{self.xrays_position}{suffix}"
                )
            return base + self._flag_tail()

        cl = self.continual_learning
        thre_str = ""
        if self.threshold_scheduling and cl is not None:
            thre_str = f"-th-scheduled-{self.adder}"
        cl_str = ""
        if cl is not None and self.ratio:
            cl_str = f"-{cl.value}-ratio-{self.threshold}"
        mode_str = ("gradient-clipping-" if cl is not None and self.ratio else "fine-tuning-") + self.mode

        if self.mode == "data-inc":
            folder = self.folder_name or f"data-incremental-{self.parts}-parts"
            base = (
                f"{folder}/{mode_str}-loss-{self.loss_name}-opt-{self.optim.value}"
                f"-lr-{self.lr}-bs{self.batch_size}-ep{self.epochs}-parts{self.parts}"
                f"{chex_str}{str_basic}-{self.xrays_position}{self._suffix(True)}"
                f"{cl_str}{thre_str}"
            )
            return base + self._flag_tail() + "-DD"

        folder = self.folder_name or (self.mode + ("-more-labels" if self.more_labels else ""))
        base = (
            f"{folder}/{mode_str}-loss-{self.loss_name}-opt-{self.optim.value}"
            f"-lr-{self.lr}-bs{self.batch_size}-ep{self.epochs}"
            f"{chex_str}{str_basic}-{self.xrays_position}{self._suffix(True)}"
            f"{cl_str}{thre_str}"
        )
        if self.more_labels:
            base += "-MORE-LABELS"
        return base + self._flag_tail() + "-DD"


def joint_config(**kw) -> ExperimentConfig:
    """Defaults of ``ZERO_JOINT_BOUNDS.py:16-31`` (joint upper bound)."""
    kw.setdefault("mode", "joint")
    kw.setdefault("lr", 1e-4)
    kw.setdefault("epochs", 10)
    return ExperimentConfig(**kw)


def zero_shot_config(**kw) -> ExperimentConfig:
    """Zero-shot bound: epochs=0, frozen encoders, no head."""
    kw.setdefault("mode", "zero")
    kw.setdefault("epochs", 0)
    kw.setdefault("shared", False)
    kw.setdefault("adapter", AdapterKind.NO_HEAD)
    kw.setdefault("image_adapter", False)
    kw.setdefault("text_adapter", False)
    return ExperimentConfig(**kw)


def data_incremental_config(**kw) -> ExperimentConfig:
    """Defaults of ``DATA_INCREMENTAL.py:44-68``."""
    kw.setdefault("mode", "data-inc")
    kw.setdefault("parts", 20)
    kw.setdefault("xrays_position", "frontal")
    kw.setdefault("threshold_scheduling", True)
    return ExperimentConfig(**kw)


def class_incremental_config(**kw) -> ExperimentConfig:
    """Defaults of ``CLASS_INCREMENTAL.py:32-57``."""
    kw.setdefault("mode", "class-pos-neg")
    kw.setdefault("more_labels", True)
    return ExperimentConfig(**kw)
