"""CheXpert prompt banks (a copy of the JAX package's ``text/prompts.py``;
this package never imports the JAX package).

Behavioral parity with the reference's three banks:

* single prompt per polarity            — ``DataRetrieval.py:183-197``
* 4-positive / 4-negative templates     — ``DataRetrieval.py:200-237``
* MedCLIP-style compositional prompts   — ``new_texts_prompts.py:3-191``
  (severity x subtype x location product per class, ``random.sample`` of
  ``n`` per class; the reference composes fields in each class's dict
  insertion order, which for "Pleural Effusion" is severity, location,
  subtype — preserved here via explicit field ordering).

Sampling here uses a self-contained ``random.Random(seed)`` instead of the
reference's process-global RNG, so banks are reproducible per seed.
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence

Prompts = Dict[str, Dict[str, List[str]]]

_NEG_TEMPLATES = (
    "There is no {c}",
    "No evidence of {c}",
    "No evidence of acute {c}",
    "No signs of {c}",
)

_POS_TEMPLATES = (
    "Findings consistent with {c}",
    "Findings suggesting {c}",
    "This opacity can represent {c}",
    "Findings are most compatible with {c}",
)

# Compositional field values, in the composition order the reference uses
# (dict insertion order of new_texts_prompts.py:3-95).
_COMPOSITIONAL_FIELDS: Dict[str, Sequence[Sequence[str]]] = {
    "Atelectasis": (
        ("", "mild", "minimal"),
        (
            "subsegmental atelectasis",
            "linear atelectasis",
            "trace atelectasis",
            "bibasilar atelectasis",
            "retrocardiac atelectasis",
            "bandlike atelectasis",
            "residual atelectasis",
        ),
        (
            "at the mid lung zone",
            "at the upper lung zone",
            "at the right lung zone",
            "at the left lung zone",
            "at the lung bases",
            "at the right lung base",
            "at the left lung base",
            "at the bilateral lung bases",
            "at the left lower lobe",
            "at the right lower lobe",
        ),
    ),
    "Cardiomegaly": (
        ("",),
        (
            "cardiac silhouette size is upper limits of normal",
            "cardiomegaly which is unchanged",
            "mildly prominent cardiac silhouette",
            "portable view of the chest demonstrates stable cardiomegaly",
            "portable view of the chest demonstrates mild cardiomegaly",
            "persistent severe cardiomegaly",
            "heart size is borderline enlarged",
            "cardiomegaly unchanged",
            "heart size is at the upper limits of normal",
            "redemonstration of cardiomegaly",
            "ap erect chest radiograph demonstrates the heart size is the upper limits of normal",
            "cardiac silhouette size is mildly enlarged",
            "mildly enlarged cardiac silhouette, likely left ventricular enlargement. "
            "other chambers are less prominent",
            "heart size remains at mildly enlarged",
            "persistent cardiomegaly with prominent upper lobe vessels",
        ),
        ("",),
    ),
    "Consolidation": (
        ("", "increased", "improved", "apperance of"),
        (
            "bilateral consolidation",
            "reticular consolidation",
            "retrocardiac consolidation",
            "patchy consolidation",
            "airspace consolidation",
            "partial consolidation",
        ),
        (
            "at the lower lung zone",
            "at the upper lung zone",
            "at the left lower lobe",
            "at the right lower lobe",
            "at the left upper lobe",
            "at the right uppper lobe",
            "at the right lung base",
            "at the left lung base",
        ),
    ),
    "Edema": (
        ("", "mild", "improvement in", "presistent", "moderate", "decreased"),
        (
            "pulmonary edema",
            "trace interstitial edema",
            "pulmonary interstitial edema",
        ),
        ("",),
    ),
    # NOTE field order is severity, location, subtype for this class
    # (matching the reference's dict insertion order).
    "Pleural Effusion": (
        ("", "small", "stable", "large", "decreased", "increased"),
        ("left", "right", "tiny"),
        (
            "bilateral pleural effusion",
            "subpulmonic pleural effusion",
            "bilateral pleural effusion",
        ),
    ),
}


def basic_prompts(class_names: Sequence[str]) -> Prompts:
    """One positive / one negative prompt per class (DataRetrieval.py:183-197)."""
    return {
        c: {
            "positive": [f"Findings suggesting {c}"],
            "negative": [f"No evidence of {c}"],
        }
        for c in class_names
    }


def template_prompts(class_names: Sequence[str]) -> Prompts:
    """4-positive / 4-negative template bank (DataRetrieval.py:200-233)."""
    return {
        c: {
            "positive": [t.format(c=c) for t in _POS_TEMPLATES],
            "negative": [t.format(c=c) for t in _NEG_TEMPLATES],
        }
        for c in class_names
    }


def compositional_candidates(class_name: str) -> List[str]:
    """All severity x subtype x location compositions for one class."""
    f0, f1, f2 = _COMPOSITIONAL_FIELDS[class_name]
    return [f"{a} {b} {c}" for a in f0 for b in f1 for c in f2]


def compositional_prompts(
    include_negatives: bool = True,
    n: int = 10,
    seed: int = 27,
) -> Prompts:
    """MedCLIP-style compositional bank (new_texts_prompts.py:98-191).

    Positives: ``n`` sampled compositions per class.  Negatives: the 4
    negation templates (the reference's ``OPZ == 1`` branch) when
    ``include_negatives`` (i.e. training on the pos-neg logit difference),
    otherwise omitted.
    """
    rng = random.Random(seed)
    out: Prompts = {}
    for cls in _COMPOSITIONAL_FIELDS:
        entry: Dict[str, List[str]] = {
            "positive": rng.sample(compositional_candidates(cls), n)
        }
        if include_negatives:
            entry["negative"] = [t.format(c=cls) for t in _NEG_TEMPLATES]
        out[cls] = entry
    return out


def create_prompts(
    class_names: Sequence[str],
    single_prompt: bool = False,
    new_prompts: bool = False,
    train_logit_diff: bool = True,
    seed: int = 27,
) -> Prompts:
    """Bank selection matching ``Trainer.preprocessing`` (Trainer.py:270-277)."""
    if single_prompt:
        return basic_prompts(class_names)
    if new_prompts:
        return compositional_prompts(include_negatives=train_logit_diff, seed=seed)
    return template_prompts(class_names)
