"""The prompt-cosine classifier (counterpart of the JAX package's
``objectives/scorer.py``).

Image embeddings are scored against per-class positive/negative
prompt-embedding banks by cosine similarity, as the reference does
(``Trainer.py:557-577`` train logits, ``:824-837`` eval scores):

* the text adapter is applied to each raw prompt embedding;
* MEAN/SINGLE average prompt embeddings per polarity after the adapter,
  then take the cosine against the mean vector;
* MAX takes the cosine against every prompt and reduces with max;
* train logit = pos - neg (``train_logit_diff``) or pos;
* eval score  = (pos-neg+2)/4 (``pred_logit_diff``) or (pos+1)/2;
* prediction  = 1 iff pos > neg, strictly (ties go to the negative).

``use_kernel`` sends the cosine contraction through the fused CUDA kernel
(``ops/fused_cosine.py``), the counterpart of the JAX ``use_pallas``; it
has no backward, so only no-grad paths take it.  ``mesh`` sends it through
the mesh variant (``pairwise_cosine_sharded``): the image embeddings are
this rank's rows of a batch, and every output covers the whole batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from incremental_multimodal_medical_learning_ii_torch.ops.cosine import (
    cosine_to_banks,
    masked_mean,
    pairwise_cosine,
)
from incremental_multimodal_medical_learning_ii_torch.utils.config import PromptMode


class PromptBank(NamedTuple):
    """Padded per-class prompt embeddings (raw, pre-text-adapter).

    pos / neg : (C, P_max, D) float32, zero-padded on the prompt axis
    pos_count / neg_count : (C,) int32 valid-prompt counts
    """

    pos: torch.Tensor
    neg: torch.Tensor
    pos_count: torch.Tensor
    neg_count: torch.Tensor

    @property
    def num_classes(self) -> int:
        return self.pos.shape[0]

    def to(self, device) -> "PromptBank":
        return PromptBank(*(t.to(device) for t in self))


class ScorerOutput(NamedTuple):
    logits: torch.Tensor  # (B, C) train logits
    scores: torch.Tensor  # (B, C) AUROC scores in [0, 1]
    preds: torch.Tensor  # (B, C) {0., 1.} predictions
    pos_sim: torch.Tensor  # (B, C) reduced positive similarity
    neg_sim: torch.Tensor  # (B, C) reduced negative similarity
    max_mean_gap: Optional[torch.Tensor]  # (2, B, C) per-row max-mean gaps (MAX mode)


def _valid_mask(p: int, count: torch.Tensor) -> torch.Tensor:
    return torch.arange(p, device=count.device)[None, :] < count[:, None]  # (C, P)


def apply_text_adapter_to_bank(adapter_fn, params, bank: PromptBank) -> PromptBank:
    """Apply the text adapter to every prompt embedding; padding rows are
    re-zeroed afterwards (the adapter has biases) to keep masked means exact."""
    if adapter_fn is None:
        return bank
    c, p, d = bank.pos.shape

    def _apply(emb, count):
        out = adapter_fn(params, emb.reshape(c * p, d)).reshape(c, p, -1)
        return out * _valid_mask(p, count).to(out.dtype)[..., None]

    return PromptBank(
        pos=_apply(bank.pos, bank.pos_count),
        neg=_apply(bank.neg, bank.neg_count),
        pos_count=bank.pos_count,
        neg_count=bank.neg_count,
    )


def _pairwise(x: torch.Tensor, t: torch.Tensor, use_kernel: bool, mesh=None,
              rows: Optional[int] = None) -> torch.Tensor:
    if mesh is not None:
        from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
            pairwise_cosine_sharded,
        )

        return pairwise_cosine_sharded(mesh, x, t, rows)
    if use_kernel:
        from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
            fused_pairwise_cosine,
        )

        return fused_pairwise_cosine(x, t)
    return pairwise_cosine(x, t)


def _reduced_similarities(
    image_embs: torch.Tensor,
    bank: PromptBank,
    prompt_mode: PromptMode,
    use_kernel: bool = False,
    mesh=None,
    rows: Optional[int] = None,
):
    """Return ((B,C) pos, (B,C) neg, optional (2,B,C) max-mean gaps)."""
    use_kernel = use_kernel or mesh is not None
    if PromptMode(prompt_mode) == PromptMode.MAX:
        c, p, d = bank.pos.shape

        def _max_and_mean(emb, count):
            valid = _valid_mask(p, count)
            # padding rows get a constant unit vector (zero rows have a NaN
            # norm gradient); their similarities are masked out below.  Made
            # by a comparison: an indexed store of a Python scalar can copy
            # it host-to-device inside the train and eval loops
            unit = (torch.arange(d, device=emb.device) == 0).to(emb.dtype)
            emb = torch.where(valid[..., None], emb, unit)
            if use_kernel:
                sims = _pairwise(image_embs, emb.reshape(c * p, d), True, mesh, rows)
                sims = sims.reshape(sims.shape[0], c, p)
            else:
                sims = cosine_to_banks(image_embs, emb)  # (B, C, P)
            neg_inf = torch.finfo(sims.dtype).min
            sim_max = torch.amax(torch.where(valid[None], sims, neg_inf), dim=-1)
            sim_mean = torch.sum(torch.where(valid[None], sims, 0.0), dim=-1) / torch.clamp(
                count, min=1
            ).to(sims.dtype)[None, :]
            return sim_max, sim_mean

        pos_max, pos_mean = _max_and_mean(bank.pos, bank.pos_count)
        neg_max, neg_mean = _max_and_mean(bank.neg, bank.neg_count)
        gaps = torch.stack([pos_max - pos_mean, neg_max - neg_mean])
        return pos_max, neg_max, gaps

    pos_mean = masked_mean(bank.pos, bank.pos_count)  # (C, D)
    neg_mean = masked_mean(bank.neg, bank.neg_count)
    if use_kernel:
        c = pos_mean.shape[0]
        both = _pairwise(image_embs, torch.cat([pos_mean, neg_mean]), True, mesh, rows)
        return both[:, :c], both[:, c:], None
    return pairwise_cosine(image_embs, pos_mean), pairwise_cosine(image_embs, neg_mean), None


def score_embeddings(
    image_embs: torch.Tensor,
    bank: PromptBank,
    prompt_mode: PromptMode,
    train_logit_diff: bool,
    pred_logit_diff: bool,
    use_kernel: bool = False,
    mesh=None,
    rows: Optional[int] = None,
) -> ScorerOutput:
    """Full scorer: train logits, eval scores, predictions for all classes.
    With ``mesh``, ``image_embs`` are this rank's rows of a ``rows``-row
    batch and the outputs are the whole batch's (no-grad only)."""
    pos_sim, neg_sim, gaps = _reduced_similarities(
        image_embs, bank, prompt_mode, use_kernel=use_kernel, mesh=mesh, rows=rows
    )
    logits = pos_sim - neg_sim if train_logit_diff else pos_sim
    scores = (pos_sim - neg_sim + 2.0) / 4.0 if pred_logit_diff else (pos_sim + 1.0) / 2.0
    preds = (pos_sim > neg_sim).to(torch.float32)
    return ScorerOutput(
        logits=logits,
        scores=scores,
        preds=preds,
        pos_sim=pos_sim,
        neg_sim=neg_sim,
        max_mean_gap=gaps,
    )
