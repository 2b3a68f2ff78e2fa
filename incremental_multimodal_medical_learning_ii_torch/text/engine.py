"""Text inference engine: CXR-BERT behind the prompt tokenizer
(counterpart of the JAX package's ``text/engine.py``, one device).

Capability parity with the reference's ``TextInferenceEngine``
(``health_multimodal/text/inference_engine.py``):

* :meth:`get_embeddings_from_prompt` — projected [CLS] embeddings of a
  list of prompts (optionally L2-normalised);
* :meth:`get_pairwise_similarities` — diagonal cosine similarities between
  two prompt sets (``:72-82``);
* :meth:`predict_masked_tokens` — top-1 MLM fill of ``[MASK]`` positions
  (``:84-119``).

Prompts are padded to the batch's longest sequence and encoded in one
dense-attention forward (prompt lengths are tens of tokens; the flash
kernel is for report lengths).  Runs on CUDA unless ``device="cpu"``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import (
    CXRBert,
    bert_encode,
    get_projected_text_embeddings,
    mlm_logits,
)
from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import (
    PromptTokenizer,
    TypePrompts,
)
from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device


class TextInferenceEngine:
    def __init__(self, model: CXRBert, tokenizer: PromptTokenizer,
                 dtype: Optional[torch.dtype] = None, mesh=None, device=None):
        """``dtype=torch.bfloat16`` opts the layer stack into bf16 (the
        parity default is fp32).  ``model`` is moved to the device."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (the tensor-, sequence- and pipeline-parallel text encode) is not yet "
                "ported: ROADMAP slice 7b")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.dims = model.dims
        self.dtype = dtype or torch.float32
        self.tokenizer = tokenizer
        # enforce the model's position cap, but never RAISE a tighter budget
        # the caller set on the tokenizer (the reference keeps this cap on
        # the engine, inference_engine.py:43-46)
        tokenizer.max_allowed_input_length = min(
            tokenizer.max_allowed_input_length, self.dims.max_position_embeddings
        )

    def _tokens(self, prompts: TypePrompts):
        ids, mask = self.tokenizer.tokenize_prompts(prompts)
        return ids, torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device)

    @torch.no_grad()
    def get_embeddings_from_prompt(self, prompts: TypePrompts, normalize: bool = True) -> np.ndarray:
        _, ids, mask = self._tokens(prompts)
        out = get_projected_text_embeddings(self.model, ids, mask, normalize=normalize,
                                            dtype=self.dtype)
        return out.cpu().numpy()

    def encode_fn(self, normalize: bool = False):
        """An ``EncodeFn`` for :func:`text.bank.build_prompt_bank`."""

        def encode(texts: List[str]) -> np.ndarray:
            return self.get_embeddings_from_prompt(texts, normalize=normalize)

        return encode

    def get_pairwise_similarities(self, prompt_set_1: TypePrompts,
                                  prompt_set_2: TypePrompts) -> np.ndarray:
        e1 = self.get_embeddings_from_prompt(prompt_set_1, normalize=True)
        e2 = self.get_embeddings_from_prompt(prompt_set_2, normalize=True)
        # torch.diag(e1 @ e2.T) semantics: min(N1, N2) diagonal entries
        n = min(len(e1), len(e2))
        return np.sum(e1[:n] * e2[:n], axis=-1)

    @torch.no_grad()
    def predict_masked_tokens(self, prompts: TypePrompts) -> List[List[str]]:
        ids_np, ids, mask = self._tokens(prompts)
        hidden = bert_encode(self.model, ids, mask, dtype=self.dtype)
        predicted = mlm_logits(self.model, hidden).argmax(dim=-1).cpu().numpy()
        out: List[List[str]] = []
        for b in range(ids_np.shape[0]):
            at_mask = ids_np[b] == self.tokenizer.mask_token_id
            out.append(self.tokenizer.convert_ids_to_tokens(predicted[b, at_mask]))
        return out
