"""Text inference engine: CXR-BERT behind the prompt tokenizer
(counterpart of the JAX package's ``text/engine.py``).

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

``mesh=`` (``parallel/mesh.py``, a 2-D mesh) runs the projected embeddings
on every rank of the mesh with the ``partition`` it names: ``"tp"``
(heads and FFN units over ``model``, ``parallel/tp.py``; the weights are
sharded once, here), ``"sp"`` (the sequence over ``seq`` with ring
attention, ``parallel/sp.py``) or ``"pp"`` (the layer stack over ``pipe``
with ``n_microbatches``, ``parallel/pp.py``).  Inputs are padded to what
the partition needs (the batch to a multiple of ``data``, times
``n_microbatches`` for ``"pp"``; the sequence to a multiple of ``seq`` for
``"sp"``) and the dummy rows are stripped from the output.  Every rank
calls the engine's encode methods together.  MLM fill and raw
``bert_encode`` stay on the rank's device alone.
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


PARTITIONS = ("tp", "sp", "pp")


class TextInferenceEngine:
    def __init__(self, model: CXRBert, tokenizer: PromptTokenizer,
                 dtype: Optional[torch.dtype] = None, mesh=None, device=None,
                 partition: str = "tp", n_microbatches: int = 1):
        """``dtype=torch.bfloat16`` opts the layer stack into bf16 (the
        parity default is fp32).  ``model`` is moved to the device: the
        mesh's with ``mesh=``, which ``device`` must then name if given."""
        if mesh is not None:
            if partition not in PARTITIONS:
                raise ValueError(f"unknown partition {partition!r}")
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not this rank's {mesh.device}")
        self.device = resolve_device(device) if mesh is None else mesh.device
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
        self._mesh = mesh
        self._partition = partition
        self._n_microbatches = n_microbatches
        self._parallel_fns: dict = {}  # normalize -> encode
        self._parallel_model = self.model
        if mesh is not None and partition == "tp":
            from incremental_multimodal_medical_learning_ii_torch.parallel.tp import shard_bert_tp

            self._parallel_model = shard_bert_tp(self.model, mesh)

    def _parallel_embed_fn(self, normalize: bool):
        fn = self._parallel_fns.get(normalize)
        if fn is None:
            from incremental_multimodal_medical_learning_ii_torch.parallel import pp, sp, tp

            if self._partition == "tp":
                fn = tp.make_tp_text_encode(self.dims, self._mesh, normalize, self.dtype)
            elif self._partition == "sp":
                fn = sp.make_sp_text_encode(self.dims, self._mesh, normalize, self.dtype)
            else:
                fn = pp.make_pp_text_encode(self.dims, self._mesh, self._n_microbatches,
                                            normalize, self.dtype)
            self._parallel_fns[normalize] = fn
        return fn

    def _parallel_embed(self, ids: np.ndarray, mask: np.ndarray, normalize: bool) -> np.ndarray:
        from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import (
            DATA_AXIS,
            pad_to_multiple,
        )

        n = ids.shape[0]
        axes = self._mesh.shape
        if self._partition == "sp":
            from incremental_multimodal_medical_learning_ii_torch.parallel.sp import (
                SEQ_AXIS,
                pad_tokens_for_sp,
            )

            ids, mask = pad_tokens_for_sp(ids, mask, axes[SEQ_AXIS])
        # batch divisibility: the data axis, times the microbatches for pp
        b_mult = axes.get(DATA_AXIS, 1) * (self._n_microbatches if self._partition == "pp" else 1)
        n_pad = pad_to_multiple(n, b_mult)
        if n_pad != n:
            # dummy rows (mask all zero) ride the partitions' tested padding
            # semantics and are stripped below
            ids = np.concatenate([ids, np.zeros((n_pad - n, ids.shape[1]), ids.dtype)])
            mask = np.concatenate([mask, np.zeros((n_pad - n, mask.shape[1]), mask.dtype)])
        out = self._parallel_embed_fn(normalize)(
            self._parallel_model, torch.from_numpy(ids), torch.from_numpy(mask))
        return out[:n].cpu().numpy()

    def _tokens(self, prompts: TypePrompts):
        ids, mask = self.tokenizer.tokenize_prompts(prompts)
        return ids, torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device)

    @torch.no_grad()
    def get_embeddings_from_prompt(self, prompts: TypePrompts, normalize: bool = True) -> np.ndarray:
        if self._mesh is not None:
            return self._parallel_embed(*self.tokenizer.tokenize_prompts(prompts), normalize)
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
