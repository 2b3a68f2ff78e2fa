"""Build the :class:`PromptBank` from a prompt dictionary (counterpart of
the JAX package's ``text/bank.py``).

Every distinct prompt is encoded once and the bank is kept padded to a
static ``(C, P_max, 128)`` layout; the text adapter is applied to the
cached raw embeddings at scoring time.  When ``train_logit_diff`` is
False the negative side mirrors the positive prompts, as the reference
does (``Trainer.py:563-564``).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from incremental_multimodal_medical_learning_ii_torch.objectives.scorer import PromptBank
from incremental_multimodal_medical_learning_ii_torch.text.prompts import Prompts

EncodeFn = Callable[[List[str]], np.ndarray]  # texts -> (len(texts), D) raw embeddings


def build_prompt_bank(
    encode_fn: EncodeFn,
    prompts: Prompts,
    class_names: Sequence[str],
    train_logit_diff: bool = True,
    emb_dim: int = 128,
) -> PromptBank:
    pos_lists: List[List[str]] = []
    neg_lists: List[List[str]] = []
    for c in class_names:
        pos_lists.append(list(prompts[c]["positive"]))
        if train_logit_diff:
            if "negative" not in prompts[c]:
                raise ValueError(
                    f"prompt bank for {c!r} has no negatives but "
                    "train_logit_diff=True needs them — build the prompts "
                    "with include_negatives=True (create_prompts wires this "
                    "from the same flag)"
                )
            neg_lists.append(list(prompts[c]["negative"]))
        else:
            neg_lists.append(list(prompts[c]["positive"]))

    # one encoder call over the UNIQUE prompts
    flat: List[str] = [t for lst in pos_lists + neg_lists for t in lst]
    uniq: List[str] = list(dict.fromkeys(flat))
    uniq_embs = np.asarray(encode_fn(uniq), dtype=np.float32)
    if uniq_embs.shape != (len(uniq), emb_dim):
        raise ValueError(
            f"encode_fn returned {uniq_embs.shape}, expected {(len(uniq), emb_dim)}"
        )
    index = {t: i for i, t in enumerate(uniq)}
    embs = uniq_embs[[index[t] for t in flat]]

    c = len(class_names)
    p_max = max(len(lst) for lst in pos_lists + neg_lists)
    pos = np.zeros((c, p_max, emb_dim), np.float32)
    neg = np.zeros((c, p_max, emb_dim), np.float32)
    pos_count = np.zeros(c, np.int32)
    neg_count = np.zeros(c, np.int32)

    offset = 0
    for i, lst in enumerate(pos_lists):
        pos[i, : len(lst)] = embs[offset : offset + len(lst)]
        pos_count[i] = len(lst)
        offset += len(lst)
    for i, lst in enumerate(neg_lists):
        neg[i, : len(lst)] = embs[offset : offset + len(lst)]
        neg_count[i] = len(lst)
        offset += len(lst)

    return PromptBank(
        pos=torch.from_numpy(pos),
        neg=torch.from_numpy(neg),
        pos_count=torch.from_numpy(pos_count),
        neg_count=torch.from_numpy(neg_count),
    )


def save_prompt_bank(path, bank: PromptBank) -> None:
    """Persist a bank (~64 KB) in the JAX package's ``.npz`` format."""
    np.savez(path, **{k: getattr(bank, k).detach().cpu().numpy() for k in PromptBank._fields})


def load_prompt_bank(path) -> PromptBank:
    with np.load(path) as z:
        return PromptBank(*(torch.from_numpy(np.array(z[k])) for k in PromptBank._fields))


def synthetic_encode_fn(seed: int = 0, emb_dim: int = 128) -> EncodeFn:
    """Deterministic text-hash encoder for tests and demos (no BERT weights
    needed): each distinct prompt string maps to a fixed pseudo-random
    embedding, bit-identical to the JAX package's (same sha256 ->
    ``default_rng`` recipe)."""

    def encode(texts: List[str]) -> np.ndarray:
        import hashlib

        out = np.empty((len(texts), emb_dim), np.float32)
        for i, t in enumerate(texts):
            # hashlib, NOT hash(): Python string hashing is salted per process
            digest = hashlib.sha256(f"{seed}|{t}".encode()).digest()
            h = int.from_bytes(digest[:8], "little") % (2**32)
            out[i] = np.random.default_rng(h).normal(size=emb_dim)
        return out

    return encode
