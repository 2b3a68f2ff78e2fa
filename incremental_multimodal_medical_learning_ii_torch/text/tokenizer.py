"""Prompt tokenisation with the reference's input conventions (counterpart
of the JAX package's ``text/tokenizer.py``), without ``transformers``.

The WordPiece tokeniser is written here: it gives the ids that
``transformers.BertTokenizer`` gives over the same local vocab file,

* special tokens are kept whole wherever they occur (with
  ``do_lower_case`` the text around them is lower-cased one character at
  a time first, as ``PreTrainedTokenizer.tokenize`` does);
* basic tokenisation: drop control characters and U+0000/U+FFFD, map
  whitespace to spaces, put spaces around CJK ideographs, NFC, split on
  whitespace, lower-case and strip accents (NFD, drop ``Mn``) per
  ``do_lower_case`` / ``strip_accents``, split off every punctuation
  character (Unicode ``P*`` and ASCII 33-47, 58-64, 91-96, 123-126), and
  keep ``never_split`` and special tokens whole;
* WordPiece: greedy longest match with ``##`` continuations; a word that
  cannot be covered, or of more than 100 characters, is ``[UNK]``.

Then the reference's conventions (``health_multimodal/text/data/io.py``
and ``text/inference_engine.py:37-48``): a lone string becomes a list;
prompts must not hold special tokens other than ``[MASK]``; trailing
``!?.`` is stripped; ``[CLS] ... [SEP]`` is added and the batch padded to
its longest prompt; an over-long batch raises.
"""

from __future__ import annotations

import re
import unicodedata
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

TypePrompts = Union[str, List[str]]

MAX_CHARS_PER_WORD = 100


def load_vocab(vocab_file: str | Path) -> Dict[str, int]:
    """One token a line; a repeated token keeps its last line's index."""
    vocab: Dict[str, int] = {}
    with open(vocab_file, "r", encoding="utf-8") as reader:
        for index, token in enumerate(reader.readlines()):
            vocab[token.rstrip("\n")] = index
    return vocab


def _is_whitespace(char: str) -> bool:
    return char in " \t\n\r" or unicodedata.category(char) == "Zs"


def _is_control(char: str) -> bool:
    return char not in "\t\n\r" and unicodedata.category(char).startswith("C")


def _is_punctuation(char: str) -> bool:
    cp = ord(char)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(char).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _strip_accents(text: str) -> str:
    return "".join(c for c in unicodedata.normalize("NFD", text) if unicodedata.category(c) != "Mn")


def _split_on_punctuation(text: str) -> List[str]:
    out: List[str] = []
    start_new_word = True
    for char in text:
        if _is_punctuation(char):
            out.append(char)
            start_new_word = True
        else:
            if start_new_word:
                out.append("")
            start_new_word = False
            out[-1] += char
    return out


class PromptTokenizer:
    def __init__(
        self,
        vocab_file: str | Path,
        max_allowed_input_length: int = 512,
        do_lower_case: bool = True,
        do_basic_tokenize: bool = True,
        never_split: Optional[Iterable[str]] = None,
        unk_token: str = "[UNK]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        cls_token: str = "[CLS]",
        mask_token: str = "[MASK]",
        tokenize_chinese_chars: bool = True,
        strip_accents: Optional[bool] = None,
    ):
        """The keyword arguments are ``BertTokenizer``'s, as a snapshot's
        ``tokenizer_config.json`` gives them."""
        self.vocab = load_vocab(vocab_file)
        self.do_lower_case = do_lower_case
        self.do_basic_tokenize = do_basic_tokenize
        self.never_split = set(never_split or ())
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.strip_accents = strip_accents
        self.unk_token, self.mask_token = unk_token, mask_token
        self.cls_token, self.sep_token, self.pad_token = cls_token, sep_token, pad_token
        # transformers' order; a special token missing from the vocab gets the next id
        self.special_tokens = list(dict.fromkeys([unk_token, sep_token, pad_token, cls_token,
                                                  mask_token]))
        for tok in self.special_tokens:
            self.vocab.setdefault(tok, len(self.vocab))
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        by_length = sorted(self.special_tokens, key=len, reverse=True)
        self._special_split = re.compile("(" + "|".join(map(re.escape, by_length)) + ")")
        self._lower_outside_specials = re.compile(
            "(" + "|".join(map(re.escape, self.special_tokens)) + ")|(.+?)")
        self.max_allowed_input_length = max_allowed_input_length

    @property
    def mask_token_id(self) -> int:
        return self.vocab[self.mask_token]

    def token_id(self, token: str) -> int:
        return self.vocab.get(token, self.vocab[self.unk_token])

    # ------------------------------------------------------------------
    # BERT basic tokenisation + WordPiece
    # ------------------------------------------------------------------
    def _basic_tokenize(self, text: str) -> List[str]:
        never_split = self.never_split | set(self.special_tokens)
        text = "".join(" " if _is_whitespace(c) else c for c in text
                       if not (ord(c) in (0, 0xFFFD) or _is_control(c)))
        if self.tokenize_chinese_chars:
            text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)
        out: List[str] = []
        for token in unicodedata.normalize("NFC", text).split():
            if token not in never_split:
                if self.do_lower_case:
                    token = token.lower()
                    if self.strip_accents is not False:
                        token = _strip_accents(token)
                elif self.strip_accents:
                    token = _strip_accents(token)
            out.extend([token] if token in never_split else _split_on_punctuation(token))
        return " ".join(out).split()

    def _wordpiece(self, text: str) -> List[str]:
        out: List[str] = []
        for word in text.split():
            if len(word) > MAX_CHARS_PER_WORD:
                out.append(self.unk_token)
                continue
            pieces, start = [], 0
            while start < len(word):
                end = len(word)
                while end > start:
                    piece = word[start:end] if start == 0 else "##" + word[start:end]
                    if piece in self.vocab:
                        break
                    end -= 1
                if end == start:  # nothing in the vocab covers word[start]
                    pieces = [self.unk_token]
                    break
                pieces.append(piece)
                start = end
            out.extend(pieces)
        return out

    def tokenize(self, text: str) -> List[str]:
        if self.do_basic_tokenize and self.do_lower_case:
            text = self._lower_outside_specials.sub(
                lambda m: m.group(1) or m.group(2).lower(), text)
        tokens: List[str] = []
        for piece in self._special_split.split(text):
            if not piece:
                continue
            if piece in self.special_tokens:
                tokens.append(piece)
            elif not self.do_basic_tokenize:
                tokens.extend(self._wordpiece(piece))
            else:
                for word in self._basic_tokenize(piece):
                    tokens.extend([word] if word in self.never_split else self._wordpiece(word))
        return tokens

    # ------------------------------------------------------------------
    # the reference's conventions
    # ------------------------------------------------------------------
    def assert_special_tokens_not_present(self, prompt: str) -> None:
        special = list(self.special_tokens)
        special.remove(self.mask_token)  # [MASK] is allowed
        if any(tok in prompt for tok in special):
            raise ValueError(
                f'The input "{prompt}" contains at least one special token ({special})'
            )

    def tokenize_prompts(self, prompts: TypePrompts) -> Tuple[np.ndarray, np.ndarray]:
        """-> (input_ids, attention_mask) int32 arrays, padded to the longest
        prompt in the batch."""
        prompts = [prompts] if isinstance(prompts, str) else list(prompts)
        self.assert_special_tokens_not_present(" ".join(prompts))
        seqs = [[self.token_id(self.cls_token)]
                + [self.token_id(t) for t in self.tokenize(p.rstrip("!?."))]
                + [self.token_id(self.sep_token)] for p in prompts]
        length = max(len(s) for s in seqs)
        ids = np.full((len(seqs), length), self.token_id(self.pad_token), np.int32)
        mask = np.zeros((len(seqs), length), np.int32)
        for i, s in enumerate(seqs):
            ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        if length > self.max_allowed_input_length:
            raise ValueError(
                f"The sequence length of the input ({length}) is longer than "
                f"the maximum allowed sequence length ({self.max_allowed_input_length})."
            )
        return ids, mask

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]


def write_test_vocab(path: str | Path, extra_words: Sequence[str] = ()) -> Path:
    """Synthetic WordPiece vocab covering the CheXpert prompt banks (the JAX
    package's recipe, over this package's own copy of the prompts); for
    tests and demos where the CXR-BERT vocab is unavailable."""
    from incremental_multimodal_medical_learning_ii_torch.text import prompts as prompt_mod
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
    )

    words = set()
    bank = prompt_mod.template_prompts(CHEXPERT_COMPETITION_TASKS)
    comp = prompt_mod.compositional_prompts(seed=0)
    single = prompt_mod.basic_prompts(CHEXPERT_COMPETITION_TASKS)
    for b in (bank, comp, single):
        for entry in b.values():
            for plist in entry.values():
                for p in plist:
                    words.update(p.lower().replace(",", " ").replace(".", " ").split())
    words.update(w.lower() for w in extra_words)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(words)
    path = Path(path)
    path.write_text("\n".join(vocab) + "\n")
    return path
