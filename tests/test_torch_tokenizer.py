"""Port text/tokenizer.py (BERT basic tokenisation + WordPiece written
without transformers) against the JAX package's PromptTokenizer, which
wraps transformers.BertTokenizer: ids and masks exactly, on the prompt
banks and on edge strings, with the same errors."""

import numpy as np
import pytest

from incremental_multimodal_medical_learning_ii_tpu.text import prompts as jprompts
from incremental_multimodal_medical_learning_ii_tpu.text.tokenizer import (
    PromptTokenizer as JaxTokenizer,
)
from incremental_multimodal_medical_learning_ii_tpu.text.tokenizer import (
    write_test_vocab as jax_write_test_vocab,
)
from incremental_multimodal_medical_learning_ii_tpu.utils.config import (
    CHEXPERT_COMPETITION_TASKS,
)
from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import (
    PromptTokenizer,
    write_test_vocab,
)

# WordPiece pieces, accented and CJK entries, punctuation: what the edge
# strings below need, beside the prompt words
HANDMADE = """[PAD] [UNK] [CLS] [SEP] [MASK] there is no evidence of mild pleural effusion
cardio ##megaly ##meg ##aly cardiomegaly edema ##s un ##want ##ed run ##ning
, . ! ? - ( ) [ ] / : ; ' " % + = @ # $ & * < > ^ _ ` { } | ~ 1 2 3 ##4 5 12 ##3
cafe café resume résumé naive 中 国 x ray x-ray mask left right lung size small
""".split()

EDGE = [
    "Cardiomegaly",
    "CARDIOMEGALY is SEVERE",
    "unwanted running edemas",
    "café résumé naïve CAFÉ",
    "There is no evidence of [MASK] pleural effusion",
    "[MASK]",
    "x[MASK]y and [MASK][MASK]",
    "a [mask] in lower case",
    "left\tlung\nright  lung\r\nsize",
    "punctuation!!! runs?!... (mild)-edema; x-ray: 12% @ 5 ~ {3} <1> [2] `a` ^_^",
    "digits 1234 123 12 5",
    "中国 cardiomegaly 中",
    "a" * 101 + " ok",
    "cardio" * 17,  # 102 characters
    "zebra unwantedly",
    " non breaking​spaces",
    "control\x07chars\x00and�replacement",
    "",
    "...",
    "Trailing punctuation?!",
]


@pytest.fixture(scope="module")
def handmade_vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(dict.fromkeys(HANDMADE)) + "\n", encoding="utf-8")
    return path


def _same(ours, ref, prompts):
    ids, mask = ours.tokenize_prompts(prompts)
    jids, jmask = ref.tokenize_prompts(prompts)
    assert ids.dtype == mask.dtype == np.int32
    np.testing.assert_array_equal(ids, jids, err_msg=str(prompts))
    np.testing.assert_array_equal(mask, jmask, err_msg=str(prompts))
    return ids


def test_write_test_vocab_is_the_jax_vocab(tmp_path):
    ours = write_test_vocab(tmp_path / "a.txt", extra_words=["Mask", "extra"])
    ref = jax_write_test_vocab(tmp_path / "b.txt", extra_words=["Mask", "extra"])
    assert ours.read_text() == ref.read_text()


@pytest.mark.parametrize("seed", [0, 1, 27])
def test_prompt_banks_tokenize_exactly(tmp_path, seed):
    vocab = write_test_vocab(tmp_path / "vocab.txt")
    ours, ref = PromptTokenizer(vocab), JaxTokenizer(vocab)
    banks = (jprompts.basic_prompts(CHEXPERT_COMPETITION_TASKS),
             jprompts.template_prompts(CHEXPERT_COMPETITION_TASKS),
             jprompts.compositional_prompts(seed=seed))
    prompts = [p for bank in banks for entry in bank.values() for plist in entry.values()
               for p in plist]
    assert len(prompts) > 50
    _same(ours, ref, prompts)
    _same(ours, ref, prompts[0])  # a lone string


def test_edge_strings_tokenize_exactly(handmade_vocab):
    ours, ref = PromptTokenizer(handmade_vocab), JaxTokenizer(handmade_vocab)
    for text in EDGE:
        _same(ours, ref, [text])
        assert ours.tokenize(text) == ref.tokenizer.tokenize(text), text
    _same(ours, ref, EDGE)  # one padded batch
    assert ours.mask_token_id == ref.mask_token_id
    ids = list(range(-1, len(HANDMADE) + 3))
    assert ours.convert_ids_to_tokens(ids) == ref.convert_ids_to_tokens(ids)
    assert ours.tokenize("Unwanted cardiomeg") == ["un", "##want", "##ed", "cardio", "##meg"]


@pytest.mark.parametrize("kwargs", [
    {"do_lower_case": False},
    {"strip_accents": False},
    {"do_lower_case": False, "strip_accents": True},
    {"tokenize_chinese_chars": False},
    {"never_split": ["x-ray", "CARDIOMEGALY"]},
    {"do_basic_tokenize": False},
])
def test_tokenizer_kwargs(handmade_vocab, kwargs):
    ours, ref = PromptTokenizer(handmade_vocab, **kwargs), JaxTokenizer(handmade_vocab, **kwargs)
    for text in EDGE:
        assert ours.tokenize(text) == ref.tokenizer.tokenize(text), (kwargs, text)
    _same(ours, ref, EDGE)


@pytest.mark.parametrize("prompt", ["a [CLS] b", "[SEP]", "pad [PAD]", "x [UNK] y"])
def test_special_token_guard(handmade_vocab, prompt):
    ours, ref = PromptTokenizer(handmade_vocab), JaxTokenizer(handmade_vocab)
    with pytest.raises(ValueError) as jerr:
        ref.tokenize_prompts(["fine", prompt])
    with pytest.raises(ValueError) as err:
        ours.tokenize_prompts(["fine", prompt])
    assert str(err.value) == str(jerr.value)


def test_over_long_input_raises(handmade_vocab):
    ours = PromptTokenizer(handmade_vocab, max_allowed_input_length=6)
    ref = JaxTokenizer(handmade_vocab, max_allowed_input_length=6)
    _same(ours, ref, ["mild pleural effusion"])  # 3 words + [CLS] [SEP]: fits
    long = ["there is no evidence of mild pleural effusion"]
    with pytest.raises(ValueError) as jerr:
        ref.tokenize_prompts(long)
    with pytest.raises(ValueError) as err:
        ours.tokenize_prompts(long)
    assert str(err.value) == str(jerr.value) and "longer than" in str(err.value)
