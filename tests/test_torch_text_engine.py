"""Port text/engine.py against the JAX package's TextInferenceEngine over
the same CXR-BERT weights and vocab: embeddings, pairwise similarities,
masked-token fill and the prompt bank built through the engine."""

import jax
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.models import cxr_bert as jbert
from incremental_multimodal_medical_learning_ii_tpu.text.bank import (
    build_prompt_bank as jax_build_prompt_bank,
)
from incremental_multimodal_medical_learning_ii_tpu.text.engine import (
    TextInferenceEngine as JaxEngine,
)
from incremental_multimodal_medical_learning_ii_tpu.text.prompts import (
    create_prompts as jax_create_prompts,
)
from incremental_multimodal_medical_learning_ii_tpu.text.tokenizer import (
    PromptTokenizer as JaxTokenizer,
)
from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
from incremental_multimodal_medical_learning_ii_torch.text.bank import build_prompt_bank
from incremental_multimodal_medical_learning_ii_torch.text.engine import TextInferenceEngine
from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import (
    PromptTokenizer,
    write_test_vocab,
)
from incremental_multimodal_medical_learning_ii_torch.utils.config import (
    CHEXPERT_COMPETITION_TASKS,
)

from torch_port_helpers import assert_parity, to_numpy_tree

ATOL = 3e-5  # the BERT torch-parity tolerance (PARITY.md:89)
PROMPTS = ["There is no pleural effusion", "Mild cardiomegaly.", "Edema",
           "No evidence of acute consolidation!"]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    vocab = write_test_vocab(tmp_path_factory.mktemp("vocab") / "vocab.txt")
    n_vocab = len(vocab.read_text().splitlines())
    jdims = jbert.tiny_bert_dims(vocab_size=n_vocab, max_position_embeddings=48,
                                 projection_size=128)
    tree = to_numpy_tree(jbert.init_cxr_bert(jax.random.PRNGKey(11), jdims))
    jeng = JaxEngine(tree, jdims, JaxTokenizer(vocab))
    teng = TextInferenceEngine(params_from_jax(tree, jdims), PromptTokenizer(vocab), device="cpu")
    return jeng, teng, vocab


@pytest.mark.parametrize("normalize", [True, False])
def test_embeddings_match_jax(engines, normalize):
    jeng, teng, _ = engines
    ours = teng.get_embeddings_from_prompt(PROMPTS, normalize=normalize)
    ref = jeng.get_embeddings_from_prompt(PROMPTS, normalize=normalize)
    assert ours.shape == (4, 128) and ours.dtype == np.float32
    assert_parity(f"text engine embeddings normalize={normalize}", ours, np.asarray(ref), ATOL)
    lone = teng.get_embeddings_from_prompt(PROMPTS[2], normalize=normalize)
    assert lone.shape == (1, 128)


def test_pairwise_similarities_diagonal(engines):
    jeng, teng, _ = engines
    for a, b in [(PROMPTS, PROMPTS[::-1]), (PROMPTS[:1], PROMPTS), (PROMPTS, PROMPTS[1:3])]:
        ours = teng.get_pairwise_similarities(a, b)
        assert ours.shape == (min(len(a), len(b)),)
        assert_parity("text engine pairwise similarities", ours,
                      np.asarray(jeng.get_pairwise_similarities(a, b)), ATOL)


def test_predict_masked_tokens(engines):
    jeng, teng, _ = engines
    prompts = ["There is [MASK] pleural effusion", "[MASK] cardiomegaly [MASK]", "edema"]
    ours = teng.predict_masked_tokens(prompts)
    assert ours == jeng.predict_masked_tokens(prompts)
    assert [len(t) for t in ours] == [1, 2, 0]


def test_prompt_bank_through_the_engine(engines):
    jeng, teng, _ = engines
    tasks = CHEXPERT_COMPETITION_TASKS
    ours = build_prompt_bank(teng.encode_fn(normalize=False), create_prompts(tasks), tasks)
    ref = jax_build_prompt_bank(jeng.encode_fn(normalize=False), jax_create_prompts(tasks), tasks)
    for name in ("pos", "neg"):
        assert_parity(f"prompt bank {name} through the text engine", getattr(ours, name).numpy(),
                      np.asarray(getattr(ref, name)), ATOL)
    for name in ("pos_count", "neg_count"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))


def test_tokenizer_cap_is_never_raised(engines):
    _, teng, vocab = engines
    tight = PromptTokenizer(vocab, max_allowed_input_length=5)
    TextInferenceEngine(teng.model, tight, device="cpu")
    assert tight.max_allowed_input_length == 5  # not raised to the model's 48
    loose = PromptTokenizer(vocab, max_allowed_input_length=512)
    TextInferenceEngine(teng.model, loose, device="cpu")
    assert loose.max_allowed_input_length == 48  # capped at the position table
    with pytest.raises(ValueError, match="longer than"):
        TextInferenceEngine(teng.model, tight, device="cpu").get_embeddings_from_prompt(PROMPTS)


def test_bf16_engine_and_unported_mesh(engines):
    _, teng, vocab = engines
    half = TextInferenceEngine(teng.model, PromptTokenizer(vocab), dtype=torch.bfloat16,
                               device="cpu")
    a = half.get_embeddings_from_prompt(PROMPTS)
    b = teng.get_embeddings_from_prompt(PROMPTS)
    assert a.dtype == np.float32 and np.sum(a * b, -1).min() > 0.995
    # mesh= is ported (tests/test_torch_text_parallel.py); a partition it
    # does not know raises before anything is built, as in JAX
    with pytest.raises(ValueError, match="unknown partition 'dp'"):
        TextInferenceEngine(teng.model, PromptTokenizer(vocab), mesh=object(), partition="dp",
                            device="cpu")
