"""Port text/prompts.py + text/bank.py against the JAX package's."""

import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.text import bank as jbank
from incremental_multimodal_medical_learning_ii_tpu.text import prompts as jprompts
from incremental_multimodal_medical_learning_ii_tpu.utils.config import (
    CHEXPERT_COMPETITION_TASKS as JTASKS,
)
from incremental_multimodal_medical_learning_ii_torch.text import bank as tbank
from incremental_multimodal_medical_learning_ii_torch.text import prompts as tprompts
from incremental_multimodal_medical_learning_ii_torch.utils.config import (
    CHEXPERT_COMPETITION_TASKS,
)


def test_task_list_and_prompts_match():
    assert CHEXPERT_COMPETITION_TASKS == JTASKS
    for kw in ({}, {"single_prompt": True}, {"new_prompts": True},
               {"new_prompts": True, "train_logit_diff": False, "seed": 3}):
        assert tprompts.create_prompts(CHEXPERT_COMPETITION_TASKS, **kw) == \
            jprompts.create_prompts(JTASKS, **kw)


def test_synthetic_encode_fn_bit_identical():
    texts = ["There is no Edema", "Findings suggesting Atelectasis", "", "ünïcode"]
    for seed in (0, 27):
        ours = tbank.synthetic_encode_fn(seed)(texts)
        ref = jbank.synthetic_encode_fn(seed)(texts)
        assert ours.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize(
    "kw", [{}, {"single_prompt": True}, {"new_prompts": True},
           {"new_prompts": True, "train_logit_diff": False}],
)
def test_build_prompt_bank_bit_identical(kw):
    tld = kw.get("train_logit_diff", True)
    prompts = tprompts.create_prompts(CHEXPERT_COMPETITION_TASKS, **kw)
    ours = tbank.build_prompt_bank(tbank.synthetic_encode_fn(27), prompts,
                                   CHEXPERT_COMPETITION_TASKS, train_logit_diff=tld)
    ref = jbank.build_prompt_bank(jbank.synthetic_encode_fn(27), prompts, JTASKS,
                                  train_logit_diff=tld)
    for a, b in zip(ours, ref):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_save_load_round_trip_and_cross_load(tmp_path):
    prompts = tprompts.create_prompts(CHEXPERT_COMPETITION_TASKS, new_prompts=True)
    bank = tbank.build_prompt_bank(tbank.synthetic_encode_fn(1), prompts, CHEXPERT_COMPETITION_TASKS)
    tbank.save_prompt_bank(tmp_path / "ours.npz", bank)
    back = tbank.load_prompt_bank(tmp_path / "ours.npz")
    for a, b in zip(back, bank):
        assert torch.equal(a, b)
    # the file format is the JAX package's, both ways
    from_jax_reader = jbank.load_prompt_bank(tmp_path / "ours.npz")
    for a, b in zip(from_jax_reader, bank):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jbank.save_prompt_bank(tmp_path / "jax.npz", from_jax_reader)
    for a, b in zip(tbank.load_prompt_bank(tmp_path / "jax.npz"), bank):
        assert torch.equal(a, b)


def test_missing_negatives_rejected():
    prompts = tprompts.create_prompts(CHEXPERT_COMPETITION_TASKS, new_prompts=True,
                                      train_logit_diff=False)
    with pytest.raises(ValueError, match="no negatives"):
        tbank.build_prompt_bank(tbank.synthetic_encode_fn(), prompts, CHEXPERT_COMPETITION_TASKS)
