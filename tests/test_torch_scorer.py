"""Port objectives/scorer.py against the JAX package's scorer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.models import adapters as jad
from incremental_multimodal_medical_learning_ii_tpu.objectives import scorer as jsc
from incremental_multimodal_medical_learning_ii_tpu.utils.config import PromptMode as JMode
from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
from incremental_multimodal_medical_learning_ii_torch.models import adapters as tad
from incremental_multimodal_medical_learning_ii_torch.objectives import scorer as tsc

from torch_port_helpers import assert_parity, to_numpy_tree

# the JAX package's scorer-parity tolerance (PARITY.md: val/Loss 1.2e-7);
# a text adapter adds two fp32 products before the cosine
ATOL = 1.2e-7
ATOL_ADAPTED = 5e-7


def _bank(rng, garbage_padding=False):
    """Uneven per-class prompt counts on both polarities."""
    c, p, d = 5, 6, 128
    pos = rng.normal(size=(c, p, d)).astype(np.float32)
    neg = rng.normal(size=(c, p, d)).astype(np.float32)
    pos_count = np.array([6, 1, 4, 3, 5], np.int32)
    neg_count = np.array([4, 4, 2, 6, 1], np.int32)
    for i in range(c):
        fill = 7.0 if garbage_padding else 0.0
        pos[i, pos_count[i]:] = fill
        neg[i, neg_count[i]:] = fill
    return pos, neg, pos_count, neg_count


def _both(arrays):
    jb = jsc.PromptBank(*(jnp.asarray(a) for a in arrays))
    tb = tsc.PromptBank(*(torch.from_numpy(a) for a in arrays))
    return jb, tb


@pytest.mark.parametrize("mode", ["single", "mean", "max"])
@pytest.mark.parametrize("train_ld,pred_ld", [(True, False), (False, True), (True, True), (False, False)])
@pytest.mark.parametrize("text_adapter", [False, True])
def test_score_embeddings_matches_jax(rng, mode, train_ld, pred_ld, text_adapter):
    arrays = _bank(rng)
    if mode == "single":
        arrays = (arrays[0][:, :1], arrays[1][:, :1], np.ones(5, np.int32), np.ones(5, np.int32))
    jb, tb = _both(arrays)
    x = rng.normal(size=(11, 128)).astype(np.float32)
    atol = ATOL
    if text_adapter:
        jpair = jad.AdapterPair(jad.AdapterKind.MLP, False, False, True)
        jparams = to_numpy_tree(jpair.init(jax.random.PRNGKey(1)))
        tpair = tad.AdapterPair("mlp", False, False, True)
        tparams = params_from_jax(jparams)
        jb = jsc.apply_text_adapter_to_bank(jpair.apply_text, jparams, jb)
        with torch.no_grad():
            tb = tsc.apply_text_adapter_to_bank(tpair.apply_text, tparams, tb)
        np.testing.assert_allclose(tb.pos.numpy(), np.asarray(jb.pos), atol=1e-6, rtol=0)
        assert np.all(tb.neg.numpy()[1, 4:] == 0.0)  # padding rows re-zeroed
        atol = ATOL_ADAPTED
    ref = jsc.score_embeddings(jnp.asarray(x), jb, JMode(mode), train_ld, pred_ld)
    for use_kernel in (False, True):
        ours = tsc.score_embeddings(torch.from_numpy(x), tb, mode, train_ld, pred_ld,
                                    use_kernel=use_kernel)
        for name in ("logits", "scores", "pos_sim", "neg_sim"):
            assert_parity(f"scorer {mode} adapter={text_adapter} kernel={use_kernel} {name}",
                          getattr(ours, name).numpy(), np.asarray(getattr(ref, name)), atol)
        margin = np.abs(np.asarray(ref.pos_sim) - np.asarray(ref.neg_sim))
        sure = margin > 10 * atol
        np.testing.assert_array_equal(ours.preds.numpy()[sure], np.asarray(ref.preds)[sure])
        if mode == "max":
            np.testing.assert_allclose(ours.max_mean_gap.numpy(), np.asarray(ref.max_mean_gap),
                                       atol=atol, rtol=0)
        else:
            assert ours.max_mean_gap is None


def test_max_mode_ignores_padding_rows(rng):
    """MAX substitutes a unit vector for padding rows and masks their
    similarities: garbage in the padding changes nothing."""
    x = torch.from_numpy(rng.normal(size=(4, 128)).astype(np.float32))
    clean = tsc.PromptBank(*(torch.from_numpy(a) for a in _bank(np.random.default_rng(5))))
    dirty = tsc.PromptBank(*(torch.from_numpy(a) for a in _bank(np.random.default_rng(5), True)))
    a = tsc.score_embeddings(x, clean, "max", True, False)
    b = tsc.score_embeddings(x, dirty, "max", True, False, use_kernel=True)
    for name in ("scores", "preds", "max_mean_gap"):
        np.testing.assert_array_equal(getattr(a, name).numpy(), getattr(b, name).numpy())
    jb, _ = _both(_bank(np.random.default_rng(5), True))
    ref = jsc.score_embeddings(jnp.asarray(x.numpy()), jb, JMode.MAX, True, False)
    np.testing.assert_allclose(b.scores.numpy(), np.asarray(ref.scores), atol=ATOL, rtol=0)


def test_ties_predict_negative(rng):
    """preds = pos > neg strictly: a mirrored bank (train_logit_diff=False
    builds one) ties everywhere and predicts 0, as the reference's argmax."""
    pos, _, count, _ = _bank(rng)
    bank = tsc.PromptBank(torch.from_numpy(pos), torch.from_numpy(pos.copy()),
                          torch.from_numpy(count), torch.from_numpy(count))
    x = torch.from_numpy(rng.normal(size=(6, 128)).astype(np.float32))
    for mode in ("mean", "max"):
        out = tsc.score_embeddings(x, bank, mode, False, False, use_kernel=True)
        assert torch.all(out.preds == 0)
        assert torch.equal(out.logits, out.pos_sim)
