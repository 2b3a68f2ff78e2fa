"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
parameter trees cross over as numpy leaves through the port's
``params_from_jax``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a module of toy-size steps: thousands of
    tiny ops run several times faster than with a thread pool, above all
    beside the other test workers.  Import it into a test module to use it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_numpy_tree(tree):
    """A JAX parameter tree with numpy leaves (structure unchanged)."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype=np.float32), tree)


def randomize_bn(tree, rng: np.random.Generator):
    """Non-trivial frozen-BN statistics in every BN dict of the tree, so a
    conversion bug cannot hide behind identity batch norms."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = np.shape(tree["scale"])[0]
            return {
                "scale": (rng.random(c) + 0.5).astype(np.float32),
                "bias": (rng.normal(size=c) * 0.1).astype(np.float32),
                "mean": (rng.normal(size=c) * 0.1).astype(np.float32),
                "var": (rng.random(c) + 0.5).astype(np.float32),
            }
        return {k: randomize_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [randomize_bn(v, rng) for v in tree]
    return tree


def _torch_default_conv_scale(tree):
    """Rescale every HWIO conv kernel from the JAX init's kaiming-normal
    (fan_out) spread to torch's default conv init spread, 1/sqrt(3*fan_in),
    which the JAX package's own parity fixture uses: activations then stay
    O(1) through the 53 convs, so absolute tolerances mean what they say."""
    if isinstance(tree, dict):
        out = {k: _torch_default_conv_scale(v) for k, v in tree.items()}
        k = out.get("kernel")
        if k is not None and np.ndim(k) == 4:
            kh, kw, cin, cout = np.shape(k)
            out["kernel"] = (k * np.sqrt((kh * kw * cout) / (6.0 * kh * kw * cin))).astype(np.float32)
        return out
    if isinstance(tree, (list, tuple)):
        return [_torch_default_conv_scale(v) for v in tree]
    return tree


def biovil_numpy_params(seed: int = 0, bn_seed: int | None = 3):
    """The JAX package's BioViL init (PRNGKey(seed)) as a numpy tree, at
    torch's default conv scale, optionally with randomized BN statistics."""
    from incremental_multimodal_medical_learning_ii_tpu.models.biovil_image import (
        init_biovil_image_model,
    )

    tree = to_numpy_tree(init_biovil_image_model(jax.random.PRNGKey(seed)))
    tree = _torch_default_conv_scale(tree)
    if bn_seed is not None:
        tree = randomize_bn(tree, np.random.default_rng(bn_seed))
    return tree


def biovil_numpy_params_from_port(seed: int = 0, bn_seed: int | None = 3):
    """A BioViL tree in the JAX layout from the port's seeded init (a torch
    generator), at torch's default conv scale, optionally with randomized
    BN statistics: the same weights for both packages at a fraction of the
    JAX init's cost (the eager JAX init takes ~15 s on the CPU)."""
    from incremental_multimodal_medical_learning_ii_torch.convert import params_to_jax
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        init_biovil_image_model,
    )

    tree = params_to_jax(init_biovil_image_model(torch.Generator().manual_seed(seed)))
    tree = _torch_default_conv_scale(tree)
    if bn_seed is not None:
        tree = randomize_bn(tree, np.random.default_rng(bn_seed))
    return tree


def assert_parity(name: str, ours, ref, atol: float) -> float:
    """assert_allclose(ours, ref, atol, rtol=0), printing the measured
    largest difference (``pytest -rA`` shows it) for the port's parity
    table."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    err = float(np.max(np.abs(ours.astype(np.float64) - ref))) if ours.size else 0.0
    print(f"PARITY {name}: max |port - jax| = {err:.3e} (atol {atol:g})")
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=0, err_msg=name)
    return err


def bf16_ulps(a: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Elementwise |a - ref| counted in bf16 units in the last place of
    max(|ref|, 1) — the scale of the kernels' ``rel`` bar, so a ReLU-edge
    flip between 0 and a tiny value counts as the small error it is."""
    mag = np.maximum(np.abs(np.asarray(ref, np.float64)), 1.0)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)  # bf16 keeps 8 significant bits
    return np.abs(np.asarray(a, np.float64) - ref) / ulp


def reference_bert_state_dict(seed=0, projection=True, decoder_bias="cls.predictions.decoder.bias",
                              hidden=64, layers=2, inter=96, vocab=200, pos=40, proj=128):
    """A BertForMaskedLM (+ CXR-BERT projection head) state dict in the
    reference's key layout, made with numpy."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.05

    sd = {"bert.embeddings.word_embeddings.weight": w(vocab, hidden),
          "bert.embeddings.position_embeddings.weight": w(pos, hidden),
          "bert.embeddings.token_type_embeddings.weight": w(2, hidden),
          "bert.embeddings.position_ids": np.arange(pos, dtype=np.int64)[None]}

    def linear(prefix, dout, din):
        sd[prefix + ".weight"], sd[prefix + ".bias"] = w(dout, din), w(dout)

    def ln(prefix, d):
        sd[prefix + ".weight"], sd[prefix + ".bias"] = 1 + w(d), w(d)

    ln("bert.embeddings.LayerNorm", hidden)
    for li in range(layers):
        p = f"bert.encoder.layer.{li}."
        for name in ("query", "key", "value"):
            linear(p + "attention.self." + name, hidden, hidden)
        linear(p + "attention.output.dense", hidden, hidden)
        ln(p + "attention.output.LayerNorm", hidden)
        linear(p + "intermediate.dense", inter, hidden)
        linear(p + "output.dense", hidden, inter)
        ln(p + "output.LayerNorm", hidden)
    linear("cls.predictions.transform.dense", hidden, hidden)
    ln("cls.predictions.transform.LayerNorm", hidden)
    sd[decoder_bias] = w(vocab)
    if projection:
        linear("cls_projection_head.dense_to_hidden", proj, hidden)
        ln("cls_projection_head.LayerNorm", proj)
        linear("cls_projection_head.dense_to_output", proj, proj)
    return sd
