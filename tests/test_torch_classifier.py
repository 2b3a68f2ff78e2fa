"""The ported serving path as a whole: the port's ChexpertClassifier against
the JAX package's on the same carried weights, bank and images, and the
port's HTTP server on the CPU."""

import argparse
import base64
import http.client
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from incremental_multimodal_medical_learning_ii_tpu.inference import (
    ChexpertClassifier as JaxClassifier,
)
from incremental_multimodal_medical_learning_ii_tpu.models.adapters import AdapterPair as JPair
from incremental_multimodal_medical_learning_ii_tpu.objectives.scorer import (
    PromptBank as JBank,
)
from incremental_multimodal_medical_learning_ii_tpu.utils import config as jcfg
from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
from incremental_multimodal_medical_learning_ii_torch.inference import ChexpertClassifier
from incremental_multimodal_medical_learning_ii_torch.objectives.scorer import score_embeddings
from incremental_multimodal_medical_learning_ii_torch.text.bank import (
    build_prompt_bank,
    synthetic_encode_fn,
)
from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
from incremental_multimodal_medical_learning_ii_torch.utils import config as tcfg

from torch_biovil_fixture import TorchBioViLImage, randomize_bn_stats
from torch_port_helpers import (
    assert_parity,
    biovil_numpy_params,
    reference_bert_state_dict,
    to_numpy_tree,
)

# scores: the 2e-4 embedding tolerance of the tower shrinks through the
# cosine against unit-scale prompt means; preds are held where the
# pos-neg margin exceeds the score tolerance
SCORE_ATOL = 1e-4
KW = dict(batch_size=2, size=64, pad_to=128, dtype=None)

SHAPES = [(100, 80), (80, 100), (100, 80), (70, 60), (128, 96)]


@pytest.fixture(scope="module")
def setup():
    tree = biovil_numpy_params(seed=0, bn_seed=3)
    tasks = tcfg.CHEXPERT_COMPETITION_TASKS
    bank = build_prompt_bank(synthetic_encode_fn(27), create_prompts(tasks, new_prompts=True),
                             tasks)  # 10 positives, 4 negatives per class
    rng = np.random.default_rng(27)
    images = [(rng.random(s) * 255).astype(np.uint8) for s in SHAPES]
    return tree, bank, images


def _classifiers(setup, mode, adapters):
    tree, bank, _ = setup
    jbank = JBank(*(jnp.asarray(t.numpy()) for t in bank))
    jcfg_, tcfg_, jad, tad = None, None, None, None
    if adapters:
        jcfg_ = jcfg.joint_config(prompt_mode=mode)
        jpair = JPair(jcfg_.adapter, jcfg_.shared, jcfg_.image_adapter, jcfg_.text_adapter)
        jad = to_numpy_tree(jpair.init(jax.random.PRNGKey(3)))
        tcfg_ = tcfg.joint_config(prompt_mode=mode)
        tad = params_from_jax(jad)
    elif mode != "mean":
        jcfg_ = jcfg.ExperimentConfig(adapter="no-head", image_adapter=False, text_adapter=False,
                                      epochs=0, mode="zero", prompt_mode=mode)
        tcfg_ = tcfg.ExperimentConfig(adapter="no-head", image_adapter=False,
                                      text_adapter=False, prompt_mode=mode)
    kw = {k: v for k, v in KW.items() if k != "dtype"}
    jclf = JaxClassifier(tree, jbank, cfg=jcfg_, adapter_params=jad, dtype=jnp.float32, **kw)
    tclf = ChexpertClassifier(params_from_jax(tree), bank, cfg=tcfg_, adapter_params=tad,
                              dtype=torch.float32, device="cpu", **kw)
    return jclf, tclf


@pytest.mark.parametrize("mode,adapters", [("mean", False), ("max", True)])
def test_classifier_matches_jax(setup, mode, adapters):
    _, _, images = setup
    jclf, tclf = _classifiers(setup, mode, adapters)
    jscores, jpreds = jclf.predict_arrays(images)
    scores, preds = tclf.predict_arrays(images)
    assert scores.shape == preds.shape == (5, 5)
    assert scores.dtype == preds.dtype == np.float32
    assert_parity(f"classifier {mode} adapters={adapters} scores", scores, np.asarray(jscores),
                  SCORE_ATOL)
    # the port's own pos/neg similarities locate the near-ties
    embs = torch.from_numpy(tclf.embed_arrays(images))
    bank = tclf.bank
    if tclf.pair.use_text:
        from incremental_multimodal_medical_learning_ii_torch.objectives.scorer import (
            apply_text_adapter_to_bank,
        )

        with torch.no_grad():
            bank = apply_text_adapter_to_bank(tclf.pair.apply_text, tclf.adapter_params, bank)
    out = score_embeddings(embs, bank, tclf.cfg.prompt_mode, True, False)
    np.testing.assert_allclose(out.scores.numpy(), scores, atol=1e-6, rtol=0)
    sure = np.abs(out.pos_sim.numpy() - out.neg_sim.numpy()) > SCORE_ATOL
    assert sure.mean() > 0.5
    np.testing.assert_array_equal(preds[sure], np.asarray(jpreds)[sure])


def test_fused_layer1_bf16_path_on_cpu(setup):
    """fused_layer1=True in bf16 (the kernel's plain version on the CPU)
    stays close to the stock bf16 forward, as the JAX test holds it."""
    tree, bank, images = setup
    kw = {k: v for k, v in KW.items() if k != "dtype"}
    model = params_from_jax(tree)
    plain = ChexpertClassifier(model, bank, dtype=torch.bfloat16, device="cpu", **kw)
    fused = ChexpertClassifier(model, bank, dtype=torch.bfloat16, fused_layer1=True,
                               device="cpu", **kw)
    a = plain.embed_arrays(images).astype(np.float64)
    b = fused.embed_arrays(images).astype(np.float64)
    cos = np.sum(a * b, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    assert cos.min() > 0.999, cos


def test_classifier_retries_and_edge_cases(setup):
    tree, bank, images = setup
    clf = ChexpertClassifier(params_from_jax(tree), bank, device="cpu", retries=2,
                             retry_backoff_s=0.0, dtype=torch.float32,
                             **{k: v for k, v in KW.items() if k != "dtype"})
    clean = clf.predict_arrays(images[:3])
    real, fail = clf._fn, {"n": 1}

    def flaky(*args):
        if fail["n"] > 0:
            fail["n"] -= 1
            raise RuntimeError("injected transient backend error")
        return real(*args)

    clf._fn = flaky
    again = clf.predict_arrays(images[:3])
    assert fail["n"] == 0
    np.testing.assert_array_equal(again[0], clean[0])
    clf._fn = lambda *a: (_ for _ in ()).throw(RuntimeError("permanently down"))
    with pytest.raises(RuntimeError, match="permanently down"):
        clf.predict_arrays(images[:1])
    clf._fn = real
    empty_s, empty_p = clf.predict_arrays([])
    assert empty_s.shape == empty_p.shape == (0, 5)
    with pytest.raises(ValueError, match="adapter_params given without a cfg"):
        ChexpertClassifier(clf.image_params, bank, adapter_params=params_from_jax(
            {"image": {"dense1": {"kernel": np.zeros((128, 128)), "bias": np.zeros(128)}}}),
            device="cpu")


def test_predict_paths_and_cli(setup, tmp_path, capsys):
    from incremental_multimodal_medical_learning_ii_torch.cli import classify

    _, bank, images = setup
    paths = []
    for i, im in enumerate(images[:2]):
        paths.append(str(tmp_path / f"im{i}.png"))
        Image.fromarray(im, "L").save(paths[-1])
    p = argparse.ArgumentParser()
    classify.add_classifier_args(p)
    args = p.parse_args(["--random-weights", "--device", "cpu", "--size", "64", "--pad-to", "128",
                         "--batch-size", "2", "--save-bank", str(tmp_path / "bank.npz")])
    clf = classify.build_classifier(args)
    scores, _ = clf.predict_paths(paths)
    direct, _ = clf.predict_arrays(images[:2])
    np.testing.assert_array_equal(scores, direct)
    # the saved bank reloads into an identical classifier
    args2 = p.parse_args(["--random-weights", "--device", "cpu", "--size", "64", "--pad-to", "128",
                          "--batch-size", "2", "--bank", str(tmp_path / "bank.npz")])
    np.testing.assert_array_equal(classify.build_classifier(args2).predict_paths(paths)[0], scores)
    classify.main(["--random-weights", "--device", "cpu", "--size", "64", "--pad-to", "128",
                   "--batch-size", "2", *paths])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-3].startswith("image,Atelectasis") and out[-1].startswith(paths[1])
    # --adapter-checkpoint restores a run's TrainState (tests/test_torch_adapter_checkpoint.py);
    # a directory without one is an error, not a zero-shot classifier
    with pytest.raises(FileNotFoundError, match="train_state"):
        classify.build_classifier(p.parse_args(["--random-weights", "--device", "cpu",
                                                "--adapter-checkpoint", str(tmp_path / "x")]))


# ----------------------------------------------------------------------
# the classify CLI with the reference's weight files, against the JAX CLI
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_files(tmp_path_factory):
    """The reference's formats: BioViL image checkpoint, CXR-BERT state dict
    + vocab, an HF snapshot directory, pickled reference adapters."""
    import sys

    from incremental_multimodal_medical_learning_ii_torch.models.convert import (
        reference_models_stub,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import write_test_vocab

    d = tmp_path_factory.mktemp("reference")
    torch.manual_seed(0)
    biovil = TorchBioViLImage().eval()
    randomize_bn_stats(biovil, seed=2)
    torch.save(biovil.state_dict(), d / "biovil.pt")
    vocab = write_test_vocab(d / "vocab.txt")
    sd = {k: torch.from_numpy(v) for k, v in reference_bert_state_dict(
        4, hidden=64, layers=2, vocab=len(vocab.read_text().splitlines()), pos=48).items()}
    torch.save(sd, d / "cxr_bert.pt")
    snap = d / "snapshot"
    snap.mkdir()
    (snap / "config.json").write_text(json.dumps(dict(
        vocab_size=sd["bert.embeddings.word_embeddings.weight"].shape[0], hidden_size=64,
        num_hidden_layers=2, num_attention_heads=2, intermediate_size=96,
        max_position_embeddings=48, type_vocab_size=2)))
    torch.save(sd, snap / "pytorch_model.bin")
    write_test_vocab(snap / "vocab.txt")
    torch.manual_seed(1)
    with reference_models_stub():
        cls = sys.modules["models"].myMLP
        cls.__module__, cls.__qualname__ = "models", "myMLP"
        for name in ("image", "text"):
            torch.save(cls(), d / f"{name}_adapter.pt")
    return d


@pytest.mark.parametrize("route", ["checkpoint", "snapshot+adapters"])
def test_classify_cli_with_reference_weights_matches_jax_cli(setup, reference_files, route):
    """Both CLIs build their classifier from the same files; the banks agree
    to the BERT tolerance and, run in fp32 from the pieces each CLI built,
    the scores to 1e-4 (the CLIs themselves serve in bf16)."""
    from incremental_multimodal_medical_learning_ii_tpu.cli import classify as jclassify
    from incremental_multimodal_medical_learning_ii_torch.cli import classify

    _, _, images = setup
    d = reference_files
    flags = ["--biovil-checkpoint", str(d / "biovil.pt"), "--size", "64", "--pad-to", "128",
             "--batch-size", "2"]
    if route == "checkpoint":
        flags += ["--cxr-bert-checkpoint", str(d / "cxr_bert.pt"), "--cxr-bert-vocab",
                  str(d / "vocab.txt")]
    else:
        flags += ["--cxr-bert-snapshot", str(d / "snapshot"), "--max-emb", "--new-prompts",
                  "--reference-image-adapter", str(d / "image_adapter.pt"),
                  "--reference-text-adapter", str(d / "text_adapter.pt")]
    jp, tp = argparse.ArgumentParser(), argparse.ArgumentParser()
    jclassify.add_classifier_args(jp)
    classify.add_classifier_args(tp)
    jclf = jclassify.build_classifier(jp.parse_args(flags))
    tclf = classify.build_classifier(tp.parse_args(flags + ["--device", "cpu"]))
    for name in ("pos", "neg"):
        assert_parity(f"classify CLI ({route}) bank {name}", getattr(tclf.bank, name).numpy(),
                      np.asarray(getattr(jclf.bank, name)), 3e-5)
    assert tclf.cfg.prompt_mode.value == jclf.cfg.prompt_mode.value
    assert (tclf.cfg.image_adapter, tclf.cfg.text_adapter) == (jclf.cfg.image_adapter,
                                                              jclf.cfg.text_adapter)
    kw = {k: v for k, v in KW.items() if k != "dtype"}
    jfp32 = JaxClassifier(jclf.image_params, jclf.bank, cfg=jclf.cfg,
                          adapter_params=jclf.adapter_params, dtype=jnp.float32, **kw)
    tfp32 = ChexpertClassifier(tclf.image_params, tclf.bank, cfg=tclf.cfg,
                               adapter_params=tclf.adapter_params or None, dtype=torch.float32,
                               device="cpu", **kw)
    assert_parity(f"classify CLI ({route}) scores", tfp32.predict_arrays(images)[0],
                  np.asarray(jfp32.predict_arrays(images)[0]), SCORE_ATOL)


@pytest.mark.parametrize("given", ["--cxr-bert-checkpoint", "--cxr-bert-vocab"])
def test_half_given_cxr_bert_pair_exits(reference_files, given):
    from incremental_multimodal_medical_learning_ii_tpu.cli import classify as jclassify
    from incremental_multimodal_medical_learning_ii_torch.cli import classify

    flags = ["--random-weights", given, str(reference_files / "vocab.txt")]
    jp, tp = argparse.ArgumentParser(), argparse.ArgumentParser()
    jclassify.add_classifier_args(jp)
    classify.add_classifier_args(tp)
    with pytest.raises(SystemExit) as jerr:
        jclassify.build_classifier(jp.parse_args(flags))
    with pytest.raises(SystemExit) as err:
        classify.build_classifier(tp.parse_args(flags + ["--device", "cpu"]))
    assert str(err.value) == str(jerr.value) and "go together" in str(err.value)


# ----------------------------------------------------------------------
# HTTP server
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def server(setup):
    from incremental_multimodal_medical_learning_ii_torch.cli.serve import make_server

    tree, bank, _ = setup
    clf = ChexpertClassifier(params_from_jax(tree), bank, device="cpu", dtype=torch.float32,
                             **{k: v for k, v in KW.items() if k != "dtype"})
    srv = make_server(clf, "127.0.0.1", 0)
    mb = make_server(clf, "127.0.0.1", 0, microbatch_s=0.05)
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in (srv, mb)]
    for t in threads:
        t.start()
    yield srv, mb, clf
    for s in (srv, mb):
        s.shutdown()
        s.server_close()


def _png(rng, h=70, w=60):
    buf = io.BytesIO()
    Image.fromarray((rng.random((h, w)) * 255).astype(np.uint8), "L").save(buf, "PNG")
    return buf.getvalue()


def _request(srv, method, path, body=None, ctype=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=60)
    conn.request(method, path, body=body, headers={**({"Content-Type": ctype} if ctype else {}),
                                                   **(headers or {})})
    resp = conn.getresponse()
    payload = json.loads(resp.read())
    conn.close()
    return resp.status, payload


def test_server_contract(server, rng):
    srv, _, clf = server
    status, payload = _request(srv, "GET", "/healthz")
    assert status == 200 and payload["status"] == "ok" and payload["platform"] == "cpu"
    assert payload["classes"][0] == "Atelectasis"
    png = _png(rng)
    status, payload = _request(srv, "POST", "/classify", body=png, ctype="image/png")
    assert status == 200 and len(payload["scores"]) == 1 and len(payload["scores"][0]) == 5
    img = np.asarray(Image.open(io.BytesIO(png)))
    scores, preds = clf.predict_arrays([img])
    np.testing.assert_allclose(payload["scores"][0], scores[0], atol=1e-5)
    assert payload["preds"][0] == [int(v) for v in preds[0]]
    pngs = [_png(rng), _png(rng, 80, 50)]
    body = json.dumps({"images_b64": [base64.b64encode(p).decode() for p in pngs]})
    status, payload = _request(srv, "POST", "/classify", body=body, ctype="application/json")
    assert status == 200 and len(payload["scores"]) == 2


def test_server_client_errors(server, rng):
    srv, _, clf = server
    for body, ctype, needle in [
        (b"not an image", "image/png", "UnidentifiedImageError"),
        (b"", None, "empty"),
        (json.dumps({"images_b64": []}), "application/json", "images_b64"),
        (_png(rng, clf.plan.pad_to + 8, 40), "image/png", "exceeds pad_to"),
        (_png(rng, 4, 100), "image/png", "aspect ratio"),
    ]:
        status, payload = _request(srv, "POST", "/classify", body=body, ctype=ctype)
        assert status == 400 and needle in payload["error"], payload
    assert _request(srv, "GET", "/nope")[0] == 404
    assert _request(srv, "POST", "/nope")[0] == 404
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=60)
    conn.putrequest("POST", "/classify")
    conn.putheader("Content-Length", str(10**10))
    conn.endheaders()
    resp = conn.getresponse()
    assert resp.status == 413 and "exceeds" in json.loads(resp.read())["error"]
    conn.close()


def test_server_microbatching(server, rng):
    _, mb, clf = server
    pngs = [_png(rng, 60 + i, 50) for i in range(4)]
    out = {}

    def worker(i):
        out[i] = _request(mb, "POST", "/classify", body=pngs[i], ctype="image/png")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for i in range(4):
        status, payload = out[i]
        assert status == 200
        scores, _ = clf.predict_arrays([np.asarray(Image.open(io.BytesIO(pngs[i])))])
        np.testing.assert_allclose(payload["scores"][0], scores[0], atol=1e-4)
    assert 1 <= mb.microbatcher.dispatches <= 4


def test_microbatcher_coalesces_and_slices(rng):
    from incremental_multimodal_medical_learning_ii_torch.cli.serve import MicroBatcher

    class Counting:
        batch_size = 64
        class_names = list("abcde")
        calls = 0

        def predict_arrays(self, images):
            self.calls += 1
            scores = np.stack([np.full(5, float(im.sum() % 97)) for im in images])
            return scores, (scores > 48).astype(np.int32)

    clf = Counting()
    mb = MicroBatcher(clf, max_delay_s=0.5)
    imgs = [(rng.random((8, 8)) * 255).astype(np.uint8) for _ in range(6)]
    results = {}

    def worker(i):
        results[i] = mb.predict([imgs[i]])[0][0]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    for i in range(6):
        assert results[i][0] == float(imgs[i].sum() % 97)
    assert clf.calls < 6 and mb.dispatches == clf.calls

    class Broken(Counting):
        def predict_arrays(self, images):
            raise RuntimeError("device gone")

    with pytest.raises(RuntimeError, match="device gone"):
        MicroBatcher(Broken(), max_delay_s=0.01).predict([imgs[0]])
