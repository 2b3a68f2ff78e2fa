"""The port's four extraction CLIs against the JAX package's, on the CPU:
``extract_embeddings`` (``--synthetic``, hosts, ``--resume``),
``prepare_data`` (shards of two hosts, ``--split-head``),
``verify_embeddings`` and ``convert_weights`` (bundles each package reads),
with both CLIs given the same BioViL weights; and ``params_to_jax`` as the
inverse of ``params_from_jax``."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from incremental_multimodal_medical_learning_ii_tpu.cli import convert_weights as j_convert
from incremental_multimodal_medical_learning_ii_tpu.cli import extract_embeddings as j_extract
from incremental_multimodal_medical_learning_ii_tpu.cli import prepare_data as j_prepare
from incremental_multimodal_medical_learning_ii_tpu.cli import verify_embeddings as j_verify
from incremental_multimodal_medical_learning_ii_tpu.models import adapters as jadapters
from incremental_multimodal_medical_learning_ii_tpu.models import biovil_image as jbio
from incremental_multimodal_medical_learning_ii_tpu.models import cxr_bert as jbert
from incremental_multimodal_medical_learning_ii_tpu.utils.serialization import (
    load_params_npz as j_load_npz,
)
from incremental_multimodal_medical_learning_ii_torch.cli import convert_weights as t_convert
from incremental_multimodal_medical_learning_ii_torch.cli import extract_embeddings as t_extract
from incremental_multimodal_medical_learning_ii_torch.cli import prepare_data as t_prepare
from incremental_multimodal_medical_learning_ii_torch.cli import verify_embeddings as t_verify
from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax, params_to_jax
from incremental_multimodal_medical_learning_ii_torch.data.store import EmbeddingDataset
from incremental_multimodal_medical_learning_ii_torch.models import convert as tconv
from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import write_test_vocab

from torch_biovil_fixture import TorchBioViLImage, randomize_bn_stats
from torch_port_helpers import (  # noqa: F401
    assert_parity,
    biovil_numpy_params_from_port,
    one_torch_thread,
    reference_bert_state_dict,
    to_numpy_tree,
)

EMB_ATOL = 2e-4  # the ResNet bar
SYN = ["--synthetic", "6", "--size", "64", "--batch-size", "4", "--fp32"]


@pytest.fixture(scope="module")
def weights_tree():
    """Seeded BioViL weights at torch's default conv scale (embeddings of
    order 1, so the absolute bar means what it says), in the JAX layout."""
    return biovil_numpy_params_from_port(seed=0, bn_seed=3)


@pytest.fixture
def same_weights(monkeypatch, weights_tree):
    """Both CLIs' --synthetic init replaced by the same weights: the JAX
    tree for the JAX CLI, the port model carried from it by params_from_jax."""
    from incremental_multimodal_medical_learning_ii_torch.models import biovil_image as tbio

    tree = jax.tree_util.tree_map(jnp.asarray, weights_tree)
    monkeypatch.setattr(jbio, "init_biovil_image_model", lambda key: tree)
    monkeypatch.setattr(tbio, "init_biovil_image_model",
                        lambda generator=None: params_from_jax(weights_tree))


def _ds(directory) -> EmbeddingDataset:
    return EmbeddingDataset.load(Path(directory) / "dataset.npz")


def _both(tmp_path, name, flags):
    j_extract.main([*flags, "--out-dir", str(tmp_path / "jax" / name)])
    out = t_extract.main([*flags, "--out-dir", str(tmp_path / "port" / name), "--device", "cpu"])
    return out


def _same_datasets(ours: EmbeddingDataset, ref: EmbeddingDataset, what: str):
    assert len(ours) == len(ref)
    assert_parity(what, ours.embeddings, ref.embeddings, EMB_ATOL)
    np.testing.assert_array_equal(ours.labels, ref.labels)


def test_extract_cli_hosts_resume_and_prepare(tmp_path, same_weights):
    out = _both(tmp_path, "clean", SYN)
    assert out["fresh"] == 6 and out["stats"]["batches"] == 2 and out["shards"] == 1
    clean = _ds(tmp_path / "port" / "clean")
    _same_datasets(clean, _ds(tmp_path / "jax" / "clean"), "extract CLI --synthetic 6")
    # the image list split over two hosts, each in <out-dir>/host-<i>
    for host in ("0", "1"):
        _both(tmp_path, "hosts", [*SYN, "--num-hosts", "2", "--host-index", host])
        ours = _ds(tmp_path / "port" / "hosts" / f"host-{host}")
        _same_datasets(ours, _ds(tmp_path / "jax" / "hosts" / f"host-{host}"),
                       f"extract CLI host {host} of 2")
        _same_datasets(ours, clean.subset(range(3 * int(host), 3 * int(host) + 3)),
                       f"extract CLI host {host} vs the single host")
    # a cut run, then --resume: bit-exact against the clean run
    cut = [*SYN[:1], "4", *SYN[2:], "--checkpoint-interval", "4"]
    _both(tmp_path, "resumed", cut)
    out = _both(tmp_path, "resumed", [*SYN, "--checkpoint-interval", "4", "--resume"])
    assert out["fresh"] == 2 and out["shards"] == 2
    resumed = _ds(tmp_path / "port" / "resumed")
    np.testing.assert_array_equal(resumed.embeddings, clean.embeddings)
    np.testing.assert_array_equal(resumed.labels, clean.labels)
    _same_datasets(resumed, _ds(tmp_path / "jax" / "resumed"), "extract CLI --resume")
    # prepare_data glues the two hosts' shards in order and splits the head
    hosts = [str(tmp_path / "port" / "hosts" / f"host-{h}") for h in ("0", "1")]
    for main, name in ((j_prepare.main, "jax"), (t_prepare.main, "port")):
        main(["--shards", *hosts, "--out", str(tmp_path / f"{name}.npz"), "--split-head", "4"])
    for suffix in (".npz", ".head.npz", ".tail.npz"):
        ours = EmbeddingDataset.load(tmp_path / f"port{suffix}")
        ref = EmbeddingDataset.load(tmp_path / f"jax{suffix}")
        np.testing.assert_array_equal(ours.embeddings, ref.embeddings)
        np.testing.assert_array_equal(ours.labels, ref.labels)
    assert len(EmbeddingDataset.load(tmp_path / "port.head.npz")) == 4
    # --native writes <out>.embstore beside the .npz, byte for byte the JAX CLI's
    for main, name in ((j_prepare.main, "jax"), (t_prepare.main, "port")):
        main(["--shards", *hosts, "--out", str(tmp_path / f"n-{name}.npz"), "--native"])
    assert (tmp_path / "n-port.embstore").read_bytes() == (tmp_path / "n-jax.embstore").read_bytes()
    with pytest.raises(SystemExit, match="host-index"):
        t_extract.main([*SYN, "--num-hosts", "2", "--host-index", "2", "--out-dir",
                        str(tmp_path / "x"), "--device", "cpu"])


# ----------------------------------------------------------------------
# verify_embeddings and convert_weights, from the reference's formats
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_files(tmp_path_factory):
    """A BioViL image checkpoint, a CXR-BERT state dict and snapshot
    directory, pickled reference adapters, and a CSV of PNG images."""
    import sys

    d = tmp_path_factory.mktemp("reference")
    torch.manual_seed(0)
    biovil = TorchBioViLImage().eval()
    randomize_bn_stats(biovil, seed=1)
    torch.save(biovil.state_dict(), d / "biovil.pt")
    sd = {k: torch.from_numpy(v) for k, v in reference_bert_state_dict(2).items()}
    torch.save(sd, d / "cxr_bert.pt")
    snap = d / "snapshot"
    snap.mkdir()
    (snap / "config.json").write_text(json.dumps(dict(
        vocab_size=200, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=96, max_position_embeddings=40, type_vocab_size=2, projection_size=128)))
    torch.save(sd, snap / "pytorch_model.bin")
    write_test_vocab(snap / "vocab.txt")
    with tconv.reference_models_stub():
        for name, cls_name in (("image_adapter", "myMLP"), ("text_adapter", "myLinearModel")):
            cls = getattr(sys.modules["models"], cls_name)
            cls.__module__, cls.__qualname__ = "models", cls_name
            torch.save(cls(), d / f"{name}.pt")
    rng = np.random.default_rng(3)
    rows = ["Path,Atelectasis,Cardiomegaly,Consolidation,Edema,Pleural Effusion"]
    for i in range(3):
        Image.fromarray((rng.random((60 + i, 50)) * 255).astype(np.uint8), "L").save(d / f"{i}.png")
        rows.append(f"{i}.png,{i % 2},0,1,,-1.0")
    (d / "labels.csv").write_text("\n".join(rows) + "\n")
    cached = EmbeddingDataset(rng.normal(size=(3, 128)).astype(np.float32),
                              np.zeros((3, 5), np.float32))
    cached.save(d / "cached.npz")
    return d


def test_verify_embeddings_cli_matches_jax(reference_files, capsys):
    d = reference_files
    flags = ["--csv", str(d / "labels.csv"), "--img-dir", str(d) + "/", "--biovil-checkpoint",
             str(d / "biovil.pt"), "--cached", str(d / "cached.npz"), "--limit", "2",
             "--batch-size", "2"]
    j_verify.main(flags)
    ref = {}
    for line in capsys.readouterr().out.strip().splitlines():
        key, value = line.split(": ")
        ref[key] = value
    ours = t_verify.main([*flags, "--device", "cpu"])
    assert set(ours) == set(ref)
    assert ours["n"] == int(ref["n"]) == 2
    assert ours["labels_equal"] == (ref["labels_equal"] == "True")
    for key in ("max_abs_diff", "mean_abs_diff", "min_cosine"):
        assert_parity(f"verify_embeddings {key}", ours[key], float(ref[key]), EMB_ATOL)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_convert_weights_bundles_match_jax(reference_files, tmp_path):
    d = reference_files
    common = ["--biovil-checkpoint", str(d / "biovil.pt"),
              "--reference-image-adapter", str(d / "image_adapter.pt"),
              "--reference-text-adapter", str(d / "text_adapter.pt")]
    for flags, tag in ((["--cxr-bert-checkpoint", str(d / "cxr_bert.pt")], "ckpt"),
                       (["--cxr-bert-snapshot", str(d / "snapshot")], "snap")):
        j_convert.main([*common, *flags, "--out-dir", str(tmp_path / f"jax-{tag}")])
        t_convert.main([*common, *flags, "--out-dir", str(tmp_path / f"port-{tag}")])
        names = sorted(p.name for p in (tmp_path / f"jax-{tag}").iterdir())
        assert sorted(p.name for p in (tmp_path / f"port-{tag}").iterdir()) == names
        assert names == ["biovil_image.npz", "cxr_bert.npz", "image_adapter.npz",
                         "text_adapter.npz"]
        for name in names:
            ours, ours_meta = j_load_npz(str(tmp_path / f"port-{tag}" / name))
            ref, ref_meta = j_load_npz(str(tmp_path / f"jax-{tag}" / name))
            assert ours_meta == ref_meta, name
            a, b = _flat(ours), _flat(ref)
            assert a.keys() == b.keys(), name
            for k in b:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, k)
    # the port reads the bundle it wrote: the same image tower as the checkpoint
    model = tconv.load_biovil_image_checkpoint(str(d / "biovil.pt"))
    from incremental_multimodal_medical_learning_ii_torch.convert import load_biovil_npz

    loaded = load_biovil_npz(str(tmp_path / "port-ckpt" / "biovil_image.npz"))
    for (k, a), (_, b) in zip(model.state_dict().items(), loaded.state_dict().items()):
        assert torch.equal(a, b), k


def test_params_to_jax_inverts_params_from_jax(weights_tree):
    trees = {
        "biovil": (to_numpy_tree(weights_tree), None),
        "bert": (to_numpy_tree(jbert.init_cxr_bert(jax.random.PRNGKey(1), jbert.tiny_bert_dims())),
                 jbert.tiny_bert_dims()),
        "adapters": (to_numpy_tree(jadapters.AdapterPair("mlp", False, True, True)
                                   .init(jax.random.PRNGKey(2))), None),
        "dense shared": (to_numpy_tree(jadapters.AdapterPair("dense", True, True, True)
                                       .init(jax.random.PRNGKey(3))), None),
    }
    for name, (tree, dims) in trees.items():
        back = params_to_jax(params_from_jax(tree, dims))
        a, b = _flat(back), _flat(tree)
        assert a.keys() == b.keys(), name
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, k)
    with pytest.raises(ValueError, match="no JAX layout"):
        params_to_jax(torch.nn.Linear(2, 2))
