"""The port's figures through its entry points, on the CPU at toy size:
the drivers write the figures a JAX run with the same flags writes (image
tags, steps, height, width and colour space; the class-incremental
heatmaps' rows and columns), a folded run's PNGs are byte-equal to the
per-epoch path's, a resumed run's event file equals an uninterrupted
run's, ``analyze_prompts`` writes its three PNGs (also on four ranks);
and the three small public functions of the last slice against the JAX
package: ``DevicePreprocessPlan.prepare``, ``matmul_resize`` and
``convert_resnet50_state_dict``."""

import glob
import io
import os
from pathlib import Path

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

matplotlib.use("Agg")

from incremental_multimodal_medical_learning_ii_tpu.cli import class_incremental as j_cls  # noqa: E402
from incremental_multimodal_medical_learning_ii_tpu.cli import data_incremental as j_data  # noqa: E402
from incremental_multimodal_medical_learning_ii_tpu.cli import zero_joint_bounds as j_joint  # noqa: E402
from incremental_multimodal_medical_learning_ii_tpu.evaluation import plots as jplots  # noqa: E402
from incremental_multimodal_medical_learning_ii_torch.cli import analyze_prompts  # noqa: E402
from incremental_multimodal_medical_learning_ii_torch.cli import class_incremental as t_cls  # noqa: E402
from incremental_multimodal_medical_learning_ii_torch.cli import data_incremental as t_data  # noqa: E402
from incremental_multimodal_medical_learning_ii_torch.cli import zero_joint_bounds as t_joint  # noqa: E402
from incremental_multimodal_medical_learning_ii_torch.data.store import (  # noqa: E402
    EmbeddingDataset,
    synthetic_dataset,
)
from incremental_multimodal_medical_learning_ii_torch.engine import protocols as tprot  # noqa: E402
from incremental_multimodal_medical_learning_ii_torch.evaluation import plots as tplots  # noqa: E402
from incremental_multimodal_medical_learning_ii_torch.evaluation.tb import (  # noqa: E402
    read_images,
    read_scalars,
)
from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import (  # noqa: E402
    write_test_vocab,
)

from torch_port_helpers import one_torch_thread, reference_bert_state_dict  # noqa: E402,F401


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Train rows with single-positive and all-0 / all-1 labels (the t-SNE
    subsets' rows), val and test drawn like the drivers' synthetic data."""
    d = tmp_path_factory.mktemp("figure_data")
    rng = np.random.default_rng(7)
    dirs = rng.normal(size=(5, 128)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    labels = np.concatenate([np.tile(np.eye(5, dtype=np.float32), (8, 1)),
                             np.zeros((12, 5), np.float32), np.ones((12, 5), np.float32)])
    embs = labels @ dirs + 0.3 * rng.normal(size=(len(labels), 128)).astype(np.float32)
    EmbeddingDataset(embs.astype(np.float32), labels).save(d / "train.npz")
    for split, seed in (("val", 2), ("test", 3)):
        synthetic_dataset(48, seed=seed, class_directions=dirs).save(d / f"{split}.npz")
    return d


def _events(log_dir: Path):
    """(run dir, [(kind, tag, step, payload), ...]) of the one event file
    under ``log_dir``: scalars with their value, images with (height,
    width, colorspace, png)."""
    files = sorted(glob.glob(str(log_dir / "**" / "events.out.tfevents.*"), recursive=True))
    assert len(files) == 1, files
    scalars = [("scalar", t, s, v) for t, s, v in read_scalars(files[0])]
    images = [("image", t, s, (im["height"], im["width"], im["colorspace"], im["png"]))
              for t, s, im in read_images(files[0])]
    return os.path.relpath(os.path.dirname(files[0]), log_dir), scalars, images


def _heatmap_rows(monkeypatch, module):
    calls = []
    orig = module.heatmap_figure

    def capture(data, rows, cols, *a, **k):
        calls.append((list(rows), list(cols), np.shape(data)))
        return orig(data, rows, cols, *a, **k)

    monkeypatch.setattr(module, "heatmap_figure", capture)
    return calls


RUNS = {
    "joint --tsne-plots": (j_joint, t_joint, ["--epochs", "1", "--tsne-plots"]),
    "data-inc --fused-unit final": (j_data, t_data, ["--parts", "3", "--epochs", "1",
                                                     "--fused-unit", "--plot-figures", "final"]),
    "class-pos, tasks 4 2 0 1 3": (j_cls, t_cls, ["--epochs", "1", "--mode", "class-pos",
                                                  "--no-more-labels", "--tasks-order", "4", "2",
                                                  "0", "1", "3", "--plot-figures", "final"]),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_driver_figures_match_jax(tmp_path, monkeypatch, data_dir, run):
    """The JAX run's flags (no ``--plot-figures`` but where the JAX run
    gives one): the same image tags at the same steps in the same order,
    each image of the JAX figure's height, width and colour space; the
    heatmaps' row and column labels (class-incremental rows follow the
    tasks trained, tests/test_tb_figures.py:119)."""
    jmod, tmod, flags = RUNS[run]
    common = ["--data-dir", str(data_dir), "--batch-size", "32", *flags]
    jrows = _heatmap_rows(monkeypatch, jplots)
    jmod.main([*common, "--log-dir", str(tmp_path / "jax"), "--mesh-devices", "1"])
    trows = _heatmap_rows(monkeypatch, tplots)
    tmod.main([*common, "--log-dir", str(tmp_path / "port"), "--device", "cpu"])
    jname, _, jimages = _events(tmp_path / "jax")
    tname, _, timages = _events(tmp_path / "port")
    assert tname == jname
    ref = [(tag, step, p[:3]) for _, tag, step, p in jimages]
    ours = [(tag, step, p[:3]) for _, tag, step, p in timages]
    assert len(ref) > 0 and ours == ref
    assert trows == jrows and len(jrows) > 0
    for *_, (height, width, colorspace, png) in timages:
        with Image.open(io.BytesIO(png)) as im:
            assert im.size == (width, height) and colorspace == 3 and im.mode == "RGB"


FOLDS = {
    "joint": (t_joint, ["--epochs", "2", "--tsne-plots"]),
    "data-inc": (t_data, ["--parts", "3", "--epochs", "2", "--continual-learning", "myCL"]),
}


@pytest.mark.parametrize("driver", list(FOLDS))
def test_folded_run_figures_are_byte_equal_to_the_per_epoch_paths(tmp_path, data_dir, driver):
    """``--fused-unit`` folds the whole run into one call, then restores each
    epoch's or unit's own state before its evals: every figure's PNG equals
    the per-epoch path's, byte for byte."""
    tmod, flags = FOLDS[driver]
    common = ["--data-dir", str(data_dir), "--batch-size", "32", "--lr", "1e-3", *flags,
              "--device", "cpu"]
    tmod.main([*common, "--log-dir", str(tmp_path / "per-epoch")])
    tmod.main([*common, "--fused-unit", "--log-dir", str(tmp_path / "fused")])
    _, ref_scalars, ref = _events(tmp_path / "per-epoch")
    _, scalars, ours = _events(tmp_path / "fused")
    assert [(t, s) for _, t, s, _ in scalars] == [(t, s) for _, t, s, _ in ref_scalars]
    assert len(ref) > 0 and ours == ref


def test_resumed_run_event_file_equals_an_uninterrupted_run(tmp_path, data_dir):
    """A data-incremental run with figures that crashes in its third part and
    resumes writes, across its two attempts, the uninterrupted run's events:
    every scalar and every figure (tag, step, PNG bytes), in order."""
    bundle = tprot.DataBundle(*(EmbeddingDataset.load(data_dir / f"{s}.npz")
                                for s in ("train", "val", "test"))).with_tsne_subsets()
    from incremental_multimodal_medical_learning_ii_torch.text.bank import (
        build_prompt_bank,
        synthetic_encode_fn,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
        data_incremental_config,
    )

    cfg = data_incremental_config(batch_size=32, eval_batch_size=32, epochs=1, parts=3, lr=1e-3)
    assert cfg.plot_figures == "reference"
    bank = build_prompt_bank(synthetic_encode_fn(), create_prompts(CHEXPERT_COMPETITION_TASKS),
                             CHEXPERT_COMPETITION_TASKS)
    tprot.run_data_incremental(cfg, bundle, bank, log_dir=str(tmp_path / "full"), device="cpu")
    orig_test = tprot.Trainer.test

    def crash_in_part_three(self, dataset, epoch, *a, **k):
        if epoch == 3:
            raise RuntimeError("boom")
        return orig_test(self, dataset, epoch, *a, **k)

    tprot.Trainer.test = crash_in_part_three
    try:
        with pytest.raises(RuntimeError, match="boom"):
            tprot.run_data_incremental(cfg, bundle, bank, log_dir=str(tmp_path / "resumed"),
                                       device="cpu")
    finally:
        tprot.Trainer.test = orig_test
    tprot.run_data_incremental(cfg, bundle, bank, log_dir=str(tmp_path / "resumed"),
                               device="cpu", resume=True)
    merged = []
    for f in sorted((tmp_path / "resumed").rglob("events.out.tfevents.*")):
        merged += [(t, s, v) for t, s, v in read_scalars(f)]
        merged += [(t, s, im["png"]) for t, s, im in read_images(f)]
    _, scalars, images = _events(tmp_path / "full")
    full = [(t, s, v) for _, t, s, v in scalars] + [(t, s, p[3]) for _, t, s, p in images]
    # scalars then images of each attempt: compare each kind in file order
    assert [e for e in merged if isinstance(e[2], float)] == [e for e in full
                                                              if isinstance(e[2], float)]
    assert [e for e in merged if isinstance(e[2], bytes)] == [e for e in full
                                                              if isinstance(e[2], bytes)]
    assert any(t.startswith("tsne-chexpert/") for t, _, p in full if isinstance(p, bytes))


def test_analyze_prompts_cli(tmp_path):
    """As tests/test_extras.py:99,108 check the JAX CLI: the three PNGs, and
    --partition needs a checkpoint."""
    paths = analyze_prompts.main(["--out-dir", str(tmp_path), "--device", "cpu"])
    assert [p.name for p in paths] == ["cosine_similarity_heat_map.png",
                                       "pca_multiple_prompts.png", "tsne_multiple_prompts.png"]
    for p in paths:
        with Image.open(p) as im:
            assert im.format == "PNG" and im.size == (960, 720)  # savefig(dpi=150)
    with pytest.raises(SystemExit, match="partition needs"):
        analyze_prompts.main(["--out-dir", str(tmp_path), "--partition", "sp", "--device", "cpu"])


def test_analyze_prompts_cli_partitioned(tmp_path):
    """--partition sp through the CLI on four CPU ranks (2 data x 2 seq):
    a CXR-BERT state dict -> the converter -> ring attention -> the figures,
    the same three PNGs as the one-device run's heatmap (same bank, to the
    SP encode's 5e-5)."""
    vocab = write_test_vocab(tmp_path / "vocab.txt")
    sd = reference_bert_state_dict(seed=1, vocab=len(vocab.read_text().splitlines()), pos=48)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "bert.pt")
    flags = ["--cxr-bert-checkpoint", str(tmp_path / "bert.pt"), "--cxr-bert-vocab", str(vocab),
             "--device", "cpu"]
    paths = analyze_prompts.main(["--out-dir", str(tmp_path / "sp"), *flags, "--partition", "sp",
                                  "--partition-size", "2", "--mesh-devices", "4"])
    assert all(p.exists() for p in paths) and len(paths) == 3
    one = analyze_prompts.main(["--out-dir", str(tmp_path / "one"), *flags])
    for a, b in zip(paths, one):
        with Image.open(a) as x, Image.open(b) as y:
            assert x.size == y.size == (960, 720)


# ----------------------------------------------------------------------
# the three small public functions
# ----------------------------------------------------------------------
def test_device_preprocess_plan_prepare_matches_jax():
    """At tests/test_preprocess.py's shapes: the same padded buffer and
    matrices bit for bit, and the device path's output within one uint8
    level of the JAX package's (two float32 GEMM orders at .5 ties)."""
    from incremental_multimodal_medical_learning_ii_tpu.ops import preprocess as jpre
    from incremental_multimodal_medical_learning_ii_torch.ops import preprocess as tpre

    rng = np.random.default_rng(0)
    imgs = [(rng.random(hw) * 255).astype(np.uint8) for hw in ((200, 160), (120, 300), (96, 96))]
    for kw in (dict(size=96, pad_to=320), dict(size=128, crop=96, pad_to=320)):
        ref = jpre.DevicePreprocessPlan(**kw).prepare(imgs)
        ours = tpre.DevicePreprocessPlan(**kw).prepare(imgs)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        out = tpre.preprocess_device(*(torch.from_numpy(a) for a in ours)).numpy()
        ref_out = np.asarray(jpre.preprocess_device(*(jnp.asarray(a) for a in ref)))
        assert np.abs(out - ref_out).max() <= 1.0 / 255.0 + 1e-6
    with pytest.raises(ValueError, match="exceeds pad_to"):
        tpre.DevicePreprocessPlan(size=96, pad_to=100).prepare(imgs)


@pytest.mark.parametrize("hw", [(200, 160), (97, 303), (64, 64), (50, 70)])
def test_matmul_resize_matches_jax(hw):
    from incremental_multimodal_medical_learning_ii_tpu.ops import resize as jres
    from incremental_multimodal_medical_learning_ii_torch.ops import resize as tres

    h, w = hw
    img = (np.random.default_rng(1).random(hw) * 255).astype(np.uint8)
    out_h, out_w = tres.resize_shape_for_smaller_edge(h, w, 96)
    w_h, w_w = tres.resize_matrix(h, out_h), tres.resize_matrix(w, out_w)
    for rounding in (True, False):
        ours = tres.matmul_resize(torch.from_numpy(img), torch.from_numpy(w_h),
                                  torch.from_numpy(w_w), round_uint8=rounding).numpy()
        ref = np.asarray(jres.matmul_resize(jnp.asarray(img), jnp.asarray(w_h), jnp.asarray(w_w),
                                            round_uint8=rounding))
        assert ours.shape == ref.shape == (out_h, out_w)
        assert np.abs(ours - ref).max() <= (1.0 if rounding else 1e-3)


def test_convert_resnet50_state_dict_matches_jax():
    """A torchvision ResNet-50 state dict under a prefix (and without one):
    the port's module holds the JAX converter's tree, and the BioViL
    converter builds its trunk through it."""
    from incremental_multimodal_medical_learning_ii_tpu.models import convert as jconv
    from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
    from incremental_multimodal_medical_learning_ii_torch.models import convert as tconv
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        init_biovil_image_model,
    )

    model = init_biovil_image_model(torch.Generator().manual_seed(3))
    trunk = {}
    for k, v in model.encoder.state_dict().items():
        parts = k.replace("downsample_conv", "downsample.0").replace(
            "downsample_bn", "downsample.1").split(".")
        parts[-1] = {"scale": "weight", "mean": "running_mean", "var": "running_var"}.get(
            parts[-1], parts[-1])
        trunk[".".join(parts)] = v.numpy().copy()
    for prefix in ("", "encoder.encoder."):
        sd = {prefix + k: v for k, v in trunk.items()}
        ours = tconv.convert_resnet50_state_dict(sd, prefix=prefix)
        ref = params_from_jax(jconv.convert_resnet50_state_dict(sd, prefix=prefix))
        assert tconv.compare_params(ours, ref, verbose=False) == []
        assert tconv.compare_params(ours, model.encoder, verbose=False) == []


# ----------------------------------------------------------------------
# the figures on mesh ranks
# ----------------------------------------------------------------------
MESH_AUROC_ATOL = 1e-4  # tests/test_torch_cli_mesh.py's bar for a metric of two ranks


def test_driver_figures_on_two_ranks_match_jax(tmp_path, monkeypatch, data_dir):
    """``zero_joint_bounds --mesh-devices 2 --plot-figures reference`` on two
    gloo ranks against the JAX CLI on ``create_mesh(2)``, from the JAX init
    and the same epoch orders: rank 0 alone writes, and its image events
    are the JAX run's (tags, steps, height, width, colour space, in
    order); every heatmap's rows and columns equal, its data within the
    mesh CLI test's AUROC bar (F1 and AUROC per class and epoch, the
    prompts' cosines)."""
    import jax

    from incremental_multimodal_medical_learning_ii_tpu.engine.trainer import Trainer as JTrainer
    from incremental_multimodal_medical_learning_ii_tpu.models.adapters import AdapterPair as JPair
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import spawn_ranks

    from torch_port_helpers import (
        assert_parity,
        figures_driver_on_rank,
        mesh_orders,
        to_numpy_tree,
    )

    tree = to_numpy_tree(JPair(kind="mlp", shared=False, use_image=True,
                               use_text=True).init(jax.random.PRNGKey(27)))
    common = ["--data-dir", str(data_dir), "--batch-size", "32", "--epochs", "2",
              "--plot-figures", "reference", "--mesh-devices", "2"]
    ranks = spawn_ranks(figures_driver_on_rank, 2, "cpu", "zero_joint_bounds",
                        [*common, "--device", "cpu", "--log-dir", str(tmp_path / "port")], tree)
    (out0, params0, heat0, writes0), (out1, params1, heat1, writes1) = ranks
    assert writes0 and not writes1
    assert out0 == out1
    for k in params0:
        np.testing.assert_array_equal(params0[k], params1[k], err_msg=k)
    init = JTrainer.__init__

    def trainer_init(self, *a, **k):
        init(self, *a, **k)
        self.permutation_source = mesh_orders

    monkeypatch.setattr(JTrainer, "__init__", trainer_init)
    jheat = []
    draw = jplots.heatmap_figure

    def capture(data, rows, cols, *a, **k):
        jheat.append((list(rows), list(cols), np.asarray(data, np.float64)))
        return draw(data, rows, cols, *a, **k)

    monkeypatch.setattr(jplots, "heatmap_figure", capture)
    j_joint.main([*common, "--log-dir", str(tmp_path / "jax")])
    jname, _, jimages = _events(tmp_path / "jax")
    tname, _, timages = _events(tmp_path / "port")
    assert tname == jname
    ref = [(tag, step, p[:3]) for _, tag, step, p in jimages]
    ours = [(tag, step, p[:3]) for _, tag, step, p in timages]
    assert len(ref) > 0 and ours == ref
    assert len(heat0) == len(jheat) > 0
    for i, ((rows, cols, data), (jrows, jcols, jdata)) in enumerate(zip(heat0, jheat)):
        assert (rows, cols) == (jrows, jcols) and data.shape == jdata.shape
        assert_parity(f"figures on two ranks, heatmap {i}", data, jdata, MESH_AUROC_ATOL)
