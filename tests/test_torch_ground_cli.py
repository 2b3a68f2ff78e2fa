"""The port's ``cli/ground.py`` and ``cli/dataset_stats.py`` against the
JAX package's CLIs on the CPU: the same ``--biovil-npz`` bundle and the
same small ``--cxr-bert-checkpoint`` + vocab give the same printed score
and ``--save-map`` array; the same CSV gives the same printout; the
plotting flags write decodable PNGs of the JAX figures' canvas sizes."""

import re

import numpy as np
import pytest
import torch
from PIL import Image

from incremental_multimodal_medical_learning_ii_tpu.cli import dataset_stats as j_stats
from incremental_multimodal_medical_learning_ii_tpu.cli import ground as j_ground
from incremental_multimodal_medical_learning_ii_tpu.utils.serialization import save_params_npz
from incremental_multimodal_medical_learning_ii_torch.cli import dataset_stats as t_stats
from incremental_multimodal_medical_learning_ii_torch.cli import ground as t_ground
from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import write_test_vocab
from incremental_multimodal_medical_learning_ii_torch.utils.config import (
    CHEXPERT_COMPETITION_TASKS,
)

from torch_port_helpers import (  # noqa: F401
    biovil_numpy_params_from_port,
    one_torch_thread,
    reference_bert_state_dict,
)

MAP_ATOL = 2e-4  # the ResNet bar
SCORE_ATOL = 2e-4  # the printed score has 4 decimals: 1e-4 of rounding on top of the 1e-4 bar


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """A BioViL bundle, a CXR-BERT state dict with its vocab, and a PNG."""
    d = tmp_path_factory.mktemp("ground")
    save_params_npz(str(d / "biovil.npz"), biovil_numpy_params_from_port(seed=0, bn_seed=3))
    vocab = write_test_vocab(d / "vocab.txt")
    n_vocab = len(vocab.read_text().splitlines())
    sd = reference_bert_state_dict(seed=1, vocab=n_vocab, pos=48)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, d / "bert.pt")
    pixels = np.random.default_rng(6).integers(0, 256, size=(64, 78), dtype=np.uint8)
    Image.fromarray(pixels, mode="L").save(d / "cxr.png")
    return d


def _score(out: str) -> float:
    return float(re.search(r"similarity score: (\S+)", out).group(1))


def test_ground_cli_matches_jax(weight_files, capsys):
    d = weight_files
    flags = ["--image", str(d / "cxr.png"), "--query", "There is no pleural effusion",
             "--biovil-npz", str(d / "biovil.npz"), "--cxr-bert-checkpoint", str(d / "bert.pt"),
             "--cxr-bert-vocab", str(d / "vocab.txt"), "--resize", "72", "--crop", "64"]
    j_ground.main([*flags, "--save-map", str(d / "jax.npy")])
    ref_out = capsys.readouterr().out
    score, sim_map = t_ground.main([*flags, "--save-map", str(d / "port.npy"), "--device", "cpu"])
    out = capsys.readouterr().out
    ours, ref = np.load(d / "port.npy"), np.load(d / "jax.npy")
    np.testing.assert_array_equal(ours, sim_map)
    assert ours.shape == ref.shape == (64, 78)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    ok = ~np.isnan(ref)
    err = float(np.abs(ours[ok] - ref[ok]).max())
    print(f"PARITY ground CLI map: max |port - jax| = {err:.3e} (atol {MAP_ATOL:g}); "
          f"score {_score(out)} vs {_score(ref_out)}")
    assert err <= MAP_ATOL
    assert abs(_score(out) - _score(ref_out)) <= SCORE_ATOL
    assert abs(score - _score(ref_out)) <= SCORE_ATOL
    assert out.count("\n") == ref_out.count("\n")
    # --random-weights: random BioViL and the synthetic text encoder
    score, sim_map = t_ground.main([*flags[:4], "--random-weights", "--resize", "72", "--crop",
                                    "64", "--device", "cpu"])
    assert np.isfinite(score) and sim_map.shape == (64, 78)


def test_ground_cli_refuses(weight_files, monkeypatch):
    d = weight_files
    base = ["--image", str(d / "cxr.png"), "--query", "edema", "--biovil-npz",
            str(d / "biovil.npz"), "--device", "cpu"]
    # --out is ported: the three-panel figure on its 1500 x 600 canvas
    t_ground.main([*base, "--random-weights", "--out", str(d / "fig.png")])
    with Image.open(d / "fig.png") as fig:
        assert fig.format == "PNG" and fig.size == (1500, 600) and fig.mode == "RGB"
    with pytest.raises(SystemExit, match="cxr-bert"):
        t_ground.main(base)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_ground.main(base[:-2] + ["--random-weights"])


@pytest.fixture(scope="module")
def label_csv(tmp_path_factory):
    rng = np.random.default_rng(9)
    path = tmp_path_factory.mktemp("stats") / "labels.csv"
    header = ["Path", "Sex", *CHEXPERT_COMPETITION_TASKS]
    rows = [[f"patient{i:05d}/view1_frontal.jpg", "F" if i % 2 else "M",
             *(str(float(v)) for v in rng.choice([0, 1, 1, -1], size=5, p=[0.6, 0.2, 0.1, 0.1]))]
            for i in range(40)]
    path.write_text("\n".join(",".join(r) for r in [header, *rows]) + "\n")
    return path


def test_dataset_stats_cli_matches_jax(label_csv, tmp_path, capsys):
    j_stats.main(["--csv", str(label_csv)])
    ref = capsys.readouterr().out
    t_stats.main(["--csv", str(label_csv)])
    ours = capsys.readouterr().out
    assert "distinct patterns over 40 rows" in ours
    assert ours == ref
    empty = tmp_path / "empty.csv"
    empty.write_text(",".join(["Path", *CHEXPERT_COMPETITION_TASKS]) + "\n")
    for main in (j_stats.main, t_stats.main):
        main(["--csv", str(empty)])
    jout, tout = capsys.readouterr().out.splitlines()
    assert jout == tout == "0 rows — nothing to report"
    # --patterns-png is ported: the JAX chart's bars and labels, 800 x 600
    import matplotlib

    matplotlib.use("Agg")
    from incremental_multimodal_medical_learning_ii_tpu.evaluation import plots as jplots
    from incremental_multimodal_medical_learning_ii_tpu.data.manifest import ChexpertManifest
    from incremental_multimodal_medical_learning_ii_torch.evaluation import plots as tplots

    t_stats.main(["--csv", str(label_csv), "--patterns-png", str(tmp_path / "p.png"),
                  "--title", "Test Pattern Frequencies"])
    assert "wrote" in capsys.readouterr().out
    with Image.open(tmp_path / "p.png") as png:
        assert png.format == "PNG" and png.size == (800, 600)
    m = ChexpertManifest.from_csv(str(label_csv))
    ref = jplots.label_pattern_frequency_figure(m.label_pattern_counts(), m.label_names)
    ours = tplots.label_pattern_frequency_figure(m.label_pattern_counts(), m.label_names)
    ax = ref.axes[0]
    assert ours.data["labels"] == [t.get_text() for t in ax.get_xticklabels()]
    np.testing.assert_array_equal(ours.data["heights"], [b.get_height() for b in ax.patches])
