"""Port evaluation/plots.py, evaluation/projection.py and the curve points
of evaluation/metrics.py against the JAX package's matplotlib figures and
scikit-learn (both installed here, absent on the card's machine), at toy
size on the CPU.

Bars: curve points, AP, heatmap matrices, labels, ranges and annotation
strings exactly; PCA 1e-6; exact t-SNE's P and objective 1e-12 and its
first five iterations 1e-10 of sklearn's exact method (from there on the
iteration is chaotic: rounding differences of 1e-14 grow to the scale of
the embedding within 50 iterations and runs end in different local
minima, so whole runs are held by the best KL of eight starts, <= 1.05 x
sklearn exact's), and the final KL <= 1.05 x that of sklearn's
Barnes-Hut embedding, both scored by the exact objective."""

import io
import warnings

import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial.distance import squareform
from sklearn import metrics as skm
from sklearn.decomposition import PCA
from sklearn.manifold import TSNE
from sklearn.manifold._t_sne import _gradient_descent, _joint_probabilities, _kl_divergence
from sklearn.metrics import pairwise_distances

matplotlib.use("Agg")

from incremental_multimodal_medical_learning_ii_tpu.evaluation import plots as jplots  # noqa: E402
from incremental_multimodal_medical_learning_ii_torch.evaluation import metrics as tmetrics  # noqa: E402
from incremental_multimodal_medical_learning_ii_torch.evaluation import plots as tplots  # noqa: E402
from incremental_multimodal_medical_learning_ii_torch.evaluation import projection  # noqa: E402
from incremental_multimodal_medical_learning_ii_torch.utils.config import (  # noqa: E402
    CHEXPERT_COMPETITION_TASKS,
)

from torch_port_helpers import one_torch_thread  # noqa: E402,F401

PCA_ATOL = 1e-6
TSNE_STEP_RTOL = 1e-10  # the first iterations, of the largest coordinate
TSNE_KL_RATIO = 1.05


def _curve_cases():
    rng = np.random.default_rng(3)
    ties = np.round(rng.random(300) * 4) / 4  # five distinct scores
    one_pos = np.zeros(40)
    one_pos[17] = 1
    return {
        "many-ties": ((rng.random(300) < 0.3).astype(np.float32), ties.astype(np.float32)),
        "one-positive": (one_pos, rng.random(40).astype(np.float32)),
        "one-positive-tied": (one_pos, np.round(rng.random(40) * 2) / 2),
        "all-tied": ((rng.random(50) < 0.5).astype(np.float64), np.full(50, 0.5)),
        "distinct": ((rng.random(500) < 0.1).astype(np.float32), rng.random(500)),
    }


@pytest.mark.parametrize("case", list(_curve_cases()))
def test_curve_points_equal_sklearn(case):
    """ROC points (drop_intermediate, the leading (0, 0, inf)), PR points
    (the closing (1, 0)), thresholds and AP: equal to sklearn's, exactly."""
    y, s = _curve_cases()[case]
    for ours, ref in ((tmetrics.roc_curve(y, s), skm.roc_curve(y, s)),
                      (tmetrics.precision_recall_curve(y, s), skm.precision_recall_curve(y, s))):
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert tmetrics.average_precision_score(y, s) == skm.average_precision_score(y, s)
    assert tmetrics._binary_roc_auc(y, s) == skm.roc_auc_score(y, s)


def _jax_heatmap(fig):
    """What the JAX matplotlib heatmap draws: the image's array and range,
    tick labels, annotation texts and colours, colour bar label."""
    ax = fig.axes[0]
    im = ax.images[0]
    texts = [(t.get_text(), matplotlib.colors.to_hex(t.get_color())) for t in ax.texts]
    return dict(matrix=np.asarray(im.get_array()), vmin=im.norm.vmin, vmax=im.norm.vmax,
                cols=[t.get_text() for t in ax.get_xticklabels()],
                rows=[t.get_text() for t in ax.get_yticklabels()], texts=texts,
                cbarlabel=fig.axes[1].get_ylabel())


def _port_heatmap(fig):
    d = fig.data
    return dict(matrix=d["matrix"], vmin=d["vmin"], vmax=d["vmax"], cols=d["col_labels"],
                rows=d["row_labels"],
                texts=[(t, matplotlib.colors.to_hex(c)) for row in d["annotations"] for t, c in row],
                cbarlabel=d["cbarlabel"])


def _assert_same_heatmap(ours, ref):
    np.testing.assert_array_equal(ours["matrix"], ref["matrix"])
    assert {k: v for k, v in ours.items() if k != "matrix"} == \
        {k: v for k, v in ref.items() if k != "matrix"}


@pytest.mark.parametrize("metric", ["F1", "AUROC", "COS"])
def test_heatmap_data_equals_jax(metric):
    rng = np.random.default_rng(5)
    data = rng.random((4, 5)) * (2 if metric == "COS" else 1) - (1 if metric == "COS" else 0)
    data[1, 2] = np.nan  # a class with one label value: NaN AUROC
    rows, cols = ["1", "2", "3", "4"], list(CHEXPERT_COMPETITION_TASKS)
    ref = jplots.heatmap_figure(data, rows, cols, f"{metric} score", metric)
    ours = tplots.heatmap_figure(data, rows, cols, f"{metric} score", metric)
    _assert_same_heatmap(_port_heatmap(ours), _jax_heatmap(ref))
    assert ours.size == tuple(ref.canvas.get_width_height()) == (640, 480)
    for mod in (jplots, tplots):
        with pytest.raises(ValueError, match="unknown heatmap metric"):
            mod.heatmap_figure(data, rows, cols, "x", "ACC")


@pytest.mark.parametrize("negatives", [True, False], ids=["pos-neg", "pos-only"])
def test_prompt_cosine_heatmap_equals_jax(negatives):
    rng = np.random.default_rng(6)
    pos = rng.normal(size=(5, 128)).astype(np.float32)
    neg = rng.normal(size=(5, 128)).astype(np.float32) if negatives else None
    pos[3] = 0.0  # the 1e-8 norm floor
    ref = jplots.prompt_cosine_heatmap_figure(pos, neg, single_prompt=False)
    ours = tplots.prompt_cosine_heatmap_figure(torch.from_numpy(pos),
                                               None if neg is None else torch.from_numpy(neg),
                                               single_prompt=False)
    _assert_same_heatmap(_port_heatmap(ours), _jax_heatmap(ref))
    assert ours.data["matrix"].shape == ((10, 10) if negatives else (5, 5))


def test_curve_and_scatter_figures_equal_jax():
    rng = np.random.default_rng(7)
    y = (rng.random(80) < 0.4).astype(np.float32)
    s = np.round(rng.random(80) * 8) / 8
    for name in ("roc_curve_figure", "pr_curve_figure"):
        ref, ours = getattr(jplots, name)(y, s, 2), getattr(tplots, name)(y, s, 2)
        ax = ref.axes[0]
        np.testing.assert_array_equal(np.stack([ours.data["x"], ours.data["y"]], 1),
                                      ax.lines[0].get_xydata())
        assert ours.data["legend"] == [t.get_text() for t in ax.get_legend().get_texts()]
        assert (ours.data["title"], ours.data["xlabel"], ours.data["ylabel"]) == (
            ax.get_title(), ax.get_xlabel(), ax.get_ylabel())
    values = np.array([0.9, 0.25, np.nan, 0.5, 1.0])
    ref, ours = jplots.class_scatter_figure(values, "Recall"), tplots.class_scatter_figure(values,
                                                                                           "Recall")
    ax = ref.axes[0]
    np.testing.assert_array_equal(np.stack([ours.data["x"], ours.data["y"]], 1),
                                  np.asarray(ax.collections[0].get_offsets()))
    assert ours.data["ylim"] == ax.get_ylim()
    assert (ours.data["title"], ours.data["xlabel"], ours.data["ylabel"]) == (
        ax.get_title(), ax.get_xlabel(), ax.get_ylabel())
    # a column with one label value: NaN rates and "AUC = nan" in both
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jplots.roc_curve_figure(np.zeros(5), np.arange(5.0), 0)
    ours = tplots.roc_curve_figure(np.zeros(5), np.arange(5.0), 0)
    np.testing.assert_array_equal(np.stack([ours.data["x"], ours.data["y"]], 1),
                                  ref.axes[0].lines[0].get_xydata())
    assert ours.data["legend"] == [t.get_text() for t in ref.axes[0].get_legend().get_texts()]


@pytest.mark.parametrize("shape,dtype", [((10, 128), np.float32), ((60, 128), np.float64),
                                         ((1000, 128), np.float32)])
def test_pca_matches_sklearn(shape, dtype):
    """The port computes PCA in float64 (sklearn's float32 path carries
    ~1e-5 of its own error at these scales): held against sklearn's PCA of
    the same values in float64."""
    x = np.random.default_rng(8).normal(size=shape).astype(dtype)
    ref = PCA(n_components=2, svd_solver="full").fit_transform(x.astype(np.float64))
    ours = projection.pca_2d(torch.from_numpy(x)).numpy()
    err = float(np.abs(ours - ref).max())
    print(f"PARITY pca {shape} {np.dtype(dtype).name}: {err:.3e} (atol {PCA_ATOL:g})")
    assert err <= PCA_ATOL


def _kl_of_embedding(x, y):
    """The exact t-SNE objective KL(P || Q) of any embedding ``y`` of the
    rows ``x`` (Barnes-Hut's too), on one scale."""
    p = projection.joint_probabilities(torch.from_numpy(x), projection.perplexity_for(len(x)))
    return float(projection.kl_divergence_and_gradient(torch.as_tensor(y, dtype=torch.float64),
                                                       p)[0])


def _clusters(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 128))
    x[: n // 2] += 2.0 * rng.normal(size=(1, 128))
    return x


def _sklearn_init(x):
    """sklearn's own start: its PCA (randomized above 500 rows) scaled to a
    first-column std of 1e-4, cast through float32 as sklearn casts it."""
    y0 = PCA(n_components=2, random_state=27).fit_transform(x).astype(np.float32)
    return (y0 / np.std(y0[:, 0]) * 1e-4).astype(np.float64)


@pytest.mark.parametrize("n", [10, 60])
def test_tsne_matches_sklearn_exact(n):
    x = _clusters(n, n)
    perplexity = projection.perplexity_for(n)
    sqd = pairwise_distances(x, metric="cosine") ** 2
    p_ref = _joint_probabilities(sqd, perplexity, 0)
    p = projection.joint_probabilities(torch.from_numpy(x), perplexity)
    assert float((p - torch.from_numpy(squareform(p_ref))).abs().max()) <= 1e-12 * p_ref.max()
    y = np.random.default_rng(1).normal(size=(n, 2))
    kl_ref, g_ref = _kl_divergence(y.ravel(), p_ref, 1, n, 2)
    kl, g = projection.kl_divergence_and_gradient(torch.from_numpy(y), p)
    assert abs(float(kl) - kl_ref) <= 1e-12 * abs(kl_ref)
    assert float((g - torch.from_numpy(g_ref.reshape(n, 2))).abs().max()) <= 1e-12 * abs(g_ref).max()
    y0 = _sklearn_init(x)
    lr = max(n / 12 / 4, 50)
    ref, _, _ = _gradient_descent(_kl_divergence, y0.ravel(), 0, 5, n_iter_check=50,
                                  n_iter_without_progress=250, momentum=0.5, learning_rate=lr,
                                  args=[p_ref * 12.0, 1, n, 2])
    ours, _, _ = projection._descend(torch.from_numpy(y0), p * 12.0, 0, 5, 0.5, lr, 250)
    ref = ref.reshape(n, 2)
    step_err = float(np.abs(ours.numpy() - ref).max() / np.abs(ref).max())
    assert step_err <= TSNE_STEP_RTOL
    # whole runs: from sklearn's own start with 1e-9 relative jitter (eight
    # starts, as rounding alone sends runs to different local minima), the
    # best KL each method reaches
    ours, ref = [], []
    for k in range(8):
        start = y0 * (1 + 1e-9 * np.random.default_rng(k).normal(size=y0.shape))
        run = projection.tsne(torch.from_numpy(x), init=torch.from_numpy(start))
        assert run.embedding.shape == (n, 2) and torch.isfinite(run.embedding).all()
        ours.append(run.kl_divergence)
        ref.append(TSNE(n_components=2, metric="cosine", init=start.copy(), learning_rate="auto",
                        perplexity=perplexity, method="exact").fit(x).kl_divergence_)
    ratio = min(ours) / min(ref)
    print(f"PARITY tsne exact n={n}: 5 steps {step_err:.2e} (rtol {TSNE_STEP_RTOL:g}); best KL of "
          f"8 starts {min(ours):.5f} vs sklearn exact {min(ref):.5f} (ratio {ratio:.4f}, bar "
          f"{TSNE_KL_RATIO}); means {np.mean(ours):.5f} / {np.mean(ref):.5f}")
    assert ratio <= TSNE_KL_RATIO


@pytest.mark.parametrize("n", [10, 60, 200])
def test_tsne_kl_within_barnes_hut(n):
    """The port's default run (exact PCA start) reaches a KL within 1.05 x
    that of sklearn's default Barnes-Hut embedding (the JAX figures'),
    both scored by the exact objective."""
    x = _clusters(n, 100 + n).astype(np.float32)
    bh = TSNE(n_components=2, metric="cosine", init="pca", learning_rate="auto",
              perplexity=projection.perplexity_for(n), random_state=27).fit_transform(x)
    kl_bh = _kl_of_embedding(x, bh)
    run = projection.tsne(torch.from_numpy(x))
    print(f"PARITY tsne vs Barnes-Hut n={n}: KL {run.kl_divergence:.5f} vs {kl_bh:.5f} "
          f"(ratio {run.kl_divergence / kl_bh:.4f}, bar {TSNE_KL_RATIO})")
    assert run.kl_divergence <= TSNE_KL_RATIO * kl_bh


def test_projection_figures_and_embedding_tsne_match_jax_data():
    rng = np.random.default_rng(9)
    pos, neg = rng.normal(size=(5, 128)).astype(np.float32), rng.normal(size=(5, 128)).astype(
        np.float32)
    pca, tsne = tplots.prompt_projection_figures(torch.from_numpy(pos), torch.from_numpy(neg))
    jpca, jtsne = jplots.prompt_projection_figures(pos, neg)
    ref_pca = PCA(n_components=2).fit_transform(np.concatenate([pos, neg])[
        np.arange(10).reshape(2, 5).T.ravel()].astype(np.float64))
    assert float(np.abs(pca.data["coords"] - ref_pca).max()) <= PCA_ATOL
    for ours, ref in ((pca, jpca), (tsne, jtsne)):
        ax = ref.axes[0]
        got = [matplotlib.colors.to_hex(c) for c in ours.data["colors"]]
        want = [matplotlib.colors.to_hex(c.get_facecolor()[0]) for c in ax.collections]
        assert got == want and ours.data["title"] == ax.get_title()
        assert ours.data["legend"] == [t.get_text() for t in ax.get_legend().get_texts()]
        assert ours.data["markers"] == ["o", "v"] * 5
    labels = np.concatenate([np.eye(5, dtype=np.float32)[[0, 1, 2, 3, 4, 0, 1]],
                             np.zeros((2, 5), np.float32), np.ones((2, 5), np.float32)])
    embs = rng.normal(size=(len(labels), 128)).astype(np.float32)
    for kind, rows in (("multiclass", slice(0, 7)), ("sani-malati", slice(7, 11))):
        ours = tplots.embedding_tsne_figure(torch.from_numpy(embs[rows]), labels[rows], kind)
        ref = jplots.embedding_tsne_figure(embs[rows], labels[rows], kind)
        ax = ref.axes[0]
        want = [matplotlib.colors.to_hex(c) for c in ax.collections[0].get_facecolors()]
        assert [matplotlib.colors.to_hex(c) for c in ours.data["colors"]] == want
        assert ours.data["legend"] == [t.get_text() for t in ax.get_legend().get_texts()]
        assert ours.data["title"] == ax.get_title() == "t-SNE Plot"
    for mod in (jplots, tplots):
        with pytest.raises(ValueError):
            mod.embedding_tsne_figure(embs, labels, "other")


def test_label_pattern_frequency_figure():
    """faq-patterns bar chart (count_pos_neg_V2.py:20-47), as
    tests/test_tb_figures.py checks the JAX one: '+'-joined abbreviations
    of the positive classes, frequency order, fractions, the length guard
    and prefix abbreviations for other label sets."""
    from collections import Counter

    counts = Counter({(0, 0, 0, 0, 0): 6, (1, 0, 0, 0, 1): 3, (0, 1, 0, 0, 0): 1})
    fig = tplots.label_pattern_frequency_figure(counts, CHEXPERT_COMPETITION_TASKS)
    assert fig.data["labels"] == ["", "ATEL+PLEF", "CMG"]
    np.testing.assert_allclose(fig.data["heights"], [0.6, 0.3, 0.1])
    assert fig.size == (800, 600)
    with pytest.raises(ValueError, match="pattern of length"):
        tplots.label_pattern_frequency_figure(Counter({(1, 0): 1}), ["A", "B", "C"])
    fig = tplots.label_pattern_frequency_figure(Counter({(1, 0, 1): 2, (0, 0, 0): 1}),
                                                ["Nodule", "Mass", "Fibrosis"])
    assert fig.data["labels"] == ["NODU+FIBR", ""]


def test_every_figure_is_a_decodable_png_of_matplotlibs_canvas():
    rng = np.random.default_rng(10)
    figs = [tplots.heatmap_figure(rng.random((3, 5)), list("abc"), list("vwxyz"), "F1", "F1"),
            tplots.roc_curve_figure(np.array([0, 1, 1, 0]), np.array([0.1, 0.9, 0.4, 0.5]), 0),
            tplots.pr_curve_figure(np.array([0, 1, 1, 0]), np.array([0.1, 0.9, 0.4, 0.5]), 0),
            tplots.class_scatter_figure(rng.random(5), "Accuracy"),
            *tplots.prompt_projection_figures(rng.normal(size=(5, 128)), None)]
    for fig in figs:
        with Image.open(io.BytesIO(fig.png())) as png:
            assert png.format == "PNG" and png.mode == "RGB" and png.size == (640, 480)
        assert fig.png() == fig.png()  # deterministic bytes
    assert tplots.colormap("YlGn", [0.0, 1.0], 0.0, 1.0).tolist() == [[255, 255, 229],
                                                                       [0, 69, 41]]
    np.testing.assert_array_equal(tplots.COLORMAPS["RdBu_r"],
                                  np.round(matplotlib.colormaps["RdBu_r"](np.arange(256))[:, :3]
                                           * 255).astype(np.uint8))
