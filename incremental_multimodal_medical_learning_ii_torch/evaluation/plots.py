"""Figures for TensorBoard, drawn with PIL (counterpart of the JAX
package's ``evaluation/plots.py``, which draws with matplotlib; the card's
machine has neither matplotlib nor scikit-learn).

The eight public functions keep the JAX package's names, signatures and
data: the annotated heatmaps with fixed per-metric ranges
(``HeatMapPlotter.py:7-128``), per-class ROC / precision-recall curves
(``Trainer.py:879-898``), per-class metric scatter plots
(``Trainer.py:192-202``), PCA / t-SNE prompt-embedding plots
(``Trainer.py:1310-1420``), image-embedding t-SNE plots
(``Trainer.py:1074-1185``), the 10x10 prompt cosine heatmap
(``Trainer.py:1474-1554``) and the label-pattern bar chart.  Each returns
a :class:`Figure`: the data it draws (``Figure.data``), an RGB PIL image
of matplotlib's default canvas size (640x480; 800x600 for the pattern
chart), and ``png()``.  The pixels are PIL's, not matplotlib's; the data,
the canvas sizes and the TensorBoard image's height, width and colour
space are the JAX package's.

The curve points and AUC / AP are :mod:`evaluation.metrics`' sklearn
equivalents; PCA and t-SNE are :mod:`evaluation.projection`'s, computed on
the device of the embeddings given (a tensor's; numpy arrays on the CPU).
Colormaps are matplotlib's YlGn and RdBu_r anchor tables, interpolated
linearly into 256 entries as matplotlib builds them.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from incremental_multimodal_medical_learning_ii_torch.evaluation import metrics, projection

CLASS_ABBREVIATIONS = ("ATEL", "CMG", "CONS", "EDE", "PLEF")
_TSNE_COLORS_5 = ("#FEB24C", "#F03B20", "#74C476", "#238B8C", "#6A51A3")
_TSNE_COLORS_2 = ("#F03B20", "#74C476")
_LINE_BLUE = "#1f77b4"  # matplotlib's first default colour
# matplotlib's single-letter colours
_NAMED = {"r": "#ff0000", "g": "#008000", "b": "#0000ff", "c": "#00bfbf", "m": "#bf00bf",
          "k": "#000000", "w": "#ffffff", "white": "#ffffff", "black": "#000000"}

# matplotlib/_cm.py anchors (ColorBrewer)
_YLGN = ((1.0, 1.0, 0.8980392156862745), (0.9686274509803922, 0.9882352941176471, 0.7254901960784313),
         (0.8509803921568627, 0.9411764705882353, 0.6392156862745098),
         (0.6784313725490196, 0.8666666666666667, 0.5568627450980392),
         (0.47058823529411764, 0.7764705882352941, 0.4745098039215686),
         (0.2549019607843137, 0.6705882352941176, 0.36470588235294116),
         (0.13725490196078433, 0.5176470588235295, 0.2627450980392157),
         (0.0, 0.40784313725490196, 0.21568627450980393), (0.0, 0.27058823529411763, 0.1607843137254902))
_RDBU = ((0.403921568627451, 0.0, 0.12156862745098039), (0.6980392156862745, 0.09411764705882353, 0.16862745098039217),
         (0.8392156862745098, 0.3764705882352941, 0.30196078431372547),
         (0.9568627450980393, 0.6470588235294118, 0.5098039215686274),
         (0.9921568627450981, 0.8588235294117647, 0.7803921568627451),
         (0.9686274509803922, 0.9686274509803922, 0.9686274509803922),
         (0.8196078431372549, 0.8980392156862745, 0.9411764705882353),
         (0.5725490196078431, 0.7725490196078432, 0.8705882352941177),
         (0.2627450980392157, 0.5764705882352941, 0.7647058823529411),
         (0.12941176470588237, 0.4, 0.6745098039215687), (0.0196078431372549, 0.18823529411764706, 0.3803921568627451))


def _lut(anchors) -> np.ndarray:
    """(256, 3) uint8 table: the anchors evenly spaced on [0, 1], linear
    between them (``LinearSegmentedColormap.from_list``, N=256)."""
    a = np.asarray(anchors, np.float64)
    pos = np.linspace(0.0, 1.0, len(a))
    x = np.linspace(0.0, 1.0, 256)
    rgb = np.stack([np.interp(x, pos, a[:, k]) for k in range(3)], axis=1)
    return np.round(rgb * 255.0).astype(np.uint8)


COLORMAPS = {"YlGn": _lut(_YLGN), "RdBu_r": _lut(_RDBU[::-1])}


def colormap(name: str, values, vmin: float, vmax: float) -> np.ndarray:
    """``values`` -> (..., 3) uint8 through the named map over [vmin, vmax]
    (matplotlib's lookup: ``floor(x * 256)`` clipped to the table; NaN
    takes the lowest entry, callers mask it)."""
    x = (np.asarray(values, np.float64) - vmin) / (vmax - vmin)
    idx = np.clip(np.floor(np.nan_to_num(x, nan=0.0) * 256), 0, 255).astype(np.intp)
    return COLORMAPS[name][idx]


def _rgb(color) -> Tuple[int, int, int]:
    if isinstance(color, tuple):
        return color
    color = _NAMED.get(color, color)
    return tuple(int(color[i:i + 2], 16) for i in (1, 3, 5))


@dataclass
class Figure:
    """A drawn figure: ``data`` (what is drawn, as numbers and strings) and
    ``image`` (RGB PIL image)."""

    kind: str
    data: Dict = field(repr=False)
    image: object = field(repr=False)

    @property
    def size(self) -> Tuple[int, int]:
        """(width, height) in pixels."""
        return self.image.size

    def png(self) -> bytes:
        buf = io.BytesIO()
        self.image.save(buf, format="PNG")
        return buf.getvalue()

    def save(self, path, dpi: Optional[float] = None) -> None:
        """Write a PNG; ``dpi`` scales the 100-dpi canvas (as matplotlib's
        ``savefig(dpi=)`` does)."""
        from PIL import Image

        image = self.image
        if dpi is not None and dpi != 100:
            w, h = image.size
            image = image.resize((round(w * dpi / 100), round(h * dpi / 100)), Image.LANCZOS)
        image.save(path, format="PNG")


# ----------------------------------------------------------------------
# drawing
# ----------------------------------------------------------------------
class Canvas:
    """A white RGB canvas with the few primitives the figures need; the
    default axes box is matplotlib's (left 0.125, right 0.9, bottom 0.11,
    top 0.88 of the canvas)."""

    def __init__(self, width: int = 640, height: int = 480):
        from PIL import Image, ImageDraw, ImageFont

        self.image = Image.new("RGB", (width, height), "white")
        self.draw = ImageDraw.Draw(self.image)
        self.font = ImageFont.load_default()
        self.width, self.height = width, height

    def default_box(self) -> Tuple[float, float, float, float]:
        w, h = self.width, self.height
        return 0.125 * w, 0.12 * h, 0.9 * w, 0.89 * h

    def text_size(self, s: str) -> Tuple[int, int]:
        left, top, right, bottom = self.draw.textbbox((0, 0), s, font=self.font)
        return right - left, bottom - top

    def text(self, xy, s: str, color="black", ha: str = "center", va: str = "center",
             rotation: float = 0.0) -> None:
        """``s`` placed by its horizontal (left/center/right) and vertical
        (top/center/bottom) anchor at ``xy``; ``rotation`` in degrees,
        counter-clockwise, about the anchor of the rotated box."""
        from PIL import Image, ImageDraw

        if not s:
            return
        w, h = self.text_size(s)
        tile = Image.new("L", (w + 4, h + 6), 0)
        left, top, _, _ = self.draw.textbbox((0, 0), s, font=self.font)
        ImageDraw.Draw(tile).text((2 - left, 3 - top), s, fill=255, font=self.font)
        if rotation:
            tile = tile.rotate(rotation, expand=True, resample=Image.BICUBIC)
        tw, th = tile.size
        x = xy[0] - {"left": 0, "center": tw / 2, "right": tw}[ha]
        y = xy[1] - {"top": 0, "center": th / 2, "bottom": th}[va]
        self.image.paste(Image.new("RGB", tile.size, _rgb(color)), (round(x), round(y)), tile)

    def frame(self, box, color="black") -> None:
        x0, y0, x1, y1 = box
        self.draw.rectangle([round(x0), round(y0), round(x1), round(y1)], outline=_rgb(color))

    def axes(self, box, xlim, ylim, xlabel: str = "", ylabel: str = "", title: str = "",
             ticks: str = "xy", title_size: int = 1):
        """A framed plot area with ticks and tick labels on the axes named
        in ``ticks``, and labels; returns the (x, y) data -> pixel map."""
        x0, y0, x1, y1 = box
        self.frame(box)

        def to_px(x, y):
            px = x0 + (np.asarray(x, np.float64) - xlim[0]) / (xlim[1] - xlim[0]) * (x1 - x0)
            py = y1 - (np.asarray(y, np.float64) - ylim[0]) / (ylim[1] - ylim[0]) * (y1 - y0)
            return px, py

        for v in nice_ticks(*xlim) if "x" in ticks else ():
            px, _ = to_px(v, ylim[0])
            self.draw.line([(px, y1), (px, y1 + 4)], fill=(0, 0, 0))
            self.text((px, y1 + 6), tick_label(v), va="top")
        for v in nice_ticks(*ylim) if "y" in ticks else ():
            _, py = to_px(xlim[0], v)
            self.draw.line([(x0 - 4, py), (x0, py)], fill=(0, 0, 0))
            self.text((x0 - 6, py), tick_label(v), ha="right")
        self.text(((x0 + x1) / 2, y1 + 22), xlabel, va="top")
        self.text((x0 - 40, (y0 + y1) / 2), ylabel, rotation=90)
        self.title(((x0 + x1) / 2, y0 - 8), title, scale=title_size)
        return to_px

    def title(self, xy, s: str, scale: int = 1) -> None:
        """A title centred above ``xy`` (``scale`` 2 doubles its size)."""
        from PIL import Image, ImageDraw

        if scale == 1:
            self.text(xy, s, va="bottom")
            return
        w, h = self.text_size(s)
        tile = Image.new("L", (w + 4, h + 6), 0)
        left, top, _, _ = self.draw.textbbox((0, 0), s, font=self.font)
        ImageDraw.Draw(tile).text((2 - left, 3 - top), s, fill=255, font=self.font)
        tile = tile.resize((tile.size[0] * scale, tile.size[1] * scale), Image.BICUBIC)
        x, y = xy[0] - tile.size[0] / 2, xy[1] - tile.size[1]
        self.image.paste(Image.new("RGB", tile.size, (0, 0, 0)), (round(x), round(y)), tile)

    def polyline(self, px, py, color, width: int = 2) -> None:
        pts = [(float(a), float(b)) for a, b in zip(px, py) if np.isfinite(a) and np.isfinite(b)]
        if len(pts) > 1:
            self.draw.line(pts, fill=_rgb(color), width=width, joint="curve")

    def marker(self, x, y, color, marker: str = "o", radius: float = 3.5,
               alpha: float = 1.0) -> None:
        rgb = _rgb(color)
        if alpha < 1.0:
            from PIL import Image, ImageDraw

            r = int(np.ceil(radius)) + 1
            box = (round(x) - r, round(y) - r)
            patch = self.image.crop((box[0], box[1], box[0] + 2 * r + 1, box[1] + 2 * r + 1))
            mask = Image.new("L", patch.size, 0)
            ImageDraw.Draw(mask).ellipse([r - radius, r - radius, r + radius, r + radius],
                                         fill=round(255 * alpha))
            patch.paste(Image.new("RGB", patch.size, rgb), (0, 0), mask)
            self.image.paste(patch, box)
            return
        if marker == "v":
            self.draw.polygon([(x - radius, y - radius), (x + radius, y - radius), (x, y + radius)],
                              fill=rgb)
        elif marker == "s":
            self.draw.rectangle([x - radius, y - radius, x + radius, y + radius], fill=rgb)
        else:
            self.draw.ellipse([x - radius, y - radius, x + radius, y + radius], fill=rgb)

    def legend(self, entries: Sequence[Tuple[str, str, str]], box, loc: str) -> None:
        """``entries``: (label, colour, marker) with marker "line", "o",
        "v" or "s"; ``loc`` like matplotlib's ("lower right", ...)."""
        if not entries:
            return
        x0, y0, x1, y1 = box
        widths = [self.text_size(label)[0] for label, _, _ in entries]
        lw, lh = max(widths) + 40, 18 * len(entries) + 8
        lx = x1 - lw - 8 if "right" in loc else x0 + 8
        ly = y1 - lh - 8 if "lower" in loc else y0 + 8
        self.draw.rectangle([lx, ly, lx + lw, ly + lh], fill=(255, 255, 255), outline=(204, 204, 204))
        for k, (label, color, marker) in enumerate(entries):
            cy = ly + 13 + 18 * k
            if marker == "line":
                self.draw.line([(lx + 6, cy), (lx + 26, cy)], fill=_rgb(color), width=2)
            else:
                self.marker(lx + 16, cy, color, marker, radius=5)
            self.text((lx + 32, cy), label, ha="left")

    def colorbar(self, box, cmap: str, vmin: float, vmax: float, label: str = "") -> None:
        """A vertical colour bar with ticks, and ``label`` turned -90 degrees."""
        x0, y0, x1, y1 = (round(v) for v in box)
        values = vmax - (np.arange(y1 - y0) + 0.5) / (y1 - y0) * (vmax - vmin)
        strip = colormap(cmap, values, vmin, vmax)
        from PIL import Image

        col = Image.fromarray(np.repeat(strip[:, None, :], x1 - x0, axis=1), "RGB")
        self.image.paste(col, (x0, y0))
        self.frame((x0, y0, x1, y1))
        for v in nice_ticks(vmin, vmax):
            py = y1 - (v - vmin) / (vmax - vmin) * (y1 - y0)
            self.draw.line([(x1, py), (x1 + 4, py)], fill=(0, 0, 0))
            self.text((x1 + 6, py), tick_label(v), ha="left")
        self.text((x1 + 44, (y0 + y1) / 2), label, rotation=-90)


def nice_ticks(lo: float, hi: float, target: int = 6) -> List[float]:
    """Round tick values inside [lo, hi] at a 1, 2, 2.5 or 5 x 10^k step."""
    if not np.isfinite(lo) or not np.isfinite(hi) or hi <= lo:
        return []
    raw = (hi - lo) / target
    mag = 10.0 ** np.floor(np.log10(raw))
    step = next(m * mag for m in (1.0, 2.0, 2.5, 5.0, 10.0) if m * mag >= raw)
    first = np.ceil(lo / step - 1e-9) * step
    return [float(v) for v in np.arange(first, hi + step * 1e-9, step)]


def tick_label(v: float) -> str:
    return f"{v:.10g}" if abs(v) >= 1e-12 else "0"


def _limits(values, margin: float = 0.05) -> Tuple[float, float]:
    """matplotlib's autoscale: the data range with 5% margins."""
    v = np.asarray(values, np.float64)
    v = v[np.isfinite(v)]
    if v.size == 0:
        return -0.05, 1.05
    lo, hi = float(v.min()), float(v.max())
    if hi == lo:
        lo, hi = lo - 0.5 if lo == 0 else lo * 0.95, hi + 0.5 if hi == 0 else hi * 1.05
        lo, hi = min(lo, hi), max(lo, hi)
    pad = (hi - lo) * margin
    return lo - pad, hi + pad


def _to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ----------------------------------------------------------------------
# the figures
# ----------------------------------------------------------------------
def heatmap_figure(
    data,
    row_labels: Sequence[str],
    col_labels: Sequence[str],
    cbarlabel: str,
    metric: str,
    valfmt: str = "{:.2f}",
) -> Figure:
    """Annotated heatmap with the reference's fixed value ranges:
    COS in [-1, 1], F1/AUROC in [0, 1] (HeatMapPlotter.py:36-43)."""
    data = np.asarray(data)
    if metric == "COS":
        vmin, vmax = -1.0, 1.0
    elif metric in ("F1", "AUROC"):
        vmin, vmax = 0.0, 1.0
    else:
        raise ValueError(f"unknown heatmap metric {metric!r}")

    def norm(v):
        return (v - vmin) / (vmax - vmin)

    # annotations, colour switched at half of the normalised maximum
    threshold = norm(float(np.nanmax(data))) / 2.0
    annotations = [[(valfmt.format(data[i, j]), "white" if norm(data[i, j]) > threshold else "black")
                    for j in range(data.shape[1])] for i in range(data.shape[0])]

    cv = Canvas()
    rows, cols = data.shape
    top, bottom, left, right = 95.0, cv.height - 20.0, 110.0, cv.width - 150.0
    cell = min((right - left) / cols, (bottom - top) / rows)
    x0 = left + ((right - left) - cell * cols) / 2
    y0 = top + ((bottom - top) - cell * rows) / 2
    rgb = colormap("YlGn", data, vmin, vmax)
    for i in range(rows):
        for j in range(cols):
            box = [x0 + j * cell, y0 + i * cell, x0 + (j + 1) * cell, y0 + (i + 1) * cell]
            cv.draw.rectangle(box, fill=tuple(int(c) for c in rgb[i, j]))
    for k in range(1, cols):  # the white grid between cells
        cv.draw.line([(x0 + k * cell, y0), (x0 + k * cell, y0 + rows * cell)], fill=(255, 255, 255),
                     width=3)
    for k in range(1, rows):
        cv.draw.line([(x0, y0 + k * cell), (x0 + cols * cell, y0 + k * cell)], fill=(255, 255, 255),
                     width=3)
    for i in range(rows):
        for j in range(cols):
            s, color = annotations[i][j]
            cv.text((x0 + (j + 0.5) * cell, y0 + (i + 0.5) * cell), s, color=color)
    for j, label in enumerate(col_labels):  # on top, turned 30 degrees
        cv.text((x0 + (j + 0.5) * cell, y0 - 4), str(label), ha="left", va="bottom", rotation=30)
    for i, label in enumerate(row_labels):
        cv.text((x0 - 6, y0 + (i + 0.5) * cell), str(label), ha="right")
    bar_x = x0 + cols * cell + 20
    cv.colorbar((bar_x, y0, bar_x + 16, y0 + rows * cell), "YlGn", vmin, vmax, cbarlabel)
    return Figure("heatmap", dict(matrix=data, row_labels=list(row_labels),
                                  col_labels=list(col_labels), vmin=vmin, vmax=vmax,
                                  cbarlabel=cbarlabel, metric=metric,
                                  annotations=annotations), cv.image)


def _curve_figure(kind, x, y, legend, loc, xlabel, ylabel, title) -> Figure:
    cv = Canvas()
    box = cv.default_box()
    to_px = cv.axes(box, _limits(x), _limits(y), xlabel, ylabel, title)
    cv.polyline(*to_px(x, y), _LINE_BLUE)
    cv.legend([(legend, _LINE_BLUE, "line")], box, loc)
    return Figure(kind, dict(x=np.asarray(x), y=np.asarray(y), legend=[legend], xlabel=xlabel,
                             ylabel=ylabel, title=title), cv.image)


def roc_curve_figure(y_true, y_score, class_index: int) -> Figure:
    """ROC curve with ``AUC = ...`` (sklearn's points and AUC: NaN rates and
    AUC for a column with one label value)."""
    fpr, tpr, _ = metrics.roc_curve(y_true, y_score)
    auc = metrics._binary_roc_auc(y_true, y_score)
    return _curve_figure("roc", fpr, tpr, "AUC = {:.3f}".format(auc), "lower right",
                         "False Positive Rate", "True Positive Rate",
                         "ROC Curve for Class " + str(class_index))


def pr_curve_figure(y_true, y_score, class_index: int) -> Figure:
    precision, recall, _ = metrics.precision_recall_curve(y_true, y_score)
    ap = metrics.average_precision_score(y_true, y_score)
    return _curve_figure("pr", recall, precision, "AP = {:.3f}".format(ap), "lower left",
                         "Recall", "Precision", "Precision-Recall Curve for Class " + str(class_index))


def class_scatter_figure(values, metric: str) -> Figure:
    """Per-class metric scatter (Trainer.py:192-202; the x axis is labelled
    'Epoch' in the reference, kept)."""
    values = np.asarray(values)
    x = np.arange(1, len(values) + 1)
    cv = Canvas()
    box = cv.default_box()
    to_px = cv.axes(box, _limits(x), (0.0, 1.0), "Epoch", metric, "Class " + metric)
    for px, py in zip(*to_px(x, values)):
        if np.isfinite(py):
            cv.marker(px, py, _LINE_BLUE)
    return Figure("scatter", dict(x=x, y=values, xlabel="Epoch", ylabel=metric,
                                  ylim=(0.0, 1.0), title="Class " + metric), cv.image)


def prompt_cosine_heatmap_figure(pos_embs, neg_embs, single_prompt: bool) -> Figure:
    """10x10 (or 5x5 pos-only) prompt cosine heatmap (Trainer.py:1474-1554).

    ``pos_embs`` / ``neg_embs``: (C, D) adapted *mean* prompt embeddings
    (the reference plots always use the mean, even in MAX mode), arrays or
    tensors; the matrix is computed on the host, pair by pair, as the JAX
    package computes it."""

    def _cos(a, b):
        an = a / max(np.linalg.norm(a), 1e-8)
        bn = b / max(np.linalg.norm(b), 1e-8)
        return float(an @ bn)

    pos_embs = _to_numpy(pos_embs)
    c = pos_embs.shape[0]
    if neg_embs is None:
        labels = [f"{a}-pos" for a in CLASS_ABBREVIATIONS[:c]]
        stacked = pos_embs
    else:
        labels = []
        for a in CLASS_ABBREVIATIONS[:c]:
            labels += [f"{a}-pos", f"{a}-neg"]
        stacked = np.empty((2 * c, pos_embs.shape[1]), pos_embs.dtype)
        stacked[0::2] = pos_embs
        stacked[1::2] = _to_numpy(neg_embs)
    n = len(stacked)
    data = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            data[i, j] = _cos(stacked[i], stacked[j])
    str_prompts = "-single-prompt" if single_prompt else "-multiple-prompts"
    return heatmap_figure(data, labels, labels, "Cosine similarity heatmap" + str_prompts, "COS")


def _scatter_figure(kind, coords, colors, markers, title, legend, sizes=3.5, alpha=1.0,
                    ticks="xy", title_size=1, legend_loc="upper right") -> Figure:
    coords = np.asarray(coords, np.float64)
    cv = Canvas()
    box = cv.default_box()
    to_px = cv.axes(box, _limits(coords[:, 0]), _limits(coords[:, 1]), title=title, ticks=ticks,
                    title_size=title_size)
    pxs, pys = to_px(coords[:, 0], coords[:, 1])
    for px, py, color, marker in zip(pxs, pys, colors, markers):
        cv.marker(px, py, color, marker, radius=sizes, alpha=alpha)
    cv.legend(legend, box, legend_loc)
    return Figure(kind, dict(coords=coords, colors=list(colors), markers=list(markers),
                             title=title, legend=[e[0] for e in legend]), cv.image)


def prompt_projection_figures(pos_embs, neg_embs, seed: int = 27) -> Tuple[Figure, Figure]:
    """PCA + t-SNE scatter of the adapted mean prompt embeddings
    (Trainer.py:1310-1420). Returns (pca_fig, tsne_fig); both projections
    run on the embeddings' device.  ``neg_embs=None`` plots positives only.
    ``seed`` is kept for the JAX signature: the exact t-SNE from the exact
    PCA start draws no random numbers."""
    import torch

    pos = projection._as_tensor(pos_embs)
    c = pos.shape[0]
    group = ["r", "g", "b", "c", "m"]
    if neg_embs is None:
        embs = pos
        markers = ["o"] * c
        colors = group[:c]
        polarity = [("Positive", "k", "o")]
    else:
        neg = projection._as_tensor(neg_embs).to(pos.device)
        embs = torch.stack([pos, neg], dim=1).reshape(2 * c, pos.shape[1])
        markers = ["o", "v"] * c
        colors = [group[i // 2] for i in range(2 * c)]
        polarity = [("Positive", "k", "o"), ("Negative", "k", "v")]
    legend = [(cat, col, "o") for col, cat in list(zip(group, CLASS_ABBREVIATIONS))[:c]] + polarity
    pca = _to_numpy(projection.pca_2d(embs))
    tsne = _to_numpy(projection.tsne(embs).embedding)
    return (_scatter_figure("pca", pca, colors, markers, "PCA multiple-prompts", legend),
            _scatter_figure("tsne", tsne, colors, markers, "TSNE multiple-prompts", legend))


def embedding_tsne_figure(embeddings, labels, kind: str, seed: int = 27) -> Figure:
    """t-SNE of adapted image embeddings (Trainer.py:1074-1185), on the
    embeddings' device.

    kind='multiclass': colour by argmax label (5 single-positive groups).
    kind='sani-malati': colour healthy (all-0) vs all-diseased (all-1).
    """
    labels = _to_numpy(labels)
    if kind == "multiclass":
        colors = [_TSNE_COLORS_5[int(np.argmax(lab))] for lab in labels]
        legend = dict(zip(CLASS_ABBREVIATIONS, _TSNE_COLORS_5))
    elif kind == "sani-malati":
        group = (labels.sum(axis=1) / labels.shape[1]).astype(int)
        colors = [_TSNE_COLORS_2[g] for g in group]
        legend = dict(zip(("NF", "DS"), _TSNE_COLORS_2))
    else:
        raise ValueError(kind)
    reduced = _to_numpy(projection.tsne(projection._as_tensor(embeddings)).embedding)
    return _scatter_figure("embedding-tsne", reduced, colors, ["o"] * len(colors), "t-SNE Plot",
                           [(k, v, "s") for k, v in legend.items()], sizes=2.8, alpha=0.7,
                           ticks="", title_size=2)


def label_pattern_frequency_figure(pattern_counts, class_names: Sequence[str],
                                   title: str = "Pattern Frequencies") -> Figure:
    """Bar plot of multi-hot label-pattern frequencies, the reference's
    ``faq-patterns/{train,val,test}_patterns.png``
    (``CSV_reformatting/count_pos_neg_V2.py:20-47``): x labels join each
    pattern's positive-class abbreviations with '+' (empty for the
    all-negative pattern), y is the pattern's share of the rows, most
    frequent first.  ``pattern_counts``: {pattern tuple: count}."""
    class_names = list(class_names)
    # the reference's 5 classes keep their short forms; any other label
    # set falls back to 4-letter prefixes
    if len(class_names) == len(CLASS_ABBREVIATIONS) and class_names[0] == "Atelectasis":
        abbr = CLASS_ABBREVIATIONS
    else:
        abbr = tuple(n[:4].upper() for n in class_names)
    for pat in pattern_counts:
        if len(pat) != len(class_names):
            raise ValueError(f"pattern of length {len(pat)} vs {len(class_names)} classes")
    total = sum(pattern_counts.values()) or 1
    items = sorted(pattern_counts.items(), key=lambda kv: -kv[1])
    abbrevs = ["+".join(abbr[i] for i, v in enumerate(pat) if v) for pat, _ in items]
    freqs = [cnt / total for _, cnt in items]

    cv = Canvas(800, 600)
    longest = max((cv.text_size(a)[0] for a in abbrevs), default=0)
    box = (80.0, 40.0, cv.width - 20.0, cv.height - 50.0 - longest)
    n = max(len(freqs), 1)
    to_px = cv.axes(box, (-0.5 - 0.05 * n, n - 0.5 + 0.05 * n), (0.0, max(freqs, default=1.0) * 1.05),
                    ylabel="Frequency", title=title, ticks="y")
    for k, (f, label) in enumerate(zip(freqs, abbrevs)):
        (xl, xr), (yt, yb) = to_px([k - 0.4, k + 0.4], [f, 0.0])
        cv.draw.rectangle([xl, yt, xr, yb], fill=_rgb(_LINE_BLUE))
        cv.text(((xl + xr) / 2, box[3] + 4), label, va="top", rotation=90)
    cv.text(((box[0] + box[2]) / 2, cv.height - 6), "Condition Combinations", va="bottom")
    return Figure("bars", dict(heights=freqs, labels=abbrevs, title=title,
                               xlabel="Condition Combinations", ylabel="Frequency"), cv.image)
