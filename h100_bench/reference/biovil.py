"""Plain BioViL image path: the torchvision preprocess, ResNet-50 and the 1x1
projector, in float32 (TF32 off, whatever the process had set) or float64.

Written from the published description (Boecking et al., ECCV 2022;
``health_multimodal`` BioViL): Resize(shorter edge to ``size``, PIL bilinear
with antialias) -> CenterCrop(``crop``) -> /255 -> three identical channels
-> ResNet-50 (torchvision v1 bottlenecks [3, 4, 6, 3], inference batch norm)
-> Conv1x1(2048, 128) -> BN -> ReLU -> Conv1x1(128, 128) + bias -> mean over
the patch grid.  The weights come as a dict keyed by :func:`param_specs`'
names; nothing here reads a table the program built.

``quant="fp8"`` rounds every convolution's weights and inputs to
float8_e4m3 (one scale a tensor) before it runs in float32: the control, the
nearest precision below the configuration's bf16.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LAYERS = ((3, 64), (4, 128), (6, 256), (3, 512))
JOINT = 128


def param_specs(in_channels: int = 3) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every weight; kind is ``conv``, ``bn`` (four
    vectors: scale, bias, mean, var) or ``bias``."""
    specs = [("encoder.conv1.weight", (64, in_channels, 7, 7), "conv"), ("encoder.bn1", (64,), "bn")]
    cin = 64
    for li, (blocks, width) in enumerate(LAYERS):
        for bi in range(blocks):
            p = f"encoder.layer{li + 1}.{bi}."
            specs += [
                (p + "conv1.weight", (width, cin, 1, 1), "conv"), (p + "bn1", (width,), "bn"),
                (p + "conv2.weight", (width, width, 3, 3), "conv"), (p + "bn2", (width,), "bn"),
                (p + "conv3.weight", (4 * width, width, 1, 1), "conv"), (p + "bn3", (4 * width,), "bn"),
            ]
            if bi == 0:
                specs += [(p + "downsample_conv.weight", (4 * width, cin, 1, 1), "conv"),
                          (p + "downsample_bn", (4 * width,), "bn")]
            cin = 4 * width
    specs += [
        ("projector.conv1.weight", (JOINT, 2048, 1, 1), "conv"), ("projector.bn", (JOINT,), "bn"),
        ("projector.conv2.weight", (JOINT, JOINT, 1, 1), "conv"), ("projector.conv2_bias", (JOINT,), "bias"),
    ]
    return specs


# ----------------------------------------------------------------------
# Preprocess: torchvision Resize + CenterCrop on a PIL "L" image, /255
# ----------------------------------------------------------------------
def _triangle_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float64 weights of PIL's antialiased bilinear resample:
    support max(1, in/out), taps centred at (i + 0.5) * in/out, normalised."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    w = np.zeros((out_size, in_size))
    for i in range(out_size):
        centre = (i + 0.5) * scale
        lo = max(int(centre - fscale + 0.5), 0)
        hi = min(int(centre + fscale + 0.5), in_size)
        x = (np.arange(lo, hi) - centre + 0.5) / fscale
        k = np.maximum(1.0 - np.abs(x), 0.0)
        if k.sum() > 0:
            k = k / k.sum()
        w[i, lo:hi] = k
    return w


def _resized_shape(h: int, w: int, size: int) -> Tuple[int, int]:
    if h <= w:
        return size, int(size * w / h)
    return int(size * h / w), size


def _crop_window(w: np.ndarray, crop: int) -> np.ndarray:
    """Rows of a resize matrix inside torchvision's centre crop (zero rows
    where the crop pads)."""
    out = w.shape[0]
    start = int(round((out - crop) / 2.0)) if out >= crop else -((crop - out) // 2)
    rows = np.zeros((crop, w.shape[1]))
    lo, hi = max(start, 0), min(start + crop, out)
    rows[lo - start:hi - start] = w[lo:hi]
    return rows


def preprocess(images: List[np.ndarray], size: int, crop: int, device, dtype=torch.float32) -> torch.Tensor:
    """(H, W) uint8 images -> (B, 3, crop, crop) in [0, 1], NCHW."""
    out = []
    for img in images:
        h, w = img.shape
        oh, ow = _resized_shape(h, w, size)
        wh = torch.as_tensor(_crop_window(_triangle_weights(h, oh), crop), dtype=torch.float64, device=device)
        ww = torch.as_tensor(_crop_window(_triangle_weights(w, ow), crop), dtype=torch.float64, device=device)
        x = torch.as_tensor(img, device=device).to(torch.float64)
        r = torch.clamp(torch.round(wh @ x @ ww.T), 0, 255)
        out.append((r / 255.0).to(dtype))
    x = torch.stack(out)[:, None]
    return x.expand(-1, 3, -1, -1)


# ----------------------------------------------------------------------
# The network
# ----------------------------------------------------------------------
def _fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8_e4m3 with one power-free scale a tensor, back to t's type."""
    amax = t.abs().amax().clamp(min=1e-30)
    s = 448.0 / amax
    return ((t * s).to(torch.float8_e4m3fn).to(t.dtype)) / s


class Net:
    def __init__(self, weights: Dict[str, torch.Tensor], dtype=torch.float32, quant: Optional[str] = None):
        self.w = weights
        self.dtype = dtype
        self.quant = quant

    def conv(self, name: str, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
        k = self.w[name + ".weight"].to(self.dtype)
        if self.quant == "fp8":
            k, x = _fp8(k), _fp8(x)
        return F.conv2d(x, k, stride=stride, padding=padding)

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        g = {k: self.w[f"{name}.{k}"].to(self.dtype) for k in ("scale", "bias", "mean", "var")}
        s = g["scale"] / torch.sqrt(g["var"] + BN_EPS)
        return x * s.view(1, -1, 1, 1) + (g["bias"] - g["mean"] * s).view(1, -1, 1, 1)

    def block(self, p: str, x: torch.Tensor, stride: int, down: bool) -> torch.Tensor:
        out = torch.relu(self.bn(p + "bn1", self.conv(p + "conv1", x)))
        out = torch.relu(self.bn(p + "bn2", self.conv(p + "conv2", out, stride, 1)))
        out = self.bn(p + "bn3", self.conv(p + "conv3", out))
        idn = self.bn(p + "downsample_bn", self.conv(p + "downsample_conv", x, stride)) if down else x
        return torch.relu(out + idn)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) -> (B, 128) global embedding (mean of the projected patches)."""
        x = x.to(self.dtype)
        x = torch.relu(self.bn("encoder.bn1", self.conv("encoder.conv1", x, 2, 3)))
        x = F.max_pool2d(x, 3, 2, 1)
        for li, (blocks, _) in enumerate(LAYERS):
            for bi in range(blocks):
                x = self.block(f"encoder.layer{li + 1}.{bi}.", x, 2 if (bi == 0 and li > 0) else 1, bi == 0)
        h = torch.relu(self.bn("projector.bn", self.conv("projector.conv1", x)))
        h = self.conv("projector.conv2", h) + self.w["projector.conv2_bias"].to(self.dtype).view(1, -1, 1, 1)
        return h.mean(dim=(2, 3))


def embed_images(weights, images: List[np.ndarray], size: int, crop: int, device,
                 dtype=torch.float32, quant: Optional[str] = None, block: int = 16) -> torch.Tensor:
    """Global embeddings of raw uint8 images, ``block`` images at a time."""
    net = Net(weights, dtype, quant)
    out = []
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            for i in range(0, len(images), block):
                out.append(net.embed(preprocess(images[i:i + block], size, crop, device, dtype)))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return torch.cat(out)


def rel_gap(a: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per-row ||a - ref|| / ||ref||."""
    a, ref = a.to(torch.float64), ref.to(torch.float64)
    return torch.linalg.vector_norm(a - ref, dim=-1) / torch.linalg.vector_norm(ref, dim=-1).clamp(min=1e-30)
