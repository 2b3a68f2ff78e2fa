"""Host-side image loading for serving (counterpart of the JAX package's
``data/images.py::load_image_raw_uint8``)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def load_image_raw_uint8(path: str | Path) -> np.ndarray:
    """CheXpert extraction-path loader (``torchvision.io.read_image``
    semantics): raw uint8, grayscaled (PIL 'L'), no remap."""
    from PIL import Image

    with Image.open(path) as img:
        if img.mode != "L":
            img = img.convert("L")
        return np.asarray(img)
