"""Host-side image loading (counterpart of the JAX package's
``data/images.py``).

Parity with ``health_multimodal/image/data/io.py:16-71``: JPEG/PNG via PIL,
NIfTI via SimpleITK, DICOM via pydicom (both gated, raising a clear error
where absent), min-max or percentile remap to uint8, grayscale.

This module is what the extraction decode workers import
(``engine/extract.py::manifest_image_iterator`` sends these loaders to a
process pool), so it stays torch-free: numpy here, PIL inside the
functions.  ``ops/preprocess.py`` re-exports :func:`remap_to_uint8`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def remap_to_uint8(array: np.ndarray, percentiles: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """Min-max (or percentile-clipped) remap to [0, 255] uint8
    (``health_multimodal/image/data/io.py:16-47``)."""
    array = array.astype(float)
    if percentiles is not None:
        if len(percentiles) != 2:
            raise ValueError(
                "The value for percentiles should be a sequence of length 2,"
                f" but has length {len(percentiles)}"
            )
        a, b = percentiles
        if a >= b:
            raise ValueError(f'Percentiles must be in ascending order, but a sequence "{percentiles}" was passed')
        if a < 0 or b > 100:
            raise ValueError(f'Percentiles must be in the range [0, 100], but a sequence "{percentiles}" was passed')
        cutoff = np.percentile(array, percentiles)
        array = np.clip(array, *cutoff)
    array -= array.min()
    mx = array.max()
    if mx > 0:
        array /= mx
    array *= 255
    return array.astype(np.uint8)


def load_image(path: str | Path, percentiles: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """Load an image as a (H, W) uint8 grayscale array (remapped)."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix in (".jpg", ".jpeg", ".png"):
        from PIL import Image

        with Image.open(path) as pil:
            if pil.mode == "P":
                # palette PNGs: skimage's imread (the reference loader,
                # io.py:38) applies the palette; raw indices would be
                # remapped as if they were intensities
                pil = pil.convert("RGB")
            image = np.asarray(pil)
    elif [s.lower() for s in path.suffixes[-2:]] == [".nii", ".gz"] or suffix == ".nii":
        try:
            import SimpleITK as sitk
        except ImportError as e:
            raise ImportError("NIfTI loading requires SimpleITK") from e
        image = sitk.GetArrayFromImage(sitk.ReadImage(str(path)))
        if image.shape[0] == 1:
            image = np.squeeze(image, axis=0)
        if image.ndim != 2:
            raise ValueError(f"expected a 2-D NIfTI slice, got shape {image.shape}")
    elif suffix == ".dcm":
        try:
            import pydicom
        except ImportError as e:
            raise ImportError("DICOM loading requires pydicom") from e
        image = pydicom.dcmread(path).pixel_array
    else:
        raise ValueError(f"Image type not supported, filename was: {path}")

    image = remap_to_uint8(np.asarray(image), percentiles)
    if image.ndim == 3:  # RGB(A) -> luma grayscale (PIL 'L' convention)
        from PIL import Image

        image = np.asarray(Image.fromarray(image).convert("L"))
    return image


def image_shape(path: str | Path) -> Tuple[int, int]:
    """(H, W) of an image file from its header alone (no decode): the shape
    :func:`load_image_raw_uint8` returns."""
    from PIL import Image

    with Image.open(path) as img:
        return img.height, img.width


def load_image_raw_uint8(path: str | Path) -> np.ndarray:
    """CheXpert extraction-path loader (``torchvision.io.read_image``
    semantics): raw uint8, grayscaled (PIL 'L'), no remap."""
    from PIL import Image

    with Image.open(path) as img:
        if img.mode != "L":
            img = img.convert("L")
        return np.asarray(img)
