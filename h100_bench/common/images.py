"""Synthetic CheXpert-small images, drawn from the seed.

The port's ``bench.py::images`` drew uint8 noise at the 390 x 320 frontal
geometry.  Noise alone leaves nothing for a global embedding to tell apart:
mean-pooled over the patch grid, every image's embedding is the same to
1e-5.  So each image here has a coarse layout of its own (a grid of 30 x 32
pixel cells, each one grey level, within the image's own brightness and
contrast) under 5 bits of noise.

Images are drawn a block at a time so that image ``i`` can be drawn again on
its own for the reference: block ``b`` comes from one generator seeded by
``(seed, b)``.  An extraction cell draws a pool of ``P`` blocks of ``n`` in
set-up and cycles it in its window, so the loop's prefetch thread does the
program's work alone: image ``i`` of the window is row ``i % n`` of block
``(i // n) % P``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

FRONTAL = (390, 320)
CELL = (30, 32)


def block(seed: int, b: int, n: int, hw: Tuple[int, int] = FRONTAL) -> np.ndarray:
    """(n, H, W) uint8: the ``b``-th block of ``n`` images."""
    rng = np.random.default_rng([int(seed), 1, int(b)])
    h, w = hw
    gh, gw = -(-h // CELL[0]), -(-w // CELL[1])
    span = rng.integers(64, 225, size=(n, 1, 1))  # the image's contrast
    base = (rng.random((n, 1, 1)) * (225 - span)).astype(np.int64)  # and brightness
    layout = (base + rng.random((n, gh, gw)) * span).astype(np.uint8)  # < 225
    x = rng.integers(0, 256, size=(n, gh, CELL[0], gw, CELL[1]), dtype=np.uint8)
    x >>= 3  # noise in [0, 32): layout + noise stays in uint8
    x += layout[:, :, None, :, None]
    x = x.reshape(n, gh * CELL[0], gw * CELL[1])
    return x if x.shape[1:] == (h, w) else np.ascontiguousarray(x[:, :h, :w])


def images_at(seed: int, idx, n: int, hw: Tuple[int, int], blocks: int) -> List[np.ndarray]:
    """Images ``idx`` of the stream that cycles blocks ``0 .. blocks - 1`` of
    ``n``, drawn anew from the seed, each block once."""
    idx = [int(i) for i in idx]
    which = [(i // n) % blocks for i in idx]
    out: List[Optional[np.ndarray]] = [None] * len(idx)
    for b in sorted(set(which)):
        data = block(seed, b, n, hw)
        for k, (i, w) in enumerate(zip(idx, which)):
            if w == b:
                out[k] = data[i % n].copy()
    return out
