"""The device-side extraction encode benchmark (counterpart of the JAX
package's ``utils/device_bench.py``): the shared-size device preprocess
and the BioViL forward in bf16, chained through an accumulator and timed
by :func:`~incremental_multimodal_medical_learning_ii_torch.utils.chained_timing.time_chained`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from incremental_multimodal_medical_learning_ii_torch.utils.chained_timing import (
    rate_or_none,
    time_chained,
)


def device_encode_rate(
    model,
    *,
    batch: int = 256,
    img_h: int = 390,
    img_w: int = 320,
    size: int = 512,
    crop: int = 512,
    channels: int = 1,
    int8: bool = False,
    fused_layer1: bool = False,
    k_short: int = 4,
    k_long: int = 24,
    n_slabs: int = 4,
    seed: int = 0,
    device=None,
) -> Optional[float]:
    """Images/s on one card for the device preprocess + encode, or None on
    an invalid sample (``utils/chained_timing.py``).  ``model`` must
    already match ``channels`` (grayscale-folded for channels=1) and
    ``int8`` (``quantize_biovil_int8``); ``fused_layer1`` runs layer1
    through K2.  ``device``: ``None`` is CUDA, ``"cpu"`` the plain path;
    the model is moved there in place, as ``Module.to`` moves it."""
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        biovil_image_forward,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.preprocess import (
        SharedSizePreprocessPlan,
        preprocess_device_shared,
    )
    from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = model.to(dev)
    rng = np.random.default_rng(seed)
    plan = SharedSizePreprocessPlan(img_h, img_w, size=size, crop=crop)
    raw_all = torch.from_numpy(
        rng.integers(0, 256, size=(n_slabs, batch, img_h, img_w), dtype=np.uint8)).to(dev)
    w_h = torch.from_numpy(plan.w_h).to(dev)
    w_w = torch.from_numpy(plan.w_w).to(dev)

    def make_encode_loop(k):
        @torch.no_grad()
        def loop(raw_, w_h_, w_w_):
            acc = torch.zeros((), device=dev)
            for i in range(k):
                wh = w_h_ + 0.0 * acc  # the chain: each iteration waits for the last
                imgs = preprocess_device_shared(raw_[i % n_slabs], wh, w_w_, channels=channels)
                emb = biovil_image_forward(model, imgs, dtype=torch.bfloat16, int8=int8,
                                           fused_layer1=fused_layer1).projected_global_embedding
                acc = acc + emb.float().sum()
            return acc
        return loop

    per_batch = time_chained(
        make_encode_loop,
        lambda r: (torch.bitwise_xor(raw_all, (r + 1) % 256), w_h, w_w),
        k_short=k_short, k_long=k_long,
    )
    return rate_or_none(per_batch, batch)
