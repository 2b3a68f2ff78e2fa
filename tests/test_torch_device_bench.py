"""Port utils/device_bench.py (the JAX package's tests/test_device_bench.py):
the chained device-encode loop runs end to end on the CPU at 32^2, with
layer1 through K2's wrapper (its plain version on the CPU) or not."""

import pytest
import torch

from torch_port_helpers import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("fused_layer1", [False, True])
def test_device_encode_rate_smoke(fused_layer1):
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        fold_grayscale_conv1,
        init_biovil_image_model,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_bottleneck import (
        fused_bottleneck_layer,
    )
    from incremental_multimodal_medical_learning_ii_torch.utils.device_bench import (
        device_encode_rate,
    )

    model = fold_grayscale_conv1(init_biovil_image_model(torch.Generator().manual_seed(0)))
    before = fused_bottleneck_layer.launches
    rate = device_encode_rate(model, batch=2, img_h=40, img_w=36, size=32, crop=32, channels=1,
                              fused_layer1=fused_layer1, k_short=1, k_long=3, n_slabs=2,
                              device="cpu")
    # CPU timing is noisy, but the rate is a positive float or an honest
    # None (an invalid sample), never a clamped absurdity
    assert rate is None or (isinstance(rate, float) and 0 < rate < 1e9)
    assert fused_bottleneck_layer.launches == before  # the plain path launches nothing
