"""Port utils/profiling.py (the JAX package's tests/test_profiling.py): a
trace is a Chrome trace file that holds the named spans, ``None`` traces
nothing, and the extraction and training paths put their spans in it."""

import numpy as np
import torch

from incremental_multimodal_medical_learning_ii_torch.utils.profiling import annotate, maybe_trace

from torch_port_helpers import one_torch_thread, trace_spans  # noqa: F401


def test_maybe_trace_writes_a_trace(tmp_path):
    with maybe_trace(str(tmp_path), device="cpu"):
        with annotate("smoke"):
            (torch.ones(64, 64) * 2).sum()
    assert trace_spans(tmp_path) == {"smoke": 1}


def test_maybe_trace_none_is_noop(tmp_path):
    with maybe_trace(None):
        with annotate("smoke"):
            pass
    assert not any(tmp_path.iterdir())


def test_extraction_trace_hook(tmp_path):
    """``extract_embeddings(trace_dir=)`` traces the run, each batch's
    dispatch and each window's readback in its span."""
    from incremental_multimodal_medical_learning_ii_torch.engine.extract import (
        extract_embeddings,
    )
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        init_biovil_image_model,
    )

    rng = np.random.default_rng(0)
    imgs = [((rng.random((70, 60)) * 255).astype(np.uint8), np.zeros(5, np.float32))
            for _ in range(4)]
    ds = extract_embeddings(iter(imgs), init_biovil_image_model(torch.Generator().manual_seed(0)),
                            batch_size=2, size=64, pad_to=128, dtype=torch.float32,
                            readback_interval=1, trace_dir=str(tmp_path / "trace"), device="cpu")
    assert len(ds) == 4
    spans = trace_spans(tmp_path / "trace")
    assert spans["extract_dispatch"] == 2 and spans["extract_readback"] >= 1


def test_train_protocol_trace_hook(tmp_path):
    """``run_zero_joint(trace_dir=)`` traces the train/eval loop: the fused
    epoch and both eval passes are spans of the trace."""
    from incremental_multimodal_medical_learning_ii_torch.data.store import synthetic_dataset
    from incremental_multimodal_medical_learning_ii_torch.engine.protocols import (
        DataBundle,
        run_zero_joint,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.bank import (
        build_prompt_bank,
        synthetic_encode_fn,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import template_prompts
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
        ExperimentConfig,
    )

    bundle = DataBundle(train=synthetic_dataset(96, seed=1), val=synthetic_dataset(64, seed=2),
                        test=synthetic_dataset(64, seed=3))
    bank = build_prompt_bank(synthetic_encode_fn(), template_prompts(CHEXPERT_COMPETITION_TASKS),
                             CHEXPERT_COMPETITION_TASKS)
    cfg = ExperimentConfig(mode="joint", epochs=1, batch_size=32, eval_batch_size=32,
                           plot_figures="off")
    run_zero_joint(cfg, bundle, bank, log_dir=None, device="cpu",
                   trace_dir=str(tmp_path / "trace"))
    spans = trace_spans(tmp_path / "trace")
    assert spans.get("eval-pass") == 2
    assert spans.get("fused-train-epoch", 0) + spans.get("fused-joint-run", 0) == 1
