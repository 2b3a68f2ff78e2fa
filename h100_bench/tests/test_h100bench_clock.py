"""The program's spans and the card's kernels lie on one clock: the
recorder's ``time.time_ns()`` and the profiler's kineto timestamps, which
``common/trace.py`` compares to name the card's idle gaps.  100 spans, each
around one ``torch.cuda._sleep`` launched on an idle stream: each kernel
starts on the card between its span's start less 20 us and its end plus
500 us."""

import pytest


@pytest.mark.card
def test_spans_and_kernels_share_a_clock(card):
    import torch

    from incremental_multimodal_medical_learning_ii_torch.utils.profiling import annotate, recording

    from h100_bench.common.trace import DeviceTrace

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with DeviceTrace(True, card) as trace, recording() as rec:
        for i in range(100):
            with annotate("sleep", i=i):
                torch.cuda._sleep(20_000)
            torch.cuda.synchronize()
    kernels = sorted(k for k in trace.kernels if "spin" in k[0])
    spans = rec.named("sleep")
    assert len(kernels) == len(spans) == 100
    early = [(s.t0_ns - k[1]) / 1e3 for s, k in zip(spans, kernels)]
    late = [(k[1] - s.t1_ns) / 1e3 for s, k in zip(spans, kernels)]
    print(f"[clock] {torch.cuda.get_device_name(0)}: kernel start - span start "
          f"{min(-e for e in early):.1f}..{max(-e for e in early):.1f} us; "
          f"kernel start - span end {min(late):.1f}..{max(late):.1f} us")
    assert max(early) <= 20 and max(late) <= 500
