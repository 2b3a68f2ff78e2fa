"""Each per-layer metric's arithmetic on a hand-made run: counters, spans and
a kernel timeline written out by hand."""

from pathlib import Path

import pytest
import torch

from h100_bench.common import counts, spec
from h100_bench.common.trace import busy_s, idle_gaps, merged

MS = 1_000_000  # ns


def make_run(workload, **kw):
    entry, config, params = spec.cell(workload)
    run = spec.Run(workload=workload, entry=entry, config=config, params=params, seed=1, seconds=1.0,
                   trace=True, device=torch.device("cuda"), tmp=Path("."))
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def read(name, run):
    return spec.metric_reader(name).read(run)


def test_timeline_union_and_gaps():
    k = [("a", 0, 10 * MS), ("b", 5 * MS, 20 * MS), ("c", 30 * MS, 40 * MS)]
    assert merged(k) == [(0, 20 * MS), (30 * MS, 40 * MS)]
    assert busy_s(k) == pytest.approx(0.030)
    spans = [("outer", 0, 100 * MS), ("readback", 21 * MS, 29 * MS)]
    gaps = idle_gaps(k, spans, 0, 45 * MS)
    assert gaps == [["readback", pytest.approx(0.010)], ["outer", pytest.approx(0.005)]]


def test_extract_host_metrics():
    run = make_run("extract-b512", counters={"batches": 4, "feed_wait_s": 0.2, "dispatch_s": 0.8, "images": 2048})
    run.window_s = 2.0
    assert read("extract.feed_wait_ms", run) == pytest.approx(50.0)
    assert read("extract.dispatch_ms", run) == pytest.approx(200.0)
    want = 100 * 2048 * counts.extract_flops_per_image(390, 320, 512) / 2.0 / counts.PEAK_BF16
    assert read("extract.mfu", run) == pytest.approx(want)


@pytest.mark.parametrize("name", ["extract.device_idle", "train.device_idle"])
def test_device_idle(name):
    run = make_run("train-joint", kernels=[("k", 0, 250 * MS), ("k", 500 * MS, 750 * MS)],
                   trace_t0_ns=0, trace_t1_ns=1000 * MS)
    assert read(name, run) == pytest.approx(50.0)
    run.kernels = []
    assert read(name, run) is None


def test_train_metrics():
    run = make_run("train-joint", counters={"runs": 3, "traced_runs": 2})
    run.window_s = 6.0
    for t0 in (0, 3000):
        run.spans.add("joint_run", t0 * MS, (t0 + 2500) * MS)
        run.spans.add("fused-joint-run", (t0 + 300) * MS, (t0 + 2300) * MS)
    assert read("train.fused_run_ms", run) == pytest.approx(2000.0)
    assert read("train.protocol_host_ms", run) == pytest.approx(500.0)
    want = 100 * 3 * counts.joint_run_flops(run.params) / 6.0 / counts.PEAK_FP32
    assert read("train.mfu", run) == pytest.approx(want)
    run.kernels = [("fused_cosine_kernel(x)", 0, 10_000)] * 4
    bound = counts.bound_s(*counts.k1_counts(1024, 10), counts.PEAK_FP32)
    assert read("train.k1_roofline", run) == pytest.approx(100 * 4 * bound / 40e-6)
    assert read("train.collective_ms_per_step", run) is None  # one chip: no exchange


def test_collectives_per_step():
    run = make_run("train-joint-dp4", counters={"traced_runs": 2},
                   kernels=[("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", 0, 64 * 10_000)])
    steps = 2 * 10 * 32
    assert read("train.collective_ms_per_step", run) == pytest.approx(0.64 / steps)
