"""The port's headline benchmark (``incremental_multimodal_medical_learning_ii_torch/bench.py``)
on the CPU with stubs: the supervisor's five cases of
tests/test_bench_supervisor.py, the child's flow with the extraction loop
stubbed, the child's command line, a real child on a host without CUDA
(the value-0 line with the raise), MFU against the H100's peak, and the
images it draws bit for bit the JAX bench's."""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import bench as jbench
from incremental_multimodal_medical_learning_ii_torch import bench
from incremental_multimodal_medical_learning_ii_torch.cli import linkhealth
from incremental_multimodal_medical_learning_ii_torch.engine import extract
from incremental_multimodal_medical_learning_ii_torch.utils import device as device_mod

REPO = Path(__file__).resolve().parent.parent
METRIC = "chexpert_extraction_images_per_sec_per_chip"


def _patch_probe(monkeypatch, result=None):
    monkeypatch.setattr(linkhealth, "quick_probe",
                        lambda **kw: result or {"probe_error": "timeout"})


def test_supervisor_forwards_child_report(monkeypatch, capsys):
    line = json.dumps({"metric": "m", "value": 123.0, "unit": "images/sec"})

    def fake_run(*a, **kw):
        return subprocess.CompletedProcess(a, 0, stdout="noise\n" + line + "\n", stderr="")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert bench._supervise() == 0
    assert capsys.readouterr().out.strip().splitlines() == [line]


def test_supervisor_reports_on_hang(monkeypatch, capsys):
    def fake_run(*a, **kw):
        raise subprocess.TimeoutExpired(cmd=a, timeout=kw["timeout"], output=b"")

    monkeypatch.setattr(subprocess, "run", fake_run)
    _patch_probe(monkeypatch)
    assert bench._supervise() == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == METRIC
    assert line["value"] == 0.0 and "killed" in line["failure"]
    assert line["link"] == {"probe_error": "timeout"}


def test_supervisor_reports_on_child_crash(monkeypatch, capsys):
    def fake_run(*a, **kw):
        return subprocess.CompletedProcess(
            a, 1, stdout="Traceback ...\n", stderr="Traceback ...\nRuntimeError: boom\n")

    monkeypatch.setattr(subprocess, "run", fake_run)
    _patch_probe(monkeypatch)
    assert bench._supervise() == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["value"] == 0.0 and "rc=1" in line["failure"]
    assert "RuntimeError: boom" in line["failure"]
    assert "Traceback" in out.err  # the child's stderr is passed on


def test_supervisor_forwards_report_even_if_child_then_hung(monkeypatch, capsys):
    """A child that printed its JSON but never exited still delivers the
    real number."""
    line = json.dumps({"metric": "m", "value": 9.0, "unit": "images/sec"})

    def fake_run(*a, **kw):
        raise subprocess.TimeoutExpired(cmd=a, timeout=kw["timeout"],
                                        output=(line + "\n").encode())

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert bench._supervise() == 0
    assert capsys.readouterr().out.strip() == line


def test_supervisor_prefers_last_report_and_ignores_stray_json(monkeypatch, capsys):
    """The parent forwards the LAST metric dict; a stray JSON-parseable
    fragment never becomes the artifact; a hang after the preliminary
    line still delivers the wall samples."""
    prelim = json.dumps({"metric": "m", "value": 5.0, "preliminary": True})
    final = json.dumps({"metric": "m", "value": 5.0, "mfu_device": 0.43})

    def fake_run(*a, **kw):
        return subprocess.CompletedProcess(a, 0, stdout=prelim + "\n" + final + "\n0\n[]\n")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert bench._supervise() == 0
    assert capsys.readouterr().out.strip() == final

    def fake_hang(*a, **kw):
        raise subprocess.TimeoutExpired(cmd=a, timeout=kw["timeout"],
                                        output=(prelim + "\n").encode())

    monkeypatch.setattr(subprocess, "run", fake_hang)
    assert bench._supervise() == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["preliminary"]


def test_child_command_is_the_module_at_the_repo_root(monkeypatch, capsys):
    """Re-executing the file would put the package's own directory on
    sys.path: the child is ``-m`` of the module, from the repo's root."""
    seen = {}

    def fake_run(cmd, **kw):
        seen.update(cmd=cmd, **kw)
        return subprocess.CompletedProcess(cmd, 0, stdout='{"metric": "m", "value": 1.0}\n')

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert bench._supervise() == 0
    assert seen["cmd"] == [sys.executable, "-m",
                           "incremental_multimodal_medical_learning_ii_torch.bench"]
    assert Path(seen["cwd"]) == REPO
    assert seen["env"]["IMML_BENCH_CHILD"] == "1"
    assert seen["timeout"] == bench.DEADLINE_S + 120.0


class _FakeDS:
    def __init__(self, n):
        self._n = n

    def __len__(self):
        return self._n


def _small_rounds(monkeypatch, module):
    """The bench's rounds cut to a few small batches (its size constants)."""
    for name, value in (("BATCH", 4), ("IMAGES_PER_ROUND", 8), ("MIN_ROUNDS", 2),
                        ("MAX_ROUNDS", 3)):
        monkeypatch.setattr(module, name, value)


def test_bench_child_flow_end_to_end(monkeypatch, capsys):
    """The child's flow (warm-up -> sampling -> PRELIMINARY report -> link
    probe -> final report) with the extraction loop stubbed and the device
    mapped to the CPU: exactly two metric lines, preliminary first, the
    final one with the link field, the device's name and power limit."""
    calls = []

    def fake_extract(images, model, **kw):
        imgs = list(images)
        calls.append((len(imgs), kw))
        stats = kw.get("stats")
        if stats is not None:
            stats.update({"batches": 4, "dispatch_s": 0.01, "readback_s": 0.02,
                          "feed_wait_s": 0.03, "retried_batches": 1})
        return _FakeDS(len(imgs))

    monkeypatch.setattr(extract, "extract_embeddings", fake_extract)
    monkeypatch.setattr(device_mod, "resolve_device", lambda device=None: torch.device("cpu"))
    _patch_probe(monkeypatch, {"rtt_ms": 3.0, "upload_mb_per_s": 50.0})
    monkeypatch.setenv("IMML_BENCH_DEVICE", "0")  # skip the chained device stage
    _small_rounds(monkeypatch, bench)
    bench.main()
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 2
    prelim, final = lines
    assert prelim.get("preliminary") is True and "link" not in prelim
    assert "preliminary" not in final
    assert final["metric"] == METRIC
    assert final["link"] == {"rtt_ms": 3.0, "upload_mb_per_s": 50.0}
    assert final["value"] == prelim["value"] > 0
    assert final["vs_baseline"] == round(final["value"] / 1.509, 2)
    assert final["retried_batches"] == prelim["retried_batches"] > 0
    assert final["device_images_per_sec_per_chip"] is None  # stage skipped
    assert final["device_images_per_sec_per_chip_b256"] is None
    assert final["mfu_device"] is None and final["mfu_wall"] > 0
    assert len(final["samples"]) >= 2
    assert final["dispatch_ms_per_batch"][0] == 2.5 and final["readback_ms_per_batch"][0] == 5.0
    assert final["feed_wait_ms_per_batch"][0] == 7.5
    assert final["device"] == "cpu" and "power_limit_w" in final
    # the real loop's arguments: batch, geometry, bf16, retries, the device
    assert calls[0][0] == 4 and all(n == 8 for n, _ in calls[1:])
    kw = calls[0][1]
    assert (kw["batch_size"], kw["size"], kw["crop"], kw["dtype"], kw["retries"]) == (
        4, 512, 512, torch.bfloat16, 3)
    assert kw["device"] == torch.device("cpu")


def test_child_without_cuda_reports_the_raise():
    """A real supervised run on a host without CUDA: the child raises in
    resolve_device, the parent prints the value-0 line with the raise in
    ``"failure"`` and the probe's own error in ``"link"``."""
    env = {k: v for k, v in os.environ.items() if k != "IMML_BENCH_CHILD"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, on any host
    out = subprocess.run([sys.executable, "-m", bench.MODULE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == METRIC and line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert "rc=1" in line["failure"] and "CUDA is not available" in line["failure"]
    assert set(line["link"]) == {"probe_error"}


def test_mfu_uses_the_h100_peak_unless_overridden(monkeypatch):
    assert bench.PEAK_FLOPS_PER_CHIP == 989e12
    assert bench.mfu(1000.0) == round(1000.0 * 4.317e10 / 989e12, 4)
    assert bench.mfu(0.0) is None and bench.mfu(None) is None
    monkeypatch.setenv("IMML_PEAK_FLOPS", "1e15")
    try:
        importlib.reload(bench)
        assert bench.PEAK_FLOPS_PER_CHIP == 1e15
        assert bench.mfu(1000.0) == round(1000.0 * 4.317e10 / 1e15, 4)
    finally:
        monkeypatch.delenv("IMML_PEAK_FLOPS")
        importlib.reload(bench)
    assert bench.PEAK_FLOPS_PER_CHIP == 989e12


def test_images_are_the_jax_benchs(monkeypatch, capsys):
    """The port's bench draws the JAX bench's pixels: both children's
    warm-up and rounds, captured at their extraction calls (the JAX model's
    init and loop stubbed), are the same arrays bit for bit, and equal
    :func:`bench.images` from ``default_rng(0)``."""
    from incremental_multimodal_medical_learning_ii_tpu.cli import linkhealth as jlinkhealth
    from incremental_multimodal_medical_learning_ii_tpu.engine import extract as jextract
    from incremental_multimodal_medical_learning_ii_tpu.models import biovil_image as jbiovil

    def capture(into):
        def fake_extract(images, model, **kw):
            into.append([img.copy() for img, _ in images])
            return _FakeDS(len(into[-1]))
        return fake_extract

    ref, ours = [], []
    monkeypatch.setenv("IMML_BENCH_DEVICE", "0")
    monkeypatch.setattr(jextract, "extract_embeddings", capture(ref))
    monkeypatch.setattr(jbiovil, "init_biovil_image_model", lambda key: None)
    monkeypatch.setattr(jlinkhealth, "quick_probe", lambda **kw: None)
    _small_rounds(monkeypatch, jbench)
    jbench.main()
    monkeypatch.setattr(extract, "extract_embeddings", capture(ours))
    monkeypatch.setattr(device_mod, "resolve_device", lambda device=None: torch.device("cpu"))
    _patch_probe(monkeypatch)
    _small_rounds(monkeypatch, bench)
    bench.main()
    capsys.readouterr()
    assert [len(c) for c in ours] == [len(c) for c in ref] == [4, 8, 8, 8]
    drawn = list(bench.images(28, np.random.default_rng(0)))
    flat_ref = [im for c in ref for im in c]
    for a, b, (c, labels) in zip([im for c in ours for im in c], flat_ref, drawn):
        assert a.dtype == b.dtype == c.dtype == np.uint8 and a.shape == (390, 320)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(labels, np.zeros(5, np.float32))
