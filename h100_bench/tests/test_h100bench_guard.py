"""The run's own guards: JAX and the JAX package must not be loaded in the
process that prints the result, nor in a rank it spawned (top-level names
compared whole); a run without a card prints nothing; the harness alone
cannot run."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from h100_bench import run as harness
from h100_bench.common import spec


def test_forbidden_names_compared_whole():
    loaded = ["jax.numpy", "jaxlib.xla_client", "flax", "incremental_multimodal_medical_learning_ii_tpu.ops",
              "incremental_multimodal_medical_learning_ii_torch.ops", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(loaded) == [
        "flax", "incremental_multimodal_medical_learning_ii_tpu", "jax", "jaxlib"]
    assert harness.forbidden_modules(["incremental_multimodal_medical_learning_ii_torch", "jaxtyping"]) == []


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "-m", "h100_bench.run", *args], cwd=cwd, capture_output=True,
                          text=True, timeout=600, env=env)


def test_a_cpu_run_loads_no_jax(tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path))
    res = _run(["--workload", "train-joint", "--seed", "4000000001", "--seconds", "0.5", "--trace", "0",
                "--device", "cpu", "--set", "rows=[400,64,32]", "--set", "batch=64", "--set", "eval_batch=32",
                "--set", "epochs=1"], spec.ROOT, env)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}


def test_without_a_card_no_result(tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path), CUDA_VISIBLE_DEVICES="")
    res = _run(["--workload", "extract-b512", "--seed", "1", "--seconds", "1", "--trace", "0"], spec.ROOT, env)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_harness_alone_cannot_run(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "h100_bench", ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, TMPDIR=str(tmp_path / "tmp"), PYTHONPATH="")
    res = _run(["--workload", "train-joint", "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
               tmp_path, env)
    assert res.returncode != 0 and res.stdout.strip() == ""


def rank_loading_jax(job):
    """A rank that loads a module named ``jax`` (a stub) before its window."""
    from h100_bench.drivers import joint_runs

    sys.modules["jax"] = types.ModuleType("jax")
    return joint_runs.rank(job)


@pytest.mark.slow
def test_a_rank_that_loads_jax_fails_the_run(capsys, tmpdir_env, monkeypatch):
    from h100_bench.drivers import joint_runs

    monkeypatch.setattr(joint_runs, "rank_fn", rank_loading_jax)
    rc = harness.main(["--workload", "train-joint-dp4", "--seed", "4100000124", "--seconds", "0.1",
                       "--trace", "0", "--device", "cpu", "--set", "rows=[600,128,64]", "--set", "batch=128",
                       "--set", "eval_batch=64", "--set", "epochs=1"])
    out = capsys.readouterr()
    assert rc == 4 and out.out.strip() == ""
    assert "jax" in out.err.strip().splitlines()[-1]
