"""``--mesh-devices`` in the port's drivers (``cli/common.py``): the
data-incremental CLI at two gloo ranks on the CPU against the JAX CLI with
``--mesh-devices 2``, from the same init and epoch orders; the CLI starting
its own ranks against its one-rank run; and the count checks of the JAX
``make_mesh``."""

import glob
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.cli import data_incremental as j_data
from incremental_multimodal_medical_learning_ii_tpu.engine.trainer import Trainer as JTrainer
from incremental_multimodal_medical_learning_ii_tpu.models.adapters import AdapterPair as JPair
from incremental_multimodal_medical_learning_ii_torch.cli import common
from incremental_multimodal_medical_learning_ii_torch.cli import data_incremental as t_data
from incremental_multimodal_medical_learning_ii_torch.evaluation.tb import read_scalars
from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import spawn_ranks

from torch_port_helpers import assert_parity, driver_on_rank, mesh_orders, to_numpy_tree

REPO = Path(__file__).resolve().parent.parent
AUROC_ATOL = 1e-4
LOSS_ATOL = 1e-5
# 4,096 rows a part at batch 500: each epoch's last batch holds 96 rows,
# all on rank 0
FLAGS = ["--synthetic", "--parts", "2", "--epochs", "1", "--batch-size", "500",
         "--continual-learning", "myCL", "--plot-figures", "off"]


def _aurocs(printout: str):
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^(\w+): .*auroc_macro=([0-9.]+)", printout, re.M)}


def _one_stream(log_dir: Path):
    files = glob.glob(str(log_dir / "**" / "events.out.tfevents.*"), recursive=True)
    assert len(files) == 1, files
    streams = {}
    for tag, step, value in read_scalars(files[0]):
        streams.setdefault(tag, []).append((step, value))
    return os.path.relpath(os.path.dirname(files[0]), log_dir), streams


def test_two_ranks_match_the_jax_cli(tmp_path, monkeypatch, capsys):
    tree = to_numpy_tree(JPair(kind="mlp", shared=False, use_image=True,
                                use_text=True).init(jax.random.PRNGKey(27)))
    argv = [*FLAGS, "--device", "cpu", "--mesh-devices", "2", "--log-dir", str(tmp_path / "port")]
    (out0, params0), (out1, params1) = spawn_ranks(driver_on_rank, 2, "cpu", "data_incremental",
                                                   argv, tree)
    assert out0 == out1
    for k in params0:
        np.testing.assert_array_equal(params0[k], params1[k], err_msg=k)
    init = JTrainer.__init__

    def trainer_init(self, *a, **k):
        init(self, *a, **k)
        self.permutation_source = mesh_orders

    monkeypatch.setattr(JTrainer, "__init__", trainer_init)
    j_data.main([*FLAGS, "--mesh-devices", "2", "--log-dir", str(tmp_path / "jax")])
    ours, ref = _aurocs(out0), _aurocs(capsys.readouterr().out)
    assert sorted(ours) == sorted(ref) and len(ref) == 4  # val/test of two parts
    assert_parity("cli mesh auroc_macro", [ours[k] for k in sorted(ref)],
                  [ref[k] for k in sorted(ref)], AUROC_ATOL)
    tname, tstreams = _one_stream(tmp_path / "port")
    jname, jstreams = _one_stream(tmp_path / "jax")
    assert tname == jname
    for tag in ("train/Loss", "val/Loss"):
        assert [s for s, _ in tstreams[tag]] == [s for s, _ in jstreams[tag]]
        assert_parity(f"cli mesh {tag}", [v for _, v in tstreams[tag]],
                      [v for _, v in jstreams[tag]], LOSS_ATOL)


def test_the_cli_starts_its_ranks(tmp_path):
    """``--mesh-devices 2`` from the command line: two ranks, one printout,
    one event stream, and the one-rank run's metrics."""
    def run(n):
        out = subprocess.run(
            [sys.executable, "-m", "incremental_multimodal_medical_learning_ii_torch.cli."
             "data_incremental", *FLAGS, "--device", "cpu", "--mesh-devices", str(n),
             "--log-dir", str(tmp_path / str(n))],
            cwd=REPO, capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
        assert out.returncode == 0, out.stderr[-3000:]
        assert out.stdout.count("run: ") == 1  # rank 0 alone prints
        _one_stream(tmp_path / str(n))
        return _aurocs(out.stdout)

    two, one = run(2), run(1)
    assert sorted(two) == sorted(one) and len(one) == 4
    assert_parity("cli 2 ranks vs 1", [two[k] for k in sorted(one)],
                  [one[k] for k in sorted(one)], AUROC_ATOL)


def test_mesh_devices_counts_as_the_jax_cli(tmp_path, monkeypatch):
    """More ranks than visible devices raise ``need n devices, have m`` in
    both packages before anything runs; 1 is no mesh, 0 is every card."""
    code = ("import sys\nimport jax\njax.config.update('jax_platforms', 'cpu')\n"
            "from incremental_multimodal_medical_learning_ii_tpu.cli import data_incremental\n"
            "try:\n    data_incremental.main(sys.argv[1:])\n"
            "except ValueError as e:\n    print('ValueError:', e)\n")
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    out = subprocess.run([sys.executable, "-c", code, *FLAGS, "--mesh-devices", "3",
                          "--log-dir", str(tmp_path / "jax")],
                         cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.stdout.strip().endswith("ValueError: need 3 devices, have 2"), out.stderr[-2000:]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="^need 3 devices, have 2$"):
        t_data.main([*FLAGS, "--mesh-devices", "3", "--log-dir", str(tmp_path / "port")])
    assert not (tmp_path / "port").exists()

    def size(n, device):
        return common.mesh_size(common.argparse.Namespace(mesh_devices=n, device=device))

    assert [size(1, "cuda"), size(0, "cuda"), size(4, "cuda")] == [1, 2, 4]
    assert [size(1, "cpu"), size(0, "cpu"), size(3, "cpu")] == [1, 1, 3]
