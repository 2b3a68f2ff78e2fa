"""The myCL reset knife edge at the reference's scale: the port's
data-incremental CLI against the JAX CLI, both on the CPU.

191,027 train rows (16,027 val, 2,048 test) of synthetic 128-d embeddings
in 20 contiguous parts, bs 6144, 10 epochs a part, Adam lr 1e-4, myCL with
threshold scheduling, ``--no-shuffle`` (``DATA_INCREMENTAL.py:44-68``; 400
steps), the JAX adapter init carried across.  The reset counts of every
logged step (each epoch's last) are held to the bound the JAX package
measured against the reference at this operating point
(``PARITY.md:177-183``: at most 434 flips a step), the loss streams to
1e-5.  Marked ``slow``: over a minute of CPU."""

import glob
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from incremental_multimodal_medical_learning_ii_tpu.cli import data_incremental as j_data
from incremental_multimodal_medical_learning_ii_tpu.models.adapters import AdapterPair as JPair
from incremental_multimodal_medical_learning_ii_torch.cli import data_incremental as t_data
from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
from incremental_multimodal_medical_learning_ii_torch.data.store import synthetic_dataset
from incremental_multimodal_medical_learning_ii_torch.evaluation.tb import read_scalars
from incremental_multimodal_medical_learning_ii_torch.models.adapters import AdapterPair as TPair

from torch_port_helpers import to_numpy_tree

RESET_BOUND = 434  # PARITY.md:177-183, JAX vs the reference at this operating point
LOSS_ATOL = 1e-5


def _streams(log_dir: Path) -> dict:
    files = sorted(glob.glob(str(log_dir / "**" / "events.out.tfevents.*"), recursive=True))
    assert len(files) == 1, files
    out: dict = {}
    for tag, step, value in read_scalars(files[0]):
        out.setdefault(tag, []).append((step, value))
    return out


@pytest.mark.slow
def test_mycl_resets_at_reference_scale(tmp_path, monkeypatch):
    rng = np.random.default_rng(27)
    dirs = rng.normal(size=(5, 128)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    for split, n, seed in (("train", 191_027, 1), ("val", 16_027, 2), ("test", 2_048, 3)):
        synthetic_dataset(n, seed=seed, class_directions=dirs).save(tmp_path / f"{split}.npz")

    def port_init(self, generator=None):
        jpair = JPair(kind=self.kind, shared=self.shared, use_image=self.use_image,
                      use_text=self.use_text)
        return params_from_jax(to_numpy_tree(jpair.init(jax.random.PRNGKey(27))))

    monkeypatch.setattr(TPair, "init", port_init)
    flags = ["--data-dir", str(tmp_path), "--parts", "20", "--continual-learning", "myCL",
             "--no-shuffle", "--plot-figures", "off"]
    t0 = time.perf_counter()
    j_data.main([*flags, "--log-dir", str(tmp_path / "jax"), "--mesh-devices", "1"])
    t1 = time.perf_counter()
    t_data.main([*flags, "--log-dir", str(tmp_path / "port"), "--device", "cpu"])
    t2 = time.perf_counter()
    js, ts = _streams(tmp_path / "jax"), _streams(tmp_path / "port")
    for tag in ("train/Loss", "val/Loss"):
        a, b = np.array([v for _, v in ts[tag]]), np.array([v for _, v in js[tag]])
        print(f"PARITY scale {tag}: max |port - jax| = {np.abs(a - b).max():.3e}")
        np.testing.assert_allclose(a, b, atol=LOSS_ATOL, rtol=0, err_msg=tag)
    steps_j = [s for s, _ in js["monitor-resets/resets"]]
    # the reference logs the counts of each epoch's last step (Trainer.py:758-770):
    # 19 myCL parts x 10 epochs
    assert [s for s, _ in ts["monitor-resets/resets"]] == steps_j and len(steps_j) == 190
    rj = np.array([v for _, v in js["monitor-resets/resets"]])
    rt = np.array([v for _, v in ts["monitor-resets/resets"]])
    diff = np.abs(rt - rj)
    print(f"PARITY scale resets/step: max {diff.max():.0f} at step {steps_j[int(diff.argmax())]}, "
          f"p99 {np.percentile(diff, 99):.1f}, p50 {np.percentile(diff, 50):.1f}, "
          f"steps over {RESET_BOUND}: {int((diff > RESET_BOUND).sum())}; "
          f"jax resets/step mean {rj.mean():.0f}; wall jax {t1 - t0:.1f}s port {t2 - t1:.1f}s")
    assert diff.max() <= RESET_BOUND, (diff.max(), steps_j[int(diff.argmax())])
