"""The port's cli/reproduce.py against the JAX package's: ``--dry-run`` on
the CPU with the JAX adapter init and the same epoch orders injected into
both; every gate's AUROC within 1e-4 (the drivers' metric bar)."""

import jax
import numpy as np
import pytest

from incremental_multimodal_medical_learning_ii_tpu.cli import reproduce as j_repro
from incremental_multimodal_medical_learning_ii_tpu.engine import protocols as jprot
from incremental_multimodal_medical_learning_ii_tpu.engine.trainer import Trainer as JTrainer
from incremental_multimodal_medical_learning_ii_tpu.models.adapters import AdapterPair as JPair
from incremental_multimodal_medical_learning_ii_torch.cli import reproduce as t_repro
from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer as TTrainer
from incremental_multimodal_medical_learning_ii_torch.models.adapters import AdapterPair as TPair

from torch_port_helpers import one_torch_thread, to_numpy_tree  # noqa: F401

AUROC_ATOL = 1e-4


def _orders(epoch, n):
    return np.random.default_rng(2000 + epoch).permutation(n)


@pytest.fixture
def injected(monkeypatch):
    """Both trainers start from the JAX init and draw the same orders; the
    JAX gates' results are captured as they return."""
    for cls in (JTrainer, TTrainer):
        orig = cls.__init__

        def init(self, *a, _orig=orig, **k):
            _orig(self, *a, **k)
            self.permutation_source = _orders

        monkeypatch.setattr(cls, "__init__", init)

    def port_init(self, generator=None):
        jpair = JPair(kind=self.kind, shared=self.shared, use_image=self.use_image,
                      use_text=self.use_text)
        return params_from_jax(to_numpy_tree(jpair.init(jax.random.PRNGKey(27))))

    monkeypatch.setattr(TPair, "init", port_init)
    captured = []
    for name in ("run_zero_joint", "run_class_incremental"):
        orig = getattr(jprot, name)

        def run(*a, _orig=orig, **k):
            out = _orig(*a, **k)
            captured.append(out)
            return out

        monkeypatch.setattr(jprot, name, run)
    return captured


def test_dry_run_matches_jax(tmp_path, injected, capsys):
    # the JAX gates write figures by default; the port has none (off)
    j_repro.main(["--dry-run", "--log-dir", str(tmp_path / "jax"), "--mesh-devices", "1"])
    zero, joint, cls = injected
    ref = {
        "zero-shot": zero["test_zero"]["auroc_macro"],
        "joint": max(joint["test_ep1"]["auroc_macro"], joint["test_ep1"]["auroc_macro"]),
        "class-inc": cls["test_task5"]["auroc_macro"],
    }
    ref_curve = [cls[f"test_task{t}"]["auroc_macro"] for t in range(1, 6)]
    capsys.readouterr()
    ours = t_repro.main(["--dry-run", "--log-dir", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "dry-run OK" in out
    assert set(ours) == set(ref)
    for gate, want in ref.items():
        got = ours[gate]["measured"]
        print(f"PARITY reproduce --dry-run {gate}: |port - jax| = {abs(got - want):.3e}")
        assert abs(got - want) <= AUROC_ATOL, (gate, got, want)
        line = next(ln for ln in out.splitlines() if ln.startswith(f"{gate}: "))
        assert f"= {got:.4f} (reference " in line and "[wall " in line
    np.testing.assert_allclose(ours["class-inc"]["curve"], ref_curve, atol=AUROC_ATOL, rtol=0)


def test_unported_flags_raise(tmp_path):
    for flags in (["--plot-figures", "final"], ["--trace-dir", str(tmp_path)],
                  ["--mesh-devices", "2"]):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            t_repro.main(["--dry-run", "--device", "cpu", "--log-dir", str(tmp_path), *flags])
