"""``multichip.py::dryrun_multichip``, the port's counterpart of
``__graft_entry__.py::dryrun_multichip``, on two gloo ranks on the CPU:
every multi-device program runs and agrees with its one-device path."""

from incremental_multimodal_medical_learning_ii_torch.multichip import (
    PART_ATOL,
    WIDE_ATOL,
    dryrun_multichip,
)


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    out = dryrun_multichip(2, device="cpu")
    assert (out["backend"], out["transport"]) == ("gloo", "gloo isend/irecv")
    for key in ("tp_err", "sp_err", "pp_err"):
        assert out[key] <= PART_ATOL, (key, out[key])
    assert out["tp_bert_base_err"] <= WIDE_ATOL
    assert 0.0 <= out["fused_run_auroc"] <= 1.0
