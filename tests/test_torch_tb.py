"""Port evaluation/tb.py: the port writes TensorBoard event files without
the ``tensorboard`` package; TensorBoard's own reader (installed here)
must read them back with the same scalars as the JAX writer's file."""

import glob

import numpy as np
import pytest
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from incremental_multimodal_medical_learning_ii_tpu.evaluation.tb import TBWriter as JWriter
from incremental_multimodal_medical_learning_ii_torch.evaluation import tb
from incremental_multimodal_medical_learning_ii_torch.evaluation.tb import TBWriter

SCALARS = [("train/Loss", 0.6931, 1), ("train/Loss", 0.5, 2), ("val/AUROC-macro", 0.75, 1),
           ("monitor-resets/resets", 131840, 7), ("val/Loss", 1e-9, 0),
           ("max-mean-comparison/pos", -0.25, 300000), ("test/F1-macro score", float("nan"), 3)]


def _accumulate(log_dir):
    acc = EventAccumulator(str(log_dir), size_guidance={"scalars": 0})
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def _write(writer_cls, log_dir):
    w = writer_cls(str(log_dir))
    for tag, value, step in SCALARS[:3]:
        w.add_scalar(tag, value, step)
    w.commit()
    for tag, value, step in SCALARS[3:]:
        w.add_scalar(tag, value, step)
    w.close()


def test_event_file_reads_back_through_tensorboard_like_the_jax_writers(tmp_path):
    _write(JWriter, tmp_path / "jax")
    _write(TBWriter, tmp_path / "port")
    ref, got = _accumulate(tmp_path / "jax"), _accumulate(tmp_path / "port")
    assert sorted(got) == sorted(ref) == sorted({t for t, _, _ in SCALARS})
    for tag in ref:
        np.testing.assert_array_equal(np.array(got[tag]), np.array(ref[tag]), err_msg=tag)
    # the port's own reader agrees with TensorBoard's, on both files
    for d in ("jax", "port"):
        (f,) = glob.glob(str(tmp_path / d / "events.out.tfevents.*"))
        mine = {}
        for tag, step, value in tb.read_scalars(f):
            mine.setdefault(tag, []).append((step, value))
        for tag in ref:
            np.testing.assert_array_equal(np.array(mine[tag]), np.array(ref[tag]), err_msg=tag)


def test_buffer_commit_and_discard(tmp_path):
    w = TBWriter(str(tmp_path))
    w.add_scalar("a", 1.0, 1)
    w.commit()
    w.add_scalar("a", 2.0, 2)
    w.discard()  # a crashed unit's events never reach the file
    w.add_scalar("b", 3.0, 1)
    w.close()
    (f,) = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    assert tb.read_scalars(f) == [("a", 1, 1.0), ("b", 1, 3.0)]
    off = TBWriter(None)
    off.add_scalar("a", 1.0, 1)
    off.close()
    assert not off.enabled
    with pytest.raises(NotImplementedError, match="not yet ported: figures need matplotlib"):
        w.add_figure("x", None)


def test_crc32c_and_corruption():
    assert tb.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    rec = tb.record(tb.encode_event(1.0, 5, scalar=("t", 2.0)))
    assert len(rec) == 16 + len(tb.encode_event(1.0, 5, scalar=("t", 2.0)))


def test_corrupt_file_is_refused(tmp_path):
    p = tmp_path / "events.out.tfevents.0"
    data = bytearray(tb.record(tb.encode_event(1.0, 5, scalar=("t", 2.0))))
    data[-6] ^= 0xFF
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        tb.read_scalars(p)
