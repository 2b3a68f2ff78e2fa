"""Port evaluation/tb.py: the port writes TensorBoard event files without
the ``tensorboard`` package; TensorBoard's own reader (installed here)
must read them back with the same scalars as the JAX writer's file."""

import glob

import numpy as np
import pytest
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from incremental_multimodal_medical_learning_ii_tpu.evaluation.tb import TBWriter as JWriter
from incremental_multimodal_medical_learning_ii_torch.evaluation import plots, tb
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
    # figures are buffered with the scalars: discarded with them, written
    # in order as RGB PNG image events, none by a rank above 0
    fig = plots.class_scatter_figure(np.array([0.5, 0.25]), "Recall")
    w2 = TBWriter(str(tmp_path / "figs"))
    w2.add_figure("dropped", fig, 1)
    w2.discard()
    w2.add_scalar("c", 4.0, 2)
    w2.add_figure("kept", fig, 2)
    w2.close()
    (f2,) = glob.glob(str(tmp_path / "figs" / "events.out.tfevents.*"))
    assert tb.read_scalars(f2) == [("c", 2, 4.0)]
    ((tag, step, image),) = tb.read_images(f2)
    assert (tag, step, image["height"], image["width"], image["colorspace"]) == ("kept", 2, 480,
                                                                                 640, 3)
    assert image["png"] == fig.png()
    other = TBWriter(str(tmp_path / "rank1"))
    other.rank = 1
    other.add_figure("x", fig, 1)
    other.close()
    assert not (tmp_path / "rank1").exists()


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


def test_image_events_read_back_through_tensorboard_like_torchs_writer(tmp_path):
    """A figure's image event against ``SummaryWriter.add_image`` of the same
    pixels (the JAX writer's path for its matplotlib figures): TensorBoard
    reads the same tag, step, size and colour space from both files, and
    both PNGs decode to the same pixels; a failing commit keeps only what
    it did not write."""
    import io

    from PIL import Image
    from torch.utils.tensorboard import SummaryWriter

    fig = plots.heatmap_figure(np.eye(3), ["a", "b", "c"], ["a", "b", "c"], "F1 score", "F1")
    ref = SummaryWriter(str(tmp_path / "torch"))
    ref.add_image("h/F1 score Heatmap", np.asarray(fig.image), 3, dataformats="HWC")
    ref.close()
    w = TBWriter(str(tmp_path / "port"))
    w.add_figure("h/F1 score Heatmap", fig, 3)
    w.close()
    decoded = {}
    for d in ("torch", "port"):
        acc = EventAccumulator(str(tmp_path / d), size_guidance={"images": 0})
        acc.Reload()
        (event,) = acc.Images("h/F1 score Heatmap")
        assert (event.step, event.height, event.width) == (3, 480, 640)
        decoded[d] = np.asarray(Image.open(io.BytesIO(event.encoded_image_string)).convert("RGB"))
    np.testing.assert_array_equal(decoded["port"], decoded["torch"])

    class Broken:
        size = (640, 480)

        def png(self):
            raise RuntimeError("render failed")

    w = TBWriter(str(tmp_path / "retry"))
    w.add_scalar("a", 1.0, 1)
    w.add_figure("bad", Broken(), 1)
    with pytest.raises(RuntimeError, match="render failed"):
        w.commit()
    w.discard()
    w.close()
    (f,) = glob.glob(str(tmp_path / "retry" / "events.out.tfevents.*"))
    assert tb.read_scalars(f) == [("a", 1, 1.0)] and tb.read_images(f) == []
