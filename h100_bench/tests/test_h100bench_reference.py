"""The plain references against their own float64 runs at a tiny size."""

import numpy as np
import torch

from h100_bench.common import images as img
from h100_bench.common.weights import biovil_weights, joint_data, prompt_bank
from h100_bench.reference import biovil as ref
from h100_bench.reference import joint


def test_biovil_fp32_matches_fp64():
    w = biovil_weights(11, "cpu")
    pics = img.images_at(11, [0, 3], 4, (78, 64), 1)
    e32 = ref.embed_images(w, pics, 64, 64, "cpu")
    e64 = ref.embed_images({k: v.double() for k, v in w.items()}, pics, 64, 64, "cpu", dtype=torch.float64)
    assert float(ref.rel_gap(e32, e64).max()) < 1e-5


def test_biovil_fp8_control_is_coarser():
    w = biovil_weights(12, "cpu")
    pics = img.images_at(12, [1, 2], 4, (78, 64), 1)
    e32 = ref.embed_images(w, pics, 64, 64, "cpu")
    e8 = ref.embed_images(w, pics, 64, 64, "cpu", quant="fp8")
    assert float(ref.rel_gap(e8, e32).max()) > 1e-2


def test_preprocess_matches_pil():
    from PIL import Image

    x = img.block(3, 0, 1, (78, 64))[0]
    ours = ref.preprocess([x], 64, 64, "cpu", torch.float64)[0, 0].numpy() * 255
    pil = np.asarray(Image.fromarray(x, mode="L").resize((64, 78), Image.BILINEAR), np.float64)
    top = int(round((78 - 64) / 2))
    # PIL rounds each pass to uint8; the one-pass product differs by at most one level
    assert np.abs(ours - pil[top:top + 64]).max() <= 1


def test_joint_replay_fp32_matches_fp64():
    p = {"rows": [300, 64, 32], "batch": 64, "eval_batch": 32, "epochs": 2, "lr": 1e-3}
    parts = joint_data(5, "cpu", p["rows"])
    bank = prompt_bank(5, "cpu")
    r32 = joint.replay(9, parts, bank, p, "cpu")
    r64 = joint.replay(9, [(x.double(), y.double()) for x, y in parts], [t.double() if t.is_floating_point()
                                                                          else t for t in bank], p, "cpu")
    numbers = joint.compare({**r32, "final": r32["final"]}, r64)
    assert numbers["loss3_gap"] < 1e-6 and numbers["val_loss_gap"] < 1e-5
    assert numbers["delta_median_gap"] < 1e-4


def test_joint_faults_read_far_from_sound():
    p = {"rows": [300, 64, 32], "batch": 64, "eval_batch": 32, "epochs": 2, "lr": 1e-3}
    parts = joint_data(6, "cpu", p["rows"])
    bank = prompt_bank(6, "cpu")
    want = joint.replay(4, parts, bank, p, "cpu")
    half = joint.compare(joint.replay(4, parts, bank, p, "cpu", fault=("half",)), want)
    alone = joint.compare(joint.replay(4, parts, bank, p, "cpu", fault=("no_exchange", 4)), want)
    assert half["delta_median_gap"] > 1e-3 and alone["loss3_gap"] > 0.5
    unchanged = joint.compare({**want, "final": want["init"]}, want)
    assert unchanged["delta_median_gap"] >= 0.5  # the larger half of the leaves read 1
