"""The control must come out not correct: at least one of the cell's numbers
over its limit.  The image tower's control is the program's own int8 path
(``test_h100bench_faults.py``); the plain reference in fp8, put in the
program's place, must fail too, and runs here at a small size.  The adapters'
control, the reference in TF32, exists only on the card."""

import pytest
import torch

from h100_bench.common import spec
from h100_bench.tools import calibrate

SMALL_IMAGES = {"batch": 4, "image_hw": [390, 320], "size": 128, "crop": 128, "check_images": 8,
                "pool_blocks": 8}


def limits(cell):
    return {k[len("limit_"):]: v for k, v in spec.cell(cell)[2].items() if k.startswith("limit_")}


@pytest.mark.parametrize("seed", [2940000001, 2940000002, 2940000003])
def test_extract_control_fails(seed):
    r = calibrate.extract_readings(SMALL_IMAGES, seed, torch.device("cpu"))
    assert r["emb_rel_gap"] > limits("extract-b512")["emb_rel_gap"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["train-joint", "train-joint-dp4"])
def test_train_control_and_faults_fail(card, cell):
    p = {**spec.cell(cell)[2], "rows": [24576, 4096, 2048], "epochs": 3}
    lim = limits(cell)
    r = calibrate.train_readings(p, 2940000001, card, spec.cell(cell)[0]["chips"])
    for name, numbers in r.items():
        assert any(numbers[k] > lim[k] for k in lim), name
