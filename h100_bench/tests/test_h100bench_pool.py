"""The extraction cells' pool of images: drawn in set-up, cycled by the
window, never written by the program, and drawn anew from the seed for
``correct``.  On the CPU at a tiny size, as ``test_h100bench_faults.py``."""

import json

import numpy as np
import pytest

from h100_bench import run as harness
from h100_bench.common import images as img
from h100_bench.common import spec
from h100_bench.drivers import extract_stream
from h100_bench.tests.test_h100bench_faults import TINY

SEED = 4100000321


def tiny_run(*extra):
    args = ["--workload", "extract-b512", "--seed", str(SEED), "--seconds", "1", "--device", "cpu"]
    return harness.build_run(harness.parse([*args, *TINY["extract-b512"], *extra]))


@pytest.mark.parametrize("cell", ["extract-b512", "extract-dinov2g-b512"])
def test_pool_is_eight_blocks_within_its_memory(cell):
    p = spec.cell(cell)[2]
    h, w = p["image_hw"]
    assert p["pool_blocks"] == 8 and p["pool_blocks"] * p["batch"] * h * w <= 0.6e9


def test_stream_cycles_the_pool_as_images_at_redraws_it(tmpdir_env):
    run = tiny_run("--set", "pool_blocks=2")
    extract_stream.draw_pool(run)
    n = run.params["batch"]
    pics = [x for x, _ in extract_stream.stream(run.state["pool"], limit=5)]
    assert len(pics) == 5 * n
    # a block boundary (n - 1, n), the pool's wrap (2n - 1, 2n) and the wrap again (4n)
    idx = [0, n - 1, n, 2 * n - 1, 2 * n, 3 * n + 1, 4 * n, 5 * n - 1]
    want = img.images_at(SEED, idx, n, tuple(run.params["image_hw"]), blocks=2)
    for i, x in zip(idx, want):
        np.testing.assert_array_equal(pics[i], x)
    assert not np.array_equal(pics[0], pics[n])  # two blocks, not one
    np.testing.assert_array_equal(pics[0], pics[2 * n])  # the wrap


def test_stream_sends_the_first_block_however_short_the_window():
    pool = [np.zeros((3, 2, 2), np.uint8), np.ones((3, 2, 2), np.uint8)]
    assert len(list(extract_stream.stream(pool, stop_at=lambda: True))) == 3
    assert len(list(extract_stream.stream(pool, stop_at=lambda: True, limit=0))) == 0
    assert len(list(extract_stream.stream(pool, limit=3))) == 9


def test_pool_bytes_unchanged_by_a_run(tmpdir_env):
    run = tiny_run("--set", "pool_blocks=1")  # the warm-up and every batch of the window send block 0
    drv = spec.driver(run.params["driver"])
    drv.setup(run)
    before = [b.copy() for b in run.state["pool"]]
    drv.window(run)
    assert run.counters["images"] >= run.params["batch"]
    for a, b in zip(before, run.state["pool"]):
        np.testing.assert_array_equal(a, b)
    drv.release(run)
    assert "pool" not in run.state
    drv.check(run)
    assert harness.judged(run)


def test_window_shorter_than_the_loops_start_is_correct(capsys, tmpdir_env):
    """A loaded host: the window ends before the loop asks for a batch."""
    rc = harness.main(["--workload", "extract-b512", "--seed", str(SEED), "--seconds", "0.001",
                       "--trace", "0", "--device", "cpu", *TINY["extract-b512"]])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True and line["attempted"] == 4  # one batch of 4


def test_program_writing_into_its_inputs_is_not_correct(capsys, tmpdir_env, monkeypatch):
    """The check draws the images anew, so a program that spoils the pool it
    is handed (each image halved in place as it is batched) reads false."""
    from incremental_multimodal_medical_learning_ii_torch.engine import extract

    batched = extract._batched

    def spoiling(it, batch_size):
        for imgs, labels, n in batched(it, batch_size):
            for x in imgs:
                x //= 2
            yield imgs, labels, n

    monkeypatch.setattr(extract, "_batched", spoiling)
    rc = harness.main(["--workload", "extract-b512", "--seed", str(SEED), "--seconds", "1", "--trace", "0",
                       "--device", "cpu", *TINY["extract-b512"]])
    assert rc == 0 and json.loads(capsys.readouterr().out.strip().splitlines()[-1])["correct"] is False
