"""A run with the timed path broken underneath must read ``correct: false``.

Each test skips the look for a card (``--device cpu``), drives the rest of a
run at a tiny size, and plants one fault the cell can have in the port: an
answer altered where it is produced; a training step that leaves the state
as it was; half of each batch left out, the mean taken over the rest; the
exchange between ranks left out; and the program's own int8 path, the
extraction cell's control.  The sound run beside them reads true."""

import json

import pytest

from h100_bench import run as harness

TINY = {
    "extract-b512": ["--set", "batch=4", "--set", "image_hw=[78,64]", "--set", "size=64", "--set", "crop=64",
                     "--set", 'dtype="float32"', "--set", "warmup_batches=1", "--set", "check_images=6"],
    "train-joint": ["--set", "rows=[600,128,64]", "--set", "batch=128", "--set", "eval_batch=64",
                    "--set", "epochs=2"],
}
TINY["train-joint-dp4"] = TINY["train-joint"]


def judged(cell, capsys, seconds="1", extra=()):
    rc = harness.main(["--workload", cell, "--seed", "4100000123", "--seconds", seconds, "--trace", "0",
                       "--device", "cpu", *TINY[cell], *extra])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["extract-b512", "train-joint"])
def test_sound_run_is_correct(cell, capsys, tmpdir_env):
    assert judged(cell, capsys)["correct"] is True


def test_extract_answer_altered(capsys, tmpdir_env, monkeypatch):
    from incremental_multimodal_medical_learning_ii_torch.engine import extract

    made = extract.make_encode_raw_shared_fn
    monkeypatch.setattr(extract, "make_encode_raw_shared_fn",
                        lambda **kw: (lambda *a, f=made(**kw): f(*a) * 1.05))
    assert judged("extract-b512", capsys)["correct"] is False


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extract_int8_path_is_not_correct(dtype, capsys, tmpdir_env):
    """The program's own lower precision, W8A8 (``int8=True``), is the control."""
    line = judged("extract-b512", capsys, extra=["--set", f'dtype="{dtype}"', "--set", "int8=true"])
    assert line["correct"] is False


def test_train_state_unchanged(capsys, tmpdir_env, monkeypatch):
    from incremental_multimodal_medical_learning_ii_torch.engine import steps

    monkeypatch.setattr(steps, "optimizer_update",
                        lambda cfg, state, grads: (state.params, state.mu, state.nu, state.count + 1))
    assert judged("train-joint", capsys)["correct"] is False


def test_train_half_batch(capsys, tmpdir_env, monkeypatch):
    from incremental_multimodal_medical_learning_ii_torch.engine import steps

    loss = steps._loss

    def half(pair, cfg, params, embs, labels, elem_mask, class_mask, bank, mask_sum=None):
        h = embs.shape[0] // 2
        return loss(pair, cfg, params, embs[:h], labels[:h], elem_mask[:h], class_mask, bank, None)

    monkeypatch.setattr(steps, "_loss", half)
    assert judged("train-joint", capsys)["correct"] is False


def test_train_answer_altered(capsys, tmpdir_env, monkeypatch):
    from incremental_multimodal_medical_learning_ii_torch.engine import steps

    eval_pass = steps._fused_eval_pass

    def altered(*a, **k):
        losses, scores, preds = eval_pass(*a, **k)
        return losses * 1.001, scores, preds

    monkeypatch.setattr(steps, "_fused_eval_pass", altered)
    assert judged("train-joint", capsys)["correct"] is False


def rank_without_exchange(job):
    """A rank whose gradients are never summed over the ranks."""
    from incremental_multimodal_medical_learning_ii_torch.engine import steps

    from h100_bench.drivers import joint_runs

    steps.all_reduce_sum = lambda mesh, t: t
    return joint_runs.rank(job)


@pytest.mark.slow
def test_train_four_ranks_without_exchange(capsys, tmpdir_env, monkeypatch):
    from h100_bench.drivers import joint_runs

    assert judged("train-joint-dp4", capsys, "0.1")["correct"] is True
    monkeypatch.setattr(joint_runs, "rank_fn", rank_without_exchange)
    assert judged("train-joint-dp4", capsys, "0.1")["correct"] is False
