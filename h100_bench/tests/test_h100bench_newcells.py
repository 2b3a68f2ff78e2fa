"""The two cells added with the DINOv2 tower: the tower's frozen counts
against ``torch.utils.flop_counter``, the benchmark's plain reference
against the port's tower, the sound run against planted faults and the
control (the reference with each block's output rounded to fp8), and the
class-incremental replay against the program, all on the CPU at small
sizes."""

import json
import tempfile
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import run as harness
from h100_bench.common import dinov2_counts, spec
from h100_bench.common.dinov2_weights import dinov2_weights, param_specs
from h100_bench.reference import dinov2 as ref
from h100_bench.tools import calibrate_cells

CELL = "extract-dinov2g-b512"
# the configuration at small widths: 4 blocks of 128, 2 heads of 64, a 4 x 4 grid (56²)
SMALL = {"hidden_size": 128, "num_hidden_layers": 4, "num_attention_heads": 2, "head_dim": 64,
         "ffn_hidden_size": 96, "image_size": 56}
SMALL_TRAFFIC = {"batch": 4, "size": 56, "crop": 56, "image_hw": [78, 64], "warmup_batches": 1,
                 "check_images": 6}


def small_cell(**traffic):
    entry, config, params = spec.cell(CELL)
    return entry, {**config, **SMALL}, {**params, **SMALL_TRAFFIC, **traffic}


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("registers", [0, 4])
def test_tower_flops_against_the_flop_counter(registers):
    _, cfg, _ = small_cell()
    cfg = {**cfg, "num_register_tokens": registers}
    w = dinov2_weights(1, "cpu", cfg)
    x = torch.rand(1, 3, 56, 56)
    assert _counted(lambda: ref.forward(w, x, cfg)) == pytest.approx(
        dinov2_counts.vit_flops_per_image(cfg, in_channels=3), rel=1e-9)
    assert dinov2_counts.tokens(cfg) == 1 + registers + 16


def test_published_counts():
    cfg = spec.cell(CELL)[1]
    assert dinov2_counts.tokens(cfg) == cfg["tokens"] == 1374
    assert dinov2_counts.block_flops(cfg) == pytest.approx(89.399e9, rel=1e-4)
    assert sum(__import__("math").prod(s) for _, s, _ in param_specs(cfg)) == cfg["parameters"]
    ops, byts = dinov2_counts.k3_counts(512, 24, 1374, 64)
    q = torch.rand(2, 3, 10, 64)
    assert _counted(lambda: (q @ q.transpose(-1, -2)) @ q) == dinov2_counts.k3_counts(2, 3, 10, 64)[0]
    assert ops == pytest.approx(5.9387e12, rel=1e-4) and byts == 4 * 512 * 24 * 1374 * 64 * 2


def test_reference_matches_the_port_tower():
    from h100_bench.drivers.extract_tower import build_model
    from incremental_multimodal_medical_learning_ii_torch.models.dinov2 import dinov2_forward

    _, cfg, _ = small_cell()
    w = dinov2_weights(2, "cpu", cfg)
    pixels = torch.rand(3, 56, 56)
    want = ref.forward(w, ref.normalize(pixels[:, None].expand(-1, 3, -1, -1), cfg), cfg)
    got = dinov2_forward(build_model(w, cfg, "cpu"), pixels[..., None].expand(-1, -1, -1, 3))
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def _run(entry, config, params, seed=3000000017):
    drv = spec.driver(params["driver"])
    with tempfile.TemporaryDirectory() as tmp:
        # a window of 2 s: the stream is cut at the first block drawn after it ends, and on a
        # loaded host the loop's set-up can take most of a shorter one
        run = spec.Run(workload=CELL, entry=entry, config=config, params=params, seed=seed, seconds=2.0,
                       trace=False, device=torch.device("cpu"), tmp=Path(tmp))
        drv.setup(run)
        drv.window(run)
        drv.release(run)
        drv.check(run)
    return run


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sound_tower_run_is_correct(dtype):
    run = _run(*small_cell(dtype=dtype))
    assert harness.judged(run) and run.counters["vit_images"] >= run.counters["images"] > 0
    assert run.counters["vit_attention_launches"] == 4 * run.counters["batches"]  # the window's alone


def test_tower_answer_altered(monkeypatch):
    from incremental_multimodal_medical_learning_ii_torch.engine import extract

    tower = extract.image_tower

    def altered(model):
        t = tower(model)
        return t.__class__(t.name, t.width, t.fold_grayscale, t.quantize_int8,
                           lambda *a: t.forward(*a) * 1.05)

    monkeypatch.setattr(extract, "image_tower", altered)
    assert not harness.judged(_run(*small_cell()))


@pytest.mark.parametrize("seed", [2950000101, 2950000102])
def test_fp8_control_fails(seed):
    """The control's gap grows with the blocks it rounds: 0.149-0.160 at the
    configuration's 40 (PERF.md), about 0.042 at 8 blocks of 128 here."""
    _, config, params = small_cell()
    config = {**config, "num_hidden_layers": 8}
    r = calibrate_cells.tower_control(params, config, seed, torch.device("cpu"))
    assert r["emb_rel_gap"] > spec.cell(CELL)[2]["limit_emb_rel_gap"]


TINY_TRAIN = ["--set", "rows=[2000,128,64]", "--set", "batch=256", "--set", "eval_batch=64",
              "--set", "epochs=3"]


def judged_train(capsys):
    rc = harness.main(["--workload", "train-classinc-mycl", "--seed", "4100000123", "--seconds", "1",
                       "--trace", "0", "--device", "cpu", *TINY_TRAIN])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_class_incremental_run_against_its_replay(capsys, tmpdir_env):
    line = judged_train(capsys)
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["checks"]) == {"loss3_gap", "delta_median_gap", "val_loss_gap", "resets_gap",
                                   "moments_gap", "count_gap"}
    assert line["checks"]["count_gap"]["value"] == 0


def test_class_incremental_state_unchanged(capsys, tmpdir_env, monkeypatch):
    from incremental_multimodal_medical_learning_ii_torch.engine import steps

    monkeypatch.setattr(steps, "optimizer_update",
                        lambda cfg, state, grads: (state.params, state.mu, state.nu, state.count + 1))
    assert judged_train(capsys)["correct"] is False


def test_class_incremental_half_batch(capsys, tmpdir_env, monkeypatch):
    from incremental_multimodal_medical_learning_ii_torch.engine import steps

    loss = steps._loss

    def half(pair, cfg, params, embs, labels, elem_mask, class_mask, bank, mask_sum=None):
        kept = elem_mask.clone()
        kept[embs.shape[0] // 2:] = 0  # the second half of the rows masked out, the mean over the rest
        return loss(pair, cfg, params, embs, labels, kept, class_mask, bank, None)

    monkeypatch.setattr(steps, "_loss", half)
    assert judged_train(capsys)["correct"] is False


def test_class_incremental_without_resets(capsys, tmpdir_env, monkeypatch):
    """myCL's resets left out: every weight keeps its update, none is counted."""
    import torch

    from incremental_multimodal_medical_learning_ii_torch.engine import steps

    def none_reset(params, snapshot, threshold, applications=1):
        total = sum(p.numel() for p in params.values())
        zero = torch.zeros((), dtype=torch.int32)
        return params, zero, zero + total

    monkeypatch.setattr(steps, "weight_reset", none_reset)
    line = judged_train(capsys)
    assert line["correct"] is False and line["checks"]["resets_gap"]["value"] == 1.0


def _zero_moments(state):
    return state._replace(mu={k: torch.zeros_like(v) for k, v in state.mu.items()},
                          nu={k: torch.zeros_like(v) for k, v in state.nu.items()})


def _plant_in_emit(monkeypatch, spoil):
    """The state ``emit_incremental_unit`` hands on spoiled after every unit:
    what the program carries, not what it computed."""
    from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer

    emit = Trainer.emit_incremental_unit

    def spoiled(trainer, idx, **kw):
        out = emit(trainer, idx, **kw)
        trainer.state = spoil(trainer.state)
        return out

    monkeypatch.setattr(Trainer, "emit_incremental_unit", spoiled)


def _plant_in_run(monkeypatch, spoil):
    """The fused run starts every unit but the first from a spoiled state."""
    from incremental_multimodal_medical_learning_ii_torch.engine import steps

    of = steps._Epochs.of

    def spoiled_of(self, *a, **kw):
        epoch = of(self, *a, **kw)
        self.units_seen = getattr(self, "units_seen", 0) + 1
        pending = [self.units_seen > 1]

        def first_spoiled(state, *b):
            if pending[0]:
                pending[0] = False
                state = spoil(state)
            return epoch(state, *b)

        return first_spoiled

    monkeypatch.setattr(steps._Epochs, "of", spoiled_of)


@pytest.mark.parametrize("where,spoil,caught_by", [
    ("emit", _zero_moments, "moments_gap"),
    ("emit", lambda st: st._replace(count=torch.zeros_like(st.count)), "count_gap"),
    ("run", _zero_moments, "delta_median_gap"),
])
def test_class_incremental_state_spoiled_at_unit_boundary(capsys, tmpdir_env, monkeypatch, where, spoil,
                                                          caught_by):
    """Adam's moments or count reset between units: where emit hands on the
    reset state, the held unit-end state catches it; where the run trains on
    from it, the next unit's change does."""
    (_plant_in_emit if where == "emit" else _plant_in_run)(monkeypatch, spoil)
    line = judged_train(capsys)
    assert line["correct"] is False
    check = line["checks"][caught_by]
    assert check["value"] > check["limit"]


def test_class_incremental_eval_scores_altered(capsys, tmpdir_env, monkeypatch):
    """The val pass scores the program's own parameters in the replay, so a
    fault in the eval arithmetic alone (each eval batch's logits 1% off)
    shows in the val losses while training is untouched."""
    from incremental_multimodal_medical_learning_ii_torch.engine import steps

    score = steps._score_batch

    def skewed(*a, **kw):
        out = score(*a, **kw)
        return out._replace(logits=out.logits * 1.01)

    monkeypatch.setattr(steps, "_score_batch", skewed)
    line = judged_train(capsys)
    assert line["correct"] is False
    assert line["checks"]["val_loss_gap"]["value"] > line["checks"]["val_loss_gap"]["limit"]
    assert line["checks"]["loss3_gap"]["value"] <= line["checks"]["loss3_gap"]["limit"]
