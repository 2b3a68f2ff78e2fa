"""A dry run of every multi-device program of the port over ``n`` ranks
(counterpart of the JAX package's ``__graft_entry__.py::dryrun_multichip``).

    python -c "from incremental_multimodal_medical_learning_ii_torch.multichip \\
        import dryrun_multichip; dryrun_multichip(2, device='cpu')"

One process a rank (``parallel/mesh.py::spawn_ranks``): gloo on the CPU,
NCCL on the cards (one card a rank).  Each rank runs, at toy sizes unless
it says otherwise:

1. the data-parallel trainer (``Trainer(mesh=)``): a fused epoch of two
   steps with the myCL reset, the fused eval pass behind ``validate``, an
   eval-folded fused unit, and the whole-run fold of two units;
2. one extraction batch with ``mesh=`` (``engine/extract.py``);
3. the text tower's tensor-parallel encode on a ``(n / m, m)`` mesh against
   the dense encode, then at BERT-base width (12 heads of 64, 3072 FFN
   units; all 12 layers on cards, 2 on the CPU);
4. the sequence-parallel (ring attention) and pipeline-parallel encodes
   against the dense encode.

Rank 0 prints one line a program and the result is rank 0's dict of
checks; any disagreement raises.
"""

from __future__ import annotations

import numpy as np
import torch

PART_ATOL = 2e-5  # the partitions against the dense encode (tests/test_tp.py:50)
WIDE_ATOL = 5e-5  # at BERT-base width (tests/test_tp.py:103)


def _inner(n: int) -> int:
    """The inner axis of an ``n``-rank 2-D mesh, as the JAX dry run picks it."""
    return 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)


def _check_close(name: str, got: torch.Tensor, ref: torch.Tensor, atol: float) -> float:
    err = float((got - ref).abs().max())
    if not err <= atol:
        raise AssertionError(f"{name}: {err:.3g} from the dense encode (bar {atol:g})")
    return err


def _trainer_programs(mesh, out: dict) -> None:
    from incremental_multimodal_medical_learning_ii_torch.data.store import (
        split_contiguous,
        synthetic_dataset,
    )
    from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer
    from incremental_multimodal_medical_learning_ii_torch.text.bank import (
        build_prompt_bank,
        synthetic_encode_fn,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
        joint_config,
    )

    n = mesh.size
    batch = 8 * n
    cfg = joint_config(batch_size=batch, eval_batch_size=batch, epochs=1, lr=1e-3,
                       continual_learning="myCL", prompt_mode="max", fused_unit=True)
    bank = build_prompt_bank(synthetic_encode_fn(), create_prompts(CHEXPERT_COMPETITION_TASKS),
                             CHEXPERT_COMPETITION_TASKS)
    trainer = Trainer(cfg, bank, mesh=mesh)
    ds = synthetic_dataset(2 * batch, seed=0)  # two batches: a fused epoch of two steps
    trainer.train(ds, epoch=1, threshold=0.1, actual_task=2)  # the myCL reset on
    if int(trainer.state.step) != 2:
        raise AssertionError(f"fused epoch: {int(trainer.state.step)} steps, not 2")
    print(f"dryrun_multichip({n}): fused epoch OK (2 steps, batch rows over {n} ranks)")
    auroc = trainer.validate(ds, 1, 1)["auroc_macro"]
    out["fused_eval_auroc"] = float(auroc)
    print(f"dryrun_multichip({n}): fused eval OK (auroc={auroc:.3f})")

    val = synthetic_dataset(batch, seed=1)
    trainer.train_unit(ds, [0.1, 0.1], part=1, actual_task=2, eval_data=(val, val))
    auroc = trainer.validate(val, 1, 1)["auroc_macro"]
    if int(trainer.state.step) != 6:
        raise AssertionError(f"fused unit: {int(trainer.state.step)} steps in all, not 6")
    out["fused_unit_auroc"] = float(auroc)
    print(f"dryrun_multichip({n}): eval-folded fused unit OK (auroc={auroc:.3f})")

    run = Trainer(cfg, bank, mesh=mesh)
    units = split_contiguous(ds, 2)
    if not run.incremental_run_fusible(units, (val, val)):
        raise AssertionError("the whole-run fold does not take two one-epoch units")
    run.train_incremental_run(units, [[0.0], [0.1]], use_my_cl_units=[False, True],
                              use_prof_units=[False, False], eval_data=(val, val))
    run.emit_incremental_unit(0, part=1, actual_task=1)
    run.emit_incremental_unit(1, part=2, actual_task=2)
    auroc = run.validate(val, 1, 1)["auroc_macro"]
    out["fused_run_auroc"] = float(auroc)
    print(f"dryrun_multichip({n}): whole-run fold OK (auroc={auroc:.3f})")
    for key in ("fused_eval_auroc", "fused_unit_auroc", "fused_run_auroc"):
        if not np.isfinite(out[key]):
            raise AssertionError(f"{key} is {out[key]}")


def _extraction(mesh, out: dict) -> None:
    from incremental_multimodal_medical_learning_ii_torch.engine.extract import extract_embeddings
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        init_biovil_image_model,
    )

    n = mesh.size
    rng = np.random.default_rng(0)
    imgs = [(rng.integers(0, 256, size=(70, 60), dtype=np.uint8), np.zeros(5, np.float32))
            for _ in range(2 * n)]
    model = init_biovil_image_model(torch.Generator().manual_seed(0))
    emb = extract_embeddings(iter(imgs), model, batch_size=2 * n, size=64, pad_to=128,
                             dtype=torch.float32, mesh=mesh).embeddings
    if emb.shape != (2 * n, 128) or not np.isfinite(emb).all():
        raise AssertionError(f"mesh extraction: {emb.shape}, finite {np.isfinite(emb).all()}")
    print(f"dryrun_multichip({n}): mesh extraction OK")


def _text_programs(world, out: dict) -> None:
    from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import (
        BertDims,
        get_projected_text_embeddings,
        init_cxr_bert,
        tiny_bert_dims,
    )
    from incremental_multimodal_medical_learning_ii_torch.parallel import pp, sp, tp

    n, inner, dev = world.size, _inner(world.size), world.device
    rng = np.random.default_rng(0)

    def tokens(vocab, b, s, pad=0):
        ids = torch.from_numpy(rng.integers(0, vocab, size=(b, s)).astype(np.int32)).to(dev)
        mask = torch.ones_like(ids)
        if pad:
            mask[0, -pad:] = 0
        return ids, mask

    def dense(model, ids, mask):
        return get_projected_text_embeddings(model, ids, mask, normalize=True)

    dims = tiny_bert_dims(num_heads=8, intermediate_size=64)
    bert = init_cxr_bert(torch.Generator().manual_seed(1), dims).to(dev)
    mesh = tp.create_mesh_2d(n // inner, inner)
    ids, mask = tokens(dims.vocab_size, 2 * n, 12)
    got = tp.make_tp_text_encode(dims, mesh)(tp.shard_bert_tp(bert, mesh), ids, mask)
    out["tp_err"] = _check_close("TP", got, dense(bert, ids, mask), PART_ATOL)
    print(f"dryrun_multichip({n}): TP text encode OK (mesh {n // inner}x{inner})")

    wide_dims = BertDims(num_layers=12 if dev.type == "cuda" else 2)
    wide = init_cxr_bert(torch.Generator().manual_seed(2), wide_dims).to(dev)
    ids_w, mask_w = tokens(wide_dims.vocab_size, 2 * n, 32, pad=5)
    got = tp.make_tp_text_encode(wide_dims, mesh)(tp.shard_bert_tp(wide, mesh), ids_w, mask_w)
    out["tp_bert_base_err"] = _check_close("TP at BERT-base width", got,
                                           dense(wide, ids_w, mask_w), WIDE_ATOL)
    print(f"dryrun_multichip({n}): TP at BERT-base width OK ({wide_dims.num_layers} layers, "
          f"{wide_dims.num_heads // inner} heads a rank)")
    del wide

    mesh = sp.create_mesh_sp(n // inner, inner)
    ids, mask = tokens(dims.vocab_size, 2 * n, 4 * inner, pad=3)  # padding in the last shard
    got = sp.make_sp_text_encode(dims, mesh)(bert, ids, mask)
    out["sp_err"] = _check_close("SP", got, dense(bert, ids, mask), PART_ATOL)
    print(f"dryrun_multichip({n}): SP ring-attention encode OK (mesh {n // inner}x{inner}, "
          f"{mesh.transport})")

    pp_dims = tiny_bert_dims(num_layers=inner, num_heads=8, intermediate_size=64)
    pp_bert = init_cxr_bert(torch.Generator().manual_seed(3), pp_dims).to(dev)
    mesh = pp.create_mesh_pp(n // inner, inner)
    ids, mask = tokens(pp_dims.vocab_size, 2 * n, 12)
    got = pp.make_pp_text_encode(pp_dims, mesh, n_microbatches=2)(pp_bert, ids, mask)
    out["pp_err"] = _check_close("PP", got, dense(pp_bert, ids, mask), PART_ATOL)
    print(f"dryrun_multichip({n}): PP pipeline encode OK (mesh {n // inner}x{inner})")


def _rank() -> dict:
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import create_mesh

    torch.set_num_threads(1)
    mesh = create_mesh()
    out = {"backend": mesh.backend, "transport": mesh.transport}
    with torch.no_grad():
        _trainer_programs(mesh, out)
        _extraction(mesh, out)
        _text_programs(mesh, out)
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Every multi-device program over ``n_devices`` ranks on ``device``
    (``"cuda"``: NCCL, one card a rank; ``"cpu"``: gloo); returns rank 0's
    checks.  Raises if a program fails or disagrees."""
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import spawn_ranks

    return spawn_ranks(_rank, n_devices, device)[0]
