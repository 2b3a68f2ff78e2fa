"""Hyperparameter sweep over the adapter-training configuration
(counterpart of the JAX package's ``cli/sweep.py``).

A grid over lr x optimiser x adapter x prompt mode (x ``--seeds``) of
joint trainings, each scored by its val macro AUROC, then ranked.  With
``--vmap`` every lr x seed block of an (optimiser, adapter, prompt-mode)
group trains as one vmapped program (``engine/sweep.py``); a group one
program cannot serve falls back to the sequential loop, loudly.  Runs on
CUDA unless ``--device cpu``.  The JAX CLI's persistent compile cache
(``enable_compile_cache``) has no counterpart: PyTorch runs eagerly and
the port compiles nothing but its CUDA kernels, which build once per
checkout.

    python -m incremental_multimodal_medical_learning_ii_torch.cli.sweep \\
        --synthetic --epochs 5 --batch-size 2048 --device cpu
"""

from __future__ import annotations

import argparse
import copy
import itertools
import math
import time


def main(argv=None) -> list:
    """Returns the results, ``(auroc, lr, optim, adapter, prompt mode,
    seed)`` a point, in grid order."""
    from incremental_multimodal_medical_learning_ii_torch.cli import common

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    p.add_argument("--lrs", type=float, nargs="+", default=[1e-4, 1e-3, 1e-2])
    p.add_argument("--optims", nargs="+", default=["adam", "sgd"])
    p.add_argument("--adapters", nargs="+", default=["mlp", "dense"])
    p.add_argument("--prompt-modes", nargs="+", default=["mean", "max"])
    p.add_argument("--vmap", action="store_true",
                   help="train every lr x seed block of a (optim, adapter, prompt-mode) group "
                   "as one vmapped program (engine/sweep.py); results equal the sequential "
                   "path's within fp32 reassociation (tests/test_torch_sweep.py)")
    p.add_argument("--seeds", type=int, nargs="+", default=None,
                   help="extra grid axis over adapter-init/shuffle seeds (error bars over "
                   "training randomness); the prompt bank stays built from --seed so the "
                   "task itself is fixed across the axis")
    args = p.parse_args(argv)

    from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer
    from incremental_multimodal_medical_learning_ii_torch.utils.config import ExperimentConfig
    from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device
    from incremental_multimodal_medical_learning_ii_torch.utils.profiling import maybe_trace

    device = resolve_device(args.device)
    bundle = common.load_bundle(args)
    base = common.config_kwargs(args)
    base.pop("lr"), base.pop("optim"), base.pop("adapter"), base.pop("prompt_mode")
    base.pop("plot_figures")  # the sweep always runs figure-free
    bank_seed = base.pop("seed")  # prompts/bank pinned to --seed (see --seeds)
    seeds = args.seeds or [bank_seed]

    results = []
    t0 = time.perf_counter()
    # one bank per prompt set (single_prompt changes the prompt list), built
    # at --seed whatever the point's seed: the bank is the task, --seeds
    # varies the training randomness
    banks: dict = {}

    def bank_of(cfg):
        if cfg.single_prompt not in banks:
            bank_args = copy.copy(args)
            bank_args.single_prompt, bank_args.seed = cfg.single_prompt, bank_seed
            banks[cfg.single_prompt] = common.build_bank(bank_args, device)
        return banks[cfg.single_prompt]

    def report(auroc, lr, optim, adapter, pm, seed):
        results.append((float(auroc), lr, optim, adapter, pm, seed))
        tag = f" seed={seed}" if len(seeds) > 1 else ""
        print(f"lr={lr:<8} opt={optim:<5} adapter={adapter:<6} prompts={pm:<5}"
              f"{tag} val-AUROC-macro={auroc:.4f}")

    def grid_cfgs(optim, adapter, pm):
        return [
            ExperimentConfig(mode="joint", lr=lr, optim=optim, adapter=adapter,
                             prompt_mode=pm, plot_figures="off", seed=seed, **base)
            for seed in seeds for lr in args.lrs
        ]

    def sequential(optim, adapter, pm):
        for cfg in grid_cfgs(optim, adapter, pm):
            trainer = Trainer(cfg, bank_of(cfg), device=device)
            for epoch in range(1, cfg.epochs + 1):
                trainer.train(bundle.train, epoch)
            report(trainer.quick_auroc(bundle.val).mean(), cfg.lr, optim, adapter, pm, cfg.seed)

    with maybe_trace(args.trace_dir, device):  # one trace spanning the whole grid
        for optim, adapter, pm in itertools.product(args.optims, args.adapters, args.prompt_modes):
            if not args.vmap:
                sequential(optim, adapter, pm)
                continue
            from incremental_multimodal_medical_learning_ii_torch.engine import sweep

            cfgs = grid_cfgs(optim, adapter, pm)
            try:
                aurocs = sweep.run_vmapped_sweep(cfgs, bundle.train, bundle.val, bank_of(cfgs[0]),
                                                 device=device)
            except ValueError as e:
                # a knob one program cannot serve (an lr schedule, no trainable
                # adapter): fall back loudly, so K x E runs are never silent
                print(f"[warn] --vmap unavailable for opt={optim} adapter={adapter} "
                      f"prompts={pm} ({e}); running sequentially")
                sequential(optim, adapter, pm)
                continue
            for cfg, vec in zip(cfgs, aurocs):
                report(vec.mean(), cfg.lr, optim, adapter, pm, cfg.seed)

    # quick_auroc is NaN for a class whose val labels have one polarity; NaN
    # compares False everywhere, so a plain sort could print it as "best"
    ranked = [r for r in results if not math.isnan(r[0])]
    dropped = len(results) - len(ranked)
    if dropped:
        print(f"[warn] {dropped} config(s) had undefined AUROC "
              f"(a val class with one polarity) and were excluded from ranking")
    ranked.sort(reverse=True)
    print(f"\n{len(results)} configs in {time.perf_counter() - t0:.1f}s")
    if not ranked:
        raise SystemExit("every config's AUROC was undefined on this val split")
    best = ranked[0]
    seed_tag = f" seed={best[5]}" if len(seeds) > 1 else ""
    print(f"best: AUROC {best[0]:.4f} @ lr={best[1]} opt={best[2]} "
          f"adapter={best[3]} prompts={best[4]}{seed_tag}")
    return results


if __name__ == "__main__":
    main()
