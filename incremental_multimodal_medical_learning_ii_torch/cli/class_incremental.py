"""Class-incremental driver (counterpart of the JAX package's
``cli/class_incremental.py``; reference ``CLASS_INCREMENTAL.py``).

Defaults equal ``CLASS_INCREMENTAL.py:32-57``: bs 6144, lr 1e-4, 5 tasks x
10 epochs, mode class-pos-neg, MORE_LABELS on, threshold 0.01 / adder
0.001.  Runs on CUDA unless ``--device cpu``.

    python -m incremental_multimodal_medical_learning_ii_torch.cli.class_incremental \
        --synthetic --epochs 2 --batch-size 512 --mode class-pos --device cpu
"""

from __future__ import annotations

import argparse

from incremental_multimodal_medical_learning_ii_torch.cli import common
from incremental_multimodal_medical_learning_ii_torch.engine.protocols import run_class_incremental
from incremental_multimodal_medical_learning_ii_torch.utils.config import ExperimentConfig
from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    p.add_argument("--mode", choices=["class-pos-neg", "class-pos"], default="class-pos-neg")
    p.add_argument("--no-more-labels", action="store_true")
    p.add_argument("--tasks-order", type=int, nargs=5, default=[0, 1, 2, 3, 4])
    p.add_argument("--continual-learning", choices=["myCL", "profCL"], default=None)
    p.add_argument("--threshold", type=float, default=0.01)
    p.add_argument("--resume", action="store_true", help="resume from the run dir checkpoint")
    p.add_argument("--adder", type=float, default=0.001)
    p.add_argument("--threshold-scheduling", action="store_true")
    args = p.parse_args(argv)
    ranks = common.run_ranks(main, argv, args)
    if ranks is not None:
        return ranks
    mesh = common.make_mesh(args)
    device = mesh.device if mesh is not None else resolve_device(args.device)

    cfg = ExperimentConfig(
        mode=args.mode,
        more_labels=not args.no_more_labels,
        tasks_order=tuple(args.tasks_order),
        continual_learning=args.continual_learning,
        threshold=args.threshold,
        adder=args.adder,
        threshold_scheduling=args.threshold_scheduling,
        **common.config_kwargs(args),
    )
    print("run:", cfg.run_name())
    bundle = common.load_bundle(args)
    bank = common.build_bank(args, device)
    results = run_class_incremental(cfg, bundle, bank, log_dir=args.log_dir, device=device,
                                    resume=args.resume, trace_dir=args.trace_dir,
                                    mesh=mesh)
    common.print_results(results)
    return results


if __name__ == "__main__":
    main()
