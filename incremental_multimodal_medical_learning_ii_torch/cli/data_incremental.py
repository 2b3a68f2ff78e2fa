"""Data-incremental driver (counterpart of the JAX package's
``cli/data_incremental.py``; reference ``DATA_INCREMENTAL.py``).

Defaults equal ``DATA_INCREMENTAL.py:44-68``: bs 6144, lr 1e-4, 20 parts,
10 epochs/part, frontal views, threshold 0.01 + 0.001/epoch scheduling.
Runs on CUDA unless ``--device cpu``.

    python -m incremental_multimodal_medical_learning_ii_torch.cli.data_incremental \
        --synthetic --parts 3 --epochs 2 --batch-size 512 --continual-learning myCL --device cpu
"""

from __future__ import annotations

import argparse

from incremental_multimodal_medical_learning_ii_torch.cli import common
from incremental_multimodal_medical_learning_ii_torch.engine.protocols import run_data_incremental
from incremental_multimodal_medical_learning_ii_torch.utils.config import ExperimentConfig
from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    p.set_defaults(xrays_position="frontal")
    p.add_argument("--parts", type=int, default=20, help="5 / 10 / 20")
    p.add_argument("--continual-learning", choices=["myCL", "profCL"], default=None)
    p.add_argument("--threshold", type=float, default=0.01)
    p.add_argument("--resume", action="store_true", help="resume from the run dir checkpoint")
    p.add_argument("--adder", type=float, default=0.001)
    p.add_argument("--no-threshold-scheduling", action="store_true")
    args = p.parse_args(argv)
    ranks = common.run_ranks(main, argv, args)
    if ranks is not None:
        return ranks
    mesh = common.make_mesh(args)
    device = mesh.device if mesh is not None else resolve_device(args.device)

    cfg = ExperimentConfig(
        mode="data-inc",
        parts=args.parts,
        continual_learning=args.continual_learning,
        threshold=args.threshold,
        adder=args.adder,
        threshold_scheduling=not args.no_threshold_scheduling,
        **common.config_kwargs(args),
    )
    print("run:", cfg.run_name())
    bundle = common.load_bundle(args)
    bank = common.build_bank(args, device)
    results = run_data_incremental(cfg, bundle, bank, log_dir=args.log_dir, device=device,
                                   resume=args.resume, trace_dir=args.trace_dir, mesh=mesh)
    common.print_results(results)
    return results


if __name__ == "__main__":
    main()
