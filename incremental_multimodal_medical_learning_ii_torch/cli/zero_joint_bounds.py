"""Zero-shot / joint-train-bound driver (counterpart of the JAX package's
``cli/zero_joint_bounds.py``; reference ``ZERO_JOINT_BOUNDS.py``).

Defaults equal the reference's constants (``ZERO_JOINT_BOUNDS.py:16-31``):
bs 6144, lr 1e-4, 10 epochs, multiple prompts, chex competition, all views,
BCEWithLogits.  ``--epochs 0`` gives the zero-shot bound (no-head or
shared).  Runs on CUDA unless ``--device cpu``.

    python -m incremental_multimodal_medical_learning_ii_torch.cli.zero_joint_bounds \
        --synthetic --epochs 2 --batch-size 512 --device cpu
"""

from __future__ import annotations

import argparse

from incremental_multimodal_medical_learning_ii_torch.cli import common
from incremental_multimodal_medical_learning_ii_torch.engine.protocols import run_zero_joint
from incremental_multimodal_medical_learning_ii_torch.utils.config import ExperimentConfig
from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    p.add_argument("--folder-name", default="zero-and-joint")
    args = p.parse_args(argv)
    ranks = common.run_ranks(main, argv, args)
    if ranks is not None:
        return ranks
    mesh = common.make_mesh(args)
    device = mesh.device if mesh is not None else resolve_device(args.device)

    kw = common.config_kwargs(args)
    if args.epochs == 0 and not args.shared:
        kw.update(adapter="no-head", image_adapter=False, text_adapter=False)
    cfg = ExperimentConfig(mode="joint" if args.epochs > 0 else "zero",
                           folder_name=args.folder_name, **kw)
    print("run:", cfg.run_name())
    bundle = common.load_bundle(args)
    bank = common.build_bank(args, device)
    results = run_zero_joint(cfg, bundle, bank, log_dir=args.log_dir, device=device,
                             trace_dir=args.trace_dir, mesh=mesh)
    common.print_results(results)
    return results


if __name__ == "__main__":
    main()
