"""Readings that set the limits of ``correct`` of the cells that
``calibrate.py`` does not know, at each cell's own size on the card.

    python3 -m h100_bench.tools.calibrate_cells --cell extract-dinov2g-b512 --seeds 20
    python3 -m h100_bench.tools.calibrate_cells --cell train-classinc-mycl --seeds 10

For each seed one JSON line of the numbers a run compares.
``extract-dinov2g-b512``: the sound program on every seed (the driver's own
set-up, a window of ``--seconds`` and its check, no warm-up batches), and
on the first ``--control-seeds`` the control, the plain reference with
each block's output rounded to float8_e4m3 against the fp32 reference on
the images a run would sample.  ``train-classinc-mycl``: the sound program
the same way, and the plain replay in TF32 (the control) and with half of
each batch left out (a fault) against the fp32 replay.
"""

from __future__ import annotations

import argparse
import json

import torch

from h100_bench.tools.calibrate import program_readings


def tower_control(params: dict, config: dict, seed: int, device) -> dict:
    from h100_bench.common import images as img
    from h100_bench.common.dinov2_weights import dinov2_weights
    from h100_bench.drivers.extract_stream import sample_indices
    from h100_bench.reference import dinov2 as ref

    idx = sample_indices(seed, 100 * params["batch"], params["check_images"])  # as a run of 100 batches
    pics = img.images_at(seed, idx, params["batch"], tuple(params["image_hw"]), blocks=params["pool_blocks"])
    weights = dinov2_weights(seed, device, config)
    want = ref.embed_images(weights, pics, config, params["size"], params["crop"], device)
    got = ref.embed_images(weights, pics, config, params["size"], params["crop"], device, quant="fp8")
    return {"emb_rel_gap": float(ref.rel_gap(got, want).max())}


def incremental_controls(params: dict, seed: int, device) -> dict:
    from h100_bench.common.weights import joint_data, prompt_bank
    from h100_bench.drivers.joint_runs import run_seed
    from h100_bench.reference import incremental as ref

    parts = joint_data(seed, device, params["rows"])
    bank = prompt_bank(seed, device)
    s = run_seed(seed, 0)
    out = {}
    for name, kw in (("control_tf32", {"tf32": True}), ("fault_half", {"fault": ("half",)})):
        # in the program's place, replayed from its own unit starts as a run is
        got = ref.replay(s, parts, bank, params, device, **kw)
        want = ref.replay(s, parts, bank, params, device, starts=got["unit_states"][:-1],
                          scored=got["unit_states"])
        out[name] = ref.compare(got, want)
    return out


def main(argv=None) -> int:
    from h100_bench.common import spec

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_950_000_001)
    ap.add_argument("--control-seeds", type=int, default=5)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, config, params = spec.cell(args.cell)
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for i, seed in enumerate(range(args.first_seed, args.first_seed + args.seeds)):
        if params["driver"] == "extract_tower":
            r = {"program": program_readings(args.cell, seed, args.seconds, device, warmup_batches=0)}
            if i < args.control_seeds:
                r["fp8_reference"] = tower_control(params, config, seed, device)
        elif params["driver"] == "incremental_runs":
            r = {"program": program_readings(args.cell, seed, args.seconds, device),
                 **incremental_controls(params, seed, device)}
        else:
            raise SystemExit(f"no calibration for driver {params['driver']!r}")
        print(json.dumps({"cell": args.cell, "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
