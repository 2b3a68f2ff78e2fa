"""Readings that set the limits of ``correct``, at a cell's own size on the card.

    python3 -m h100_bench.tools.calibrate --cell extract-b512 --seeds 12
    python3 -m h100_bench.tools.calibrate --cell train-joint --seeds 3

For each seed it prints one JSON line with the numbers a run compares, read
from the control and, for the training cells, from the faults planted in the
reference put in the program's place (half of each batch; on several chips,
the gradients' exchange left out).  The bf16 image tower's control is the
program's own int8 path; the fp32 adapters' is the plain reference in TF32.
The extraction cell's readings come from the driver itself, set-up, a window
of ``--seconds`` and its check, in this one process: the sound program on
every seed, and on the first ``--int8-seeds`` the program with its int8 path
on and the plain reference with fp8-rounded convolutions.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import torch


def program_readings(cell: str, seed: int, seconds: float, device, **overrides) -> dict:
    """The numbers a run of ``cell`` compares, from the driver's own set-up,
    window and check, with traffic parameters ``overrides``."""
    from h100_bench.common import spec

    entry, config, params = spec.cell(cell)
    params = {**params, **overrides}
    drv = spec.driver(params["driver"])
    with tempfile.TemporaryDirectory() as tmp:
        run = spec.Run(workload=cell, entry=entry, config=config, params=params, seed=seed,
                       seconds=seconds, trace=False, device=device, tmp=Path(tmp))
        drv.setup(run)
        drv.window(run)
        drv.release(run)
        drv.check(run)
    return {name: v for name, v, _ in run.checks}


def extract_readings(params: dict, seed: int, device) -> dict:
    from h100_bench.common import images as img
    from h100_bench.common.weights import biovil_weights
    from h100_bench.drivers.extract_stream import sample_indices
    from h100_bench.reference import biovil as ref

    idx = sample_indices(seed, 100 * params["batch"], params["check_images"])  # as a run of 100 batches
    pics = img.images_at(seed, idx, params["batch"], tuple(params["image_hw"]))
    weights = biovil_weights(seed, device)
    with torch.no_grad():
        want = ref.embed_images(weights, pics, params["size"], params["crop"], device)
        got = ref.embed_images(weights, pics, params["size"], params["crop"], device, quant="fp8")
    return {"emb_rel_gap": float(ref.rel_gap(got, want).max())}


def train_readings(params: dict, seed: int, device, chips: int) -> dict:
    from h100_bench.common.weights import joint_data, prompt_bank
    from h100_bench.drivers.joint_runs import run_seed
    from h100_bench.reference import joint as ref

    parts = joint_data(seed, device, params["rows"])
    bank = prompt_bank(seed, device)
    s = run_seed(seed, 0)
    want = ref.replay(s, parts, bank, params, device)
    out = {"control_tf32": ref.compare(ref.replay(s, parts, bank, params, device, tf32=True), want),
           "fault_half": ref.compare(ref.replay(s, parts, bank, params, device, fault=("half",)), want)}
    if chips > 1:
        out["fault_no_exchange"] = ref.compare(
            ref.replay(s, parts, bank, params, device, fault=("no_exchange", chips)), want)
    return out


def main(argv=None) -> int:
    from h100_bench.common import spec

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_900_000_001)
    ap.add_argument("--int8-seeds", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    params = spec.traffic(args.cell)
    chips = next((w["chips"] for w in spec.benchmark()["workloads"] if w["name"] == args.cell), 1)
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for i, seed in enumerate(range(args.first_seed, args.first_seed + args.seeds)):
        if params["driver"] == "extract_stream":
            r = {"program": program_readings(args.cell, seed, args.seconds, device)}
            if i < args.int8_seeds:
                r["int8"] = program_readings(args.cell, seed, args.seconds, device, int8=True)
                r["fp8_reference"] = extract_readings(params, seed, device)
        elif params["driver"] == "joint_runs":
            r = train_readings(params, seed, device, chips)
        else:
            raise SystemExit(f"no calibration for driver {params['driver']!r}")
        print(json.dumps({"cell": args.cell, "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
