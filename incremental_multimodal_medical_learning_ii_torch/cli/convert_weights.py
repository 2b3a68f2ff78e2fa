"""Convert the reference's weight files into ``.npz`` bundles in the JAX
package's format (counterpart of its ``cli/convert_weights.py``).

The reference ships torch pickles (``biovil_image_resnet50_proj_size_128.pt``,
HF snapshots, ``{image,text}_adapter.pt``).  This CLI converts them once
into plain ``.npz`` bundles (``utils/serialization.py``) through the port's
loaders and ``convert.py::params_to_jax``, so either package loads them
(the port with ``--biovil-npz``, the JAX package with its
``load_params_npz``).

    python -m incremental_multimodal_medical_learning_ii_torch.cli.convert_weights \\
        [--biovil-checkpoint biovil.pt] \\
        [--cxr-bert-snapshot /weights/BiomedVLP-CXR-BERT-specialized] \\
        [--reference-image-adapter image_adapter.pt] \\
        [--reference-text-adapter text_adapter.pt] \\
        --out-dir converted/

Writes (for the inputs given): ``biovil_image.npz``, ``cxr_bert.npz``
(with ``BertDims`` in the npz meta sidecar), ``image_adapter.npz``,
``text_adapter.npz``.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--biovil-checkpoint")
    p.add_argument("--cxr-bert-snapshot")
    p.add_argument("--cxr-bert-checkpoint")
    p.add_argument("--reference-image-adapter")
    p.add_argument("--reference-text-adapter")
    p.add_argument("--out-dir", required=True)
    args = p.parse_args(argv)
    if not any((args.biovil_checkpoint, args.cxr_bert_snapshot,
                args.cxr_bert_checkpoint, args.reference_image_adapter,
                args.reference_text_adapter)):
        p.error("nothing to convert: give at least one input checkpoint")

    from incremental_multimodal_medical_learning_ii_torch.convert import params_to_jax
    from incremental_multimodal_medical_learning_ii_torch.models import convert as ref
    from incremental_multimodal_medical_learning_ii_torch.utils.serialization import (
        save_params_npz,
    )

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    if args.biovil_checkpoint:
        save_params_npz(out / "biovil_image.npz",
                        params_to_jax(ref.load_biovil_image_checkpoint(args.biovil_checkpoint)))
        print(f"wrote {out / 'biovil_image.npz'}")

    if args.cxr_bert_snapshot or args.cxr_bert_checkpoint:
        if args.cxr_bert_snapshot:
            model, _tok = ref.load_cxr_bert_snapshot(args.cxr_bert_snapshot)
        else:
            model = ref.load_cxr_bert_checkpoint(args.cxr_bert_checkpoint)
        save_params_npz(out / "cxr_bert.npz", params_to_jax(model),
                        meta={"dims": dataclasses.asdict(model.dims)})
        print(f"wrote {out / 'cxr_bert.npz'}")

    for flag, name in (
        (args.reference_image_adapter, "image_adapter"),
        (args.reference_text_adapter, "text_adapter"),
    ):
        if flag:
            save_params_npz(out / f"{name}.npz", params_to_jax(ref.load_reference_adapter(flag)))
            print(f"wrote {out / f'{name}.npz'}")


if __name__ == "__main__":
    main()
