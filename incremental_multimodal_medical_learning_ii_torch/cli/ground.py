"""Phrase grounding: image + text query -> similarity score + similarity map
(counterpart of the JAX package's ``cli/ground.py``).

CLI surface over the VLP engine (``vlp/engine.py``, parity with the
vendored ``ImageTextInferenceEngine``,
``health_multimodal/vlp/inference_engine.py:30-155``; the reference
itself exposes this only as a library).  Runs on CUDA unless
``--device cpu``.  ``--out`` writes the three-panel overlay figure as a
PNG (``vlp/engine.py::plot_phrase_grounding_similarity_map``).  The JAX CLI's
persistent compile cache has no counterpart here (eager PyTorch compiles
nothing ahead; the CUDA kernels build once into ``_build/``).

    python -m incremental_multimodal_medical_learning_ii_torch.cli.ground \\
        --image cxr.jpg --query "left pleural effusion" \\
        --biovil-checkpoint biovil.pt \\
        --cxr-bert-snapshot /weights/BiomedVLP-CXR-BERT-specialized \\
        --save-map map.npy --out grounding.png
"""

from __future__ import annotations

import argparse

import numpy as np


class _SyntheticText:
    """The synthetic prompt encoder behind the text engine's interface
    (``--random-weights`` without CXR-BERT weights)."""

    def __init__(self):
        from incremental_multimodal_medical_learning_ii_torch.text.bank import synthetic_encode_fn

        self._fn = synthetic_encode_fn()

    def get_embeddings_from_prompt(self, prompts, normalize=True):
        embs = self._fn(list(prompts))
        if normalize:
            embs = embs / np.maximum(np.linalg.norm(embs, axis=-1, keepdims=True), 1e-12)
        return embs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image", required=True)
    p.add_argument("--query", required=True, help="free-text phrase to ground")
    p.add_argument("--biovil-checkpoint")
    p.add_argument("--biovil-npz", help="a JAX-format bundle (cli.convert_weights)")
    p.add_argument("--random-weights", action="store_true",
                   help="random BioViL + synthetic text encoder (smoke/demo)")
    p.add_argument("--cxr-bert-snapshot")
    p.add_argument("--cxr-bert-checkpoint")
    p.add_argument("--cxr-bert-vocab")
    p.add_argument("--resize", type=int, default=512)
    p.add_argument("--crop", type=int, default=480,
                   help="default geometry matches the vendored engine factory")
    p.add_argument("--out", help="write the 3-panel overlay figure (PNG)")
    p.add_argument("--save-map", help="write the raw similarity map (npy)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu; nothing falls back")
    return p


def text_engine_from_args(args, device):
    """CXR-BERT on ``device`` (``cli/common.py::cxr_bert_engine``); the
    synthetic encoder under --random-weights without CXR-BERT weights."""
    from incremental_multimodal_medical_learning_ii_torch.cli.common import cxr_bert_engine

    engine = cxr_bert_engine(args, device)
    if engine is not None:
        return engine
    if args.random_weights:
        return _SyntheticText()
    raise SystemExit("give --cxr-bert-snapshot or --cxr-bert-checkpoint + vocab")


def build_engine(args):
    """The ``ImageTextInferenceEngine`` the flags describe."""
    from incremental_multimodal_medical_learning_ii_torch.cli.common import load_image_tower
    from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device
    from incremental_multimodal_medical_learning_ii_torch.vlp.engine import (
        ImageTextInferenceEngine,
    )

    device = resolve_device(args.device)
    image_model = load_image_tower(args)
    text_engine = text_engine_from_args(args, device)
    return ImageTextInferenceEngine(image_model, text_engine, resize_size=args.resize,
                                    crop_size=args.crop, device=device)


def main(argv=None):
    """Prints the score and the map's summary; returns ``(score, map)``."""
    args = build_parser().parse_args(argv)
    engine = build_engine(args)
    score, sim_map = engine.get_score_and_map_from_raw_data(args.image, args.query)
    print(f"similarity score: {score:.4f}")
    print(f"map: shape={sim_map.shape} max={float(np.nanmax(sim_map)):.4f}")
    if args.save_map:
        np.save(args.save_map, sim_map)
        print(f"wrote {args.save_map}")
    if args.out:
        from incremental_multimodal_medical_learning_ii_torch.vlp.engine import (
            plot_phrase_grounding_similarity_map,
        )

        plot_phrase_grounding_similarity_map(args.image, sim_map).save(args.out)
        print(f"wrote {args.out}")
    return score, sim_map


if __name__ == "__main__":
    main()
