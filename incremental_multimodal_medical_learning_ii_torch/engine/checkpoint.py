"""Checkpoints of the full :class:`TrainState` and the part/task progress
file (counterpart of the JAX package's ``engine/checkpoint.py``).

A checkpoint is a directory ``<directory>/<name>/`` holding ``state.pt``
(params, Adam's ``mu``/``nu``, ``count``, ``lr``, ``step``; ``torch.save``
of CPU tensors), written through a temporary file and a rename.
``progress.json`` (completed units + the trainer's host-side stream state)
is the JAX package's file, byte for byte in layout.

On a data-parallel mesh (``parallel/mesh.py``) rank 0 writes and every
rank then waits at a barrier, so no rank reads what rank 0 has not yet
written.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch

from incremental_multimodal_medical_learning_ii_torch.engine.steps import TrainState
from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import barrier


def _to(state: TrainState, device) -> TrainState:
    return TrainState(*(
        {k: t.to(device) for k, t in f.items()} if isinstance(f, dict) else f.to(device)
        for f in state
    ))


def save_checkpoint(directory: str | Path, state: TrainState, name: str = "train_state",
                    mesh=None) -> Path:
    path = Path(directory).absolute() / name
    if mesh is None or mesh.rank == 0:
        path.mkdir(parents=True, exist_ok=True)
        tmp = path / "state.pt.tmp"
        torch.save(_to(state, "cpu")._asdict(), tmp)
        os.replace(tmp, path / "state.pt")
    if mesh is not None:
        barrier(mesh)
    return path


def restore_checkpoint(directory: str | Path, template: TrainState, name: str = "train_state") -> TrainState:
    """The saved state, on ``template``'s device; its tensor names and
    shapes must be the template's."""
    path = Path(directory).absolute() / name / "state.pt"
    saved = TrainState(**torch.load(path, map_location="cpu", weights_only=True))
    for field, want, got in zip(TrainState._fields, template, saved):
        if isinstance(want, dict):
            shapes = {k: tuple(v.shape) for k, v in want.items()}
            if {k: tuple(v.shape) for k, v in got.items()} != shapes:
                raise ValueError(f"{path}: {field} does not fit this configuration")
    device = template.step.device
    return _to(saved, device)


# ----------------------------------------------------------------------
# Part/task-level resume for the incremental protocols
# ----------------------------------------------------------------------
def save_progress(directory: str | Path, completed: int, aux: dict | None = None,
                  mesh=None) -> None:
    """Record the completed part/task count and the trainer's host-side
    stream state, atomically (tmp + rename)."""
    if mesh is None or mesh.rank == 0:
        Path(directory).mkdir(parents=True, exist_ok=True)
        payload: dict = {"completed": completed}
        if aux is not None:
            payload["aux"] = aux
        path = Path(directory) / "progress.json"
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(payload))
        os.replace(tmp, path)
    if mesh is not None:
        barrier(mesh)


def _read_progress(directory: str | Path) -> dict:
    path = Path(directory) / "progress.json"
    if not path.exists():
        return {}
    try:
        return json.loads(path.read_text())
    except (ValueError, OSError) as e:  # corrupt file: restart rather than abort
        print(f"[resume] unreadable progress.json ({e}); starting from scratch")
        return {}


def load_progress(directory: str | Path) -> int:
    """Number of completed parts/tasks recorded in ``directory`` (0 if none
    or unreadable)."""
    return int(_read_progress(directory).get("completed", 0))


def load_aux(directory: str | Path) -> dict | None:
    """The trainer aux state saved alongside progress (None if absent)."""
    return _read_progress(directory).get("aux")
