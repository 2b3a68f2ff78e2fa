"""Reader for the flat ``.npz`` weight bundles the JAX package writes
(its ``utils/serialization.py::save_params_npz``).

Layout: dict keys join with ``/``; list elements use their index as a key
segment (``encoder/layer1/0/conv1/kernel``); dicts whose keys are exactly
``0..n-1`` come back as lists.  An optional JSON sidecar is stored under
``__meta_json__`` as uint8 bytes.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

_META_KEY = "__meta_json__"


def _insert(root: dict, segments, value) -> None:
    node = root
    for seg in segments[:-1]:
        node = node.setdefault(seg, {})
    node[segments[-1]] = value


def _listify(node: Any) -> Any:
    """Convert dicts whose keys are exactly 0..n-1 (as strings) to lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    keys = list(node.keys())
    if keys and all(k.isdigit() for k in keys):
        idx = sorted(int(k) for k in keys)
        if idx == list(range(len(idx))):
            return [node[str(i)] for i in idx]
    return node


def load_params_npz(path: str):
    """Returns (tree of numpy arrays, meta dict or None)."""
    with np.load(path) as z:
        meta = None
        root: dict = {}
        for key in z.files:
            if key == _META_KEY:
                meta = json.loads(bytes(z[key]).decode())
                continue
            _insert(root, key.split("/"), z[key])
    return _listify(root), meta
