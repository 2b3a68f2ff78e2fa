"""Flat ``.npz`` weight bundles in the JAX package's format (its
``utils/serialization.py``): each package reads the other's.

Layout: dict keys join with ``/``; list elements use their index as a key
segment (``encoder/layer1/0/conv1/kernel``); dicts whose keys are exactly
``0..n-1`` come back as lists.  An optional JSON sidecar is stored under
``__meta_json__`` as uint8 bytes.  Trees that could not round-trip are
rejected when saved: empty dicts and lists (their key would vanish),
digit-string dict keys (ambiguous with list indices), the reserved
metadata key, and leaves that are not numeric arrays.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np

_META_KEY = "__meta_json__"


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        if not tree:
            raise ValueError(f"empty dict at {prefix!r} cannot round-trip")
        for k, v in tree.items():
            k = str(k)
            if "/" in k:
                raise ValueError(f"key {k!r} contains '/'")
            if k == _META_KEY:
                raise ValueError(f"key {k!r} is reserved for metadata")
            if k.isdigit():
                raise ValueError(f"digit-string dict key {k!r} at {prefix!r}")
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        if not tree:
            raise ValueError(f"empty list at {prefix!r} cannot round-trip")
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        arr = np.asarray(tree)
        if arr.dtype == object:
            # np.savez would pickle object arrays, which the loader refuses
            raise ValueError(
                f"leaf at {prefix[:-1]!r} is not a numeric array (got {type(tree).__name__})"
            )
        out[prefix[:-1]] = arr


def save_params_npz(path, tree: Any, meta: Optional[dict] = None) -> None:
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    if meta is not None:
        flat[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8).copy()
    np.savez(path, **flat)


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
