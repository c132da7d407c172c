"""Parameter (de)serialization for the weight pack.

One uncompressed ``.npz`` holds every leaf under its flattened key path
(``dit/text_embed/blocks/[0]/pw1/w``: dict keys as written, list positions
as ``[i]``), so the pack needs numpy alone to read and write, and the dict
and list structure, shapes and dtypes survive a round trip. Dtypes numpy has
no native code for (bfloat16) are stored as same-width unsigned integers,
with their names kept in the ``__dtypes__`` entry. Orbax checkpointing for
training lives in ``training/``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import jax
import numpy as np

# File name of the parameter tree inside a weight-pack directory.
PARAMS_FILE = "params.npz"
# The earlier flax-msgpack parameter file; such packs are refused on load.
LEGACY_PARAMS_FILE = "params.msgpack"

_SEP = "/"
_DTYPES_KEY = "__dtypes__"
_INDEX = re.compile(r"\[(\d+)\]")


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        if not tree:
            raise ValueError(f"empty dict at {prefix or '<root>'} cannot be stored")
        for key, sub in tree.items():
            key = str(key)
            if not key or _SEP in key or _INDEX.fullmatch(key) or key == _DTYPES_KEY:
                raise ValueError(f"parameter key {key!r} cannot be stored")
            _flatten(sub, f"{prefix}{_SEP}{key}" if prefix else key, out)
    elif isinstance(tree, (list, tuple)):
        if not tree:
            raise ValueError(f"empty list at {prefix or '<root>'} cannot be stored")
        for i, sub in enumerate(tree):
            _flatten(sub, f"{prefix}{_SEP}[{i}]" if prefix else f"[{i}]", out)
    else:
        out[prefix] = np.asarray(jax.device_get(tree))


def save_params(path: str | Path, params) -> None:
    flat: dict = {}
    _flatten(params, "", flat)
    arrays, dtypes = {}, {}
    for key, arr in flat.items():
        if arr.dtype.kind == "V":
            dtypes[key] = arr.dtype.name
            arr = arr.view(f"uint{arr.dtype.itemsize * 8}")
        arrays[key] = arr
    arrays[_DTYPES_KEY] = np.asarray(json.dumps(dtypes))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def _listify(node):
    """Nested dicts from the flat keys → the saved tree, with ``[i]`` keys
    turned back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if all(_INDEX.fullmatch(k) for k in node):
        return [node[f"[{i}]"] for i in range(len(node))]
    return node


def load_params(path: str | Path):
    with np.load(path, allow_pickle=False) as data:
        dtypes = json.loads(str(data[_DTYPES_KEY]))
        tree: dict = {}
        for key in data.files:
            if key == _DTYPES_KEY:
                continue
            arr = data[key]
            if key in dtypes:
                arr = arr.view(np.dtype(dtypes[key]))
            *parents, leaf = key.split(_SEP)
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = arr
    return _listify(tree)
