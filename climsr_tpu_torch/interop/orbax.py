# -*- coding: utf-8 -*-
"""The JAX package's orbax checkpoints, read with the standard library and
numpy (no orbax, tensorstore or JAX).

``climsr_tpu/training/checkpoint.py`` saves a state with
``CheckpointManager.save(step, args=StandardSave(state))``:
``<root>/<step>/_CHECKPOINT_METADATA`` and ``<root>/<step>/default/`` with

- ``_METADATA``: JSON whose ``tree_metadata`` maps each leaf's key path to
  its keys (``key_type`` 1 a sequence index, 2 a dict key) and its value
  (``value_type``; ``skip_deserialize`` for the leaves that hold no array:
  ``None`` for optax's ``EmptyState``, ``Tuple`` for an empty tuple);
- each array as a zarr v2 array named by its keys joined with ``.``, in the
  OCDBT store of ``default/`` (:mod:`climsr_tpu_torch.io.ocdbt`) or, with
  ``use_ocdbt=False``, as files: ``<name>/.zarray`` (JSON: ``shape``,
  ``chunks``, ``dtype``, ``fill_value``, ``order``, ``compressor``,
  ``filters``, ``dimension_separator``) and one zstd-compressed chunk per key
  ``i.j.k`` of the chunk grid (``0`` for a scalar). An array sharded over
  devices (ZeRO) is stored as one chunk per shard.

:func:`restore_pytree` gives the tree as nested dicts and lists of numpy
arrays (``None`` leaves stay ``None``), like
``climsr_tpu.training.checkpoint.restore_pytree`` without a template.
``bfloat16`` arrays (stored as 2-byte words) come back widened to float32,
exactly. A field, dtype or layout it does not know
(zarr v3 included) raises ``ValueError``.
"""
from __future__ import annotations

import itertools
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np

from climsr_tpu_torch.io import zstd
from climsr_tpu_torch.io.ocdbt import open_store

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
ITEM = "default"

_DTYPES = {"<f4": np.float32, "<f8": np.float64, "<f2": np.float16, "<i4": np.int32, "<i8": np.int64,
           "<i2": np.int16, "|i1": np.int8, "|u1": np.uint8, "<u2": np.uint16, "<u4": np.uint32,
           "<u8": np.uint64, "|b1": np.bool_, "bfloat16": np.uint16}
_EMPTY = {"None": lambda: None, "Tuple": tuple, "List": list, "Dict": dict}
_ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
_SEQUENCE, _DICT = 1, 2


def item_directory(path: Union[str, Path]) -> Path:
    """The ``default/`` directory of a checkpoint: ``path`` may be a manager
    root (its latest numeric step, as ``climsr_tpu/training/checkpoint.py:82-89``),
    a step directory or the item directory itself."""
    p = Path(path)
    if (p / METADATA).is_file():
        return p
    if (p / ITEM / METADATA).is_file():
        return p / ITEM
    steps = sorted((d for d in p.iterdir() if d.is_dir() and d.name.isdigit()), key=lambda d: int(d.name)) \
        if p.is_dir() else []
    if steps and (steps[-1] / ITEM / METADATA).is_file():
        return steps[-1] / ITEM
    raise FileNotFoundError(
        f"{p} is neither a checkpoint directory of the port (index.json of .ckpt files) nor an orbax checkpoint "
        f"of the JAX package (a manager root with numeric step directories, a step directory or its "
        f"'{ITEM}/', holding {METADATA})")


def is_orbax_checkpoint(path: Union[str, Path]) -> bool:
    try:
        item_directory(path)
    except FileNotFoundError:
        return False
    return True


def _metadata(item: Path) -> Dict[str, Any]:
    meta = json.loads((item / METADATA).read_text())
    if meta.get("use_zarr3"):
        raise ValueError(f"{item}: zarr v3 arrays (use_zarr3) are not read")
    if "tree_metadata" not in meta:
        raise ValueError(f"{item / METADATA}: no tree_metadata")
    return meta["tree_metadata"]


def top_level_keys(path: Union[str, Path]) -> List[str]:
    """The keys at the top of a checkpoint's tree, from its metadata alone."""
    tree = _metadata(item_directory(path))
    return sorted({entry["key_metadata"][0]["key"] for entry in tree.values() if entry["key_metadata"]})


def _zarray(store, name: str) -> dict:
    """``name``'s ``.zarray``, checked field by field."""
    try:
        meta = json.loads(store.read(f"{name}/.zarray"))
    except KeyError:
        if f"{name}/zarr.json" in store:
            raise ValueError(f"{name}: a zarr v3 array (zarr.json) is not read") from None
        raise
    known = {"shape", "chunks", "dtype", "fill_value", "order", "compressor", "filters", "zarr_format",
             "dimension_separator"}
    if set(meta) - known:
        raise ValueError(f"{name}/.zarray: unknown fields {sorted(set(meta) - known)}")
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}/.zarray: zarr_format {meta.get('zarr_format')} (only 2 is read)")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}/.zarray: order {meta['order']!r} (only 'C' is read)")
    if meta.get("filters"):
        raise ValueError(f"{name}/.zarray: filters {meta['filters']} are not read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}/.zarray: compressor {comp.get('id')!r} (only zstd and none are read)")
    if meta["dtype"] not in _DTYPES:
        raise ValueError(f"{name}/.zarray: dtype {meta['dtype']!r} is not read")
    if meta.get("dimension_separator", ".") not in (".", "/"):
        raise ValueError(f"{name}/.zarray: dimension_separator {meta['dimension_separator']!r}")
    if len(meta["shape"]) != len(meta["chunks"]) or any(c <= 0 for c in meta["chunks"]):
        raise ValueError(f"{name}/.zarray: chunks {meta['chunks']} do not fit shape {meta['shape']}")
    return meta


def read_arrays(store, names: List[str]) -> Dict[str, np.ndarray]:
    """The zarr v2 arrays ``names`` of ``store`` (an OCDBT or file store),
    chunk by chunk; bfloat16 widened to float32."""
    arrays = {}
    for name in names:
        meta = _zarray(store, name)
        shape, chunk = tuple(meta["shape"]), tuple(meta["chunks"])
        sep, fill = meta.get("dimension_separator", "."), meta.get("fill_value")
        out = np.full(shape, 0 if fill is None else fill, _DTYPES[meta["dtype"]])
        n = int(np.prod(chunk)) * out.dtype.itemsize
        for idx in itertools.product(*[range(-(-s // c)) for s, c in zip(shape, chunk)]):
            key = f"{name}/{sep.join(str(i) for i in idx) if idx else '0'}"
            if key not in store:
                continue  # a chunk never written holds the fill value
            raw = store.read(key)
            if meta.get("compressor") is not None:
                raw = zstd.decompress(raw)
            if len(raw) != n:
                raise ValueError(f"{key}: {len(raw)} bytes, a chunk of {chunk} {out.dtype} is {n}")
            region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunk, shape))
            crop = tuple(slice(0, r.stop - r.start) for r in region)  # edge chunks are stored whole
            out[region] = np.frombuffer(raw, out.dtype).reshape(chunk)[crop]
        arrays[name] = (out.astype(np.uint32) << 16).view(np.float32) if meta["dtype"] == "bfloat16" else out
    return arrays


def restore_pytree(path: Union[str, Path], select: Optional[str] = None) -> Any:
    """The checkpoint's tree: dicts and lists of numpy arrays, ``None`` where
    orbax kept no value. ``select``: read only the subtree under that
    top-level key (``"params"``, ``"g_params"``...) and return it."""
    item = item_directory(path)
    tree_meta = _metadata(item)
    store = open_store(item)
    entries = []
    for entry in tree_meta.values():
        keys = entry["key_metadata"]
        if select is not None and (not keys or keys[0]["key"] != select):
            continue
        value = entry["value_metadata"]
        vtype = value.get("value_type")
        if value.get("skip_deserialize"):
            if vtype not in _EMPTY:
                raise ValueError(f"{item / METADATA}: a skipped leaf of type {vtype!r}")
            entries.append((keys, None, _EMPTY[vtype]()))
        elif vtype in _ARRAY_TYPES:
            entries.append((keys, ".".join(str(k["key"]) for k in keys), None))
        else:
            raise ValueError(f"{item / METADATA}: leaf type {vtype!r} is not read")
    arrays = read_arrays(store, [name for _, name, _ in entries if name is not None])
    root: Dict = {}
    for keys, name, leaf in entries:
        leaf = arrays[name] if name is not None else leaf
        if not keys:
            return leaf
        node = root
        for k in keys[:-1]:
            node = node.setdefault((k["key_type"], k["key"]), {})
        node[(keys[-1]["key_type"], keys[-1]["key"])] = leaf
    if select is not None:
        if not root:
            raise KeyError(f"{item} holds no '{select}' subtree")
        return _build(root)[select]
    return _build(root)


def _build(node: Any) -> Any:
    """Nested ``{(key_type, key): child}`` -> dicts and lists."""
    if not isinstance(node, dict) or not node:
        return node
    types = {t for t, _ in node}
    if types == {_SEQUENCE}:
        items = sorted(node.items(), key=lambda kv: int(kv[0][1]))
        if [int(k) for (_, k), _ in items] != list(range(len(items))):
            raise ValueError(f"sequence indices {[k for (_, k), _ in items]} are not 0..n-1")
        return [_build(v) for _, v in items]
    if types == {_DICT}:
        return {k: _build(v) for (_, k), v in node.items()}
    raise ValueError(f"key types {sorted(types)} mixed in one node (1 sequence, 2 dict)")
