"""Orbax checkpoints without orbax.

Counterpart of ``diffsg_tpu/utils/orbax_io.py``, which saves and restores
through ``orbax.checkpoint.StandardCheckpointer``. Neither orbax nor
tensorstore is needed here: the layout is read and written by hand.

A checkpoint directory holds ``_METADATA`` (the tree: per leaf its key path
and value type, and whether the arrays sit in an OCDBT store or in plain
directories, zarr v2 or v3), ``_CHECKPOINT_METADATA``, and one zarr v2
array per leaf, named by its key path joined with ``.``: a ``.zarray``
description and chunks named by their grid index (``0.0``; ``0`` for a 0-d
array), each chunk a zstd frame. The tree is JAX's: ``params``, ``step``,
``ema_params`` and ``ema_n_averaged`` with an EMA, ``schedule_betas``
(float64) with a schedule; the metadata dict goes in ``diffsg_metadata.json``
beside it (orbax takes no strings).

* :func:`load_checkpoint_orbax` reads both layouts: OCDBT (what the JAX
  package writes, through ``_ocdbt``) and plain directories. It refuses, with
  the field named, zarr v3, compressors other than zstd, filters and Fortran
  order.
* :func:`save_checkpoint_orbax` writes orbax's ``use_ocdbt=False`` layout,
  every value an ``np.ndarray`` and every chunk a raw-block zstd frame, into
  a temporary directory renamed over ``directory`` when complete. Orbax
  (``diffsg_tpu.utils.orbax_io.load_checkpoint_orbax``) restores it.
"""

from __future__ import annotations

import ast
import itertools
import json
import math
import os
import pathlib
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from ..diffusion.schedule import Schedule, schedule_from_betas
from ..train.ema import EmaState
from ._ocdbt import read_ocdbt
from ._zstd import compress_raw, decompress
from .params import params_from_jax, tree_from_state

_DICT_KEY = 2  # orbax's key_type for a dict key (1 is a sequence index)
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
_FILL = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}


class OrbaxFormatError(ValueError):
    """A checkpoint this reader refuses; the message names the field."""


# --- reading ---------------------------------------------------------------

def _leaf_paths(meta: Dict[str, Any]) -> List[Tuple[str, ...]]:
    """The key path of every leaf in ``_METADATA``'s tree, checked against
    its ``key_metadata``."""
    if meta.get("use_zarr3", False):
        raise OrbaxFormatError("_METADATA: use_zarr3: true (only zarr v2 is read)")
    paths = []
    for text, entry in meta["tree_metadata"].items():
        path = ast.literal_eval(text)  # a tuple literal, parsed, never run
        keys = entry.get("key_metadata", [])
        if (not isinstance(path, tuple) or not all(isinstance(k, str) for k in path)
                or [k.get("key") for k in keys] != list(path)):
            raise OrbaxFormatError(f"_METADATA: tree key {text} disagrees with key_metadata")
        if any(k.get("key_type") != _DICT_KEY for k in keys):
            raise OrbaxFormatError(f"_METADATA: {text}: key_type other than a dict key")
        value = entry.get("value_metadata", {})
        if value.get("value_type") not in ("np.ndarray", "jax.Array"):
            raise OrbaxFormatError(f"_METADATA: {text}: value_type {value.get('value_type')}")
        if value.get("skip_deserialize", False):
            raise OrbaxFormatError(f"_METADATA: {text}: skip_deserialize: true")
        paths.append(path)
    return paths


def _zarr_dtype(spec: Any, name: str) -> np.dtype:
    try:
        dtype = np.dtype(spec)
    except TypeError as e:
        raise OrbaxFormatError(f"{name}/.zarray: dtype {spec!r}") from e
    if dtype.kind not in "fiub" or dtype.fields is not None:
        raise OrbaxFormatError(f"{name}/.zarray: dtype {spec!r}")
    return dtype


def _read_array(get: Callable[[str], Optional[bytes]], name: str) -> np.ndarray:
    """Assemble the zarr v2 array ``name`` from its chunks."""
    raw = get(f"{name}/.zarray")
    if raw is None:
        raise OrbaxFormatError(f"{name}/.zarray: missing")
    spec = json.loads(raw)
    if spec.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{name}/.zarray: zarr_format {spec.get('zarr_format')}")
    if spec.get("order", "C") != "C":
        raise OrbaxFormatError(f"{name}/.zarray: order {spec['order']} (only C)")
    if spec.get("filters"):
        raise OrbaxFormatError(f"{name}/.zarray: filters {spec['filters']} (none are read)")
    compressor = spec.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise OrbaxFormatError(f"{name}/.zarray: compressor {compressor.get('id')} "
                               "(only zstd or none)")
    sep = spec.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise OrbaxFormatError(f"{name}/.zarray: dimension_separator {sep!r}")
    dtype = _zarr_dtype(spec["dtype"], name)
    shape, chunks = [int(s) for s in spec["shape"]], [int(c) for c in spec["chunks"]]
    if len(shape) != len(chunks) or any(c < 1 for c in chunks):
        raise OrbaxFormatError(f"{name}/.zarray: chunks {chunks} for shape {shape}")
    fill = spec.get("fill_value")
    out = np.full(shape, 0 if fill is None else _FILL.get(fill, fill), dtype)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*[range(g) for g in grid]):
        data = get(f"{name}/{sep.join(map(str, idx)) if idx else '0'}")
        if data is None:
            continue  # a chunk never written holds the fill value
        if compressor is not None:
            data = decompress(data)
        if len(data) != math.prod(chunks) * dtype.itemsize:
            raise OrbaxFormatError(f"{name}: chunk {idx} holds {len(data)} bytes")
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        dst = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[dst] = chunk[tuple(slice(0, d.stop - d.start) for d in dst)]
    return out


def _store(path: pathlib.Path, use_ocdbt: bool) -> Callable[[str], Optional[bytes]]:
    """``key -> bytes`` (None for a missing key) over the checkpoint's
    arrays."""
    if use_ocdbt:
        items = read_ocdbt(path)
        return lambda key: items.get(key.encode())

    def get(key: str) -> Optional[bytes]:
        f = path / key
        return f.read_bytes() if f.is_file() else None
    return get


def load_checkpoint_orbax(directory: str, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Read an orbax checkpoint; returns ``utils.checkpoint.load_checkpoint``'s
    layout: ``params`` (the flax tree of NumPy arrays), ``step``,
    ``metadata`` (``{}`` without the sidecar), and where the checkpoint
    holds them ``ema`` (an :class:`EmaState` of float32 CPU tensors) and
    ``sched`` (a :class:`Schedule` on ``device``)."""
    path = pathlib.Path(directory).absolute()
    meta = json.loads((path / "_METADATA").read_text())
    leaves = _leaf_paths(meta)
    get = _store(path, bool(meta.get("use_ocdbt", False)))
    tree: Dict[str, Any] = {}
    for keys in leaves:
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _read_array(get, ".".join(keys))
    meta_file = path / "diffsg_metadata.json"
    out: Dict[str, Any] = {
        "params": tree["params"],
        "step": int(tree.get("step", 0)),
        "metadata": json.loads(meta_file.read_text()) if meta_file.exists() else {},
    }
    if "ema_params" in tree:
        out["ema"] = EmaState(params_from_jax(tree["ema_params"]),
                              int(tree.get("ema_n_averaged", 0)))
    if "schedule_betas" in tree:
        out["sched"] = schedule_from_betas(tree["schedule_betas"], device=device)
    return out


# --- writing ---------------------------------------------------------------

def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for name, val in tree.items():
        path = prefix + (str(name),)
        if isinstance(val, dict):
            yield from _leaves(val, path)
        elif isinstance(val, torch.Tensor):
            yield path, val.detach().cpu().numpy()
        else:
            yield path, np.asarray(val)


def _write_array(root: pathlib.Path, name: str, arr: np.ndarray):
    arr = np.asarray(arr, order="C")
    dtype = _zarr_dtype(arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">" else arr.dtype,
                        name)
    arr = arr.astype(dtype, copy=False)
    if 0 in arr.shape:
        raise OrbaxFormatError(f"{name}: empty array of shape {arr.shape}")
    spec = {"chunks": list(arr.shape), "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": dtype.str, "fill_value": None,
            "filters": None, "order": "C", "shape": list(arr.shape), "zarr_format": 2}
    d = root / name
    d.mkdir()
    (d / ".zarray").write_text(json.dumps(spec, sort_keys=True, separators=(",", ":")))
    (d / (".".join("0" * arr.ndim) or "0")).write_bytes(compress_raw(arr.tobytes()))


def save_checkpoint_orbax(directory: str, params: Any, ema: Optional[EmaState] = None,
                          step: int = 0, sched: Optional[Schedule] = None,
                          metadata: Optional[Dict] = None) -> str:
    """Write ``params`` (the flax tree), ``ema``, ``step`` and ``sched``'s
    betas as an orbax checkpoint in ``directory``, replacing one that is
    there; returns the absolute path."""
    tree: Dict[str, Any] = {"params": params, "step": np.asarray(step)}
    if ema is not None:
        tree["ema_params"] = tree_from_state(ema.params)
        tree["ema_n_averaged"] = np.asarray(ema.n_averaged)
    if sched is not None:
        tree["schedule_betas"] = sched.betas.detach().cpu().double().numpy()
    path = pathlib.Path(directory).absolute()
    tmp = path.with_name(f"{path.name}.orbax-checkpoint-tmp-{os.getpid()}")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    start = time.time_ns()
    try:
        tree_metadata = {}
        for keys, arr in sorted(_leaves(tree), key=lambda leaf: leaf[0]):
            _write_array(tmp, ".".join(keys), arr)
            tree_metadata[str(keys)] = {
                "key_metadata": [{"key": k, "key_type": _DICT_KEY} for k in keys],
                "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}
        (tmp / "_METADATA").write_text(json.dumps({
            "tree_metadata": tree_metadata, "use_ocdbt": False, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
        if metadata:
            (tmp / "diffsg_metadata.json").write_text(json.dumps(dict(metadata), default=str))
        (tmp / "_CHECKPOINT_METADATA").write_text(json.dumps({
            "item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": start, "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}}))
        if path.exists():
            old = path.with_name(f"{path.name}.orbax-checkpoint-old-{os.getpid()}")
            path.rename(old)
            tmp.rename(path)
            shutil.rmtree(old)
        else:
            tmp.rename(path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return str(path)
