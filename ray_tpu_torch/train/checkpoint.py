"""Checkpoint — dict/directory morphing container (counterpart of
ray_tpu/train/checkpoint.py, with its names).

Parity with the reference's AIR Checkpoint (ref: python/ray/air/
checkpoint.py:66 — dict <-> dir forms). Where the JAX package pulls every
array into an ``arrays.npz`` beside a pickle of the structure, the port
keeps the arrays inside the pickle, on the host:

- A tensor of any device goes to the host: a dict checkpoint does so
  when it is pickled (``train.report`` ships one from a rank on the card
  to the driver), a directory when it is written.
- In a directory, a tensor whose dtype numpy has (f32, f16, f64,
  integers, bool) is stored as a numpy array, and ``to_dict`` returns it
  as one, as the JAX package's does. numpy has no bf16 (nor float8): such
  a tensor is stored as a CPU torch tensor, bit for bit, and ``to_dict``
  returns it so.
- The JAX package reads a directory the port wrote (its ``to_dict``
  unpickles ``checkpoint.pkl``, and finds no ``arrays.npz`` to restore
  from), and the port reads one the JAX package wrote: its ``_ArrayRef``
  placeholders are restored from its ``arrays.npz``.
"""
from __future__ import annotations

import os
import pickle
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np

from .._vendor import cloudpickle


class Checkpoint:
    def __init__(self, data: Optional[Dict[str, Any]] = None,
                 directory: Optional[str] = None):
        if (data is None) == (directory is None):
            raise ValueError("Provide exactly one of data / directory")
        self._data = data
        self._dir = directory

    def __getstate__(self):
        # a checkpoint crosses processes with its tensors on the host: the
        # runtime's serializer refuses a tensor on the card, and the
        # driver that persists it may hold no card
        state = dict(self.__dict__)
        if state["_data"] is not None:
            state["_data"] = _map_leaves(_host_leaf, state["_data"])
        return state

    # ---- constructors ------------------------------------------------------

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, directory: str) -> "Checkpoint":
        return cls(directory=directory)

    # ---- accessors ---------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return dict(self._data)
        with open(os.path.join(self._dir, "checkpoint.pkl"), "rb") as f:
            data = _Unpickler(f).load()
        arrays_path = os.path.join(self._dir, "arrays.npz")
        if os.path.exists(arrays_path):     # written by the JAX package
            with np.load(arrays_path, allow_pickle=False) as arrs:
                data = _restore_arrays(data, arrs)
        return data

    def to_directory(self, path: Optional[str] = None) -> str:
        if self._dir is not None and path is None:
            return self._dir
        path = path or tempfile.mkdtemp(prefix="rtpu_ckpt_")
        os.makedirs(path, exist_ok=True)
        data = _extract_arrays(self._data if self._data is not None
                               else self.to_dict())
        with open(os.path.join(path, "checkpoint.pkl"), "wb") as f:
            cloudpickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
        with open(os.path.join(path, ".metadata"), "w") as f:
            f.write(f"ray_tpu_torch checkpoint {time.time()}\n")
        return path

    def __repr__(self):
        kind = "dict" if self._data is not None else f"dir:{self._dir}"
        return f"Checkpoint({kind})"


def _tensor_type():
    # a tensor exists only where torch was imported: no import here
    return getattr(sys.modules.get("torch"), "Tensor", None)


def _map_leaves(fn, data: Any) -> Any:
    """``data`` with ``fn`` applied to each leaf of its dicts, lists and
    tuples."""
    if isinstance(data, dict):
        return {k: _map_leaves(fn, v) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return type(data)(_map_leaves(fn, v) for v in data)
    return fn(data)


def _host_leaf(x: Any) -> Any:
    """A tensor detached and on the host (dtype and bits unchanged)."""
    tensor = _tensor_type()
    if tensor is not None and isinstance(x, tensor):
        return x.detach().cpu()
    return x


def _stored_leaf(x: Any) -> Any:
    """A leaf as a directory stores it: a tensor on the host, as a numpy
    array where numpy has its dtype (else a CPU torch tensor), and any
    other object with ``__array__`` (not a numpy scalar) as a numpy
    array, as the JAX package takes them."""
    tensor = _tensor_type()
    if tensor is not None and isinstance(x, tensor):
        host = x.detach().cpu()
        try:
            return host.numpy()
        except TypeError:           # bf16, float8: no numpy dtype
            return host
    if hasattr(x, "__array__") and not np.isscalar(x):
        return np.asarray(x)
    return x


def _extract_arrays(data: Any) -> Any:
    """``data`` with every leaf as a directory stores it."""
    return _map_leaves(_stored_leaf, data)


def _restore_arrays(data: Any, arrs) -> Any:
    """A JAX-package structure with its ``_ArrayRef`` placeholders replaced
    by the arrays of its ``arrays.npz``."""
    if isinstance(data, dict):
        return {k: _restore_arrays(v, arrs) for k, v in data.items()}
    if isinstance(data, _ArrayRef):
        return arrs[data.key]
    return data


class _ArrayRef:
    """The JAX package's placeholder for an array of ``arrays.npz``."""
    __slots__ = ("key",)

    def __init__(self, key: str):
        self.key = key

    def __setstate__(self, state):
        # pickled by the JAX package as (None, {"key": ...}) with __slots__
        if isinstance(state, tuple):
            state = state[1]
        self.key = state["key"]


class _Unpickler(pickle.Unpickler):
    """Reads the JAX package's ``checkpoint.pkl`` too: its ``_ArrayRef``
    (the class of its train/checkpoint.py) becomes the port's, so the
    JAX package is never imported."""

    def find_class(self, module, name):
        if name == "_ArrayRef" and module.endswith(".train.checkpoint"):
            return _ArrayRef
        return super().find_class(module, name)


def prune_checkpoints(base_dir: str, num_to_keep: Optional[int]) -> None:
    if not num_to_keep or not os.path.isdir(base_dir):
        return
    ckpts = sorted(d for d in os.listdir(base_dir)
                   if d.startswith("checkpoint_"))
    for stale in ckpts[:-num_to_keep]:
        shutil.rmtree(os.path.join(base_dir, stale), ignore_errors=True)
