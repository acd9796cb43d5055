"""Numpy checkpoints with atomic writes (port of
``repro.train.checkpoint``), in the JAX package's on-disk format, so
each package reads the other's:

* one ``.npy`` file per leaf, named by its path (``repro_torch.tree``)
  with ``__`` for ``/``, and ``manifest.json`` holding ``step``,
  ``time``, ``leaves`` (``path``, ``file``, ``shape``, ``dtype``) and
  ``extra``;
* a write goes to ``<dir>/tmp-<step>-<pid>`` and is then renamed
  (``os.replace``) to ``<dir>/step-%08d``: a crash mid-write never
  corrupts the latest checkpoint; the newest ``keep`` are kept;
* bf16 (and fp8) leaves are stored as same-width unsigned integers with
  the true dtype in the manifest.  Without ``ml_dtypes`` a bf16 tensor
  goes through ``tensor.view(torch.int16)`` both ways.

Leaves are tensors (any device) or numpy arrays in nested dicts and
lists.  :func:`restore_checkpoint` returns CPU tensors in the template's
structure.  :class:`AsyncCheckpointer` copies the state to the host in
``save()`` (inside ``host_sync``: the one sanctioned device wait of a
save) and writes it on a worker thread, which touches numpy only.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.guards import host_sync
from repro_torch.tree import flatten_with_paths, tree_from_paths

# Stored as same-width unsigned integers; the manifest keeps the name.
_EXOTIC = {"bfloat16": (np.uint16, torch.bfloat16),
           "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
           "float8_e5m2": (np.uint8, torch.float8_e5m2)}
_BY_TORCH = {t: name for name, (_, t) in _EXOTIC.items()}

# (path, host array as stored, true shape, dtype name)
Encoded = List[Tuple[str, np.ndarray, List[int], str]]


def _encode_leaf(leaf) -> Tuple[np.ndarray, str]:
    """The host array to store and its dtype name: a copy, so the caller
    may update the leaf in place while a worker writes it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype in _BY_TORCH:
            name = _BY_TORCH[t.dtype]
            width = torch.int16 if name == "bfloat16" else torch.int8
            return t.view(width).numpy().view(_EXOTIC[name][0]), name
        arr = t.numpy()
        return arr, arr.dtype.name
    arr = np.array(leaf)
    name = arr.dtype.name
    if name in _EXOTIC:                       # numpy bf16 from ml_dtypes
        return arr.view(_EXOTIC[name][0]), name
    return arr, name


def _decode(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = np.require(arr, requirements="C")
    if dtype_name in _EXOTIC:
        width = np.int16 if dtype_name == "bfloat16" else np.int8
        return torch.from_numpy(arr.view(width)).view(_EXOTIC[dtype_name][1])
    return torch.from_numpy(arr)


def _encode(state) -> Encoded:
    out = []
    for name, leaf in flatten_with_paths(state):
        arr, dtype_name = _encode_leaf(leaf)
        out.append((name, arr, list(arr.shape), dtype_name))
    return out


def _write(directory: str, step: int, leaves: Encoded,
           extra: Optional[Dict[str, Any]], keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp-{step}-{os.getpid()}")
    final = os.path.join(directory, f"step-{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "time": time.time(), "leaves": [],
                "extra": extra or {}}
    for name, arr, shape, dtype_name in leaves:
        fname = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"path": name, "file": fname,
                                   "shape": shape, "dtype": dtype_name})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _rotate(directory, keep)
    return final


def save_checkpoint(directory: str, step: int, state,
                    extra: Optional[Dict[str, Any]] = None,
                    keep: int = 3) -> str:
    """state: nested dicts/lists of tensors or arrays.  Returns the final
    path."""
    return _write(directory, step, _encode(state), extra, keep)


def _rotate(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step-"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step-") and os.path.exists(
                os.path.join(directory, d, "manifest.json")):
            steps.append(int(d.split("-")[1]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, template, step: Optional[int] = None,
                       ) -> Tuple[Any, int, Dict[str, Any]]:
    """Restore into ``template``'s structure (its leaves name the files;
    their values are not read).  Returns ``(state of CPU tensors, step,
    extra)``."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step-{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    leaves = []
    for name, _leaf in flatten_with_paths(template):
        entry = by_path.get(name)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {name}")
        leaves.append((name, _decode(np.load(os.path.join(d, entry["file"])),
                                     entry["dtype"])))
    return tree_from_paths(leaves), step, manifest.get("extra", {})


class AsyncCheckpointer:
    """Checkpoint writes on a worker thread, one in flight at a time."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def save(self, step: int, state, extra=None) -> None:
        self.wait()
        with host_sync("checkpoint: copy the state to the host"):
            leaves = _encode(state)

        def work():
            try:
                _write(self.directory, step, leaves, extra, self.keep)
            except Exception as e:      # surfaced on the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
