"""Async, atomic checkpointing, in the reference's file format.

Port of ``repro/checkpoint/ckpt.py``, with numpy and ``torch`` only:

* **atomic**: a checkpoint is written to ``step_<N>.tmp/`` and renamed to
  ``step_<N>/`` once the manifest and every leaf are written, so a crashed
  writer never corrupts the latest valid checkpoint;
* **async**: the device -> host copy happens when ``save_checkpoint`` is
  called (CPU tensors are copied too, since the train step updates its
  state in place), and serialization runs on a background thread;
* **the reference's files**: one ``<path>.npy`` a leaf, the tree path's
  ``/`` written ``__`` (``params__layers__wq.npy``, ``opt__step.npy``),
  each holding the leaf's raw bytes as uint8, and ``manifest.json`` with
  the step, a time, a description of the tree and each leaf's shape and
  dtype (numpy's names: ``float32``, ``int32``, ``bfloat16``).  Paths
  follow ``jax.tree_util``'s: a named tuple's or dataclass's field names,
  dict keys, ``[i]`` for a list item.  So a checkpoint written by either
  package restores into the other's state.  A bf16 leaf is stored through
  a 16-bit integer view and rebuilt through one (no ``ml_dtypes``); the
  optimizer's step (a Python int) is stored as an int32 scalar.

:func:`restore_checkpoint` fills the tensor leaves of ``like`` in place
(the port updates in place where that saves a copy of the state) and
returns ``like``'s structure with them; a ``like`` leaf on the meta device
becomes a new tensor on ``device``, an int leaf an int.  Elastic re-mesh
placement (``shardings=``) is multi-device and not ported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _children(node):
    """(name, child) pairs of an inner node, or None for a leaf."""
    if hasattr(node, "_fields"):                       # NamedTuple
        return [(f, getattr(node, f)) for f in node._fields]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(node)]
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat = {}
    for name, child in kids:
        flat.update(_flatten(child, f"{prefix}/{name}" if prefix else name))
    return flat


def _describe(tree) -> str:
    kids = _children(tree)
    if kids is None:
        return "*"
    inner = ", ".join(f"{n}: {_describe(c)}" for n, c in kids)
    return f"{type(tree).__name__}({inner})"


def _to_host(leaf):
    """(numpy array, numpy dtype name) of a leaf, a copy of its bytes."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    if isinstance(leaf, (bool, int)):
        return np.asarray(leaf, np.int32), "int32"
    a = np.array(leaf)
    return a, str(a.dtype)


def save_checkpoint(ckpt_dir: str, step: int, state, *,
                    blocking: bool = True) -> threading.Thread:
    """Serialize ``state`` (a tree of tensors, arrays and ints) under
    ``ckpt_dir``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    # device -> host NOW (so the train loop can update the state after)
    flat = {k: _to_host(v) for k, v in _flatten(state).items()}
    treedef = _describe(state)

    def write():
        manifest = {"step": step, "time": time.time(), "treedef": treedef,
                    "leaves": {k: {"shape": list(a.shape), "dtype": dt}
                               for k, (a, dt) in flat.items()}}
        for k, (a, _) in flat.items():
            fn = os.path.join(tmp, k.replace("/", "__") + ".npy")
            np.save(fn, np.ascontiguousarray(a).reshape(-1).view(np.uint8))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                    # atomic publish

    t = threading.Thread(target=write, daemon=True)
    t.start()
    if blocking:
        t.join()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _from_host(raw: np.ndarray, meta: Dict) -> torch.Tensor:
    shape = tuple(meta["shape"])
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(raw.view(np.int16).reshape(shape)).view(
            torch.bfloat16)
    return torch.from_numpy(raw.view(np.dtype(meta["dtype"])).reshape(shape))


def _rebuild(like, loaded: Dict[str, Any], prefix: str = ""):
    kids = _children(like)
    if kids is None:
        return loaded[prefix]
    vals = {n: _rebuild(c, loaded, f"{prefix}/{n}" if prefix else n)
            for n, c in kids}
    if hasattr(like, "_fields"):
        return type(like)(*(vals[f] for f in like._fields))
    if dataclasses.is_dataclass(like):
        return type(like)(**vals)
    if isinstance(like, dict):
        return {k: vals[str(k)] for k in like}
    return type(like)(vals[f"[{i}]"] for i in range(len(like)))


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, step: int, like, *, device="cpu"):
    """The checkpoint of ``step`` in ``like``'s structure.  Tensor leaves
    of ``like`` on a real device are filled in place (and cast to their
    dtype); meta leaves become tensors on ``device``; int leaves ints."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    loaded = {}
    for k, leaf in _flatten(like).items():
        raw = np.load(os.path.join(d, k.replace("/", "__") + ".npy"))
        meta = manifest["leaves"][k]
        t = _from_host(raw, meta)
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(t.shape) != shape:
            raise ValueError(f"checkpoint leaf {k}: shape {tuple(t.shape)}, "
                             f"the state's {shape}")
        if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
            leaf.copy_(t)
            loaded[k] = leaf
        elif isinstance(leaf, torch.Tensor):
            loaded[k] = t.to(device=device, dtype=leaf.dtype)
        elif isinstance(leaf, (bool, int)):
            loaded[k] = int(t)
        else:
            loaded[k] = t.numpy()
    return _rebuild(like, loaded)


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; saves async every ``every``."""

    def __init__(self, ckpt_dir: str, every: int = 100, keep: int = 3):
        self.dir = ckpt_dir
        self.every = every
        self.keep = keep
        self._pending: Optional[threading.Thread] = None

    def maybe_save(self, step: int, state) -> bool:
        if step % self.every != 0:
            return False
        if self._pending is not None:
            self._pending.join()                 # one in flight max
        self._pending = save_checkpoint(self.dir, step, state,
                                        blocking=False)
        self._gc()
        return True

    def finalize(self):
        if self._pending is not None:
            self._pending.join()
            self._gc()

    def _gc(self):
        if not os.path.isdir(self.dir):
            return
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
