"""Checkpointing: one ``.npy`` file per leaf and a JSON index, written by
a background thread, as ``repro.checkpoint.store``.

* **Format** (the reference's): ``step_%08d/`` holding ``leaf_%05d.npy``
  per leaf and ``index.json`` with ``step``, ``leaves`` (``name``,
  ``file``, ``dtype``, ``shape``) and ``extra``.  Leaf names are the
  port's dotted paths: a dict key, a list index or an ``nn.Module``'s
  parameter name per level (``params.groups.0.p0.attn.wq``,
  ``opt.m.groups.0.p0.attn.wq``, ``step``).  numpy has no bfloat16, so a
  bfloat16 leaf is stored as its ``uint16`` bits with ``"dtype":
  "bfloat16"`` in the index and comes back bit for bit.
* **Async**: :meth:`CheckpointManager.save` copies every leaf to host
  memory before it returns (the train step updates the parameters in
  place right after) and leaves the file I/O to a writer thread.
* **Atomic**: a checkpoint is written to ``step_K.tmp/`` and renamed to
  ``step_K/``, so a crash mid-write never leaves a half checkpoint that
  :func:`latest_step` would pick.
* **Restore in place**: :func:`load_checkpoint` copies each leaf into the
  ``like`` tree's own tensors (``copy_``), which the optimizer and the
  module keep referring to; with ``devices`` it places each leaf on the
  given device instead (the reference's reshard-on-load).
* **Retention**: the manager keeps the newest ``keep`` checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["named_leaves", "device_of", "save_checkpoint", "latest_step",
           "load_checkpoint", "CheckpointManager"]

Setter = Optional[Callable[[torch.Tensor], None]]


def _join(prefix: str, key) -> str:
    return f"{prefix}.{key}" if prefix else str(key)


def named_leaves(tree: Any, prefix: str = ""
                 ) -> Iterator[tuple[str, torch.Tensor, Setter]]:
    """``(name, tensor, setter)`` for every tensor of ``tree``: nested
    dicts, lists and ``nn.Module``s (their parameters and buffers).
    ``setter(t)`` puts ``t`` in the leaf's place (a parameter keeps its
    identity and takes ``t`` as its data); a bare tensor has none."""
    if isinstance(tree, torch.Tensor):
        if isinstance(tree, nn.Parameter):
            yield prefix, tree, lambda t, p=tree: setattr(p, "data", t)
        else:
            yield prefix, tree, None
    elif isinstance(tree, nn.Module):
        for name, t in tree.named_parameters():
            yield _join(prefix, name), t, \
                lambda v, p=t: setattr(p, "data", v)
        for name, t in tree.named_buffers():
            yield _join(prefix, name), t, \
                lambda v, p=t: setattr(p, "data", v)
    elif isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for key, sub in items:
            for name, t, setter in named_leaves(sub, _join(prefix, key)):
                if setter is None and sub is t:
                    setter = lambda v, c=tree, k=key: c.__setitem__(k, v)
                yield name, t, setter
    elif tree is not None:
        raise TypeError(f"{prefix or 'tree'}: cannot checkpoint a "
                        f"{type(tree).__name__}")


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Synchronous atomic save of every leaf of ``tree``; returns the
    final directory.  Trips the ``checkpoint.save`` fault site."""
    # imported here: runtime/__init__ -> supervisor -> checkpoint would cycle
    from ..runtime.faults import trip
    trip("checkpoint.save", detail=directory, step=step)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    index = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (name, leaf, _) in enumerate(named_leaves(tree)):
        arr, dtype = _to_numpy(leaf)
        fn = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr, allow_pickle=False)
        index["leaves"].append({"name": name, "file": fn, "dtype": dtype,
                                "shape": list(arr.shape)})
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(directory: str) -> list[int]:
    return [int(d.split("_")[1]) for d in os.listdir(directory)
            if d.startswith("step_") and not d.endswith(".tmp")]


def latest_step(directory: str) -> Optional[int]:
    """The newest complete checkpoint's step, or None."""
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def device_of(devices, name: str):
    """The device ``devices`` (one device, or a dict of leaf name ->
    device) gives leaf ``name``; None keeps the leaf where it is."""
    if isinstance(devices, dict):
        return devices.get(name)
    return devices


def load_checkpoint(directory: str, like: Any, step: Optional[int] = None,
                    devices: Any = None) -> tuple[int, Any, dict]:
    """Restore checkpoint ``step`` (default: the newest) into ``like``;
    returns ``(step, like, extra)``.  Each leaf is copied into ``like``'s
    own tensor, in that tensor's dtype; with ``devices`` (one device, or a
    dict of leaf name -> device) a leaf given a device is put in its place
    as a new tensor on that device instead.  A leaf whose shape differs
    from the checkpoint's raises ``ValueError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)
    by_name = {e["name"]: e for e in index["leaves"]}
    with torch.no_grad():
        for name, leaf, setter in named_leaves(like):
            e = by_name[name]
            arr = np.load(os.path.join(d, e["file"]), allow_pickle=False)
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{name}: checkpoint shape {arr.shape} != "
                                 f"target {tuple(leaf.shape)}")
            value = _from_numpy(arr, e["dtype"])
            dev = device_of(devices, name)
            if dev is None:
                leaf.copy_(value)
            elif setter is None:
                raise TypeError(f"{name}: a bare tensor cannot be moved to "
                                f"{dev}")
            else:
                setter(value.to(device=dev, dtype=leaf.dtype))
    return step, like, index["extra"]


class CheckpointManager:
    """Async writer and retention over one directory."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = False) -> None:
        """Snapshot every leaf of ``tree`` to host memory now, then write
        it (on a writer thread unless ``blocking``).  One save is in
        flight at a time; a writer's error raises from the next
        :meth:`wait` or save."""
        self.wait()
        snapshot = {name: leaf.detach().to("cpu", copy=True)
                    for name, leaf, _ in named_leaves(tree)}

        def work():
            try:
                save_checkpoint(self.directory, step, snapshot, extra)
                self._gc()
            except BaseException as e:  # surfaced by the next wait()
                self._error = e

        if blocking:
            work()
            self._raise()
        else:
            self._thread = threading.Thread(target=work, daemon=True,
                                            name="repro-ckpt-writer")
            self._thread.start()

    def wait(self) -> None:
        """Join the writer; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise()

    def _raise(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def restore_latest(self, like: Any, devices: Any = None):
        """:func:`load_checkpoint` of the newest checkpoint."""
        return load_checkpoint(self.directory, like, devices=devices)

    def latest_step(self) -> Optional[int]:
        """The newest complete checkpoint's step, or None."""
        return latest_step(self.directory)

    def _gc(self):
        for s in sorted(_steps(self.directory))[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
