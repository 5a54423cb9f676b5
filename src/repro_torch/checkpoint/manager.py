"""Checkpointing: async save, retention, atomic commit, restore.

The JAX package's layout, read and written with numpy alone:

  * A checkpoint is a directory ``step_<N>/`` holding one ``arrays.npz``
    (the tree's leaves keyed by path: the port's own paths,
    ``params/layers/3/attn/wq`` or ``opt/m/embed``, from
    ``repro_torch.tree``) and ``meta.json`` (step, wall time, the
    caller's entries, and ``bfloat16``: the paths of bf16 leaves, which
    numpy has no type for and which are stored as their int16 bits). A
    ``COMMIT`` marker makes the save atomic: the directory is written as
    ``step_<N>.tmp`` and renamed once whole, and restore ignores a
    directory without the marker, so a failure mid-save never corrupts the
    latest checkpoint.
  * ``save`` is asynchronous: leaves are copied to the host on the calling
    thread (the device -> host copy; a copy for CPU leaves too, since the
    optimizer updates them in place while the file is written), then written
    on a background thread, so the loop resumes while the file is written.
    One save is in flight at a time.
  * Retention keeps the newest ``keep`` committed checkpoints.
  * ``restore`` builds the template's tree from the file, each leaf cast to
    the template leaf's dtype and placed on ``device``; a stored array whose
    shape differs from its template leaf's raises.
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

from repro_torch import tree as tree_lib

_COMMIT = "COMMIT"


def _host(leaf) -> Tuple[np.ndarray, bool]:
    """(numpy array, was bf16) of one leaf, on the host."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), False
    # a snapshot, never a view: the step updates CPU leaves in place while
    # the background thread writes them
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), True
    return t.numpy(), False


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest committed step in ``ckpt_dir`` (None if no valid checkpoint)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(os.path.join(ckpt_dir, name, _COMMIT)):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, template: Any, device=None) -> Any:
    """Load ``step_<step>`` into the structure of ``template`` (a tree whose
    leaves give the dtypes and shapes: tensors, on any device, ``meta``
    included). Each leaf is cast to its template's dtype and placed on
    ``device`` (default: the CPU); a shape that differs from the template
    leaf's raises ``ValueError``."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    if not os.path.exists(os.path.join(d, _COMMIT)):
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    with open(os.path.join(d, "meta.json")) as f:
        bf16 = set(json.load(f).get("bfloat16", ()))
    out = []
    with np.load(os.path.join(d, "arrays.npz")) as z:
        for path, leaf in tree_lib.flatten_with_paths(template):
            t = torch.from_numpy(z[path])
            if isinstance(leaf, torch.Tensor) and tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint {d}: {path} has shape {tuple(t.shape)}, "
                                 f"the template {tuple(leaf.shape)}")
            if path in bf16:
                t = t.view(torch.bfloat16)
            if isinstance(leaf, torch.Tensor):
                t = t.to(device=device, dtype=leaf.dtype)
            else:
                t = t.to(device=device)
            out.append(t)
    return tree_lib.unflatten(template, out)


class CheckpointManager:
    """Async checkpoint writer with retention."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # seconds from the last save's call to its commit (None before one)
        self.last_save_s: Optional[float] = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, *, meta: Optional[Dict] = None,
             blocking: bool = False) -> None:
        """Snapshot ``tree`` at ``step``. The device -> host copy happens
        here; the file is written on a background thread unless
        ``blocking``."""
        self.wait()  # one in-flight save at a time
        t0 = time.perf_counter()
        host: List[Tuple[str, np.ndarray]] = []
        bf16 = []
        for path, leaf in tree_lib.flatten_with_paths(tree):
            arr, was_bf16 = _host(leaf)
            host.append((path, arr))
            if was_bf16:
                bf16.append(path)
        info = dict(meta or {}, step=step, time=time.time(), bfloat16=bf16)

        def write():
            try:
                final = os.path.join(self.ckpt_dir, f"step_{step}")
                tmp = final + ".tmp"
                shutil.rmtree(tmp, ignore_errors=True)
                shutil.rmtree(final, ignore_errors=True)
                os.makedirs(tmp)
                np.savez(os.path.join(tmp, "arrays.npz"), **dict(host))
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(info, f)
                with open(os.path.join(tmp, _COMMIT), "w") as f:
                    f.write(str(step))
                os.rename(tmp, final)
                self.last_save_s = time.perf_counter() - t0
                self._retain()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if blocking:
            write()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Block until the in-flight save (if any) commits; re-raise its
        error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # -- retention ------------------------------------------------------------
    def _retain(self) -> None:
        steps = sorted(
            int(n.split("_", 1)[1]) for n in os.listdir(self.ckpt_dir)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.ckpt_dir, n, _COMMIT)))
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def restore_latest(self, template: Any, device=None) -> Tuple[Optional[int], Any]:
        step = latest_step(self.ckpt_dir)
        if step is None:
            return None, None
        return step, restore(self.ckpt_dir, step, template, device)
