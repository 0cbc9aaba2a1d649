"""Async, atomic checkpointing of flat trees of tensors and arrays.

Counterpart of ``repro.checkpoint.manager``, with the same on-disk layout,
so either package's checkpoints load in the other:

* ``step_XXXXXXXX/`` holds one ``.npy`` per leaf (``"/"`` in a leaf's name
  becomes ``"__"`` in its file name) and ``manifest.json`` with ``step``
  and each leaf's ``file``, ``shape`` and ``dtype``;
* **atomic** — written to ``step_XXXXXXXX.tmp``, then ``os.replace``d;
  orphaned ``*.tmp`` directories of a process killed mid-write are swept
  when a manager is made, and a published directory whose manifest is
  unreadable is skipped, so a torn write never shadows a good step;
* **async** — the device-to-host copy happens in :meth:`save`, the disk
  write on a background thread; :meth:`wait` joins it; published steps
  beyond the newest ``keep`` are deleted.

A tree is a dict (nested dicts and lists are flattened with ``"/"``) of
torch tensors, numpy arrays or scalars.  Tensors go to the host with
``.detach().cpu().numpy()``.  numpy-native kinds (float, int, unsigned,
bool, complex, unicode) are stored as they are and round-trip bit for
bit.  A bf16 tensor is stored widened to f32 with ``"bfloat16"`` in the
manifest, as the reference stores its bf16 arrays: :meth:`load` returns
it widened (numpy has no bf16), :meth:`restore` narrows it back to
``torch.bfloat16``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import faults

#: numpy dtype kinds stored natively: float, int, unsigned, bool, complex,
#: unicode (JSON-in-a-leaf metadata).
_NATIVE_KINDS = "fiubcU"


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{"a": {"b": x}, "c": [y, z]}`` -> ``{"a/b": x, "c/0": y, "c/1": z}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _to_host(leaf):
    """A leaf as ``(numpy array to store, manifest dtype name)``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().resolve_conj().resolve_neg()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        # a CPU tensor's numpy view shares its memory: copy it, so that an
        # update in place (a donated train step) cannot reach the write
        arr = t.numpy().copy() if leaf.device.type == "cpu" else t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.kind not in _NATIVE_KINDS:   # ml_dtypes bf16/fp8 arrays
        return arr.astype(np.float32), str(arr.dtype)
    return arr, str(arr.dtype)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        # sweep the tmp dirs of a process killed mid-write; published steps
        # are never touched
        for p in self.dir.glob("step_*.tmp"):
            shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, blocking: bool = False) -> None:
        """Copy ``tree`` to host memory now; write it to disk on a
        background thread (``blocking=True``: here)."""
        self.wait()
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}

        def write():
            fault = faults.should_fire("checkpoint.write")
            tmp = self.dir / f"step_{step:08d}.tmp"
            final = self.dir / f"step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
            manifest = {"step": step, "leaves": {}}
            for key, (arr, dtype) in host.items():
                fname = key.replace("/", "__") + ".npy"
                np.save(tmp / fname, arr)
                manifest["leaves"][key] = {
                    "file": fname, "shape": list(arr.shape), "dtype": dtype}
                if fault is not None and fault.action == "torn":
                    # an injected kill mid-write: partial tmp, never published
                    return
            body = json.dumps(manifest)
            if fault is not None and fault.action == "torn_final":
                # an injected kill mid-publish on a non-atomic filesystem:
                # the final dir exists, its manifest is truncated
                (tmp / "manifest.json").write_text(body[: len(body) // 2])
                os.replace(tmp, final)
                return
            (tmp / "manifest.json").write_text(body)
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            try:
                json.loads((p / "manifest.json").read_text())
            except (OSError, ValueError):
                continue   # torn publish: never shadows a good step
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _manifest(self, step: int) -> dict:
        final = self.dir / f"step_{step:08d}"
        try:
            return json.loads((final / "manifest.json").read_text())
        except FileNotFoundError:
            raise FileNotFoundError(
                f"no checkpoint for step {step} in {self.dir} "
                f"(available steps: {self.all_steps() or 'none'})") from None

    def _load(self, step: int):
        final = self.dir / f"step_{step:08d}"
        manifest = self._manifest(step)
        return {key: (np.load(final / meta["file"]), meta["dtype"])
                for key, meta in manifest["leaves"].items()}

    def load(self, step: int) -> Dict[str, np.ndarray]:
        """The checkpoint as a flat ``{path: np.ndarray}`` dict.  bf16
        leaves come back widened to f32 (see the module docstring)."""
        return {key: arr for key, (arr, _) in self._load(step).items()}

    def restore(self, step: int, target: Dict[str, Any], device=None):
        """Restore into the flat dict ``target`` of tensors, arrays or
        shapes: every leaf must be in ``target`` with its shape, and every
        target leaf in the checkpoint.  A leaf lands on its target tensor's
        device, else on ``device`` (default the CPU); unicode leaves stay
        numpy arrays."""
        loaded = self._load(step)
        flat_target = dict(target)
        out = {}
        for key, (arr, dtype) in loaded.items():
            if key not in flat_target:
                raise KeyError(f"checkpoint leaf {key} not in target tree")
            want = flat_target[key]
            shape = tuple(want.shape) if hasattr(want, "shape") else tuple(want)
            if tuple(arr.shape) != shape:
                raise ValueError(f"{key}: shape {arr.shape} != {shape}")
            dev = want.device if isinstance(want, torch.Tensor) else device
            out[key] = _as_tensor(arr, dtype, dev)
        missing = set(flat_target) - set(out)
        if missing:
            raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]}")
        return {key: out[key] for key in flat_target}


def _as_tensor(arr: np.ndarray, dtype: str, device):
    if arr.dtype.kind == "U":
        return arr
    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
    return t.to(device if device is not None else "cpu")
