"""Fault-tolerant checkpointing — the counterpart of
``repro.training.checkpoint``, in its on-disk format, so either package
reads the other's checkpoints.

Guarantees:
* **Atomicity** — writes go to ``step_XXXXXXXX.tmp`` and are renamed only
  after every array and the manifest have been fsynced; a crash mid-save
  never corrupts the latest valid checkpoint.
* **Integrity** — the manifest stores per-leaf SHA-256 (over the array's
  bytes) + shapes/dtypes; ``restore`` verifies before handing tensors
  back and falls back to the previous valid step on corruption.
* **Placement** — each leaf is restored onto the device and dtype of the
  template's leaf (the reference's reshard-on-restore).
* **Data-order resume** — the data cursor rides in the manifest's
  ``extra``; the stateless pipeline regenerates the batches that follow.

Format: ``step_XXXXXXXX/`` holds one ``.npy`` per leaf, named by the
first 16 hex digits of the md5 of its key (``a/b/c``, the path in the
reference's flattening order), and ``manifest.json``.  numpy has no
bfloat16: such a leaf is written as 2-byte void records (``'<V2'``, what
numpy writes for the reference's ``ml_dtypes`` arrays) with
``"dtype": "bfloat16"`` in the manifest, and restored through that dtype
(the bytes viewed as int16, then as ``torch.bfloat16``).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from .tree import leaves_with_paths, unflatten_like

Params = Any


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _host_array(leaf):
    """``(numpy array, manifest dtype name, npy descr or None)``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16", "<V2"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype), None


def _write_npy(f, arr: np.ndarray, descr: Optional[str]) -> None:
    if descr is None:
        np.save(f, arr)
        return
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = descr
    np.lib.format.write_array_header_1_0(f, header)
    f.write(arr.tobytes())


def _as_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state: Params, extra: Optional[Dict] = None):
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for path, leaf in leaves_with_paths(state):
            key = _key(path)
            arr, dtype_name, descr = _host_array(leaf)
            fname = hashlib.md5(key.encode()).hexdigest()[:16] + ".npy"
            with open(os.path.join(tmp, fname), "wb") as f:
                _write_npy(f, arr, descr)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype_name,
                "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)                      # atomic publish
        self._gc()

    def _gc(self):
        steps = self.available_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def available_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    # ------------------------------------------------------------------
    def _verify_and_load(self, step: int, template: Params):
        cdir = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(cdir, "manifest.json")) as f:
            manifest = json.load(f)
        loaded = {}
        for key, meta in manifest["leaves"].items():
            arr = np.load(os.path.join(cdir, meta["file"]))
            if hashlib.sha256(arr.tobytes()).hexdigest() != meta["sha256"]:
                raise IOError(f"integrity failure in {key} @ step {step}")
            loaded[key] = _as_tensor(arr, meta["dtype"])
        out = []
        for path, like in leaves_with_paths(template):
            t = loaded[_key(path)]
            if isinstance(like, torch.Tensor):
                if tuple(like.shape) != tuple(t.shape):
                    raise ValueError(
                        f"{_key(path)}: the checkpoint holds shape "
                        f"{tuple(t.shape)}, the template {tuple(like.shape)}")
                t = t.to(device=like.device, dtype=like.dtype)
            out.append(t)
        return unflatten_like(template, out), manifest

    def restore(self, template: Params, step: Optional[int] = None):
        """Restore the latest (or the given) step onto ``template``'s
        structure, each leaf on the device and in the dtype of the
        template's tensor leaf (a leaf that is no tensor comes back as a
        CPU tensor in the stored dtype); skip corrupt checkpoints.
        Returns (state, manifest) or (None, None) if nothing restorable."""
        steps = self.available_steps()
        if step is not None:
            steps = [s for s in steps if s == step]
        for s in reversed(steps):
            try:
                return self._verify_and_load(s, template)
            except (IOError, FileNotFoundError, json.JSONDecodeError):
                continue
        return None, None
