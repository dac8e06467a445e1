"""Fault-tolerant checkpoint/restart — the port of
``repro.checkpoint.manager`` for trees of torch tensors and numpy arrays.

Design (both tracks):
* atomic: write to a temp dir, fsync, rename — a crash mid-save never
  corrupts the latest checkpoint;
* versioned: step-numbered directories + a ``manifest.json`` with the
  leaves' shapes and dtypes and a content hash for integrity verification;
* bounded: keeps the newest ``keep`` checkpoints;
* resumable: ``restore_latest`` returns (state, step) or None, falling back
  to the previous good snapshot when the newest fails its check.

Trees are nested dicts, lists, tuples and dataclasses (``None`` holds no
leaf); every other object is a leaf. Leaf keys are the reference's:
``"a/b/0"`` for dict keys and sequence indices, ``".name"`` for a dataclass
field and ``"_root"`` for a bare leaf, so a numpy tree written by either
package restores in the other. The file format and the content hash
(per leaf: key, dtype, shape, first MiB of bytes) are the reference's.

bfloat16: npz has no bfloat16, so a bf16 tensor is stored as its raw
``uint16`` bit pattern and the manifest records its dtype as
``"bfloat16"``; restore views the bits back, so bf16 round-trips bit for
bit. (The reference writes no bf16 leaf this way: its bf16 pools go out as
f32, as the port's store does too.)

Restore follows the template ``like``: numpy leaves come back as numpy in
the template's dtype, tensors as tensors on the template's device and
dtype, anything else as the stored 0-d array.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

_BF16 = "bfloat16"


def _is_dataclass(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _children(tree):
    """[(key part, child)] of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if _is_dataclass(tree):
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def _walk(tree, prefix=()):
    """(key, leaf) for every leaf, in the reference's flattening order."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield "/".join(prefix) or "_root", tree
        return
    for part, child in kids:
        yield from _walk(child, prefix + (part,))


def _rebuild(tree, fn: Callable[[str, Any], Any], prefix=()):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, _rebuild(v, fn, prefix + (str(k),)))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, fn, prefix + (str(i),))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    if _is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), fn,
                             prefix + (f".{f.name}",))
            for f in dataclasses.fields(tree)})
    return fn("/".join(prefix) or "_root", tree)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array as stored in the npz, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _flatten_with_paths(tree: Any):
    """({key: stored array}, {key: dtype name})."""
    arrays, dtypes = {}, {}
    for key, leaf in _walk(tree):
        arrays[key], dtypes[key] = _to_numpy(leaf)
    return arrays, dtypes


def _head_bytes(a: np.ndarray) -> bytes:
    """``a.tobytes()[:1 MiB]`` without copying the whole array."""
    flat = np.ascontiguousarray(a).reshape(-1)
    return flat.view(np.uint8)[:1 << 20].tobytes()


def _content_hash(arrays: dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(str(arrays[k].dtype).encode())
        h.update(str(arrays[k].shape).encode())
        h.update(_head_bytes(arrays[k]))   # first 1MB per leaf
    return h.hexdigest()


def _fsync(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _restore_leaf(arr: np.ndarray, dtype_name: str, leaf):
    if isinstance(leaf, torch.Tensor):
        if dtype_name == _BF16:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if dtype_name == _BF16:
        raise ValueError("a bfloat16 leaf restores into a tensor template "
                         "only")
    if isinstance(leaf, np.ndarray):
        # host-side template leaves (the store's slot maps, centroids)
        # restore as numpy: moving them to the device would change their
        # owner's semantics
        return np.asarray(arr, leaf.dtype)
    if hasattr(leaf, "dtype"):
        return np.asarray(arr).astype(leaf.dtype)
    return arr


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}"

    def save(self, state: Any, step: int) -> Path:
        arrays, dtypes = _flatten_with_paths(state)
        tmp = self.dir / f".tmp_step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **arrays)
        _fsync(tmp / "arrays.npz")
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in arrays.items()},
            "hash": _content_hash(arrays),
            "format": 1,
        }
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = self._step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                     # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def steps(self) -> list[int]:
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if (p / "manifest.json").exists()]

    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like`` (a template tree)."""
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "arrays.npz") as z:
            arrays = {k: z[k] for k in z.files}
        if _content_hash(arrays) != manifest["hash"]:
            raise IOError(f"checkpoint {d} failed integrity check")
        keys = {k for k, _ in _walk(like)}
        if keys != set(arrays):
            missing = keys ^ set(arrays)
            raise ValueError(f"checkpoint/state structure mismatch: {missing}")
        leaves = manifest["leaves"]
        return _rebuild(like, lambda k, leaf: _restore_leaf(
            arrays[k], leaves.get(k, {}).get("dtype", ""), leaf))

    def restore_latest(self, like: Any) -> Optional[tuple[Any, int]]:
        steps = self.steps()
        if not steps:
            return None
        for s in sorted(steps, reverse=True):
            try:
                return self.restore(s, like), s
            except (IOError, ValueError):
                # corrupted (e.g. died mid-publish on a weird FS): fall
                # back to the previous snapshot
                continue
        return None
