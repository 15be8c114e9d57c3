"""Fault-tolerant checkpointing: atomic, async, keep-N (counterpart of
``repro.checkpoint.checkpointer``, in the reference's on-disk format).

Layout (one directory per step):
    <root>/step_000000123.tmp-<nonce>/   while writing
    <root>/step_000000123/               after atomic rename
        manifest.json     leaf paths, shapes, dtypes, crc32 per leaf
        leaf_00000.npy ...

Leaves are numbered in the reference's order (its pytree flattening
with paths): dict keys sorted, list and tuple items by index, the fields
of a :func:`tree_node` dataclass (the reference's ``pytree_dataclass``:
``TrainState``, ``AdamWState``) in declaration order as ``.<field>``,
a ``ParamTree`` as its nested dict; paths joined with ``/``; ``None``
holds no leaf.  A leaf is a torch tensor (copied to the host), a numpy
array or a number.  So a checkpoint of either package restores in the
other, bit for bit.

Guarantees
----------
* **Atomicity**: a checkpoint directory appears only via rename(2); a
  crashed writer leaves ``.tmp-*`` litter that the next writer removes.
* **Integrity**: every leaf carries a CRC32; restore verifies before use.
* **Async**: ``CheckpointManager.save_async`` copies every leaf to the host
  on the calling thread (``.detach().cpu()``: the caller may go on
  changing its tensors), then hands the serialization to a worker thread.
* **Keep-N** GC + a ``latest`` pointer written last.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.logging import get_logger

log = get_logger("checkpoint")


_TREE_NODES: set = set()


def tree_node(cls):
    """Class decorator: instances of the dataclass ``cls`` flatten field by
    field, in declaration order, with the path part ``.<field>``, as the
    reference's ``pytree_dataclass`` instances do."""
    _TREE_NODES.add(cls)
    return cls


def _is_param_tree(node) -> bool:
    return isinstance(node, torch.nn.Module) and hasattr(node, "tree")


def _items(node):
    """Children of a container node as ``(key, child)``, in the
    reference's flattening order; ``None`` for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if type(node) in _TREE_NODES:
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if _is_param_tree(node):
        return _items(node.tree())
    return None


def _flatten_with_paths(tree, prefix: str = ""):
    """``(paths, leaves)`` of ``tree`` in the reference's order."""
    if tree is None:
        return [], []
    items = _items(tree)
    if items is None:
        return [prefix], [tree]
    paths, leaves = [], []
    for k, child in items:
        p, lv = _flatten_with_paths(child, f"{prefix}/{k}" if prefix
                                    else str(k))
        paths += p
        leaves += lv
    return paths, leaves


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        items = _items(node)
        if items is None:
            return next(it)
        if isinstance(node, dict):
            return {k: build(v) for k, v in items}
        if type(node) in _TREE_NODES:
            return type(node)(**{k[1:]: build(v) for k, v in items})
        if _is_param_tree(node):
            # tensors make a new ParamTree; host copies stay a dict
            tree = {k: build(v) for k, v in items}
            return type(node)(tree) if _all_tensors(tree) else tree
        return type(node)(build(v) for _, v in items)

    return build(tree)


def _all_tensors(tree: dict) -> bool:
    return all(_all_tensors(v) if isinstance(v, dict) else torch.is_tensor(v)
               for v in tree.values())


def to_host(leaf) -> np.ndarray:
    """A host numpy copy of a leaf: a tensor is detached and copied (also
    one on the CPU, so the caller may change it afterwards)."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _numpy_dtype(ref) -> np.dtype:
    if torch.is_tensor(ref):
        return torch.empty((), dtype=ref.dtype).numpy().dtype
    return np.asarray(ref).dtype


def save_checkpoint(root: str | Path, step: int, tree: Any,
                    meta: Optional[dict] = None) -> Path:
    """Synchronous atomic save of a tree of tensors / arrays.

    ``meta`` (optional, JSON-serializable) rides inside the manifest —
    schema versions, config fingerprints, anything a reader must check
    before trusting the leaves (``checkpoint_meta`` reads it back without
    touching the arrays)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    for stale in root.glob("*.tmp-*"):
        shutil.rmtree(stale, ignore_errors=True)

    final = root / f"step_{step:09d}"
    tmp = root / f"step_{step:09d}.tmp-{os.getpid()}_{time.time_ns()}"
    tmp.mkdir()

    paths, leaves = _flatten_with_paths(tree)
    manifest = {"step": step, "leaves": []}
    if meta is not None:
        manifest["meta"] = meta
    for i, (path, leaf) in enumerate(zip(paths, leaves)):
        arr = to_host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append({
            "path": path, "file": fname, "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
        })
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    (root / "latest.tmp").write_text(str(step))
    os.rename(root / "latest.tmp", root / "latest")
    log.info("saved checkpoint step=%d (%d leaves)", step, len(leaves))
    return final


def latest_step(root: str | Path) -> Optional[int]:
    root = Path(root)
    marker = root / "latest"
    if marker.exists():
        s = int(marker.read_text())
        if (root / f"step_{s:09d}" / "manifest.json").exists():
            return s
    steps = sorted(int(p.name.split("_")[1]) for p in root.glob("step_*")
                   if p.is_dir() and (p / "manifest.json").exists())
    return steps[-1] if steps else None


def _step_or_latest(root: Path, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    return step


def _manifest(root: Path, step: int) -> dict:
    return json.loads((root / f"step_{step:09d}" /
                       "manifest.json").read_text())


def _verified_leaf(d: Path, e: dict, step: int, verify: bool) -> np.ndarray:
    arr = np.load(d / e["file"])
    if verify:
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
        if crc != e["crc32"]:
            raise IOError(
                f"checksum mismatch for {e['path']} at step {step}")
    return arr


def load_checkpoint(root: str | Path, tree_like: Any,
                    step: Optional[int] = None, *, device=None,
                    verify: bool = True) -> tuple[Any, int]:
    """Restore into the structure of ``tree_like``: a tensor leaf comes
    back as a tensor on ``device`` (``None``: that leaf's device), a numpy
    leaf as a numpy array.  Shapes and dtypes must match."""
    root = Path(root)
    step = _step_or_latest(root, step)
    d = root / f"step_{step:09d}"
    by_path = {e["path"]: e for e in _manifest(root, step)["leaves"]}
    paths, leaves = _flatten_with_paths(tree_like)
    out = []
    for path, ref in zip(paths, leaves):
        arr = _verified_leaf(d, by_path[path], step, verify)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"shape mismatch {path}: ckpt {arr.shape} vs "
                f"{tuple(ref.shape)}")
        if str(arr.dtype) != str(_numpy_dtype(ref)):
            # a wrong-dtype leaf would otherwise restore silently (same
            # shape, different bits)
            raise ValueError(
                f"dtype mismatch {path}: ckpt {arr.dtype} vs "
                f"{_numpy_dtype(ref)}")
        if torch.is_tensor(ref):
            out.append(torch.from_numpy(arr).to(
                ref.device if device is None else device))
        else:
            out.append(arr)
    return _unflatten(tree_like, out), step


def checkpoint_meta(root: str | Path,
                    step: Optional[int] = None) -> Optional[dict]:
    """The manifest's ``meta`` dict (None when absent) without loading
    any leaf — how resuming services validate schema/config fingerprints
    before paying for the array restore."""
    root = Path(root)
    return _manifest(root, _step_or_latest(root, step)).get("meta")


def load_checkpoint_flat(root: str | Path, step: Optional[int] = None, *,
                         verify: bool = True) -> tuple[dict, int]:
    """Manifest-driven restore: ``{path: np.ndarray}`` with no
    ``tree_like`` (what lets a resumed run restore a stage whose shapes it
    cannot know yet, e.g. top-K lists widened before the crash).  CRC
    verification as in :func:`load_checkpoint`."""
    root = Path(root)
    step = _step_or_latest(root, step)
    d = root / f"step_{step:09d}"
    return {e["path"]: _verified_leaf(d, e, step, verify)
            for e in _manifest(root, step)["leaves"]}, step


class CheckpointManager:
    """Async keep-N manager around save/load."""

    def __init__(self, root: str | Path, keep_n: int = 3):
        self.root = Path(root)
        self.keep_n = keep_n
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any, meta: Optional[dict] = None):
        self.wait()
        paths, leaves = _flatten_with_paths(tree)
        host_tree = _unflatten(tree, [to_host(v) for v in leaves])

        def work():
            try:
                save_checkpoint(self.root, step, host_tree, meta=meta)
                self._gc()
            except BaseException as e:   # noqa: BLE001 — surfaced in wait()
                self._error = e

        self._worker = threading.Thread(target=work, daemon=True)
        self._worker.start()

    def wait(self):
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, meta: Optional[dict] = None):
        self.wait()
        save_checkpoint(self.root, step, tree, meta=meta)
        self._gc()

    def restore(self, tree_like: Any, step: Optional[int] = None,
                device=None):
        self.wait()
        return load_checkpoint(self.root, tree_like, step, device=device)

    def restore_flat(self, step: Optional[int] = None):
        """Manifest-driven ``{path: array}`` restore (no ``tree_like``)."""
        self.wait()
        return load_checkpoint_flat(self.root, step)

    def step_dir(self, step: int) -> Path:
        return self.root / f"step_{step:09d}"

    def available_steps(self) -> list:
        """Ascending steps with a manifest on disk (corrupt leaves are only
        detected at restore time — callers fall back step by step)."""
        return sorted(int(p.name.split("_")[1])
                      for p in self.root.glob("step_*")
                      if p.is_dir() and (p / "manifest.json").exists())

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.root.glob("step_*") if p.is_dir())
        for s in steps[:-self.keep_n]:
            shutil.rmtree(self.root / f"step_{s:09d}", ignore_errors=True)
