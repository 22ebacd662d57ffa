"""Atomic, async, bounded checkpoints in ``repro``'s on-disk format.

The counterpart of ``repro.checkpoint.ckpt``, without ``jax`` or
``ml_dtypes``: a checkpoint written by either package restores in the
other, bit for bit.  A checkpoint ``<dir>/step_<step:010d>/`` holds one
``.npy`` file per leaf (``arr_<i:05d>.npy``, in ``jax.tree`` leaf order)
and a ``manifest.json`` of ``{"path", "file", "shape", "dtype"}`` records.
A leaf's identity is its path string, built as ``jax``'s
``tree_flatten_with_path`` prints it: ``['params']/['embed']/['tok']``
for dict keys, ``[0]`` for list and tuple positions, joined by ``/``.
bfloat16 leaves are stored as their raw uint16 bits (numpy has no
bfloat16) under the dtype name ``bfloat16`` and viewed back as
``torch.bfloat16``.

  * **atomic**: written to ``<dir>/tmp.<step>`` then renamed;
  * **async**: ``CheckpointManager.save_async`` copies every leaf to host
    memory at once (a real copy: the port's optimizer updates the train
    state in place) and writes the copy in a background thread;
  * **bounded**: the manager keeps the newest ``keep`` checkpoints.

``restore(..., like)`` gives each leaf the dtype and device of the
matching leaf of ``like`` (a tensor, or a numpy array for a numpy leaf),
and raises ``ValueError`` where a file's shape is not that leaf's (a
checkpoint of another config in the same directory).  A DTensor leaf
(sharded training) is saved whole (``full_tensor()``): a checkpoint never
holds one rank's shard, so it restores onto any mesh.  ``restore(...,
shardings=)`` places each leaf on a mesh (``repro``'s elastic restart onto
another mesh): a tree of ``parallel.sharding.NamedSharding`` on a live
``DeviceMesh`` (``launch.steps.out_shardings_for`` of an abstract state),
each leaf placed at its placements by ``parallel.sharding.place``; without
it a DTensor leaf of ``like`` gives its own mesh and placements.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.params import tree_flatten, tree_unflatten
from repro_torch.parallel.sharding import place


def _paths(t, prefix: str, out: list) -> None:
    if isinstance(t, dict):
        for k in sorted(t):
            _paths(t[k], f"{prefix}[{k!r}]/", out)
    elif isinstance(t, (list, tuple)):
        for i, c in enumerate(t):
            _paths(c, f"{prefix}[{i}]/", out)
    elif t is not None:
        out.append(prefix[:-1])


def _flatten_with_paths(tree):
    """``(paths, leaves, treedef)`` in ``jax.tree`` order, each path the
    string ``repro.checkpoint`` writes for the leaf."""
    leaves, treedef = tree_flatten(tree)
    paths: list[str] = []
    _paths(tree, "", paths)
    return paths, leaves, treedef


def _to_host(leaf) -> tuple[np.ndarray, str | None]:
    """A host copy of ``leaf`` as numpy, and its logical dtype where the
    array's differs (a bf16 tensor: its uint16 bits, ``"bfloat16"``)."""
    if torch.is_tensor(leaf):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    return np.array(leaf), None


def _host_tree(tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [_HostLeaf(*_to_host(x)) for x in leaves])


class _HostLeaf:
    """A leaf copied to the host: its numpy array and its logical dtype
    (``bfloat16`` for bits held as uint16, else the array's own)."""

    def __init__(self, arr: np.ndarray, dtype: str | None):
        self.arr, self.dtype = arr, dtype or str(arr.dtype)


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Write checkpoint atomically; returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    paths, leaves, _ = _flatten_with_paths(tree)
    manifest = {"step": step, "arrays": []}
    for i, (p, leaf) in enumerate(zip(paths, leaves)):
        if not isinstance(leaf, _HostLeaf):
            leaf = _HostLeaf(*_to_host(leaf))
        fname = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), leaf.arr, allow_pickle=False)
        manifest["arrays"].append(
            {"path": p, "file": fname, "shape": list(leaf.arr.shape),
             "dtype": leaf.dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_")
    ]
    return max(steps) if steps else None


def _load(path: str, rec: dict, like):
    arr = np.load(os.path.join(path, rec["file"]), allow_pickle=False)
    if tuple(arr.shape) != tuple(rec["shape"]):
        raise ValueError(f"{rec['path']}: file of shape {arr.shape}, "
                         f"manifest {rec['shape']}")
    if (torch.is_tensor(like) or isinstance(like, np.ndarray)) \
            and tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{rec['path']}: checkpoint leaf of shape "
                         f"{tuple(arr.shape)}, the state's leaf "
                         f"{tuple(like.shape)} (another config's checkpoint?)")
    if torch.is_tensor(like):
        if "bfloat16" in rec["dtype"] and arr.dtype == np.uint16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device=like.device, dtype=like.dtype)
    if "bfloat16" in rec["dtype"]:
        raise TypeError(f"{rec['path']}: a bfloat16 leaf restores into a "
                        f"tensor only, not {type(like).__name__}")
    return arr.astype(getattr(like, "dtype", arr.dtype))


def _place(t: torch.Tensor, like, shd):
    """``t`` (the whole leaf) on the mesh of ``shd`` (a ``NamedSharding``),
    or of ``like`` where it is a DTensor; ``t`` itself otherwise."""
    if shd is not None:
        return place(t, shd.mesh, shd.placements)
    if isinstance(like, DTensor):
        return place(t, like.device_mesh, like.placements)
    return t


def restore(ckpt_dir: str, step: int, like: Any, shardings=None) -> Any:
    """Restore into the structure of ``like``: each leaf found by its path
    string, given the dtype (and, for a tensor, the device) of ``like``'s
    leaf, and placed by ``shardings`` (a tree of ``NamedSharding`` or None
    of ``like``'s structure) or by ``like``'s DTensor leaf."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {a["path"]: a for a in manifest["arrays"]}
    paths, leaves, treedef = _flatten_with_paths(like)
    shds = [None] * len(leaves) if shardings is None else \
        tree_flatten(shardings, is_leaf=lambda x: x is None
                     or not isinstance(x, (dict, list, tuple)))[0]
    if len(shds) != len(leaves):
        raise ValueError(f"{len(shds)} shardings for {len(leaves)} leaves")
    out = []
    for p, leaf, shd in zip(paths, leaves, shds):
        x = _load(path, by_path[p], leaf)
        out.append(_place(x, leaf, shd) if torch.is_tensor(x) else x)
    return tree_unflatten(treedef, out)


class CheckpointManager:
    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save_async(self, step: int, tree: Any) -> None:
        # copy to host now (the caller goes on to update the state in
        # place), write in the background
        host_tree = _host_tree(tree)
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, host_tree), daemon=True
        )
        self._thread.start()

    def _write(self, step, host_tree):
        save(self.dir, step, host_tree)
        self._gc()

    def save(self, step: int, tree: Any) -> str:
        p = save(self.dir, step, tree)
        self._gc()
        return p

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.dir)
            if d.startswith("step_")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)
