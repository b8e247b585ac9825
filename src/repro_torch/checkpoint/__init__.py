"""Checkpointing: npz-sharded tree save/restore and the stage backups.

The port of ``repro.checkpoint``, in its on-disk format:
``<dir>/<name>.meta.json`` (leaf count, dtype names, shard indices) and
``<name>.<i>.npz`` shards of at most ``SHARD_BYTES``, leaf ``i`` stored as
``leaf_<i>`` in ``jax.tree_util`` order (:func:`repro_torch.optim.tree_leaves`:
dict keys sorted, sequences in order, so an ``AdamWState`` is its step, then
``m``, then ``v``).  bfloat16 and fp8 leaves are stored as their raw bits
(uint16 / uint8) beside their dtype name, as ``repro`` stores them, so a
checkpoint written by either package restores in the other.  ``repro``'s
meta also names its JAX tree definition, which its ``restore`` does not
read; the port writes the tree's structure there instead.

``StageBackupStore`` is the in-memory stage replication of the
fault-tolerance runtime (topology-driven backups, paper §3.4): here the
snapshots are in host memory, standing in for the backup node.  A stage's
snapshot of card tensors lands in one pinned host buffer, allocated when
the stage's layout (its leaves' shapes and dtypes) is first backed up and
reused by every later backup of that layout.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.optim import tree_leaves

SHARD_BYTES = 1 << 30

# numpy holds no bfloat16 / fp8: their raw bits, by repro's dtype names
_BITS = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
         torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8),
         torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8)}
_BY_NAME = {name: (dt, bits) for dt, (name, bits, _) in _BITS.items()}


def _to_numpy(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype in _BITS:
        name, bits, np_bits = _BITS[t.dtype]
        return t.view(bits).numpy().view(np_bits), name
    arr = t.numpy()
    return arr, arr.dtype.name


def _from_numpy(arr: np.ndarray, dtype_name: str | None) -> torch.Tensor:
    if dtype_name in _BY_NAME:
        dt, bits = _BY_NAME[dtype_name]
        raw = np.ascontiguousarray(arr).view(np.int16 if bits == torch.int16 else np.uint8)
        return torch.from_numpy(raw.copy()).view(dt)
    return torch.from_numpy(np.array(arr, copy=True))


def _structure(tree) -> str:
    """The tree's nesting, leaves as ``*`` (the meta's ``treedef`` entry)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_structure(v) for v in tree)
        return f"{type(tree).__name__}({inner})"
    return "*"


def save(path: str, name: str, tree) -> None:
    os.makedirs(path, exist_ok=True)
    leaves = tree_leaves(tree)
    meta = {"treedef": _structure(tree), "n_leaves": len(leaves), "shards": [],
            "dtypes": []}
    shard, size, idx = {}, 0, 0
    for i, leaf in enumerate(leaves):
        arr, dtype_name = _to_numpy(torch.as_tensor(leaf))
        meta["dtypes"].append(dtype_name)
        shard[f"leaf_{i}"] = arr
        size += arr.nbytes
        if size >= SHARD_BYTES:
            np.savez(os.path.join(path, f"{name}.{idx}.npz"), **shard)
            meta["shards"].append(idx)
            shard, size, idx = {}, 0, idx + 1
    if shard:
        np.savez(os.path.join(path, f"{name}.{idx}.npz"), **shard)
        meta["shards"].append(idx)
    with open(os.path.join(path, f"{name}.meta.json"), "w") as f:
        json.dump(meta, f)


def restore(path: str, name: str, like):
    """Restore into the structure, dtypes and devices of ``like``."""
    with open(os.path.join(path, f"{name}.meta.json")) as f:
        meta = json.load(f)
    arrays = {}
    for idx in meta["shards"]:
        with np.load(os.path.join(path, f"{name}.{idx}.npz")) as z:
            arrays.update({k: z[k] for k in z.files})
    leaves_like = tree_leaves(like)
    if len(leaves_like) != meta["n_leaves"]:
        raise ValueError(f"checkpoint {name} holds {meta['n_leaves']} leaves, the "
                         f"tree {len(leaves_like)}")
    dtypes = meta.get("dtypes") or [None] * len(leaves_like)
    it = iter(range(len(leaves_like)))

    def leaf(ref):
        i = next(it)
        t = _from_numpy(arrays[f"leaf_{i}"], dtypes[i])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {tuple(t.shape)} != "
                             f"{tuple(ref.shape)}")
        return t.to(dtype=ref.dtype, device=ref.device)

    return _map_in_order(leaf, like)


def _map_in_order(fn, tree):
    """``tree_map`` visiting the leaves in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        done = {k: _map_in_order(fn, tree[k]) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        vals = [_map_in_order(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return fn(tree)


# ---------------------------------------------------------------------------
# Stage replication (fault tolerance)
# ---------------------------------------------------------------------------


def _layout(leaves) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in leaves)


class StageBackupStore:
    """In-memory topology-driven replica store: stage -> snapshot on the
    backup node (here: host memory).

    ``meta`` rides along with each snapshot (the canonical period range the
    rows cover, the step they were taken at) so a replay session can
    scatter a restored stage back into its period rows after a plan swap.
    ``restore`` returns the host snapshot itself (the store's buffers, which
    the next backup of the stage overwrites).
    """

    _ALIGN = 64

    def __init__(self):
        self._store: dict[int, object] = {}
        self._meta: dict[int, dict] = {}
        self._buffers: dict[int, tuple] = {}      # stage -> (layout, host views)
        self.bytes_transferred = 0

    def _host_views(self, stage: int, leaves) -> list:
        layout = _layout(leaves)
        held = self._buffers.get(stage)
        if held is not None and held[0] == layout:
            return held[1]
        self._buffers.pop(stage, None)            # free the old layout's buffer first
        pin = any(t.device.type == "cuda" for t in leaves)
        sizes = [t.numel() * t.element_size() for t in leaves]
        offs, total = [], 0
        for n in sizes:
            offs.append(total)
            total += -(-n // self._ALIGN) * self._ALIGN
        buf = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=pin)
        views = [buf[o:o + n].view(t.dtype).view(t.shape)
                 for o, n, t in zip(offs, sizes, leaves)]
        self._buffers[stage] = (layout, views)
        return views

    def backup(self, stage: int, params, meta: dict | None = None) -> None:
        leaves = tree_leaves(params)
        views = self._host_views(stage, leaves)
        for dst, src in zip(views, leaves):
            dst.copy_(src.detach(), non_blocking=src.device.type == "cuda")
        if any(t.device.type == "cuda" for t in leaves):
            torch.cuda.current_stream(leaves[0].device).synchronize()
        it = iter(views)
        self._store[stage] = _map_in_order(lambda _: next(it), params)
        self._meta[stage] = dict(meta or {})
        self.bytes_transferred += sum(v.numel() * v.element_size() for v in views)

    def restore(self, stage: int):
        if stage not in self._store:
            raise KeyError(f"no backup for stage {stage}")
        return self._store[stage]

    def meta(self, stage: int) -> dict:
        if stage not in self._store:
            raise KeyError(f"no backup for stage {stage}")
        return dict(self._meta.get(stage, {}))

    def has(self, stage: int) -> bool:
        return stage in self._store

    def drop(self, stage: int) -> None:
        self._store.pop(stage, None)
        self._meta.pop(stage, None)
        self._buffers.pop(stage, None)
