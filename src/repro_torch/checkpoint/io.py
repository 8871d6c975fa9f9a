"""Pytree checkpointing for torch tensors: npz arrays + json tree structure
(port of ``repro/checkpoint/io.py``).

Saves/restores nested dict/list/tuple pytrees of torch tensors, numpy
arrays and scalars — the SPEC-RL rollout cache (``core/cache.py``) and the
slot server's exact serving state (DESIGN.md §10 kill-and-resume).  The
file format is JAX's: ``<path>.npz`` holds one array per leaf under its
``/key/#index`` path and ``<path>.json`` the tree structure plus metadata,
so a float32 or integer tree written by either package loads in the other.

bfloat16.  numpy has no bfloat16 and ``Tensor.numpy()`` refuses it, while
the card's caches are bf16.  Such a leaf is stored as its raw 16-bit words
(a ``uint16`` array) and its json leaf carries ``"dtype": "bfloat16"``;
loading views the words back as bf16, so the leaf round-trips bit for bit.
(JAX's loader ignores the tag and returns the words.)  Leaves load as CPU
torch tensors; the caller moves them where it needs them.

Crash safety (§10): every file is written to a temp name in the same
directory and moved into place with ``os.replace`` — a reader never sees a
half-written checkpoint.  A checkpoint directory additionally keeps a
``latest`` pointer file, updated *last* (``write_latest``), so a crash
between "new checkpoint fully on disk" and "pointer moved" leaves the
previous checkpoint live — the pointer flip is the commit point.
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cache import CacheEntry, RolloutCache

LATEST = "latest"                    # pointer file name inside a ckpt dir
_BF16 = "bfloat16"


def _leaf_array(leaf) -> np.ndarray:
    """A leaf as the numpy array the npz stores (bf16 as its raw words)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix="", out=None):
    out = out if out is not None else {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/#{i}", out)
    else:
        out[prefix] = _leaf_array(tree)
    return out


def _structure(tree):
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _structure(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"__kind__": "list" if isinstance(tree, list) else "tuple",
                "items": [_structure(v) for v in tree]}
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
        return {"__kind__": "leaf", "dtype": _BF16}
    return {"__kind__": "leaf"}


def _rebuild(struct, flat, prefix="", leaf=None):
    kind = struct["__kind__"]
    if kind == "dict":
        return {k: _rebuild(v, flat, f"{prefix}/{k}", leaf)
                for k, v in struct["items"].items()}
    if kind in ("list", "tuple"):
        seq = [_rebuild(v, flat, f"{prefix}/#{i}", leaf)
               for i, v in enumerate(struct["items"])]
        return seq if kind == "list" else tuple(seq)
    arr = flat[prefix]                      # read from the file here
    if not arr.flags.writeable:
        arr = arr.copy()                    # own, writable memory
    if struct.get("dtype") == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t if leaf is None else leaf(prefix, t)


# ------------------------------------------------------------ atomic writes

def _fsync_dir(path: str) -> None:
    """fsync the directory holding ``path``: ``os.replace`` makes the new
    name visible, but the rename itself is only durable once the parent
    directory's entry is flushed (POSIX).  Best-effort on filesystems that
    refuse O_RDONLY directory handles."""
    d = os.path.dirname(path) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write_npz(path: str, blob: Dict[str, np.ndarray]) -> None:
    """np.savez to ``path`` via temp-file + os.replace (same filesystem)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path)


def _atomic_write_text(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path)


def write_latest(ckpt_dir: str, name: str) -> None:
    """Flip the ``latest`` pointer to checkpoint ``name`` — the commit
    point of a checkpoint: call it only after every file of ``name`` is
    fully on disk.  Atomic, so a crash leaves either pointer intact."""
    os.makedirs(ckpt_dir, exist_ok=True)
    _atomic_write_text(os.path.join(ckpt_dir, LATEST), name + "\n")


def read_latest(ckpt_dir: str) -> Optional[str]:
    """Name of the last committed checkpoint in ``ckpt_dir`` (None if no
    checkpoint was ever committed, or if the pointer names a checkpoint
    whose files are not on disk: a reader falls back to "no checkpoint"
    rather than a name that raises downstream)."""
    p = os.path.join(ckpt_dir, LATEST)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        name = f.read().strip()
    if not name:
        return None
    try:
        entries = os.listdir(ckpt_dir)
    except OSError:
        return None
    if not any(e == name or e.startswith(name + ".") for e in entries):
        return None
    return name


# ---------------------------------------------------------------- pytrees

def save_pytree(path: str, tree, metadata: Optional[Dict[str, Any]] = None) -> None:
    """Write ``path``.npz + ``path``.json, each atomically.

    The json (structure + metadata) is written LAST — loaders open it
    first, so a crash mid-save leaves either the complete previous pair or
    a dangling .npz that no json references yet."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    _atomic_write_npz(path + ".npz", flat)
    _atomic_write_text(path + ".json", json.dumps(
        {"structure": _structure(tree), "metadata": metadata or {}}))


def load_pytree(path: str, leaf: Optional[Callable[[str, torch.Tensor],
                                                   torch.Tensor]] = None
                ) -> Tuple[Any, Dict[str, Any]]:
    """The tree (leaves as CPU torch tensors) and its metadata.  The leaves
    are read one at a time, and ``leaf(path, tensor)``, when given, turns
    each into what the tree keeps as it is read (``path`` its ``/key/#index``
    path: ``distributed/mesh.py:cut_on_read`` keeps a rank's slice)."""
    with open(path + ".json") as f:
        meta = json.load(f)
    with np.load(path + ".npz") as z:
        tree = _rebuild(meta["structure"], z, leaf=leaf)
    return tree, meta["metadata"]


# ----------------------------------------------------------- rollout cache

def save_rollout_cache(path: str, cache: RolloutCache) -> None:
    """Persist a RolloutCache *losslessly*: entries, LRU recency order,
    sibling-group registration, eviction bound and hit/miss counters all
    round-trip (JAX's file layout)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = {}
    index = {}
    for pid, q in cache._store.items():          # iteration order = LRU order
        index[str(pid)] = len(q)
        for j, e in enumerate(q):
            blob[f"t/{pid}/{j}"] = e.tokens
            blob[f"l/{pid}/{j}"] = e.logprobs
            blob[f"m/{pid}/{j}"] = np.array([e.step, int(e.ends_with_eos)])
    meta = {
        "index": index,
        "order": [int(pid) for pid in cache._store],   # LRU, oldest first
        "history": cache.history,
        "max_prompts": cache.max_prompts,
        "group_size": cache.group_size,
        "group_of": {str(pid): int(gid)
                     for pid, gid in cache._group_of.items()},
        "counters": {"puts": cache.puts, "hits": cache.hits,
                     "misses": cache.misses, "evictions": cache.evictions},
    }
    _atomic_write_npz(path + ".cache.npz", blob)
    _atomic_write_text(path + ".cache.json", json.dumps(meta))


def load_rollout_cache(path: str) -> RolloutCache:
    with open(path + ".cache.json") as f:
        meta = json.load(f)
    cache = RolloutCache(history=meta["history"],
                         max_prompts=meta.get("max_prompts"),
                         group_size=meta.get("group_size", 0))
    with np.load(path + ".cache.npz") as z:
        # rebuild the store directly (not via put(): that would bump the
        # puts counter, re-derive groups and re-run eviction) in saved LRU
        # order — insertion order of the OrderedDict IS its recency order
        order = meta.get("order") or [int(p) for p in meta["index"]]
        for pid in order:
            n = meta["index"][str(pid)]
            q = deque(maxlen=cache.history)
            for j in range(n):
                step, eos = z[f"m/{pid}/{j}"]
                q.append(CacheEntry(z[f"t/{pid}/{j}"], z[f"l/{pid}/{j}"],
                                    int(step), bool(eos)))
            cache._store[pid] = q
    for pid_s, gid in meta.get("group_of", {}).items():
        pid = int(pid_s)
        cache._group_of[pid] = int(gid)
        cache._groups.setdefault(int(gid), set()).add(pid)
    for k, v in meta.get("counters", {}).items():
        setattr(cache, k, int(v))
    return cache


# ---------------------------------------------- §10 serving state snapshots

def save_server_state(path: str, server,
                      metadata: Optional[Dict[str, Any]] = None) -> None:
    """Snapshot a ``SlotEngine`` / ``PagedSlotEngine`` for exact
    kill-and-resume: ``server.state_dict()`` is an all-array pytree, which
    the atomic pytree writer carries (bf16 caches as their raw words)."""
    save_pytree(path, server.state_dict(),
                metadata={**(metadata or {}), "kind": "server_state"})


def load_server_state(path: str, server) -> Dict[str, Any]:
    """Restore ``server`` in place from a ``save_server_state`` snapshot
    into a freshly built engine of the same shapes and model; returns the
    snapshot's metadata."""
    tree, meta = load_pytree(path)
    server.load_state_dict(tree)
    return meta
