"""Block allocator for the paged KV cache (DESIGN.md §13); own copy
of ``repro/serving/block_table.py``, which imports no JAX.

The paged layout replaces each row's dense ``(S, D)`` cache stripe with a
pool of fixed-size KV blocks plus a per-row *block table* mapping logical
block index → physical block id.  This module owns the host-side pool
bookkeeping: a LIFO free list, per-block refcounts, and the copy-on-write
(CoW) primitives the slot engine uses to share one physical prompt copy
across the G sibling rollouts of a GRPO group.

Conventions:

* **Block 0 is the sink.**  It is never allocated and its refcount is
  pinned; every unmapped block-table entry points at it.  Clamped writes
  from idle / finished rows and the dead-split DMA redirect in the decode
  kernel both land there, so recycled blocks can never be corrupted by a
  stale table.  Sink contents are garbage by construction and always masked
  (the dense ``pos`` array still gates attention with ``pos == -1``).

* **Refcounts implement CoW.**  ``share`` bumps a block's refcount (a
  follower mapping its group leader's prompt blocks); ``fork`` is the
  write-path dual — called when a row is about to write into a block it
  does not own exclusively, it allocates a fresh block, drops one ref on
  the shared one, and reports the (old, new) pair so the engine can issue
  the device copy.

* **Conservation.**  ``free + in_use + 1 (sink) == num_blocks`` always;
  ``check()`` asserts it and the hypothesis suite drives it.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class PoolExhausted(RuntimeError):
    """Raised by ``alloc`` when the free list cannot cover a request."""


class BlockAllocator:
    """Free-list + refcount bookkeeping for one physical KV block pool.

    Pure host-side numpy/python — the device never sees this object, only
    the int32 block tables it hands out.
    """

    SINK = 0  # reserved garbage block; never allocated, never freed

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(f"pool needs >= 2 blocks (1 sink), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # LIFO free list over blocks 1..num_blocks-1 (0 is the sink)
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self.refcount = np.zeros(self.num_blocks, dtype=np.int32)
        self.refcount[self.SINK] = 1  # pinned
        # §11 counters (monotonic except blocks_in_use / peak gauge pair)
        self.cow_forks = 0
        self.alloc_failures = 0
        self.shared_prompt_bytes_saved = 0
        self.peak_blocks_in_use = 0

    # ------------------------------------------------------------- queries

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - 1 - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def check(self) -> None:
        """Assert the conservation + refcount invariants."""
        assert self.blocks_in_use + self.free_blocks + 1 == self.num_blocks
        assert self.refcount[self.SINK] >= 1
        live = np.flatnonzero(self.refcount[1:]) + 1
        assert len(live) == self.blocks_in_use, (live, self.blocks_in_use)
        assert not set(live.tolist()) & set(self._free)

    # ---------------------------------------------------------- lifecycle

    def alloc(self, n: int = 1) -> List[int]:
        """Pop ``n`` fresh blocks (refcount 1 each); all-or-nothing."""
        if n > len(self._free):
            self.alloc_failures += 1
            raise PoolExhausted(
                f"need {n} blocks, {len(self._free)} free of {self.num_blocks}")
        out = [self._free.pop() for _ in range(n)]
        self.refcount[out] += 1
        self.peak_blocks_in_use = max(self.peak_blocks_in_use, self.blocks_in_use)
        return out

    def share(self, block: int) -> int:
        """Add a reference to an allocated block (CoW prompt sharing)."""
        assert block != self.SINK and self.refcount[block] > 0, block
        self.refcount[block] += 1
        return block

    def free(self, block: int) -> None:
        """Drop one reference; the block returns to the pool at zero."""
        if block == self.SINK:
            return
        assert self.refcount[block] > 0, f"double free of block {block}"
        self.refcount[block] -= 1
        if self.refcount[block] == 0:
            self._free.append(block)

    def free_table(self, table) -> None:
        """Drop one reference per non-sink entry of a row's block table."""
        for b in np.asarray(table).reshape(-1).tolist():
            self.free(int(b))

    def fork(self, block: int) -> int:
        """CoW fork: exclusive copy target for a shared ``block``.

        Allocates a fresh block, transfers this row's reference off the
        shared one, and returns the new id.  The caller owns issuing the
        device-side ``pool[new] = pool[old]`` copy.  Raises ``PoolExhausted``
        (allocator state unchanged) when the pool is dry.
        """
        assert block != self.SINK and self.refcount[block] > 1, (
            f"fork of exclusively-owned block {block}")
        new = self.alloc(1)[0]
        self.free(block)
        self.cow_forks += 1
        return new

    # ------------------------------------------------------------- metrics

    def stats(self) -> Dict[str, int]:
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "blocks_in_use": self.blocks_in_use,
            "peak_blocks_in_use": self.peak_blocks_in_use,
            "free_blocks": self.free_blocks,
            "cow_forks": self.cow_forks,
            "alloc_failures": self.alloc_failures,
            "shared_prompt_bytes_saved": self.shared_prompt_bytes_saved,
        }

    # ------------------------------------------------- §10 kill-and-resume

    def state_dict(self) -> Dict[str, object]:
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "free": np.asarray(self._free, dtype=np.int32),
            "refcount": self.refcount.copy(),
            "counters": np.asarray(
                [self.cow_forks, self.alloc_failures,
                 self.shared_prompt_bytes_saved, self.peak_blocks_in_use],
                dtype=np.int64),
        }

    def load_state_dict(self, state: Dict[str, object]) -> None:
        assert int(state["num_blocks"]) == self.num_blocks
        assert int(state["block_size"]) == self.block_size
        self._free = [int(b) for b in np.asarray(state["free"]).tolist()]
        self.refcount = np.asarray(state["refcount"], dtype=np.int32).copy()
        c = np.asarray(state["counters"])
        self.cow_forks = int(c[0])
        self.alloc_failures = int(c[1])
        self.shared_prompt_bytes_saved = int(c[2])
        self.peak_blocks_in_use = int(c[3])
        self.check()


def identity_table(batch: int, blocks_per_row: int,
                   offset: int = 0) -> np.ndarray:
    """Static row-major table: row b owns blocks [b*nb, (b+1)*nb).

    The pure-functional paths (``generate``, one-pass resume, drafted
    fixed-batch decode) have no allocator — each row simply owns a
    contiguous stripe of the pool, which exercises the full paged
    read/write machinery with zero host bookkeeping.  ``offset`` shifts
    past reserved blocks (the serving engine's sink).
    """
    return (offset + np.arange(batch * blocks_per_row, dtype=np.int32)
            .reshape(batch, blocks_per_row))
