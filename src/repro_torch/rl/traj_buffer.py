"""Bounded, watermarked trajectory buffer (DESIGN.md §12; port of
``repro/rl/traj_buffer.py`` over the port's ``RolloutBatch`` and
``PromptBatch``, whose fields are numpy arrays).

The seam between the rollout service (producer) and the async trainer
(consumer).  Capacity is hard-bounded with two levels of backpressure:

* at the **high watermark** the producer throttles — ``should_throttle``
  turns true and the service skips its tick (counted, never silent);
* at **capacity** a forced ``put`` sheds the *oldest* trajectory — stale
  data is the cheapest to lose, because anything still in the buffer can
  be re-verified, and anything shed is simply regenerated fresher.

Every trajectory is tagged with the policy version it was sampled under
(the staleness bookkeeping the consumer's K-window runs on) and a
per-producer sequence number; version tags must be monotone per producer
(asserted — a producer that time-travels is a bug, not a load condition).

Counters reconcile by construction (property-tested):

    submitted == consumed + shed + occupancy

``state_dict``/``load_state_dict`` round-trip the full buffer — entries,
order, tags and counters — through the checkpoint/io all-array pytree
writer, so kill-and-resume of the async pair restores the exact seam
state (§10 discipline).  The port's ``RolloutBatch`` also carries ``n``,
each row's verified prefix length; it rides the state when present.
"""
from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Optional

import numpy as np

from repro_torch.core.spec_rollout import RolloutBatch
from repro_torch.data.dataset import PromptBatch
from repro_torch.obs import get_registry


def _enc(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-8"), np.uint8).copy()


def _dec(arr) -> str:
    return bytes(np.asarray(arr, np.uint8).tolist()).decode("utf-8")


@dataclass
class Trajectory:
    """One collected batch: the prompts it came from, the rollout, its
    rewards, and the provenance tags the async consumer schedules by."""
    batch: PromptBatch
    rb: RolloutBatch
    rewards: np.ndarray
    version: int                  # policy version it was sampled under
    producer: int = 0
    seq: int = 0                  # buffer-assigned, monotone

    # -------------------------------------------------- exact serialization

    def to_state(self) -> Dict:
        b, rb = self.batch, self.rb
        st = {
            "tags": {"version": np.int64(self.version),
                     "producer": np.int64(self.producer),
                     "seq": np.int64(self.seq)},
            "rewards": np.asarray(self.rewards, np.float32),
            "batch": {"tokens": np.asarray(b.tokens, np.int32),
                      "mask": np.asarray(b.mask, bool),
                      "cache_keys": np.asarray(b.cache_keys, np.int32),
                      "answers": np.asarray(b.answers, np.int32),
                      "problem_ids": np.asarray(b.problem_ids, np.int32),
                      "epoch": np.int64(b.epoch)},
            "rb": {"prompt": np.asarray(rb.prompt, np.int32),
                   "prompt_mask": np.asarray(rb.prompt_mask, bool),
                   "response": np.asarray(rb.response, np.int32),
                   "response_mask": np.asarray(rb.response_mask, bool),
                   "behaviour_logprobs":
                       np.asarray(rb.behaviour_logprobs, np.float32),
                   "length": np.asarray(rb.length, np.int32),
                   # float metrics ride as encoded json (uint8 leaf): keys
                   # vary per variant and the pytree writer wants arrays
                   "metrics": _enc(json.dumps(
                       {k: float(v) for k, v in rb.metrics.items()},
                       sort_keys=True))},
        }
        if rb.n is not None:
            st["rb"]["n"] = np.asarray(rb.n, np.int32)
        return st

    @classmethod
    def from_state(cls, st: Dict) -> "Trajectory":
        b, r = st["batch"], st["rb"]
        batch = PromptBatch(
            tokens=np.asarray(b["tokens"], np.int32),
            mask=np.asarray(b["mask"], bool),
            cache_keys=[int(x) for x in np.asarray(b["cache_keys"])],
            answers=[int(x) for x in np.asarray(b["answers"])],
            problem_ids=[int(x) for x in np.asarray(b["problem_ids"])],
            epoch=int(b["epoch"]))
        rb = RolloutBatch(
            prompt=np.asarray(r["prompt"], np.int32),
            prompt_mask=np.asarray(r["prompt_mask"], bool),
            response=np.asarray(r["response"], np.int32),
            response_mask=np.asarray(r["response_mask"], bool),
            behaviour_logprobs=np.asarray(r["behaviour_logprobs"],
                                          np.float32),
            length=np.asarray(r["length"], np.int32),
            metrics=json.loads(_dec(r["metrics"])),
            n=np.asarray(r["n"], np.int32) if "n" in r else None)
        return cls(batch=batch, rb=rb,
                   rewards=np.asarray(st["rewards"], np.float32),
                   version=int(st["tags"]["version"]),
                   producer=int(st["tags"]["producer"]),
                   seq=int(st["tags"]["seq"]))


class TrajBuffer:
    """FIFO of ``Trajectory`` with watermark backpressure and shed-oldest
    overflow (all counted)."""

    def __init__(self, capacity: int = 8,
                 high_watermark: Optional[int] = None):
        assert capacity >= 1, capacity
        self.capacity = int(capacity)
        hw = capacity if high_watermark is None else int(high_watermark)
        assert 1 <= hw <= capacity, (hw, capacity)
        self.high_watermark = hw
        self._q: Deque[Trajectory] = deque()
        self.submitted = 0
        self.consumed = 0
        self.shed = 0
        self.throttled = 0
        self.occupancy_peak = 0
        self._seq = 0
        self._last_version: Dict[int, int] = {}   # per-producer monotonicity

    # ------------------------------------------------------------- queries

    def __len__(self) -> int:
        return len(self._q)

    @property
    def occupancy(self) -> int:
        return len(self._q)

    def should_throttle(self) -> bool:
        """Producer-side gate: true at/above the high watermark.  The
        caller counts the skipped tick via ``note_throttled``."""
        return len(self._q) >= self.high_watermark

    def note_throttled(self) -> None:
        self.throttled += 1
        self._emit_obs()

    # -------------------------------------------------------------- moves

    def put(self, traj: Trajectory) -> Optional[Trajectory]:
        """Append; returns the shed trajectory if capacity forced one out.

        A forced put past a full buffer sheds the OLDEST entry — the
        staleness ordering makes that the principled victim."""
        last = self._last_version.get(traj.producer)
        assert last is None or traj.version >= last, \
            f"producer {traj.producer} version went backwards: " \
            f"{last} -> {traj.version}"
        self._last_version[traj.producer] = traj.version
        shed = None
        if len(self._q) >= self.capacity:
            shed = self._q.popleft()
            self.shed += 1
        traj.seq = self._seq
        self._seq += 1
        self._q.append(traj)
        self.submitted += 1
        self.occupancy_peak = max(self.occupancy_peak, len(self._q))
        self._emit_obs()
        return shed

    def get(self) -> Optional[Trajectory]:
        """Pop the oldest trajectory (None when starved)."""
        if not self._q:
            return None
        t = self._q.popleft()
        self.consumed += 1
        self._emit_obs()
        return t

    def peek_version(self) -> Optional[int]:
        return self._q[0].version if self._q else None

    # ----------------------------------------------------------------- obs

    def _emit_obs(self) -> None:
        reg = get_registry()
        reg.set("async.buffer_occupancy", float(len(self._q)))
        reg.set("async.buffer_occupancy_peak", float(self.occupancy_peak),
                agg="max")

    def counters(self, prefix: str = "buffer_") -> Dict[str, float]:
        return {f"{prefix}submitted": float(self.submitted),
                f"{prefix}consumed": float(self.consumed),
                f"{prefix}shed": float(self.shed),
                f"{prefix}throttled": float(self.throttled),
                f"{prefix}occupancy": float(len(self._q)),
                f"{prefix}occupancy_peak": float(self.occupancy_peak)}

    def check_invariants(self) -> None:
        assert len(self._q) <= self.capacity
        assert self.submitted == self.consumed + self.shed + len(self._q), \
            self.counters()

    # -------------------------------------------- exact state (§10 resume)

    def state_dict(self) -> Dict:
        ents = {str(i): t.to_state() for i, t in enumerate(self._q)}
        prods = sorted(self._last_version)
        return {
            "entries": ents,
            "scalars": {
                "capacity": np.int64(self.capacity),
                "high_watermark": np.int64(self.high_watermark),
                "submitted": np.int64(self.submitted),
                "consumed": np.int64(self.consumed),
                "shed": np.int64(self.shed),
                "throttled": np.int64(self.throttled),
                "occupancy_peak": np.int64(self.occupancy_peak),
                "seq": np.int64(self._seq),
            },
            "producers": np.asarray(prods, np.int64).reshape(-1),
            "producer_versions": np.asarray(
                [self._last_version[p] for p in prods], np.int64).reshape(-1),
        }

    def load_state_dict(self, st: Dict) -> None:
        sc = st["scalars"]
        self.capacity = int(sc["capacity"])
        self.high_watermark = int(sc["high_watermark"])
        self.submitted = int(sc["submitted"])
        self.consumed = int(sc["consumed"])
        self.shed = int(sc["shed"])
        self.throttled = int(sc["throttled"])
        self.occupancy_peak = int(sc["occupancy_peak"])
        self._seq = int(sc["seq"])
        self._q = deque(Trajectory.from_state(st["entries"][k])
                        for k in sorted(st["entries"], key=int))
        self._last_version = {
            int(p): int(v) for p, v in zip(np.asarray(st["producers"]),
                                           np.asarray(st["producer_versions"]))}
        self.check_invariants()
