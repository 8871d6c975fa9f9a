"""Disaggregated rollout service (DESIGN.md §12; port of
``repro/serving/rollout_service.py``): the producer half of the async
rollout ↔ train seam.

``RolloutService`` continuously drives the shared ``rl.trainer.Collector``
— same dataset RNG, same key split order, same SPEC-RL cache as the
synchronous trainer — and feeds the bounded ``rl.traj_buffer.TrajBuffer``,
tagging every trajectory with the policy version it was sampled under.
Backpressure is cooperative: at the buffer's high watermark the tick is a
counted no-op (the producer throttles rather than shed).

``WeightSync`` is the versioned weight-publication channel between the
two failure domains.  The trainer publishes (model, version) through
``core.backoff.retry``; a publish that exhausts its retry budget *fails
open* — the service keeps serving the last good version while the
consumer's staleness gauge rises, and past the hard cap the async loop
walks its mode ladder (rl/async_loop.py).  ``fail_next`` is the
deterministic chaos hook the §10 fault lane uses to inject sync failures.

Weights are copied, never shared.  JAX publishes and installs its params
by reference, which is safe because a JAX array never changes.  The
port's AdamW writes each parameter in place, so a service that held the
trainer's model would sample under the consumer's newest weights while
tagging the trajectory with an older version.  Hence:

* a successful publish copies the model's parameters into the channel's
  snapshot (allocated once, then overwritten in place: the copy is the
  attempt's last act, so a failed attempt leaves the last good snapshot
  and its version untouched); ``copy=True`` keeps that snapshot on the
  host, as JAX's ``copy=True`` host-fetches its params;
* the service samples with its own ``LM``, built once on its device and
  loaded from a snapshot by ``install`` (the bootstrap copies the
  trainer's parameters directly).

A copy is exact, so K = 0 stays bit-identical to the synchronous trainer,
and at most two copies of the weights live beside the trainer's: the
published snapshot and the service's model.

The mesh: a model cut over it (``distributed/mesh.py:shard_params``) is
published shard by shard: each rank copies its own shards in place (with
``copy=True`` to the host), and the service's own model, cut as the
collector's mesh cuts it, installs them.  The service's snapshot
(``state_dict``) gathers the whole parameters to the writing rank, as the
trainer's does, and a restore installs the slices that the async pair's
loader cut onto the rank (``rl/async_loop.py``).

Failure-domain isolation: producer-side faults ride the same seeded
``FaultPlan`` as the slot engine — ``kill`` raises ``EngineKilled`` at a
tick boundary (the consumer catches, counts and restarts the producer;
the trainer never dies with it), ``stall`` makes the service idle for
``count`` ticks (fresh-trajectory starvation, which the §10 watchdog's
service-stall detector is armed against).
"""
from __future__ import annotations

import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.backoff import BackoffConfig, RetriesExhausted, retry
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.mesh import gather_params, shard_params
from repro_torch.models import model as M
from repro_torch.obs import get_registry
from repro_torch.rl.traj_buffer import TrajBuffer, Trajectory

from .faults import EngineKilled, FaultPlan


class SyncFailed(RuntimeError):
    """One failed weight-publication attempt (injected or real)."""


@torch.no_grad()
def copy_weights(dst: Mapping[str, torch.Tensor],
                 src: Mapping[str, torch.Tensor]) -> None:
    """``dst[name].copy_(src[name])`` for every name; the two must hold
    the same names."""
    if set(dst) != set(src):
        raise ValueError(f"weights differ in names: "
                         f"{sorted(set(dst) ^ set(src))[:4]}")
    for name, t in dst.items():
        t.copy_(src[name])


class WeightSync:
    """Versioned, retrying weight-publication channel.

    ``publish`` copies the model's parameters into the channel's snapshot
    through an injectable transport with exponential backoff; the service
    pulls via ``poll``.  Transport and sleep are injectable so tests and
    the deterministic async scheduler replay the exact same retry schedule
    with no wall-clock.
    """

    def __init__(self, backoff: Optional[BackoffConfig] = None,
                 transport=None, sleep=None, copy: bool = False):
        self.backoff = backoff or BackoffConfig(base=0.0, max_attempts=3)
        self._transport = transport          # callable(version, model)
        self._sleep = sleep or (lambda d: None if d == 0.0 else time.sleep(d))
        # copy=True keeps the snapshot on the host (JAX's host_fetch), so
        # the channel carries a self-contained copy; the default keeps it
        # on the model's device
        self._copy = bool(copy)
        self._snapshot: Optional[Dict[str, torch.Tensor]] = None
        self._published = None               # (version, snapshot) last good
        self.version = -1                    # last successfully published
        self.publishes = 0
        self.retries = 0
        self.failures = 0
        self._fail_next = 0

    # ---------------------------------------------------------- chaos hook

    def fail_next(self, n: int = 1) -> None:
        """Make the next ``n`` publish *attempts* raise (deterministic
        injected sync failure — the §10 chaos lane's weight-sync fault)."""
        self._fail_next += int(n)

    # ------------------------------------------------------------- publish

    def _copy_in(self, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
        params = dict(model.named_parameters())
        if self._snapshot is None:
            dev = torch.device("cpu") if self._copy else None
            self._snapshot = {
                name: torch.empty_like(p, device=dev or p.device,
                                       requires_grad=False)
                for name, p in params.items()}
        copy_weights(self._snapshot, params)
        return self._snapshot

    def publish(self, model: torch.nn.Module, version: int) -> bool:
        """Publish ``model``'s weights as ``version`` with retry/backoff.
        Returns False when the retry budget is exhausted — the caller
        degrades gracefully (last good version keeps serving) instead of
        crashing."""
        reg = get_registry()

        def _attempt():
            if self._fail_next > 0:
                self._fail_next -= 1
                raise SyncFailed(f"injected sync failure (v{version})")
            if self._transport is not None:
                self._transport(version, model)
            # last: an attempt that failed above left the snapshot alone
            self._published = (int(version), self._copy_in(model))

        def _on_retry(attempt, exc, delay):
            self.retries += 1
            reg.inc("async.sync_retries")

        try:
            retry(_attempt, self.backoff, sleep=self._sleep,
                  retry_on=(SyncFailed,), on_retry=_on_retry,
                  describe=f"weight sync v{version}")
        except RetriesExhausted:
            self.failures += 1
            reg.inc("async.sync_failures")
            return False
        self.version = int(version)
        self.publishes += 1
        return True

    def poll(self):
        """Latest successfully published (version, snapshot), or None."""
        return self._published

    # ------------------------------------------------------------- §10 state

    def state_dict(self) -> Dict:
        return {"version": np.int64(self.version),
                "publishes": np.int64(self.publishes),
                "retries": np.int64(self.retries),
                "failures": np.int64(self.failures),
                "fail_next": np.int64(self._fail_next)}

    def load_state_dict(self, st: Dict) -> None:
        self.version = int(st["version"])
        self.publishes = int(st["publishes"])
        self.retries = int(st["retries"])
        self.failures = int(st["failures"])
        self._fail_next = int(st["fail_next"])


class RolloutService:
    """Continuously-running trajectory producer over the shared Collector.

    One ``tick`` = poll the weight channel, consult the fault plan, then
    (unless throttled/stalled) collect one batch under the served model
    and push the tagged trajectory into the buffer.  The served model is
    the service's own ``LM`` on ``device`` (the card unless ``"cpu"``),
    built at the first ``install``."""

    def __init__(self, collector, buffer: TrajBuffer, sync: WeightSync,
                 faults: Optional[FaultPlan] = None, producer: int = 0,
                 device: DeviceLike = None):
        self.collector = collector
        self.buffer = buffer
        self.sync = sync
        self.faults = faults
        self.producer = int(producer)
        self.device = resolve_device(device)
        self.model: Optional[M.LM] = None    # last good installed weights
        self.version = -1                    # version of self.model
        self.produced = 0                    # completed collect ticks
        self.ticks = 0
        self.stalled_ticks = 0
        self._stall_remaining = 0

    # ------------------------------------------------------------- weights

    def install(self, weights: Mapping[str, torch.Tensor],
                version: int) -> None:
        """Copy ``weights`` (parameter name → tensor: a published snapshot,
        or a model's ``named_parameters()`` at bootstrap / resume) into the
        served model: this rank's shards on the mesh."""
        if self.model is None:
            self.model = self._build()
        copy_weights(dict(self.model.named_parameters()), weights)
        self.version = int(version)

    def _build(self) -> M.LM:
        """An empty served model on the service's device, cut as the
        collector's mesh cuts the trainer's."""
        cfg = self.collector.cfg
        return shard_params(getattr(self.collector, "mesh", None), cfg,
                            M.LM(cfg, device="meta")).to_empty(
                                device=self.device)

    def _maybe_sync(self) -> None:
        pub = self.sync.poll()
        if pub is not None and pub[0] > self.version:
            self.install(pub[1], pub[0])

    # ---------------------------------------------------------------- tick

    def tick(self) -> bool:
        """One producer step.  Returns True iff a trajectory was produced
        (False: throttled, stalled, or no weights installed yet).

        Raises ``EngineKilled`` on a due 'kill' fault — the producer's
        failure domain; the consumer catches and restarts it."""
        reg = get_registry()
        self.ticks += 1
        self._maybe_sync()
        if self.faults is not None:
            if self.faults.due(self.ticks - 1, "kill"):
                raise EngineKilled(f"rollout service killed at tick "
                                   f"{self.ticks - 1}")
            for e in self.faults.due(self.ticks - 1, "stall"):
                self._stall_remaining += max(1, int(e.count))
        if self._stall_remaining > 0:
            self._stall_remaining -= 1
            self.stalled_ticks += 1
            reg.inc("async.producer_stalled_ticks")
            return False
        if self.model is None:
            return False
        if self.buffer.should_throttle():
            self.buffer.note_throttled()
            reg.inc("async.producer_throttled_ticks")
            return False
        # the produced-counter IS the collection epoch: under the strict
        # K=0 alternation it equals the consumer's step_idx, so the
        # dataset-RNG and key streams replay the synchronous run exactly
        epoch = self.produced
        batch = self.collector.sample(epoch)
        batch, rb, rewards, times = self.collector.collect(
            self.model, batch, epoch)
        # the stage-times dict (collect_time, reward_time, rollout metrics)
        # travels with the trajectory so the consumer's step metrics match
        # the synchronous trainer's schema key-for-key
        rb.metrics = {k: float(v) for k, v in times.items()
                      if isinstance(v, (int, float))}
        self.buffer.put(Trajectory(batch=batch, rb=rb, rewards=rewards,
                                   version=self.version,
                                   producer=self.producer))
        self.produced += 1
        reg.set("async.produced", float(self.produced))
        return True

    def recover(self) -> None:
        """Post-kill restart: clear transient stall state (the collector,
        cache and buffer live outside the producer's failure domain and
        carry over — mirroring the engine's kill-and-resume contract where
        durable state rides the checkpoint, transient state resets)."""
        self._stall_remaining = 0

    # ------------------------------------------------------------- counters

    def counters(self, prefix: str = "service_") -> Dict[str, float]:
        return {f"{prefix}produced": float(self.produced),
                f"{prefix}ticks": float(self.ticks),
                f"{prefix}stalled_ticks": float(self.stalled_ticks),
                f"{prefix}version": float(self.version)}

    # ------------------------------------------------------------ §10 state

    def state_dict(self) -> Dict:
        st = {"scalars": {"version": np.int64(self.version),
                          "produced": np.int64(self.produced),
                          "ticks": np.int64(self.ticks),
                          "stalled_ticks": np.int64(self.stalled_ticks),
                          "stall_remaining": np.int64(self._stall_remaining),
                          "has_params": np.int64(self.model is not None)}}
        if self.model is not None:
            st["params"] = gather_params(self.model)
        return st

    def load_state_dict(self, st: Dict) -> None:
        sc = st["scalars"]
        if int(sc["has_params"]):
            self.install(st["params"], int(sc["version"]))
        else:
            self.model = None
        self.version = int(sc["version"])
        self.produced = int(sc["produced"])
        self.ticks = int(sc["ticks"])
        self.stalled_ticks = int(sc["stalled_ticks"])
        self._stall_remaining = int(sc["stall_remaining"])
