"""Async trainer (DESIGN.md §12; port of ``repro/rl/async_loop.py``): the
consumer half of the disaggregated rollout ↔ train seam, under a bounded
staleness window.

Topology: a ``serving.RolloutService`` produces version-tagged
trajectories into a bounded ``TrajBuffer``; this loop consumes them and
runs the optimization half of the trainer (``Trainer.optimize``).  Per
consumed trajectory, staleness = consumer policy version − the version it
was sampled under:

* **0**            — the exact synchronous computation (no correction);
* **1 … K**        — truncated importance weights
                     w = min(ρ̄, exp(lp_now − lp_behaviour)) folded into
                     the advantages (``Trainer.optimize(behaviour_lp=…)``);
* **> K**          — NOT dropped: the stale response is primed into a
                     throwaway RolloutCache and re-verified through the
                     one-pass verify_and_prefill → realign_decode_cache →
                     resume_from_cache path under the current weights —
                     reuse the still-agreeing prefix, regenerate the
                     divergent tail, re-reward, train on-policy.

Graceful degradation: when the *service* staleness (consumer version −
served version, i.e. how far weight publication has fallen behind)
exceeds ``hard_staleness_cap``, the loop walks one rung down
``_MODE_LADDER`` per step:

    async  →  reverify (re-verify every trajectory)  →  sync (collect
    in-process, the pre-§12 loop)

Failure-domain isolation: a producer ``kill`` fault surfaces as
``EngineKilled`` at a tick boundary — the consumer catches it, counts a
restart and keeps training; a failed weight sync leaves the service on
its last good version while the staleness gauge rises.  Everything is
counted in the obs registry (staleness histogram, buffer occupancy, sync
retries, degradation level) and the whole pair checkpoints through
``checkpoint/io`` for exact kill-and-resume.

The mesh: over a ``Trainer(mesh=...)`` the service samples with a model
cut as the trainer's (its rank's shards, published shard by shard), the
collection and the re-verification run on the mesh, and the consumer's
``optimize`` is the mesh trainer's.  A checkpoint gathers the whole trees
to the mesh's first rank, which writes it (``rl/watchdog.py:trainer_state``),
and a restore cuts each tensor onto its rank as it is read
(``distributed/mesh.py:cut_on_read``).

Keys: the re-verification stream is ``make_key(reverify_seed)`` on the
trainer's device, split before each re-verification as JAX splits its
``PRNGKey(reverify_seed)``; it is saved as its 64-bit seed.

Determinism contract (tested): with window K=0, publish_every=1 and the
strict ``"pc"`` schedule, producer and consumer replay the synchronous
trainer's RNG streams in lockstep — token-, loss- and weight-identical to
``Trainer.train_step`` (the service samples a bit-exact copy of the
trainer's weights).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.io import (load_pytree, load_rollout_cache,
                                       read_latest, save_pytree,
                                       save_rollout_cache, write_latest)
from repro_torch.core import RolloutCache, rollout
from repro_torch.core.spec_rollout import RolloutBatch
from repro_torch.distributed.mesh import cut_on_read
from repro_torch.engine.sampling import make_key, split_key
from repro_torch.obs import get_registry, get_tracer
from repro_torch.rewards.verifier import batch_rewards
from repro_torch.serving.faults import EngineKilled, FaultPlan
from repro_torch.serving.rollout_service import RolloutService, WeightSync

from .traj_buffer import TrajBuffer, Trajectory
from .watchdog import (key_from_state, key_state, load_trainer_state,
                       state_models, trainer_state, write_once)

# one-way degradation ladder (§10 pattern): async consumption → re-verify
# every trajectory → fully synchronous in-process collection
_MODE_LADDER = {"async": "reverify", "reverify": "sync", "sync": None}
_MODES = ("async", "reverify", "sync")


@dataclass(frozen=True)
class AsyncConfig:
    staleness_window: int = 1        # K: max versions corrected by IS
    is_clip: float = 2.0             # truncated-IS cap ρ̄
    buffer_capacity: int = 8
    high_watermark: Optional[int] = None   # None → capacity (shed-only)
    hard_staleness_cap: int = 4      # service staleness → walk the ladder
    publish_every: int = 1           # optimizer steps between publications
    schedule: str = "pc"             # deterministic p(roducer)/c(onsumer)
                                     # interleave, repeated
    reverify_seed: int = 7321        # key stream for re-verification
    max_idle_ticks: int = 10000      # run() no-progress safety valve


class AsyncTrainer:
    """Drives a (RolloutService, TrajBuffer, Trainer) triple under the
    deterministic step-interleaved schedule."""

    def __init__(self, trainer, acfg: AsyncConfig = AsyncConfig(),
                 faults: Optional[FaultPlan] = None,
                 sync: Optional[WeightSync] = None,
                 buffer: Optional[TrajBuffer] = None):
        self.trainer = trainer
        self.acfg = acfg
        self.collector = trainer.collector       # SHARED with the trainer:
        # one sampling RNG, one key stream, one SPEC-RL cache — the K=0
        # identity contract depends on there being exactly one of each
        self.buffer = buffer if buffer is not None else TrajBuffer(
            acfg.buffer_capacity, acfg.high_watermark)
        self.sync = sync if sync is not None else WeightSync()
        self.service = RolloutService(self.collector, self.buffer, self.sync,
                                      faults=faults, device=trainer.device)
        self.version = 0                         # consumer policy version
        self.mode = "async"
        self.degradations = 0
        self.exact_steps = 0                     # staleness == 0
        self.is_steps = 0                        # 1 <= staleness <= K
        self.reverified = 0                      # staleness > K or mode
        self.sync_steps = 0                      # ladder bottom
        self.producer_restarts = 0
        self.starved_ticks = 0
        self._wait_ticks = 0
        self._wait_t0: Optional[float] = None
        self._reverify_key = make_key(acfg.reverify_seed, trainer.device)
        # bootstrap deployment: the service starts on a copy of the
        # trainer's initial weights as version 0 (a direct install, not a
        # sync — there is no failure domain to cross yet)
        self.service.install(dict(trainer.model.named_parameters()),
                             self.version)

    # -------------------------------------------------------------- ladder

    @property
    def mode_level(self) -> int:
        return _MODES.index(self.mode)

    def _degrade(self, reason: str) -> None:
        nxt = _MODE_LADDER[self.mode]
        if nxt is None:
            return
        prev, self.mode = self.mode, nxt
        self.degradations += 1
        reg = get_registry()
        reg.inc("async.degradations")
        reg.set("async.degradation_level", float(self.mode_level), agg="max")
        get_tracer().event("async_degrade", "trainer", cat="fault",
                           frm=prev, to=nxt, reason=reason,
                           step=self.trainer.step_idx)

    def _maybe_degrade(self) -> int:
        """Check the service-staleness hard cap; walk ONE rung per step
        while above it (mirrors the engine's per-incident ladder walk)."""
        lag = max(0, self.version - max(0, self.service.version))
        get_registry().set("async.service_staleness", float(lag))
        if lag > self.acfg.hard_staleness_cap:
            self._degrade(f"service staleness {lag} > "
                          f"cap {self.acfg.hard_staleness_cap}")
        return lag

    # ------------------------------------------------------------ producer

    def producer_tick(self) -> bool:
        """One service tick inside its own failure domain: a 'kill' fault
        dies here, is counted, and the producer restarts — the trainer
        never goes down with it."""
        try:
            return self.service.tick()
        except EngineKilled:
            self.producer_restarts += 1
            get_registry().inc("async.producer_restarts")
            get_tracer().event("producer_restart", "trainer", cat="fault",
                               tick=self.service.ticks)
            self.service.recover()
            return False

    # ------------------------------------------------------------ consumer

    def _reverify(self, traj: Trajectory
                  ) -> Tuple[RolloutBatch, np.ndarray, Dict[str, float]]:
        """Over-stale trajectory → SPEC-RL draft: prime a throwaway cache
        with the stale response and roll it under the CURRENT weights — the
        one-pass verify→compact→resume path reuses the still-agreeing
        prefix and regenerates only the divergent tail; then re-reward."""
        c = self.collector
        tmp = RolloutCache(history=2, group_size=c.rl.group_size)
        rb0 = traj.rb
        tmp.batch_put(traj.batch.cache_keys, rb0.response,
                      rb0.behaviour_logprobs, rb0.length,
                      step=max(0, traj.version), eos_id=c.gen.eos_id)
        self._reverify_key, sub = split_key(self._reverify_key)
        t0 = time.perf_counter()
        rb = rollout(self.trainer.model, c.cfg, c.gen, c.spec,
                     traj.batch.tokens, traj.batch.mask,
                     traj.batch.cache_keys, tmp, sub, self.version,
                     mesh=c.mesh)
        rewards = batch_rewards(rb.response, rb.length, traj.batch.answers)
        times = dict(rb.metrics)
        times["collect_time"] = time.perf_counter() - t0
        return rb, rewards, times

    def _after_optimize(self) -> None:
        """Version bump + (possibly failing) weight publication."""
        self.version += 1
        if self.version % max(1, self.acfg.publish_every) == 0:
            self.sync.publish(self.trainer.model, self.version)
        get_registry().set("async.published_version",
                           float(self.sync.version))
        get_registry().set("async.policy_version", float(self.version))

    def consumer_step(self) -> Optional[Dict[str, float]]:
        """One optimization step off the buffer.  None = starved (the
        schedule's next producer tick will feed it)."""
        reg = get_registry()
        lag = self._maybe_degrade()

        if self.mode == "sync":
            # ladder bottom: in-process collection, the pre-§12 loop
            m = self.trainer.train_step()
            self.sync_steps += 1
            m["async_mode_level"] = float(self.mode_level)
            m["service_staleness"] = float(lag)
            self._after_optimize()
            return m

        traj = self.buffer.get()
        if traj is None:
            self.starved_ticks += 1
            self._wait_ticks += 1
            if self._wait_t0 is None:
                self._wait_t0 = time.perf_counter()
            reg.inc("async.consumer_starved_ticks")
            return None
        wait_s = (time.perf_counter() - self._wait_t0
                  if self._wait_t0 is not None else 0.0)
        wait_ticks, self._wait_ticks, self._wait_t0 = self._wait_ticks, 0, None

        staleness = max(0, self.version - max(0, traj.version))
        reg.observe("async.traj_staleness", float(staleness))
        extra = {
            "staleness": float(staleness),
            "traj_version": float(traj.version),
            "policy_version": float(self.version),
            "service_staleness": float(lag),
            "service_wait_ticks": float(wait_ticks),
            "service_wait_s": float(wait_s),
            "async_mode_level": float(self.mode_level),
            "sync_retries": float(self.sync.retries),
            "sync_failures": float(self.sync.failures),
            "producer_restarts": float(self.producer_restarts),
            **self.buffer.counters(),
        }

        K = self.acfg.staleness_window
        if self.mode == "reverify" or staleness > K:
            rb, rewards, times = self._reverify(traj)
            self.reverified += 1
            reg.inc("async.reverified")
            extra["reverified"] = 1.0
            m = self.trainer.optimize(rb, rewards, times,
                                      extra_metrics=extra)
        elif staleness > 0:
            self.is_steps += 1
            reg.inc("async.is_corrected")
            m = self.trainer.optimize(
                traj.rb, traj.rewards, dict(traj.rb.metrics),
                behaviour_lp=traj.rb.behaviour_logprobs,
                is_clip=self.acfg.is_clip, extra_metrics=extra)
        else:
            self.exact_steps += 1
            m = self.trainer.optimize(traj.rb, traj.rewards,
                                      dict(traj.rb.metrics),
                                      extra_metrics=extra)
        self._after_optimize()
        return m

    # ----------------------------------------------------------- scheduler

    def run(self, num_steps: int, schedule: Optional[str] = None
            ) -> List[Dict[str, float]]:
        """Drive the deterministic step-interleaved schedule until
        ``num_steps`` consumer steps completed.  The schedule string is a
        cycle over 'p' (producer tick) and 'c' (consumer step) — the test
        scheduler of the §12 determinism contract."""
        sched = schedule if schedule is not None else self.acfg.schedule
        assert sched and set(sched) <= {"p", "c"}, sched
        out: List[Dict[str, float]] = []
        idle = 0
        i = 0
        while len(out) < num_steps:
            ch = sched[i % len(sched)]
            i += 1
            progressed = False
            if ch == "p":
                progressed = self.producer_tick()
            else:
                m = self.consumer_step()
                if m is not None:
                    out.append(m)
                    progressed = True
            idle = 0 if progressed else idle + 1
            if idle > self.acfg.max_idle_ticks:
                raise RuntimeError(
                    f"async loop stalled: {idle} ticks without progress "
                    f"(mode={self.mode}, buffer={len(self.buffer)})")
        return out

    # ------------------------------------------------------------- counters

    def counters(self) -> Dict[str, float]:
        return {"async_version": float(self.version),
                "async_mode_level": float(self.mode_level),
                "async_degradations": float(self.degradations),
                "async_exact_steps": float(self.exact_steps),
                "async_is_steps": float(self.is_steps),
                "async_reverified": float(self.reverified),
                "async_sync_steps": float(self.sync_steps),
                "async_producer_restarts": float(self.producer_restarts),
                "async_starved_ticks": float(self.starved_ticks),
                **self.buffer.counters(),
                **self.service.counters()}

    # -------------------------------------------- §10 exact kill-and-resume

    def state_dict(self) -> Dict:
        return {
            "trainer": trainer_state(self.trainer),
            "service": self.service.state_dict(),
            "sync": self.sync.state_dict(),
            "buffer": self.buffer.state_dict(),
            "reverify_key": key_state(self._reverify_key),
            "scalars": {
                "version": np.int64(self.version),
                "mode": np.int64(self.mode_level),
                "degradations": np.int64(self.degradations),
                "exact_steps": np.int64(self.exact_steps),
                "is_steps": np.int64(self.is_steps),
                "reverified": np.int64(self.reverified),
                "sync_steps": np.int64(self.sync_steps),
                "producer_restarts": np.int64(self.producer_restarts),
                "starved_ticks": np.int64(self.starved_ticks),
            },
        }

    def load_state_dict(self, st: Dict) -> None:
        load_trainer_state(self.trainer, st["trainer"], step_idx=True)
        self.service.load_state_dict(st["service"])
        self.sync.load_state_dict(st["sync"])
        self.buffer.load_state_dict(st["buffer"])
        self._reverify_key = key_from_state(st["reverify_key"],
                                            self.trainer.device)
        sc = st["scalars"]
        self.version = int(sc["version"])
        self.mode = _MODES[int(sc["mode"])]
        self.degradations = int(sc["degradations"])
        self.exact_steps = int(sc["exact_steps"])
        self.is_steps = int(sc["is_steps"])
        self.reverified = int(sc["reverified"])
        self.sync_steps = int(sc["sync_steps"])
        self.producer_restarts = int(sc["producer_restarts"])
        self.starved_ticks = int(sc["starved_ticks"])

    def save(self, ckpt_dir: str, name: Optional[str] = None) -> str:
        """Checkpoint the whole async pair — trainer core, service (incl.
        served weights + version), weight-sync channel, buffer contents,
        mode/version scalars, SPEC-RL cache — committed by the ``latest``
        pointer flip, exactly like the watchdog's snapshots."""
        name = name or f"async_{self.trainer.step_idx:06d}"
        path = os.path.join(ckpt_dir, name)
        st = self.state_dict()
        write_once(self.trainer, lambda: (
            save_pytree(path, st, metadata={"step": self.trainer.step_idx,
                                            "kind": "async_pair"}),
            save_rollout_cache(path, self.collector.cache)),
            lambda: write_latest(ckpt_dir, name))
        return name

    def restore(self, ckpt_dir: str) -> bool:
        """Restore the pair from the last committed checkpoint; False if
        none exists (a fresh start, not an error)."""
        name = read_latest(ckpt_dir)
        if name is None:
            return False
        path = os.path.join(ckpt_dir, name)
        tree, _meta = load_pytree(path, leaf=cut_on_read({
            **state_models(self.trainer, "/trainer"),
            "/service/params": self.trainer.model}))
        self.load_state_dict(tree)
        self.collector.cache = load_rollout_cache(path)
        return True
