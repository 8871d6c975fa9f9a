"""Trainer watchdog: restore-last-good on poisoned steps (DESIGN.md §10;
port of ``repro/rl/watchdog.py``).

The serving layer degrades gracefully (quarantine / retry / shed), but the
*trainer* has its own failure modes the engine cannot see: a non-finite
loss (one poisoned batch can NaN the params through the update), or a
rollout stage that stalls far past its normal duration.  The watchdog
wraps ``train_step`` output:

* on a healthy step, it snapshots trainer state (params, optimizer
  moments, key, critic, rollout cache, step counters) on a fixed cadence
  through ``checkpoint/io`` — atomic files, ``latest`` pointer flipped
  last, so a crash mid-snapshot keeps the previous one live;
* on a poisoned step (non-finite loss/reward, or ``collect_time`` above
  the stall threshold), it restores the last snapshot and deliberately
  does NOT roll the step counter back — the dataset's epoch-keyed
  sampling moves on, so the poisoned batch is skipped rather than
  replayed into the same failure.

A restore writes into the live objects.  JAX rebinds ``trainer.params``;
the port copies the snapshot into ``trainer.model``'s parameters and into
the existing AdamW moments in place (the critic and its moments alike),
so the ``model`` object that the collector and any rollout service were
handed stays the trainer's.  The key is saved as its 64-bit seed
(``key_state``) and rebuilt on the model's device (``key_from_state``).

On the mesh (a ``Trainer(mesh=...)``) a snapshot gathers the whole trees
to the host of the mesh's first rank alone, a tensor at a time
(``distributed/mesh.py:gather_params``, a collective of its model group),
so its files are a single device's, the ones that already cross
packages; that rank writes them, and after a barrier flips ``latest``
last.  A restore reads the files on every rank, a tensor at a time, and
keeps only its rank's slice of each (``cut_on_read`` over
``state_models``), so no rank holds a whole tree.

Stall detection is adaptive as well as absolute (§11): beyond the fixed
``max_collect_time`` ceiling, a step is stalled when its collect time
exceeds ``stall_p95_mult`` × the p95 of the run's own healthy collect
times (a log-bucketed ``obs.Histogram``; armed only once
``stall_min_samples`` healthy steps have been seen, so short tests and
cold-start steps never trip it).

Counters (snapshots / restores / skips) ride the step metrics dict, next
to the serving layer's fault_ counters — recovery is observable from the
training log, not from log archaeology.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.io import (load_pytree, load_rollout_cache,
                                       read_latest, save_pytree,
                                       save_rollout_cache, write_latest)
from repro_torch.distributed.mesh import WRITER, cut_on_read, gather_params
from repro_torch.engine.sampling import Key
from repro_torch.obs import Histogram, get_tracer
from repro_torch.serving.rollout_service import copy_weights

_M32 = 0xFFFFFFFF


def key_state(key) -> np.ndarray:
    """A scalar key as its 64-bit seed, in two 32-bit words (int64)."""
    return np.asarray([key.seed & _M32, key.seed >> 32], np.int64)


def key_from_state(words, device) -> Key:
    w = np.asarray(words, np.int64)
    return Key(int(w[0]) | int(w[1]) << 32, device)


def _opt_state(model, opt) -> Dict:
    """AdamW's state of ``model``, its moments whole."""
    return {k: list(gather_params(model, opt[k]).values())
            for k in ("mu", "nu")} | {"step": np.int64(opt["step"])}


@torch.no_grad()
def _load_opt_state(opt, st) -> None:
    for dst, src in zip(opt["mu"] + opt["nu"], list(st["mu"]) + list(st["nu"])):
        dst.copy_(src)
    opt["step"] = int(st["step"])


def trainer_state(trainer) -> Dict:
    """What a restore needs of a ``Trainer``: params, AdamW moments, key,
    step counters, and the critic with its moments when there is one (an
    all-array pytree for ``checkpoint/io``).  On the mesh the trees are
    whole on the writing rank alone (``gather_params``; a collective of
    its model group), and empty on the others, which write nothing."""
    st = {
        "params": gather_params(trainer.model),
        "opt_state": _opt_state(trainer.model, trainer.opt_state),
        "key": key_state(trainer.key),
        "scalars": {
            "step_idx": np.int64(trainer.step_idx),
            "gen_steps": np.int64(trainer.gen_steps),
            "total_generated_tokens":
                np.int64(trainer.total_generated_tokens),
        },
    }
    if trainer.critic is not None:
        st["critic_params"] = gather_params(trainer.critic)
        st["critic_opt_state"] = _opt_state(trainer.critic,
                                            trainer.critic_opt_state)
    return st


def state_models(trainer, prefix: str = "") -> Dict:
    """The subtrees of ``trainer_state`` (under ``prefix`` in a file) that
    hold a model's tensors, each with its model: what ``cut_on_read``
    cuts onto this rank as a snapshot is read."""
    out = {}
    for key, model in (("", trainer.model), ("critic_", trainer.critic)):
        if model is not None:
            out.update({f"{prefix}/{key}params": model,
                        f"{prefix}/{key}opt_state/mu": model,
                        f"{prefix}/{key}opt_state/nu": model})
    return out


def load_trainer_state(trainer, st: Dict, step_idx: bool) -> None:
    """``trainer_state`` back into the live trainer, in place, its trees
    this rank's (as ``load_pytree`` with ``cut_on_read(state_models(...))``
    reads them); the step counter only with ``step_idx`` (the async pair's
    resume), never for a watchdog restore."""
    copy_weights(dict(trainer.model.named_parameters()), st["params"])
    _load_opt_state(trainer.opt_state, st["opt_state"])
    trainer.key = key_from_state(st["key"], trainer.device)
    if "critic_params" in st and trainer.critic is not None:
        copy_weights(dict(trainer.critic.named_parameters()),
                     st["critic_params"])
        _load_opt_state(trainer.critic_opt_state, st["critic_opt_state"])
    sc = st["scalars"]
    if step_idx:
        trainer.step_idx = int(sc["step_idx"])
    trainer.gen_steps = int(sc["gen_steps"])
    trainer.total_generated_tokens = int(sc["total_generated_tokens"])


def write_once(trainer, write, commit) -> None:
    """``write()`` then ``commit()`` (the ``latest`` flip) on the mesh's
    ``WRITER``, the other ranks waiting at a barrier after each, so that
    no rank goes on (or reads ``latest``) before the snapshot is whole;
    both at once off the mesh."""
    if getattr(trainer, "mesh", None) is None:
        write()
        commit()
        return
    lead = dist.get_rank() == WRITER
    if lead:
        write()
    dist.barrier()
    if lead:
        commit()
    dist.barrier()


@dataclass(frozen=True)
class WatchdogConfig:
    checkpoint_dir: str                      # where snapshots live
    snapshot_every: int = 10                 # healthy-step snapshot cadence
    max_collect_time: float = float("inf")   # rollout-stall threshold (s)
    max_restores: int = 3                    # give up (raise) past this
    stall_p95_mult: float = 10.0             # adaptive: > mult * p95 = stall
    stall_min_samples: int = 8               # healthy samples to arm p95
    # §12 async topology: the collect stage lives in the rollout service's
    # failure domain, so a stalled *service* shows up here not as a long
    # collect_time but as the consumer waiting on fresh trajectories
    # (``service_wait_s``) or as an unbounded staleness gauge
    # (``service_staleness``).  Both route into the same restore-last-good
    # verdict as an in-process stall.
    max_service_wait: float = float("inf")   # fresh-trajectory wait cap (s)
    max_service_staleness: float = float("inf")  # staleness-gauge hard cap


class TrainWatchdog:
    """Attachable step monitor for ``rl.trainer.Trainer``."""

    def __init__(self, cfg: WatchdogConfig):
        assert cfg.checkpoint_dir, "watchdog needs a checkpoint_dir"
        self.cfg = cfg
        self.snapshots = 0
        self.restores = 0
        self.nonfinite_steps = 0
        self.stalled_steps = 0
        self.service_stalled_steps = 0
        self.skipped_no_snapshot = 0
        self.alert_events = 0                # §14 alert routing
        self.crit_alert_events = 0
        self.last_alert = ""
        self._collect_hist = Histogram()     # healthy collect times (§11)
        self._wait_hist = Histogram()        # healthy trajectory waits (§12)

    # ------------------------------------------------------------- plumbing

    def note_alert(self, event) -> None:
        """§14 alert sink: ``obs.alerts.AlertManager`` routes its events
        here (``Trainer(alerts=..., watchdog=...)``).  Alerts are advisory — they count toward the step log but
        do not by themselves trigger a restore; the poison checks stay the
        only rollback authority."""
        self.alert_events += 1
        if getattr(event, "severity", "") == "crit":
            self.crit_alert_events += 1
        self.last_alert = getattr(event, "rule", "")

    def _path(self, name: str) -> str:
        return os.path.join(self.cfg.checkpoint_dir, name)

    def snapshot(self, trainer) -> str:
        """Persist everything a restore needs; commit via the pointer.  On
        the mesh the first rank's model group gathers to it, and it writes
        (``write_once``)."""
        name = f"watchdog_{trainer.step_idx:06d}"
        st = trainer_state(trainer)
        write_once(trainer, lambda: (
            save_pytree(self._path(name), st,
                        metadata={"step": trainer.step_idx}),
            save_rollout_cache(self._path(name), trainer.cache)),
            lambda: write_latest(self.cfg.checkpoint_dir, name))
        self.snapshots += 1
        return name

    def restore(self, trainer) -> bool:
        """Reset trainer state to the last committed snapshot (params,
        moments, key, cache, counters) in place — step_idx deliberately NOT
        rolled back, so the poisoned batch is skipped.  False if no
        snapshot."""
        name = read_latest(self.cfg.checkpoint_dir)
        if name is None:
            return False
        tree, _ = load_pytree(self._path(name),
                              leaf=cut_on_read(state_models(trainer)))
        load_trainer_state(trainer, tree, step_idx=False)
        trainer.cache = load_rollout_cache(self._path(name))
        self.restores += 1
        return True

    # ------------------------------------------------------------ step hook

    def _poisoned(self, metrics: Dict[str, float]) -> Optional[str]:
        for k in ("loss", "reward_mean", "critic_loss"):
            v = metrics.get(k)
            if v is not None and not math.isfinite(float(v)):
                return "nonfinite"
        ct = metrics.get("collect_time", 0.0)
        if ct > self.cfg.max_collect_time:
            return "stall"
        # adaptive threshold: the run's own p95 rollout time (not a single
        # step) decides what "far past normal" means; p95 > 0 guards the
        # all-zero-history case
        if self._collect_hist.count >= self.cfg.stall_min_samples:
            p95 = self._collect_hist.percentile(95)
            if p95 > 0 and ct > self.cfg.stall_p95_mult * p95:
                return "stall"
        # §12: stalled rollout *service* — the async consumer had to wait
        # far past its normal fresh-trajectory cadence (absolute cap, or
        # adaptive p95 × mult over the run's own healthy waits), or the
        # staleness gauge blew past its hard cap.  Same verdict, same
        # restore-last-good recovery as an in-process collect stall.
        wt = metrics.get("service_wait_s", 0.0)
        if wt > self.cfg.max_service_wait:
            return "service_stall"
        if self._wait_hist.count >= self.cfg.stall_min_samples:
            p95 = self._wait_hist.percentile(95)
            if p95 > 0 and wt > self.cfg.stall_p95_mult * p95:
                return "service_stall"
        if metrics.get("service_staleness", 0.0) > \
                self.cfg.max_service_staleness:
            return "service_stall"
        return None

    def after_step(self, trainer, metrics: Dict[str, float]) -> None:
        """Call once per train_step with the step's metrics dict (mutated
        in place with watchdog counters and the recovery verdict)."""
        why = self._poisoned(metrics)
        if why is None:
            ct = float(metrics.get("collect_time", 0.0))
            if ct > 0:
                self._collect_hist.record(ct)    # healthy samples only
            wt = float(metrics.get("service_wait_s", 0.0))
            if wt > 0:
                self._wait_hist.record(wt)
            if self.snapshots == 0 or \
                    trainer.step_idx % max(1, self.cfg.snapshot_every) == 0:
                self.snapshot(trainer)
        else:
            if why == "nonfinite":
                self.nonfinite_steps += 1
            elif why == "service_stall":
                self.service_stalled_steps += 1
            else:
                self.stalled_steps += 1
            if self.restores >= self.cfg.max_restores:
                raise RuntimeError(
                    f"watchdog: {why} step and restore budget "
                    f"({self.cfg.max_restores}) exhausted")
            if self.restore(trainer):
                metrics["watchdog_restored"] = 1.0
                get_tracer().event("watchdog_restore", "trainer",
                                   cat="fault", reason=why,
                                   step=trainer.step_idx)
            else:
                # nothing to restore yet — record the skip; the poisoned
                # update stands but the batch still advances past
                self.skipped_no_snapshot += 1
        metrics.update(self.as_dict())

    def as_dict(self, prefix: str = "watchdog_") -> Dict[str, float]:
        return {f"{prefix}snapshots": float(self.snapshots),
                f"{prefix}restores": float(self.restores),
                f"{prefix}nonfinite_steps": float(self.nonfinite_steps),
                f"{prefix}stalled_steps": float(self.stalled_steps),
                f"{prefix}service_stalled_steps":
                    float(self.service_stalled_steps),
                f"{prefix}skipped_no_snapshot":
                    float(self.skipped_no_snapshot),
                f"{prefix}alert_events": float(self.alert_events),
                f"{prefix}crit_alert_events": float(self.crit_alert_events),
                f"{prefix}collect_p95": self._collect_hist.percentile(95),
                f"{prefix}service_wait_p95": self._wait_hist.percentile(95)}
