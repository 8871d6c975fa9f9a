"""RLVR trainer, GRPO / PPO / DAPO (port of ``repro/rl/trainer.py``), with
SPEC-RL as a drop-in rollout stage.

Pipeline per step (veRL's stage order, Table 4 of the paper):
  [verification] -> [rollout] -> [assembly]   (core.rollout)
  -> reward (+ DAPO's resample rounds) -> old-log-probs -> (ref log-probs)
  -> (values) -> adv -> (update-critic) -> update-actor

SPEC-RL touches only the first three stages; everything downstream is the
standard algorithm, and the rollout variant is a constructor argument the
update never sees.

The update is JAX's ``_update_actor`` in PyTorch idiom: the actor's
parameters require grad only inside it, its forward takes the model's
differentiable route (``attention.dot_product_attention``,
``rwkv.wkv_scan``, ``mamba.ssm_scan``; no kernel launches),
``loss.backward()`` fills ``.grad``, and ``optim.adamw.update`` steps the
parameters in place.  The old-policy and reference log-probs and PPO's
values are no-grad forwards, which run the ``flash_attention`` kernel (and
the recurrences' ``wkv`` or ``mamba_scan``) on the card.  PPO's critic
(``rl/critic.py``) is updated the same way, before the actor, as in JAX.

Keys follow JAX: the trainer's key splits four ways (``k1, k2, k3,
coll_key``) and the collector splits its stream before every rollout, so
with a key that draws as JAX does the collection is JAX's, token for
token; DAPO's resample rounds split it once a round, in JAX's order.  The
trainer takes an optional ``model`` (else it draws one from ``k1``) and a
``device`` (the card unless ``"cpu"``); PPO's critic, of the actor's
config, is drawn from ``k2``.

``optimize`` is also the consumer half of the async loop
(``rl/async_loop.py``), whose provenance (``extra_metrics``: staleness,
buffer counters, mode) joins the step's metrics.  The step log goes
through ``obs.MetricsRegistry.from_flat(...).as_dict()``, JAX's audited
flat namespace, and an attached ``rl/watchdog.py:TrainWatchdog`` sees the
step last (it may restore the last good snapshot in place and always adds
its counters).  ``spec.draft`` reaches the rollout (the §9 draft engine).

§11/§14 observatory, as in JAX: ``tracer=`` (else the process-global
tracer) draws each stage (reward, collect, old_logprob, ref, values, adv,
update_critic, update_actor) and the enclosing ``train_step`` on the
``trainer`` lane, from the stamps the stage timers take after their device
wait, and the process-global registry gets the ``train.*_s`` histograms.
With a ledger configured the step log carries its cumulative
``ledger_tokens_*`` tallies, ``ledger_finalized`` and
``ledger_violations`` (mirrored as ``ledger.tokens_*`` gauges into the
registry); ``alerts=`` (an ``obs.alerts.AlertManager``) evaluates each
step's flat metrics before the watchdog sees them and routes its events to
an attached watchdog; a decision log is flushed once a step.

The mesh (``mesh=``: a ``MeshConfig`` or a built mesh, as in JAX): the
parameters, the KL reference, the PPO critic and both sets of AdamW
moments are cut by the partition rules (``distributed/mesh.py``), and the
collection runs on the mesh (part 1).  ``optimize`` takes the whole batch
on every rank: the old and reference log-probs and the values are scored
over each data rank's rows and gathered (the kernels on local shards),
the advantages are the whole batch's, and then each rank takes its rows
(``mesh.LossRows``).  Its loss divides by the whole batch's token and row
counts (``rl/losses.py``), so after the backward the gradients need only
the sums of ``LossRows.finish``, and AdamW clips by the global norm.  The
loss and diagnostics are summed over the data group (``LossRows.sum``),
so the step log is the same on every rank and equals one device's; a MoE
trunk's router losses are the whole batch's too (``LossRows.router_loss``).
The model families other than GQA attention with dense FFN or MoE layers
come to the mesh with part 3 of ROADMAP Queue 1 item 11 (the mesh).
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import RolloutCache, SpecConfig, rollout
from repro_torch.core.lenience import FixedLenience
from repro_torch.core.spec_rollout import RolloutBatch
from repro_torch.data.dataset import PromptBatch, PromptDataset
from repro_torch.data.tokenizer import EOS_ID, PAD_ID
from repro_torch.device import DeviceLike, resolve_device, sync
from repro_torch.distributed.mesh import (DataRows, LossRows, MeshConfig,
                                          check_mesh_family, clone_module,
                                          cut_flags, shard_params)
from repro_torch.engine.generate import GenerateConfig, score, token_logprobs
from repro_torch.engine.sampling import split_key
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.obs import (MetricsRegistry, get_decision_log, get_ledger,
                             get_registry, get_tracer)
from repro_torch.optim import adamw
from repro_torch.rewards.verifier import batch_rewards

from .advantages import (gae_advantages, group_relative_advantages,
                         terminal_reward_to_tokens, whiten)
from .critic import Critic, forward_values, init_critic
from .losses import (PolicyLossConfig, entropy_bonus, kl_to_reference,
                     masked_mean, policy_loss, value_loss)


ALGOS = ("grpo", "ppo", "dapo")


@dataclass(frozen=True)
class RLConfig:
    algo: str = "grpo"                # one of ALGOS
    group_size: int = 4
    prompts_per_batch: int = 8
    max_new_tokens: int = 32
    temperature: float = 1.0
    top_p: float = 1.0
    optim: adamw.AdamWConfig = adamw.AdamWConfig(lr=5e-7)
    critic_optim: adamw.AdamWConfig = adamw.AdamWConfig(lr=1e-5)
    gamma: float = 1.0
    gae_lambda: float = 0.95
    whiten_adv: bool = False
    dynamic_sampling: bool = True     # DAPO only
    max_resample_rounds: int = 3
    entropy_coef: float = 0.0

    def __post_init__(self):
        if self.algo not in ALGOS:
            raise ValueError(f"unknown algo {self.algo!r}: one of {ALGOS}")

    def policy_cfg(self) -> PolicyLossConfig:
        if self.algo == "dapo":
            return PolicyLossConfig(clip_low=0.2, clip_high=0.28, clip_c=10.0,
                                    agg="token", kl_coef=0.0,
                                    entropy_coef=self.entropy_coef)
        if self.algo == "grpo":
            return PolicyLossConfig(clip_low=0.2, clip_high=0.2, clip_c=3.0,
                                    agg="seq", kl_coef=1e-4,
                                    entropy_coef=self.entropy_coef)
        return PolicyLossConfig(clip_low=0.2, clip_high=0.2, clip_c=3.0,
                                agg="seq", kl_coef=0.0,
                                entropy_coef=self.entropy_coef)


# ------------------------------------------------------------------ steps


@torch.no_grad()
def _old_logprobs(model: M.LM, cfg: ModelConfig, full_tokens, full_mask,
                  resp_start: int, temperature: float, top_p: float,
                  mesh=None):
    """Log-probs and entropies of the response columns under ``model``,
    no grad (the ``flash_attention`` kernel on the card; on the mesh over
    each data rank's rows, gathered whole)."""
    sc = score(model, cfg, full_tokens, full_mask, temperature=temperature,
               top_p=top_p, return_entropy=True, mesh=mesh)
    return sc["logprobs"][:, resp_start:], sc["entropy"][:, resp_start:]


def _actor_loss_fn(model: M.LM, cfg: ModelConfig, pcfg: PolicyLossConfig,
                   full_tokens, full_mask, resp_start: int, lp_old,
                   advantages, resp_mask, ref_lp, temperature: float,
                   top_p: float, count=None, rows=None,
                   loss_rows: Optional[LossRows] = None):
    """The GRPO actor loss with its graph, and its diagnostics (floats of
    the graph's values, detached).  A MoE trunk adds its router losses,
    ``cfg.router_aux_coef`` times the load-balance loss and
    ``cfg.router_z_coef`` times the z-loss, as JAX's does.  ``count``/
    ``rows``: the whole batch's, when these are one data rank's rows;
    ``loss_rows``: those rows' ``LossRows``, whose rule makes the router
    losses the whole batch's (``LossRows.router_loss``)."""
    if loss_rows is None:
        loss_rows = LossRows(None, full_tokens.shape[0])
    stats: List[Dict[str, torch.Tensor]] = []
    lp_all, ent_all, aux = token_logprobs(
        model, cfg, full_tokens, full_mask, temperature, top_p,
        entropy_grad=pcfg.entropy_coef > 0.0, router_stats=stats)
    lp_new = lp_all[:, resp_start:]
    ent = ent_all[:, resp_start:]
    loss, info = policy_loss(lp_new, lp_old, advantages, resp_mask, pcfg,
                             count=count, rows=rows)
    if pcfg.kl_coef > 0.0:
        kl = kl_to_reference(lp_new, ref_lp, resp_mask, count=count)
        loss = loss + pcfg.kl_coef * kl
        info["kl_ref"] = kl.detach()
    if pcfg.entropy_coef > 0.0:
        loss = loss - pcfg.entropy_coef * entropy_bonus(ent, resp_mask,
                                                        count=count)
    if "moe_lb_loss" in aux:
        term, info["moe_lb_loss"] = loss_rows.router_loss(cfg, aux, stats)
        loss = loss + term
    info["entropy"] = masked_mean(ent, resp_mask, count=count).detach()
    return loss, info


def trainable(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """A model's (actor's or critic's) parameters in the order the
    optimizer state holds."""
    return list(model.parameters())


def _grad_step(model: torch.nn.Module, opt_state, ocfg: adamw.AdamWConfig,
               loss_fn, rows: LossRows
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                          Dict[str, torch.Tensor]]:
    """One update of ``model``: ``loss_fn()`` (a loss with its graph and a
    dict of diagnostics) with the parameters requiring grad only inside,
    its backward, the gradients finished on the mesh (``rows.finish``),
    then AdamW in place, clipping by the global norm.  ``.grad`` is
    dropped once AdamW has stepped, so no model holds gradients between
    updates (a caller that needs them reads what ``adamw.update``
    receives).  Returns (the loss, detached; the diagnostics; AdamW's
    ``{"grad_norm", "lr"}``)."""
    params = trainable(model)
    for p in params:
        p.requires_grad_(True)
    try:
        loss, info = loss_fn()
        loss.backward()
    finally:
        for p in params:
            p.requires_grad_(False)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    rows.finish(model, grads)
    oinfo = adamw.update(ocfg, params, grads, opt_state, mesh=rows.mesh,
                         sharded=cut_flags(model))
    for p in params:
        p.grad = None
    return loss.detach(), info, oinfo


def _update_actor(model: M.LM, opt_state, cfg: ModelConfig,
                  pcfg: PolicyLossConfig, ocfg: adamw.AdamWConfig,
                  full_tokens, full_mask, resp_start: int, lp_old,
                  advantages, resp_mask, ref_lp, temperature: float,
                  top_p: float, rows: Optional[LossRows] = None,
                  count=None) -> Dict[str, torch.Tensor]:
    """One actor update (``_grad_step`` on the policy loss) of this data
    rank's ``rows`` of the batch arguments (one device's whole batch when
    None); ``count``: the whole batch's response tokens
    (``LossRows.count``)."""
    if rows is None:
        rows = LossRows(None, full_tokens.shape[0])
    loss, info, oinfo = _grad_step(model, opt_state, ocfg, lambda: (
        _actor_loss_fn(model, cfg, pcfg, full_tokens, full_mask, resp_start,
                       lp_old, advantages, resp_mask, ref_lp, temperature,
                       top_p, count=count, rows=rows.whole_rows,
                       loss_rows=rows)), rows)
    return {**rows.sum({**info, "loss": loss}), **oinfo}


@torch.no_grad()
def _values(critic: Critic, cfg: ModelConfig, full_tokens, full_mask,
            resp_start: int, mesh=None):
    """The critic's values of the response columns, no grad (the
    ``flash_attention`` kernel on the card; on the mesh over each data
    rank's rows, gathered whole)."""
    rows = DataRows(mesh, full_tokens.shape[0])
    v = forward_values(critic, cfg, rows.take(full_tokens),
                       rows.take(full_mask))[:, resp_start:]
    return rows.gather(v.contiguous())


def _update_critic(critic: Critic, opt_state, cfg: ModelConfig,
                   ocfg: adamw.AdamWConfig, full_tokens, full_mask,
                   resp_start: int, returns, old_values, resp_mask,
                   rows: Optional[LossRows] = None, count=None
                   ) -> Dict[str, torch.Tensor]:
    """One critic update (``_grad_step`` on the clipped value loss) of
    this data rank's ``rows`` (as ``_update_actor``).  Returns
    ``{"critic_loss", "grad_norm", "lr"}``."""
    if rows is None:
        rows = LossRows(None, full_tokens.shape[0])

    def loss_fn():
        v = forward_values(critic, cfg, full_tokens, full_mask)[:, resp_start:]
        return value_loss(v, returns, old_values, resp_mask,
                          count=count), {}

    loss, _, oinfo = _grad_step(critic, opt_state, ocfg, loss_fn, rows)
    return {**rows.sum({"critic_loss": loss}), **oinfo}


# ------------------------------------------------------------------ collector


class Collector:
    """The collection half of the RL loop: dataset sampling, the SPEC-RL
    rollout cache, the lenience schedule and the collection key stream,
    everything ``train_step`` needs to turn the model into a rewarded
    batch (DAPO's resample rounds included), and nothing it needs to
    update it.  The synchronous ``Trainer`` drives it in-process; the
    async rollout service (``serving/rollout_service.py``) drives the same
    object from the producer side with its own copy of the weights, so
    both share one sampling RNG, one key stream and one SPEC-RL cache (the
    K = 0 identity of ``rl/async_loop.py``)."""

    def __init__(self, model_cfg: ModelConfig, rl: RLConfig, spec: SpecConfig,
                 dataset: PromptDataset, key, lenience_schedule=None,
                 mesh=None, tracer=None):
        if mesh is not None:
            check_mesh_family(model_cfg, mesh)
        self.mesh = mesh          # the rollout runs on it (whole batch out)
        self.cfg = model_cfg
        self.rl = rl
        self.spec = spec
        self.lenience_schedule = lenience_schedule or FixedLenience(
            spec.lenience)
        self.dataset = dataset
        self.key = key
        self.cache = RolloutCache(history=spec.cache_history,
                                  max_prompts=spec.cache_max_prompts,
                                  group_size=rl.group_size)
        self.gen = GenerateConfig(max_new_tokens=rl.max_new_tokens,
                                  temperature=rl.temperature, top_p=rl.top_p,
                                  eos_id=EOS_ID, pad_id=PAD_ID)
        self.gen_steps = 0
        self.total_generated_tokens = 0
        self._py_rng = random.Random(1234)
        self.tracer = tracer if tracer is not None else get_tracer()

    def _stage(self, name: str, t0: float, times: Dict[str, float], key: str,
               step: int) -> float:
        """Close a collect stage: record its duration under ``key``, emit a
        'trainer'-lane span and a train.* histogram sample."""
        return _close_stage(self.tracer, name, t0, times, key, step)

    def sample(self, epoch: int,
               batch: Optional[PromptBatch] = None) -> PromptBatch:
        """Epoch-keyed batch draw from the shared Python RNG stream."""
        if batch is not None:
            return batch
        return self.dataset.sample_batch(self._py_rng,
                                         self.rl.prompts_per_batch,
                                         self.rl.group_size, epoch=epoch)

    def rollout_once(self, model: M.LM, batch: PromptBatch,
                     epoch: int) -> RolloutBatch:
        self.key, sub = split_key(self.key)
        cur_l = float(self.lenience_schedule(epoch))
        if cur_l != self.spec.lenience and self.spec.variant == "spec":
            self.spec = replace(self.spec, lenience=cur_l)
        rb = rollout(model, self.cfg, self.gen, self.spec, batch.tokens,
                     batch.mask, batch.cache_keys, self.cache, sub, epoch,
                     mesh=self.mesh)
        self.gen_steps += 1
        self.total_generated_tokens += rb.metrics["n_generated"]
        return rb

    def collect(self, model: M.LM, batch: PromptBatch, epoch: int
                ) -> Tuple[PromptBatch, RolloutBatch, np.ndarray,
                           Dict[str, float]]:
        """Rollout + reward (+ DAPO's dynamic sampling) under ``model``.

        DAPO re-rolls the prompt groups whose rewards have zero spread, up
        to ``max_resample_rounds`` times, through ``rollout_once`` at the
        same epoch (so through the SPEC-RL cache the first round has just
        filled, as in JAX), and merges the new rows in.  ``n_generated``
        and ``n_reused`` sum over the rounds; ``reward_time`` is the first
        round's."""
        t0 = time.perf_counter()
        rb = self.rollout_once(model, batch, epoch)
        t_reward0 = time.perf_counter()
        rewards = batch_rewards(rb.response, rb.length, batch.answers)
        rtimes: Dict[str, float] = {}
        self._stage("reward", t_reward0, rtimes, "reward_time", epoch)
        reward_time = rtimes["reward_time"]

        if self.rl.algo == "dapo" and self.rl.dynamic_sampling:
            G = self.rl.group_size
            for _ in range(self.rl.max_resample_rounds):
                degenerate = rewards.reshape(-1, G).std(axis=1) == 0.0
                if not degenerate.any():
                    break
                idxs = np.where(degenerate)[0]
                sub_batch = _subset_batch(batch, idxs, G)
                rb2 = self.rollout_once(model, sub_batch, epoch)
                r2 = batch_rewards(rb2.response, rb2.length,
                                   sub_batch.answers)
                rb = _merge_rollouts(rb, rb2, idxs, G)
                rewards = rewards.copy()
                rewards[_group_rows(idxs, G)] = r2

        stage_times = dict(rb.metrics)
        stage_times["reward_time"] = reward_time
        self._stage("collect", t0, stage_times, "collect_time", epoch)
        return batch, rb, rewards, stage_times


def _close_stage(tracer, name: str, t0: float, times: Dict[str, float],
                 key: str, step: int) -> float:
    """Record a stage's duration under ``key``, draw its span on the
    'trainer' lane and feed the train.* histogram; returns the end stamp."""
    t1 = time.perf_counter()
    times[key] = t1 - t0
    if tracer.enabled:
        tracer.complete(name, "trainer", t0, t1, cat="train", step=step)
    get_registry().observe(f"train.{name}_s", t1 - t0)
    return t1


def _group_rows(group_idxs: np.ndarray, G: int) -> np.ndarray:
    """The batch rows of the given prompt groups, group by group."""
    return np.concatenate([np.arange(g * G, (g + 1) * G) for g in group_idxs])


def _subset_batch(batch: PromptBatch, group_idxs: np.ndarray, G: int
                  ) -> PromptBatch:
    rows = _group_rows(group_idxs, G)
    return PromptBatch(
        tokens=batch.tokens[rows], mask=batch.mask[rows],
        cache_keys=[batch.cache_keys[r] for r in rows],
        answers=[batch.answers[r] for r in rows],
        problem_ids=[batch.problem_ids[r] for r in rows],
        epoch=batch.epoch)


def _merge_rollouts(rb: RolloutBatch, rb2: RolloutBatch,
                    group_idxs: np.ndarray, G: int) -> RolloutBatch:
    """``rb`` with the rows of the given groups taken from ``rb2`` (the
    prompts stay ``rb``'s), and ``n_generated``/``n_reused`` summed; the
    other metrics stay ``rb``'s."""
    rows = _group_rows(group_idxs, G)
    out = RolloutBatch(
        prompt=rb.prompt.copy(), prompt_mask=rb.prompt_mask.copy(),
        response=rb.response.copy(), response_mask=rb.response_mask.copy(),
        behaviour_logprobs=rb.behaviour_logprobs.copy(),
        length=rb.length.copy(), metrics=dict(rb.metrics), n=rb.n.copy())
    out.response[rows] = rb2.response
    out.response_mask[rows] = rb2.response_mask
    out.behaviour_logprobs[rows] = rb2.behaviour_logprobs
    out.length[rows] = rb2.length
    out.n[rows] = rb2.n
    for k in ("n_generated", "n_reused"):
        out.metrics[k] = rb.metrics.get(k, 0) + rb2.metrics.get(k, 0)
    return out


def _seed_from(key) -> int:
    """A 48-bit integer seed drawn from a key (for ``init_lm``)."""
    u = key.uniform((2,)).double().cpu()
    return int(u[0] * 2 ** 24) << 24 | int(u[1] * 2 ** 24)


# ------------------------------------------------------------------ trainer


class Trainer:
    def __init__(self, model_cfg: ModelConfig, rl: RLConfig, spec: SpecConfig,
                 dataset: PromptDataset, key, *,
                 model: Optional[M.LM] = None, device: DeviceLike = None,
                 lenience_schedule=None, mesh=None, watchdog=None,
                 tracer=None, alerts=None):
        if isinstance(mesh, MeshConfig):
            mesh = mesh.build(model.device if model is not None else device)
        if mesh is not None:
            check_mesh_family(model_cfg, mesh)
        # the §8 mesh: None (or a MeshConfig that found too few ranks) is
        # the single-device path
        self.mesh = mesh
        self.cfg = model_cfg
        self.rl = rl
        k1, k2, k3, coll_key = key.split(4)
        self.collector = Collector(model_cfg, rl, spec, dataset, coll_key,
                                   lenience_schedule=lenience_schedule,
                                   mesh=mesh, tracer=tracer)
        if model is None:
            model = M.init_lm(model_cfg, seed=_seed_from(k1),
                              device=resolve_device(device))
        elif device is not None and model.device != resolve_device(device):
            raise ValueError(f"model is on {model.device}, device={device!r}")
        # every rank draws (or is handed) the whole model and keeps its cut
        model = shard_params(mesh, model_cfg, model)
        self.model = model
        self.device = model.device
        # the moments in the parameters' layout (JAX's shard_opt_state)
        self.opt_state = adamw.init(trainable(model))
        self.pcfg = rl.policy_cfg()
        self.ref_model = None
        if self.pcfg.kl_coef > 0:
            self.ref_model = clone_module(model)
            self.ref_model.requires_grad_(False)
        self.critic: Optional[Critic] = None
        if rl.algo == "ppo":
            self.critic = shard_params(mesh, model_cfg, init_critic(
                model_cfg, seed=_seed_from(k2), device=self.device))
            self.critic_opt_state = adamw.init(trainable(self.critic))
        self.step_idx = 0
        self.history: List[Dict[str, float]] = []
        # §10 watchdog (rl/watchdog.py): snapshots on healthy steps,
        # restore-last-good + skip-the-batch on a non-finite loss or a
        # stalled rollout stage.  None = no monitoring (the default).
        self.watchdog = watchdog
        # §14 alerts (obs/alerts.py): evaluated on every step's flat
        # metrics; events trace on the 'alerts' lane and, with a watchdog
        # attached, feed its degradation counters
        self.alerts = alerts
        if alerts is not None and alerts.watchdog is None:
            alerts.watchdog = watchdog
        self.tracer = tracer if tracer is not None else get_tracer()
        self.last_rb: Optional[RolloutBatch] = None

    # ------------------------------------------- collection-state delegation

    @property
    def spec(self) -> SpecConfig:
        return self.collector.spec

    @spec.setter
    def spec(self, v) -> None:
        self.collector.spec = v

    @property
    def dataset(self) -> PromptDataset:
        return self.collector.dataset

    @property
    def gen(self) -> GenerateConfig:
        return self.collector.gen

    @property
    def lenience_schedule(self):
        return self.collector.lenience_schedule

    @property
    def cache(self) -> RolloutCache:
        return self.collector.cache

    @cache.setter
    def cache(self, v) -> None:
        self.collector.cache = v

    @property
    def key(self):
        return self.collector.key

    @key.setter
    def key(self, v) -> None:
        self.collector.key = v

    @property
    def gen_steps(self) -> int:
        return self.collector.gen_steps

    @gen_steps.setter
    def gen_steps(self, v) -> None:
        self.collector.gen_steps = v

    @property
    def total_generated_tokens(self):
        return self.collector.total_generated_tokens

    @total_generated_tokens.setter
    def total_generated_tokens(self, v) -> None:
        self.collector.total_generated_tokens = v

    @property
    def _py_rng(self) -> random.Random:
        return self.collector._py_rng

    # -------------------------------------------------------------- training

    def _stage(self, name: str, t0: float, times: Dict[str, float],
               key: str) -> float:
        """Close a trainer stage once the device is done with it: its
        duration under ``key``, a 'trainer'-lane span and a train.*
        histogram sample.  Returns the end stamp."""
        sync(self.device)
        return _close_stage(self.tracer, name, t0, times, key, self.step_idx)

    def _collect(self, batch: PromptBatch):
        return self.collector.collect(self.model, batch, self.step_idx)

    def train_step(self, batch: Optional[PromptBatch] = None
                   ) -> Dict[str, float]:
        batch = self.collector.sample(self.step_idx, batch)
        t_step0 = time.perf_counter()
        batch, rb, rewards, times = self._collect(batch)
        return self.optimize(rb, rewards, times, t_step0=t_step0)

    def optimize(self, rb: RolloutBatch, rewards: np.ndarray,
                 times: Dict[str, float], *, behaviour_lp=None,
                 is_clip: Optional[float] = None,
                 extra_metrics: Optional[Dict[str, float]] = None,
                 t_step0: Optional[float] = None) -> Dict[str, float]:
        """The optimization half of ``train_step``: old log-probs → (ref) →
        (values) → advantages → (critic update) → actor update, on an
        already-collected and rewarded rollout.  ``behaviour_lp`` (with cap
        ``is_clip``) switches on the truncated importance weights of stale
        trajectories; ``None`` leaves the update the synchronous one.
        ``extra_metrics`` (the async loop's provenance) joins the step's
        metrics before the watchdog sees them.  On the mesh the batch is
        the whole one on every rank (module docstring)."""
        if t_step0 is None:
            t_step0 = time.perf_counter()
        self.last_rb = rb
        dev = self.device
        P = rb.prompt.shape[1]
        N = rb.response.shape[1]
        full_tokens = torch.as_tensor(
            np.concatenate([rb.prompt, rb.response], 1), dtype=torch.int32,
            device=dev)
        full_mask = torch.as_tensor(
            np.concatenate([rb.prompt_mask, rb.response_mask], 1),
            dtype=torch.bool, device=dev)
        resp_mask = torch.as_tensor(rb.response_mask, dtype=torch.bool,
                                    device=dev)
        lengths = torch.as_tensor(rb.length, device=dev)
        rew = torch.as_tensor(np.asarray(rewards, np.float32), device=dev)

        # ---- old log-probs (veRL stage; ratio == 1 at the first epoch) ----
        t0 = time.perf_counter()
        mesh = self.mesh
        lp_old, _ = _old_logprobs(self.model, self.cfg, full_tokens,
                                  full_mask, P, self.rl.temperature,
                                  self.rl.top_p, mesh=mesh)
        self._stage("old_logprob", t0, times, "old_logprob_time")

        ref_lp = torch.zeros_like(lp_old)
        if self.ref_model is not None:
            t0 = time.perf_counter()
            ref_lp, _ = _old_logprobs(self.ref_model, self.cfg, full_tokens,
                                      full_mask, P, self.rl.temperature,
                                      self.rl.top_p, mesh=mesh)
            self._stage("ref", t0, times, "ref_time")

        # ---- advantages ----------------------------------------------------
        t0 = time.perf_counter()
        old_values = returns = None
        if self.rl.algo == "ppo":
            tv = time.perf_counter()
            values = _values(self.critic, self.cfg, full_tokens,
                             full_mask, P, mesh=mesh)
            self._stage("values", tv, times, "values_time")
            rew_tok = terminal_reward_to_tokens(rew, lengths, N)
            adv, returns = gae_advantages(rew_tok, values, resp_mask,
                                          gamma=self.rl.gamma,
                                          lam=self.rl.gae_lambda)
            old_values = values
            if self.rl.whiten_adv:
                adv = whiten(adv, resp_mask)
        else:
            scalar_adv = group_relative_advantages(rew, self.rl.group_size)
            adv = scalar_adv[:, None] * resp_mask.float()
        if behaviour_lp is not None:
            # truncated per-token importance weights w = min(cap,
            # exp(lp_now - lp_behaviour)) fold into the advantages
            blp = torch.as_tensor(np.asarray(behaviour_lp),
                                  dtype=torch.float32, device=dev)
            cap = float(is_clip) if is_clip is not None else 2.0
            w = torch.clamp_max(torch.exp(lp_old - blp), cap) \
                * resp_mask.float()
            adv = adv * w
            times["is_weight_mean"] = float(masked_mean(w, resp_mask))
        self._stage("adv", t0, times, "adv_time")

        # ---- updates: on the mesh this data rank's rows, the whole
        # batch's counts ---------------------------------------------------
        rows = LossRows(mesh, resp_mask.shape[0])
        count = rows.count(resp_mask)
        take = rows.take
        full_tokens, full_mask, resp_mask, lp_old, adv, ref_lp = (
            take(x) for x in (full_tokens, full_mask, resp_mask, lp_old, adv,
                              ref_lp))
        cinfo = {}
        if self.rl.algo == "ppo":
            t0 = time.perf_counter()
            cinfo = _update_critic(self.critic, self.critic_opt_state,
                                   self.cfg, self.rl.critic_optim,
                                   full_tokens, full_mask, P, take(returns),
                                   take(old_values), resp_mask, rows,
                                   count)
            self._stage("update_critic", t0, times, "update_critic_time")

        t0 = time.perf_counter()
        if dev.type == "cuda":
            # the rollout's caches are gone: hand their blocks back, so the
            # update's float32 (B, L, V) logits find room in one piece
            torch.cuda.empty_cache()
        info = _update_actor(self.model, self.opt_state, self.cfg, self.pcfg,
                             self.rl.optim, full_tokens, full_mask, P, lp_old,
                             adv, resp_mask, ref_lp, self.rl.temperature,
                             self.rl.top_p, rows, count)
        t_end = self._stage("update_actor", t0, times, "update_actor_time")
        get_registry().observe("train.train_step_s", t_end - t_step0)
        if self.tracer.enabled:
            # the whole-step span encloses the stage spans on the same lane
            self.tracer.complete("train_step", "trainer", t_step0, t_end,
                                 cat="train", step=self.step_idx)

        self.lenience_schedule.update(abs(float(info.get("approx_kl", 0.0))))
        metrics = {
            "step": self.step_idx,
            "lenience": float(self.spec.lenience),
            "reward_mean": float(np.asarray(rewards).mean()),
            "response_len_mean": float(np.asarray(rb.length).mean()),
            "total_generated_tokens": self.total_generated_tokens,
            "gen_steps": self.gen_steps,
            **{k: float(v) for k, v in info.items()},
            # PPO: the critic's grad_norm and lr replace the actor's, as in
            # JAX's step log
            **{k: float(v) for k, v in cinfo.items()},
            **{k: float(v) for k, v in times.items()
               if isinstance(v, (int, float))},
        }
        if extra_metrics:
            # async-loop provenance (staleness, buffer counters, mode) joins
            # the flat namespace BEFORE the watchdog sees the step
            metrics.update({k: float(v) for k, v in extra_metrics.items()})
        led = get_ledger()
        if led.enabled:
            # §14: cumulative provenance counts join the step log (the
            # savings attribution divides exactly these) and mirror into the
            # global registry, so an events.jsonl dump feeds
            # `launch.analysis attrib` offline
            greg = get_registry()
            for cname, nv in led.counts_dict().items():
                metrics[f"ledger_tokens_{cname}"] = float(nv)
                greg.set(f"ledger.tokens_{cname}", float(nv), agg="max")
            metrics["ledger_finalized"] = float(led.finalized)
            metrics["ledger_violations"] = float(led.violations)
        # §11: the step log goes through a MetricsRegistry, the audited
        # flat-float namespace the trainer shares with the other surfaces
        metrics = MetricsRegistry.from_flat(metrics).as_dict()
        if self.alerts is not None:
            # evaluated BEFORE the watchdog, so a critical alert's counters
            # show in the same step log
            self.alerts.evaluate(metrics, self.step_idx)
            metrics.update(self.alerts.as_dict())
        if self.watchdog is not None:
            # may restore the weights, moments and cache to the last
            # snapshot in place (the poisoned update is undone; step_idx
            # still advances below, so the bad batch is skipped, not
            # replayed) — and always folds its counters into the metrics
            self.watchdog.after_step(self, metrics)
        dec = get_decision_log()
        if dec.enabled:
            dec.flush()      # decision shards hit disk once a step
        self.history.append(metrics)
        self.step_idx += 1
        return metrics

    def train(self, num_steps: int, log_every: int = 10,
              callback=None) -> List[Dict[str, float]]:
        for _ in range(num_steps):
            m = self.train_step()
            if callback and (m["step"] % log_every == 0):
                callback(m)
        return self.history
