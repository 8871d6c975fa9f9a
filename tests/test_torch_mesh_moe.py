"""The MoE family on the port's §8 mesh: a (2, 2) ``gloo`` mesh of four
spawned CPU ranks held against JAX's single device in the pytest process
(JAX's mesh is GSPMD, which computes the global function: its results are
the single device's).

One module-scoped spawn (``distributed/mesh.py:run_ranks``, torch on one
thread a rank) runs every scenario while this process computes JAX's
references; each scenario is then its own test case.  Weights are JAX's
draws carried across with ``from_jax_params``; keys draw with
``jax.random`` (``JaxKey``, ``JaxKeyBatch``).  Three reduced MoE configs
under GQA attention (two layers, d 64, 4 query / 2 KV heads), both router
coefficients at 1.0 so that a wrong router gradient shows:

* ``ep``: 4 experts, top 2, ``dispatch`` with ``capacity_factor`` 0.5
  (tokens drop): expert-parallel at model 2, two experts a rank;
* ``tp``: 3 experts, ``dense``: the axis does not divide E, so each
  expert is tensor-parallel on its ``d_ff`` of 32;
* ``shared``: a dense FFN layer, then a MoE layer with one shared expert
  (``dispatch``).

Held: ``generate`` on each (tokens and lengths equal, log-probs within
1e-4) and ``moe_aux`` of its rows (``moe_drop_frac`` and
``moe_expert_frac`` within 1e-6, the router losses rtol 1e-5); on ``ep``
the one-pass and two-pass rollouts, slot backfill (``MeshSlotServer``),
the paged layout, a drafted rollout and ``MeshSlotServer`` itself; each
config's gradient shards of the GRPO actor loss with its router losses
over data shards of different token counts, and a batch the data axis
does not divide (every gradient shard within 1e-5 of its leaf's largest
of ``jax.grad``); GRPO and DAPO ``optimize`` with uneven masks, one PPO
``optimize`` (a MoE critic trunk), and ``make_train_step`` with two
chunked microbatches (gradient shards within 1e-5, parameters within
``_update_tol``, loss and grad norm rtol 1e-4, ``moe_lb_loss`` rtol
1e-5); the GRPO trainer's watchdog snapshot (whole 3-D expert tensors,
read by JAX's loader) and its restore; ``sort`` and ``moe_groups``
refused on a data axis of 2 and ``sort`` run on a (1, 4) mesh; the
families still refused on a mesh; and ``launch/serve.py`` and
``launch/train.py --arch mixtral-8x22b`` under ``torchrun``.  About two
minutes alone (the ranks' half-minute overlaps JAX's references).
"""
import copy
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import RolloutCache as JaxRolloutCache  # noqa: E402
from repro.core import SpecConfig as JaxSpecConfig  # noqa: E402
from repro.core import rollout as jax_rollout  # noqa: E402
from repro.checkpoint.io import load_pytree as jax_load_pytree  # noqa: E402
from repro.core.spec_rollout import RolloutBatch as JaxRolloutBatch  # noqa: E402
from repro.drafting import DraftConfig as JaxDraftConfig  # noqa: E402
from repro.engine.generate import GenerateConfig as JaxGenerateConfig  # noqa: E402
from repro.engine.generate import generate as jax_generate  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.rl import trainer as jax_trainer  # noqa: E402
from repro.rl.losses import PolicyLossConfig as JaxPolicyLossConfig  # noqa: E402
from repro.rl.trainer import RLConfig as JaxRLConfig  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import make_slot_engine as jax_make_slot_engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RolloutCache, SpecConfig, rollout  # noqa: E402
from repro_torch.core.spec_rollout import RolloutBatch  # noqa: E402
from repro_torch.data.tokenizer import VOCAB_SIZE  # noqa: E402
from repro_torch.distributed import mesh as mesh_module  # noqa: E402
from repro_torch.distributed.mesh import (LossRows, MeshConfig,  # noqa: E402
                                          model_rank, param_specs,
                                          region_params, run_ranks,
                                          shard_params)
from repro_torch.drafting import DraftConfig  # noqa: E402
from repro_torch.engine.generate import (GenerateConfig, generate,  # noqa: E402
                                         moe_aux)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.rl import trainer as port_trainer  # noqa: E402
from repro_torch.rl import async_loop, watchdog  # noqa: E402
from repro_torch.rl.async_loop import AsyncConfig, AsyncTrainer  # noqa: E402
from repro_torch.rl.critic import critic_from_jax_params  # noqa: E402
from repro_torch.rl.losses import PolicyLossConfig  # noqa: E402
from repro_torch.rl.trainer import RLConfig, Trainer  # noqa: E402
from repro_torch.rl.watchdog import TrainWatchdog, WatchdogConfig  # noqa: E402
from repro_torch.core.backoff import BackoffConfig  # noqa: E402
from repro_torch.serving import (Request, SlotEngine,  # noqa: E402
                                 make_slot_engine)
from repro_torch.serving.rollout_service import WeightSync  # noqa: E402
from test_torch_mesh import (_assert_responses, _inputs,  # noqa: E402
                             _kill_requests, _responses, _step_keys)
from test_torch_mesh_train import (_local, _mine, _named, _np,  # noqa: E402
                                   _spy_update, _steps_batch)
from test_torch_rollout import JaxKey, JaxKeyBatch  # noqa: E402
from test_torch_train import (LOSS_RTOL, TOL, _capture_jax_grads,  # noqa: E402
                              _datasets, _mixed_rewards, _update_tol)

ATOL = 1e-4             # log-probs: the model axis sums in another order
AUX_TOL = 1e-6          # moe_drop_frac, moe_expert_frac
AUX_RTOL = 1e-5         # the router losses
GRAD_RTOL = 1e-5        # a gradient shard, of its leaf's largest magnitude
WORLD = 4
LR = 1e-3
N_NEW = 10
ROOT = Path(__file__).resolve().parents[1]


def _moe(**kw):
    base = dict(name="mesh-moe", arch_type="moe", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=VOCAB_SIZE,
                max_seq_len=256, num_experts=4, num_experts_per_tok=2,
                moe_d_ff=32, moe_impl="dispatch", router_aux_coef=1.0,
                router_z_coef=1.0)
    base.update(kw)
    return base


CFGS = {"ep": _moe(capacity_factor=0.5),
        "tp": _moe(num_experts=3, moe_impl="dense"),
        "shared": _moe(num_shared_experts=1, first_dense_layers=1)}
# coupled across the data axis: refused there, run on a (1, 4) mesh
SORT = _moe(moe_impl="sort", capacity_factor=0.5)
GROUPS = _moe(moe_groups=2)
REFUSED = ("deepseek-v3-671b", "jamba-v0.1-52b", "rwkv6-3b", "pixtral-12b",
           "whisper-tiny")
PAGED = dict(cache_layout="paged", kv_block_size=4)


def _jax_trainer(algo="grpo", cfg_key="ep"):
    jds, _ = _datasets()
    return jax_trainer.Trainer(
        JaxModelConfig(**CFGS[cfg_key]),
        JaxRLConfig(optim=jax_adamw.AdamWConfig(lr=LR),
                    critic_optim=jax_adamw.AdamWConfig(lr=LR),
                    **_rl_kw(algo)),
        JaxSpecConfig(), jds, jax.random.PRNGKey(0))


def _rl_kw(algo):
    return dict(algo=algo, group_size=4, prompts_per_batch=2,
                max_new_tokens=6)


def _rollout_batch(B=8, P=4, N=6, seed=0):
    """A rewarded rollout whose two data shards (rows 0-3, 4-7) hold
    different numbers of response tokens, with left-padded prompts."""
    rng = np.random.default_rng(seed)
    pm = np.ones((B, P), bool)
    pm[1, :2] = pm[5, :1] = False
    lengths = np.array([6, 2, 5, 1, 6, 6, 4, 6], np.int32)[:B]
    rm = np.arange(N)[None] < lengths[:, None]
    prompt = rng.integers(3, VOCAB_SIZE - 1, (B, P)).astype(np.int32) * pm
    resp = rng.integers(3, VOCAB_SIZE - 1, (B, N)).astype(np.int32) * rm
    return dict(prompt=prompt, prompt_mask=pm, response=resp,
                response_mask=rm, length=lengths,
                behaviour_logprobs=(-rng.random((B, N)) * 3 * rm).astype(
                    np.float32),
                rewards=_mixed_rewards(B, 4))


def _grad_batch(B, P=4, N=6, seed=0):
    rb = _rollout_batch(seed=seed)
    rng = np.random.default_rng(seed + 1)
    rm = rb["response_mask"][:B]
    return dict(tokens=np.concatenate([rb["prompt"], rb["response"]], 1)[:B],
                mask=np.concatenate([rb["prompt_mask"],
                                     rb["response_mask"]], 1)[:B],
                resp_mask=rm, P=P,
                lp_old=(-rng.random((B, N)) * 3).astype(np.float32),
                adv=(rng.normal(0, 1, (B, N)) * rm).astype(np.float32),
                ref_lp=(-rng.random((B, N)) * 3).astype(np.float32))


# (config, rows, policy-loss settings): the data shards' token counts
# differ; five rows the data axis does not divide run whole on every rank
GRAD_CASES = {"ep": ("ep", 8, dict(agg="seq", kl_coef=0.5)),
              "tp": ("tp", 8, dict(agg="token", kl_coef=0.5)),
              "shared": ("shared", 8, dict(agg="seq", kl_coef=0.5)),
              "ep_5_rows": ("ep", 5, dict(agg="token", kl_coef=0.5))}


def _data():
    """Everything both sides share, as numpy."""
    params = {"ep": _jax_trainer().params}
    for i, k in enumerate(("tp", "shared")):
        params[k] = JM.init_lm(jax.random.PRNGKey(10 + i),
                               JaxModelConfig(**CFGS[k]))
    params["sort"] = JM.init_lm(jax.random.PRNGKey(20),
                                JaxModelConfig(**SORT))
    roll = _inputs(8, 9)
    return {
        "params": {k: jax.tree.map(np.asarray, p) for k, p in params.items()},
        "critic": jax.tree.map(np.asarray, _jax_trainer("ppo").critic_params),
        "gen": _inputs(8, 9, seed=3), "roll": roll,
        "roll_keys": _step_keys(roll[2], 2),
        "kill": _kill_requests(), "rb": _rollout_batch(),
        "grad": {name: _grad_batch(b) for name, (_, b, _) in
                 GRAD_CASES.items()},
        "steps": _steps_batch()}


# ------------------------------------------------------------ the ranks


def _rb(rb):
    return {"response": rb.response, "response_mask": rb.response_mask,
            "length": rb.length, "lp": rb.behaviour_logprobs,
            "metrics": dict(rb.metrics)}


def _with_response(prompts, mask, out):
    """[prompt | response] and its mask, from a ``generate`` output."""
    toks = np.asarray(out["tokens"])
    m = np.arange(toks.shape[1])[None] < np.asarray(out["length"])[:, None]
    return np.concatenate([prompts, toks], 1), np.concatenate([mask, m], 1)


def _rank_generate(mesh, cfgs, cut, data):
    out = {}
    prompts, mask, keys = data["gen"]
    for k, cfg in cfgs.items():
        g = generate(cut[k], cfg, GenerateConfig(max_new_tokens=N_NEW,
                                                 eos_id=VOCAB_SIZE - 1),
                     prompts, mask, JaxKeyBatch(keys), mesh=mesh)
        g = {n: g[n].numpy() for n in ("tokens", "logprobs", "length")}
        toks, m = _with_response(prompts, mask, g)
        aux = moe_aux(cut[k], cfg, toks, m, mesh=mesh)
        out[k] = {"gen": g, "aux": {n: v.numpy() for n, v in aux.items()}}
    return out


def _rank_rollouts(mesh, cfg, cut, full, data):
    """The ``ep`` config's rollouts: two epochs each of the one-pass and
    two-pass branches, slot backfill, the paged layout and a drafted
    rollout; then ``MeshSlotServer`` on ungrouped requests."""
    gen = GenerateConfig(max_new_tokens=N_NEW, eos_id=VOCAB_SIZE - 1)
    prompts, mask, _ = data["roll"]
    ids = list(range(8))
    out = {}
    draft = DraftConfig(kind="ngram", draft_k=4)
    for name, c, spec in (
            ("one_pass", cfg, SpecConfig(variant="spec")),
            ("two_pass", cfg, SpecConfig(variant="spec", one_pass="off")),
            ("slots", cfg, SpecConfig(variant="spec", backfill="slots")),
            ("paged", cfg.replace(**PAGED), SpecConfig(variant="spec")),
            ("drafted", cfg, SpecConfig(variant="spec", draft=draft))):
        cache = RolloutCache(group_size=2) if name == "drafted" else \
            RolloutCache()
        out[name] = [_rb(rollout(cut, c, gen, spec, prompts, mask, ids,
                                 cache, JaxKeyBatch(k), step, mesh=mesh))
                     for step, k in enumerate(data["roll_keys"])]
    srv = make_slot_engine(full, cfg, gen, mesh=mesh, num_slots=4,
                           prompt_width=8)
    for r in data["kill"]:
        srv.submit(Request(**copy.deepcopy(r)))
    out["server"] = _responses(srv.run())
    return out


def _rank_grads(mesh, cut, cfg, b, loss_kw):
    """A rank's finished gradient shards of the GRPO actor loss with its
    router losses, and the step log's values (whole batch)."""
    t = {k: torch.as_tensor(v) for k, v in b.items() if k != "P"}
    rows = LossRows(mesh, t["resp_mask"].shape[0])
    params = list(cut.parameters())
    for p in params:
        p.requires_grad_(True)
    try:
        loss, info = port_trainer._actor_loss_fn(
            cut, cfg, PolicyLossConfig(**loss_kw), rows.take(t["tokens"]),
            rows.take(t["mask"]), b["P"], rows.take(t["lp_old"]),
            rows.take(t["adv"]), rows.take(t["resp_mask"]),
            rows.take(t["ref_lp"]), 1.0, 1.0,
            count=rows.count(t["resp_mask"]), rows=rows.whole_rows,
            loss_rows=rows)
        loss.backward()
    finally:
        for p in params:
            p.requires_grad_(False)
    grads = [p.grad for p in params]
    for p in params:
        p.grad = None
    rows.finish(cut, grads)
    names = [n for n, _ in cut.named_parameters()]
    total = rows.sum({"loss": loss.detach(), **info})
    return {"grads": _np(dict(zip(names, grads))), "sharded": rows.sharded,
            "info": {k: float(v) for k, v in total.items()},
            "specs": param_specs(cut), "model_rank": model_rank(mesh)}


def _trainer(mesh, data, algo):
    """The ``ep`` config's trainer on the mesh, from JAX's weights."""
    cfg = ModelConfig(**CFGS["ep"])
    _, ds = _datasets()
    rl = RLConfig(optim=adamw.AdamWConfig(lr=LR),
                  critic_optim=adamw.AdamWConfig(lr=LR), **_rl_kw(algo))
    tr = Trainer(cfg, rl, SpecConfig(), ds, JaxKey(jax.random.PRNGKey(0)),
                 model=from_jax_params(data["params"]["ep"], cfg,
                                       device="cpu"),
                 device="cpu", mesh=mesh)
    if tr.critic is not None:
        tr.critic = shard_params(mesh, cfg, critic_from_jax_params(
            data["critic"], cfg, device="cpu"))
        tr.critic_opt_state = adamw.init(port_trainer.trainable(tr.critic))
    return tr


def _rank_async(mesh, data):
    """One ``"pc"`` step of the async loop over the MoE trainer: the
    service's model is cut as the trainer's, and once it has polled the
    published snapshot it holds the trainer's shards bit for bit."""
    tr = _trainer(mesh, data, "grpo")
    at = AsyncTrainer(tr, AsyncConfig(staleness_window=0, buffer_capacity=2,
                                      schedule="pc"), sync=WeightSync(
        BackoffConfig(base=0.0, max_attempts=3), sleep=lambda d: None))
    m = at.run(1)[0]
    at.service._maybe_sync()
    served = at.service.model
    return {"loss": float(m["loss"]),
            "equal": all(torch.equal(a, b) for a, b in zip(
                served.parameters(), tr.model.parameters())),
            "cut": [(mod.expert_group is not None, mod.expert_lo)
                    for mod in served.modules()
                    if hasattr(mod, "expert_group")]}


def _rank_optimize(mesh, data, algo, ckpt_dir=None):
    tr = _trainer(mesh, data, algo)
    b = data["rb"]
    rb = RolloutBatch(**{k: v for k, v in b.items() if k != "rewards"},
                      metrics={})
    seen = {}
    update = _spy_update(seen)
    try:
        m = tr.optimize(rb, b["rewards"], {})
    finally:
        adamw.update = update
    names = [n for n, _ in tr.model.named_parameters()]
    out = {"metrics": {k: float(v) for k, v in m.items()
                       if not k.endswith("_time")},
           "params": _local(tr.model), "specs": param_specs(tr.model),
           "grads": _np(dict(zip(names, seen[id(next(
               tr.model.parameters()))])))}
    if tr.critic is not None:
        cn = [n for n, _ in tr.critic.named_parameters()]
        out["critic"] = _local(tr.critic)
        out["critic_grads"] = _np(dict(zip(cn, seen[id(next(
            tr.critic.parameters()))])))
    if ckpt_dir is not None:
        # a watchdog snapshot (whole trees, rank 0 writes), the weights
        # and moments poisoned, the restore cutting them back
        wd = TrainWatchdog(WatchdogConfig(checkpoint_dir=ckpt_dir))
        state = list(tr.model.parameters()) + tr.opt_state["mu"] \
            + tr.opt_state["nu"]
        keep = [t.clone() for t in state]
        wd.snapshot(tr)
        with torch.no_grad():
            for t in state:
                t.fill_(float("nan"))
        out["restored"] = wd.restore(tr) and all(
            torch.equal(a, b) for a, b in zip(state, keep))
    return out


def _rank_train_step(mesh, data):
    """``make_train_step`` with two chunked microbatches on ``ep``."""
    cfg = ModelConfig(**CFGS["ep"])
    model = shard_params(mesh, cfg, from_jax_params(data["params"]["ep"],
                                                    cfg, device="cpu"))
    b = data["steps"]
    seen = {}
    update = _spy_update(seen)
    try:
        step = steps.make_train_step(
            cfg, adamw.AdamWConfig(lr=LR, clip_norm=1e9), mesh=mesh,
            ce_impl="chunked", ce_chunk=4, microbatch=2)
        _, _, loss, gnorm = step(model, adamw.init(list(model.parameters())),
                                 b["tokens"], b["positions"])
    finally:
        adamw.update = update
    names = [n for n, _ in model.named_parameters()]
    return {"loss": float(loss), "grad_norm": float(gnorm),
            "params": _local(model), "specs": param_specs(model),
            "grads": _np(dict(zip(names, seen[id(next(
                model.parameters()))])))}


def _refusal(mesh, cfg) -> str:
    try:
        shard_params(mesh, cfg, None)
    except NotImplementedError as e:
        return str(e)
    return ""


def _rank_main(rank, path, ckpt_dir):
    SlotEngine.key_type = JaxKeyBatch      # requests carry JAX key words
    # gradient sums, norms and updates a piece of 4,096 elements at a time
    # (``mesh.pieces``), as a full-size expert stack's go
    mesh_module.GRAD_BUCKET = 4096
    with open(path, "rb") as f:
        data = pickle.load(f)
    mesh = MeshConfig(data=2, model=2, require=True).build("cpu")
    cfgs = {k: ModelConfig(**kw) for k, kw in CFGS.items()}
    full = {k: from_jax_params(data["params"][k], cfgs[k], device="cpu")
            for k in cfgs}
    cut = {k: shard_params(mesh, cfgs[k], m) for k, m in full.items()}
    out = {"layout": {k: (param_specs(m)["layers.1.moe.w_gate"],
                          m.layers[1].moe.expert_lo, sorted(region_params(m)))
                      for k, m in cut.items()}}
    out["generate"] = _rank_generate(mesh, cfgs, cut, data)
    out["rollouts"] = _rank_rollouts(mesh, cfgs["ep"], cut["ep"], full["ep"],
                                     data)
    out["grads"] = {name: _rank_grads(mesh, cut[k], cfgs[k],
                                      data["grad"][name], loss_kw)
                    for name, (k, _, loss_kw) in GRAD_CASES.items()}
    for mod in (watchdog, async_loop):
        mod.key_state = lambda k: np.asarray(k.key, np.int64)
        mod.key_from_state = lambda w, dev: JaxKey(
            jnp.asarray(np.asarray(w, np.int64), jnp.uint32))
    async_loop.make_key = lambda seed, device=None: JaxKey(
        jax.random.PRNGKey(seed))
    for algo in ("grpo", "dapo", "ppo"):
        out[algo] = _rank_optimize(
            mesh, data, algo, ckpt_dir if algo == "grpo" else None)
    out["async"] = _rank_async(mesh, data)
    out["train_step"] = _rank_train_step(mesh, data)
    out["refused"] = {
        "sort": _refusal(mesh, ModelConfig(**SORT)),
        "groups": _refusal(mesh, ModelConfig(**GROUPS)),
        **{a: _refusal(mesh, get_config(a).reduced()) for a in REFUSED}}
    # sort runs where the data axis is 1: one expert a rank on (1, 4)
    mesh14 = MeshConfig(data=1, model=4, require=True).build("cpu")
    sort = ModelConfig(**SORT)
    prompts, mask, keys = data["gen"]
    g = generate(shard_params(mesh14, sort, from_jax_params(
        data["params"]["sort"], sort, device="cpu")), sort,
        GenerateConfig(max_new_tokens=N_NEW, eos_id=VOCAB_SIZE - 1),
        prompts, mask, JaxKeyBatch(keys), mesh=mesh14)
    out["sort_1x4"] = {n: g[n].numpy() for n in ("tokens", "logprobs",
                                                 "length")}
    return out


# ------------------------------------------------------------ JAX's side

_REFS = {}


def _memo(fn):
    """A reference computed once a module run (the fixture warms every
    one while the ranks run: ``_WARM``)."""
    def run(data, *args):
        key = (fn.__name__,) + args
        if key not in _REFS:
            _REFS[key] = fn(data, *args)
        return _REFS[key]
    run.__name__ = fn.__name__
    return run


def _jp(data, key):
    return jax.tree.map(jnp.asarray, data["params"][key])


@_memo
def _jax_gen(data, key):
    """JAX's generate, and its forward's aux over [prompt | response]."""
    prompts, mask, keys = data["gen"]
    jcfg, params = JaxModelConfig(**CFGS[key]), _jp(data, key)
    want = jax_generate(params, jcfg, JaxGenerateConfig(
        max_new_tokens=N_NEW, eos_id=VOCAB_SIZE - 1), jnp.asarray(prompts),
        jnp.asarray(mask), jnp.asarray(keys))
    want = {n: np.asarray(want[n]) for n in ("tokens", "logprobs", "length")}
    toks, m = _with_response(prompts, mask, want)
    pos = np.where(m, np.cumsum(m, 1) - 1, -1).astype(np.int32)
    _, jaux = JM.forward(params, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    return want, {n: np.asarray(v) for n, v in jaux.items()}


ROLL_SPECS = {"one_pass": dict(variant="spec"),
              "two_pass": dict(variant="spec", one_pass="off"),
              "slots": dict(variant="spec"),
              "paged": dict(variant="spec"),
              "drafted": dict(variant="spec", draft=JaxDraftConfig(
                  kind="ngram", draft_k=4))}


@_memo
def _jax_epochs(data, name):
    """JAX's two epochs of the ``ep`` rollout ``name`` (slot backfill's
    reference is the fixed batch)."""
    prompts, mask, _ = data["roll"]
    gen = JaxGenerateConfig(max_new_tokens=N_NEW, eos_id=VOCAB_SIZE - 1)
    cache = JaxRolloutCache(group_size=2) if name == "drafted" else \
        JaxRolloutCache()
    return [jax_rollout(_jp(data, "ep"), JaxModelConfig(**CFGS["ep"]), gen,
                        JaxSpecConfig(**ROLL_SPECS[name]),
                        jnp.asarray(prompts), jnp.asarray(mask),
                        list(range(8)), cache, jnp.asarray(k), step)
            for step, k in enumerate(data["roll_keys"])]


@_memo
def _jax_server(data):
    gen = JaxGenerateConfig(max_new_tokens=N_NEW, eos_id=VOCAB_SIZE - 1)
    eng = jax_make_slot_engine(_jp(data, "ep"),
                               JaxModelConfig(**CFGS["ep"]), gen,
                               num_slots=4, prompt_width=8)
    for r in data["kill"]:
        eng.submit(JaxRequest(**copy.deepcopy(r)))
    return eng.run()


@_memo
def _jax_sort(data):
    prompts, mask, keys = data["gen"]
    out = jax_generate(_jp(data, "sort"), JaxModelConfig(**SORT),
                       JaxGenerateConfig(max_new_tokens=N_NEW,
                                         eos_id=VOCAB_SIZE - 1),
                       jnp.asarray(prompts), jnp.asarray(mask),
                       jnp.asarray(keys))
    return {n: np.asarray(out[n]) for n in ("tokens", "logprobs", "length")}


@_memo
def _jax_grad_case(data, name):
    key, _, loss_kw = GRAD_CASES[name]
    jcfg = JaxModelConfig(**CFGS[key])
    b = data["grad"][name]

    def loss(p):
        return jax_trainer._actor_loss_fn(
            p, jcfg, JaxPolicyLossConfig(**loss_kw),
            jnp.asarray(b["tokens"]), jnp.asarray(b["mask"]), b["P"],
            jnp.asarray(b["lp_old"]), jnp.asarray(b["adv"]),
            jnp.asarray(b["resp_mask"]), jnp.asarray(b["ref_lp"]), 1.0, 1.0,
            jcfg.router_aux_coef, jcfg.router_z_coef)

    grad = jax.jit(jax.value_and_grad(loss, has_aux=True))
    (jloss, jinfo), jgrad = grad(_jp(data, key))
    return float(jloss), {k: float(v) for k, v in jinfo.items()}, _named(
        jax.tree.map(np.asarray, jgrad), ModelConfig(**CFGS[key]))


@_memo
def _jax_optimize(data, algo):
    """JAX's ``optimize`` of the shared rollout: its step log, the actor's
    ``jax.grad`` (``_capture_jax_grads``'s spy), the parameters before and
    after (and the critic's), by the port's names."""
    jtr = _jax_trainer(algo)
    cfg = ModelConfig(**CFGS["ep"])
    before = (_named(jax.tree.map(np.asarray, jtr.params), cfg),
              None if jtr.critic_params is None else _named(
                  jax.tree.map(np.asarray, jtr.critic_params), cfg,
                  critic=True))
    b = data["rb"]
    jrb = JaxRolloutBatch(**{k: v for k, v in b.items() if k != "rewards"},
                          metrics={})
    with pytest.MonkeyPatch.context() as mp:
        jgrads = _capture_jax_grads(mp)
        want = jtr.optimize(jrb, b["rewards"], {})
    return {"metrics": want, "before": before,
            "grad": _named(jax.tree.map(np.asarray, jgrads[0]), cfg),
            "params": _named(jax.tree.map(np.asarray, jtr.params), cfg),
            "critic": None if jtr.critic_params is None else _named(
                jax.tree.map(np.asarray, jtr.critic_params), cfg,
                critic=True)}


@_memo
def _jax_train_step(data):
    """JAX's ``make_train_step`` (two chunked microbatches): the updated
    parameters, loss, grad norm and the gradients AdamW received."""
    seen = []
    update = jax_adamw.update

    def spy(ocfg, params, grads, state):
        seen.append(grads)
        return update(ocfg, params, grads, state)

    b = data["steps"]
    params = _jp(data, "ep")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_adamw, "update", spy)
        p1, _, loss, gnorm = jax_steps.make_train_step(
            JaxModelConfig(**CFGS["ep"]),
            jax_adamw.AdamWConfig(lr=LR, clip_norm=1e9),
            ce_impl="chunked", ce_chunk=4, microbatch=2)(
            params, jax_adamw.init(params), jnp.asarray(b["tokens"]),
            jnp.asarray(b["positions"]))
    cfg = ModelConfig(**CFGS["ep"])
    return {"loss": float(loss), "grad_norm": float(gnorm),
            "grad": _named(jax.tree.map(np.asarray, seen[0]), cfg),
            "params": _named(jax.tree.map(np.asarray, p1), cfg)}


_WARM = ([(_jax_gen, (k,)) for k in CFGS]
         + [(_jax_epochs, (n,)) for n in ROLL_SPECS]
         + [(_jax_server, ()), (_jax_sort, ())]
         + [(_jax_grad_case, (n,)) for n in GRAD_CASES]
         + [(_jax_optimize, (a,)) for a in ("grpo", "dapo", "ppo")]
         + [(_jax_train_step, ())])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results (a future), the shared data and the
    snapshot directory; JAX's references are computed while the ranks
    run (``_WARM``)."""
    data = _data()
    tmp = tmp_path_factory.mktemp("mesh_moe")
    path, ckpt = tmp / "data.pkl", tmp / "wd"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(run_ranks, _rank_main, WORLD,
                          (str(path), str(ckpt)), device="cpu", timeout=300)
        _REFS.clear()
        for fn, args in _WARM:
            fn(data, *args)
        yield fut, data, str(ckpt)
        fut.result()


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _results(ranks):
    return ranks[0].result()


def _assert_gen(got, want):
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["length"], np.asarray(want["length"]))
    np.testing.assert_allclose(got["logprobs"], np.asarray(want["logprobs"]),
                               atol=ATOL)


def _assert_rb(got, want):
    np.testing.assert_array_equal(got["response"], np.asarray(want.response))
    np.testing.assert_array_equal(got["length"], np.asarray(want.length))
    np.testing.assert_allclose(got["lp"], np.asarray(want.behaviour_logprobs),
                               atol=ATOL)
    for k in ("n_generated", "n_reused", "one_pass"):
        assert got["metrics"][k] == want.metrics[k], k


def _assert_grads(got, want, r):
    """Rank ``r``'s gradient shards against the slices of JAX's whole
    gradient (by the port's names)."""
    mine = _mine(want, got["specs"], r)
    assert set(mine) == set(got["grads"])
    for k, w in mine.items():
        g = got["grads"][k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        assert np.abs(w).max() > 0, f"{k}: zero"
        d = np.abs(g.astype(np.float64) - w).max()
        assert d <= GRAD_RTOL * np.abs(w).max(), (
            f"model rank {r} {k}: max diff {d}, largest {np.abs(w).max()}")


# ------------------------------------------------------------ serving


@pytest.mark.parametrize("key", list(CFGS))
def test_generate_and_aux_match_jax(ranks, key):
    """generate on the mesh == JAX's single device; ``moe_aux`` over the
    generated rows (each data rank its own) is the whole batch's, JAX's
    forward's aux."""
    want, jaux = _jax_gen(ranks[1], key)
    got = _got(ranks, "generate")[key]
    _assert_gen(got["gen"], want)
    assert set(got["aux"]) == set(jaux)
    for n, w in jaux.items():
        if n in ("moe_drop_frac", "moe_expert_frac"):
            np.testing.assert_allclose(got["aux"][n], w, atol=AUX_TOL,
                                       err_msg=n)
        else:
            np.testing.assert_allclose(got["aux"][n], w, rtol=AUX_RTOL,
                                       err_msg=n)
    if key == "ep":
        assert float(jaux["moe_drop_frac"]) > 0
    for res in _results(ranks)[1:]:
        np.testing.assert_array_equal(res["generate"][key]["gen"]["tokens"],
                                      got["gen"]["tokens"])
        for n, v in res["generate"][key]["aux"].items():
            np.testing.assert_array_equal(v, got["aux"][n])


def _got(ranks, name, rank=0):
    return _results(ranks)[rank][name]


@pytest.mark.parametrize("name", list(ROLL_SPECS))
def test_rollout_matches_jax(ranks, name):
    """Two epochs of ``rollout`` on the mesh (epoch 1 verifies epoch 0's
    rows) == JAX's single device: the one-pass branch, the two-pass one,
    slot backfill (a ``MeshSlotServer``), the paged layout and a drafted
    rollout (draft blocks route k + 1 tokens a row, so tokens drop)."""
    want = _jax_epochs(ranks[1], name)
    got = _got(ranks, "rollouts")[name]
    for g, w in zip(got, want):
        _assert_rb(g, w)
    m = got[1]["metrics"]
    assert m["n_reused"] > 0
    assert m["one_pass"] == (0.0 if name == "two_pass" else 1.0)
    for res in _results(ranks)[1:]:
        for g, mine in zip(res["rollouts"][name], got):
            for k in ("response", "length", "lp"):
                np.testing.assert_array_equal(g[k], mine[k])


def test_mesh_slot_server_matches_jax(ranks):
    """``MeshSlotServer`` over the MoE model (one slot engine a data
    shard) serves JAX's single engine's responses."""
    want = _jax_server(ranks[1])
    for res in _results(ranks):
        _assert_responses(res["rollouts"]["server"], want)


def test_sort_runs_on_a_mesh_without_a_data_axis(ranks):
    """``sort`` (one capacity from the whole batch) on a (1, 4) mesh, one
    expert a rank: JAX's tokens."""
    want = _jax_sort(ranks[1])
    for res in _results(ranks):
        _assert_gen(res["sort_1x4"], want)


def test_refusals_name_item_11(ranks):
    """``sort`` and ``moe_groups`` > 0 on a data axis of 2, and the
    families still to come (MLA and MTP, Mamba, RWKV6, the frontends),
    raise on a mesh with a message that names item 11."""
    for res in _results(ranks):
        got = res["refused"]
        assert set(got) == {"sort", "groups", *REFUSED}
        for k, msg in got.items():
            assert "ROADMAP Queue 1 item 11" in msg, (k, msg)
        assert "couples rows across the data axis" in got["sort"]
        assert "moe_groups=2" in got["groups"]
        for a in REFUSED:
            assert "Mamba, MLA and MTP, RWKV6" in got[a], a


# ------------------------------------------------------------ training


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_gradient_shards_match_jax_grad(ranks, name):
    """Each rank's finished gradient shards of the GRPO actor loss plus
    both router losses (coefficients 1.0) == the slices of JAX's
    ``jax.grad`` on the whole batch; the step log's ``moe_lb_loss`` is the
    whole batch's.  The data shards hold different token counts; five
    rows run whole on every data rank."""
    jloss, jinfo, want = _jax_grad_case(ranks[1], name)
    b = ranks[1]["grad"][name]
    sharded = len(b["resp_mask"]) == 8
    if sharded:
        counts = b["resp_mask"].reshape(2, -1).sum(1)
        assert counts[0] != counts[1]
    for rank, res in enumerate(_results(ranks)):
        got = res["grads"][name]
        assert got["sharded"] == sharded
        _assert_grads(got, want, got["model_rank"])
        np.testing.assert_allclose(got["info"]["loss"], jloss,
                                   rtol=LOSS_RTOL, atol=TOL)
        np.testing.assert_allclose(got["info"]["moe_lb_loss"],
                                   jinfo["moe_lb_loss"], rtol=AUX_RTOL)


def _assert_update(rank, got, params, before, grads, scale,
                   which="params"):
    """A rank's updated shards (``got[which]``) against JAX's within
    ``_update_tol`` of its own gradient shards."""
    r = rank % 2
    p0, want = _mine(before, got["specs"], r), _mine(params, got["specs"], r)
    for k, w in want.items():
        t = _update_tol(p0[k], grads[k], LR, scale)
        d = np.abs(got[which][k].astype(np.float64) - w)
        assert not (d > t).any(), f"rank {rank} {which} {k}: max {d.max()}"


@pytest.mark.parametrize("algo", ["grpo", "dapo", "ppo"])
def test_optimize_matches_jax(ranks, algo):
    """One ``optimize`` of a rollout with uneven masks on the mesh (GRPO
    with its KL reference, DAPO's token aggregation, PPO with a MoE critic
    trunk) == JAX's: the step log (``moe_lb_loss`` rtol 1e-5), each
    actor gradient shard within 1e-5 of its leaf's largest, every updated
    shard (the critic's too) within ``_update_tol``."""
    ref = _jax_optimize(ranks[1], algo)
    want, wgrad = ref["metrics"], ref["grad"]
    # PPO's step log holds the critic's norm: the actor's clip scale from
    # JAX's whole actor gradient
    norm = float(np.sqrt(sum(np.sum(np.square(v.astype(np.float64)))
                             for v in wgrad.values())))
    for rank, res in enumerate(_results(ranks)):
        got = res[algo]
        assert set(got["metrics"]) == {k for k in want
                                       if not k.endswith("_time")}
        for k, w in got["metrics"].items():
            np.testing.assert_allclose(
                w, want[k], rtol=AUX_RTOL if k == "moe_lb_loss"
                else LOSS_RTOL, atol=0 if k == "moe_lb_loss" else TOL,
                err_msg=f"rank {rank} {k}")
        _assert_grads(got, wgrad, rank % 2)
        _assert_update(rank, got, ref["params"], ref["before"][0],
                       got["grads"], min(1.0, 1.0 / (norm + 1e-9)))
        if algo == "ppo":
            _assert_update(rank, got, ref["critic"], ref["before"][1],
                           got["critic_grads"],
                           min(1.0, 1.0 / (want["grad_norm"] + 1e-9)),
                           which="critic")
    assert want["moe_lb_loss"] > 0


def test_watchdog_snapshot_of_the_expert_shards_crosses_packages(ranks):
    """The GRPO trainer's watchdog snapshot on the mesh is one whole tree
    (the 3-D expert tensors gathered along their cut dimension) that
    JAX's loader reads: each of its tensors is the concatenation of the
    two model ranks' updated shards; the restore cuts it back onto every
    rank bit for bit."""
    _, _, ckpt = ranks
    results = _results(ranks)
    tree, meta = jax_load_pytree(os.path.join(ckpt, "watchdog_000001"))
    assert meta["step"] == 1                     # after one optimize
    g0, g1 = results[0]["grpo"], results[1]["grpo"]
    assert set(tree["params"]) == set(g0["params"])
    for k, whole in tree["params"].items():
        spec = g0["specs"].get(k, ())
        want = g0["params"][k] if "model" not in spec else np.concatenate(
            [g0["params"][k], g1["params"][k]], axis=spec.index("model"))
        np.testing.assert_array_equal(np.asarray(whole, np.float32), want,
                                      err_msg=k)
    assert np.asarray(tree["params"]["layers.0.moe.w_gate"]).shape[0] == 4
    assert all(r["grpo"]["restored"] for r in results)


def test_async_service_holds_the_trainer_s_expert_shards(ranks):
    """The async loop over the MoE mesh trainer: the rollout service's
    model is cut as the trainer's (its experts on the same ranks) and,
    once it has polled the published snapshot, holds the trainer's shards
    bit for bit; every rank logs the same loss."""
    results = _results(ranks)
    for rank, res in enumerate(results):
        a = res["async"]
        assert a["equal"]
        assert a["cut"] == [(True, 2 * (rank % 2))] * 2
        assert a["loss"] == results[0]["async"]["loss"]


def test_train_step_with_microbatches_matches_jax(ranks):
    """``make_train_step`` (chunked cross entropy, two microbatches, each
    with its own router losses over its whole rows) on the mesh == JAX's
    on one device: gradient shards as AdamW receives them, the loss, the
    grad norm and every updated shard."""
    ref = _jax_train_step(ranks[1])
    before = _named(ranks[1]["params"]["ep"], ModelConfig(**CFGS["ep"]))
    for rank, res in enumerate(_results(ranks)):
        got = res["train_step"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                                   rtol=LOSS_RTOL)
        _assert_grads(got, ref["grad"], rank % 2)
        _assert_update(rank, got, ref["params"], before, got["grads"], 1.0)


# ------------------------------------------------------------ the layout
# (last: the tests above compute JAX's references while the ranks run)


def test_experts_are_cut_by_their_rules(ranks):
    """E = 4 on model 2: two whole experts a rank; E = 3: every expert on
    half its d_ff.  No replicated tensor of a MoE is summed over the
    model group: the router's gradient comes out whole (its combine
    weights enter the experts' region through copy-to-model)."""
    for rank, res in enumerate(_results(ranks)):
        lay = res["layout"]
        assert lay["ep"][:2] == (("model", None, None), 2 * (rank % 2))
        assert lay["tp"][:2] == ((None, None, "model"), 0)
        assert lay["shared"][:2] == (("model", None, None), 2 * (rank % 2))
        for k, (_, _, region) in lay.items():
            assert not [n for n in region if ".moe." in n], (k, region)


# ------------------------------------------------------------ pieces


def test_update_and_sums_in_pieces_equal_the_whole(monkeypatch):
    """AdamW's update and norm, and the gradient sums, run a large tensor
    piece by piece (``mesh.pieces``: an expert stack's float32
    temporaries stay bounded): with the piece size cut to 7 elements the
    parameters and moments equal the whole-tensor update bit for bit, the
    norm within float32 summation order."""
    MS = mesh_module
    gen = torch.Generator().manual_seed(0)
    shapes = [(3, 5, 4), (7,), (2, 9)]
    params = [torch.randn(s, generator=gen) for s in shapes]
    grads = [torch.randn(s, generator=gen) for s in shapes]

    def run():
        ps = [p.clone() for p in params]
        st = adamw.init(ps)
        info = adamw.update(adamw.AdamWConfig(lr=LR, clip_norm=0.5), ps,
                            [g.clone() for g in grads], st)
        return ps, st, float(info["grad_norm"])

    whole = run()
    monkeypatch.setattr(MS, "GRAD_BUCKET", 7)
    assert [len(MS.pieces(p)) for p in params] == [9, 1, 3]
    cut = run()
    for a, b in zip(whole[0] + whole[1]["mu"] + whole[1]["nu"],
                    cut[0] + cut[1]["mu"] + cut[1]["nu"]):
        assert torch.equal(a, b)
    np.testing.assert_allclose(cut[2], whole[2], rtol=1e-6)


# ------------------------------------------------------------ the launcher


LAUNCHES = {
    "serve": (["--requests", "4", "--max-new-tokens", "6"],
              ["shards=2): served 4/4"]),
    "train": (["--steps", "2"], ["mesh=2x2", "step   1 "])}


@pytest.mark.parametrize("launcher", list(LAUNCHES))
def test_launcher_runs_mixtral_on_a_torchrun_mesh(launcher):
    """``launch/serve.py`` and ``launch/train.py --arch mixtral-8x22b``
    (reduced) under ``torchrun`` on a (2, 2) mesh: rank 0 prints."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    extra, want = LAUNCHES[launcher]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", f"repro_torch.launch.{launcher}",
           "--device", "cpu", "--smoke", "--arch", "mixtral-8x22b",
           "--mesh-data", "2", "--mesh-model", "2", *extra]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh (data, model) = (2, 2) over gloo on cpu" in out.stdout
    for w in want:
        assert out.stdout.count(w) == 1, (w, out.stdout[-2000:])
