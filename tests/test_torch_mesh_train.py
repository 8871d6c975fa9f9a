"""The port's trainer on the §8 mesh: a (2, 2) ``gloo`` mesh of four
spawned CPU ranks held against JAX's single device in the pytest process
(JAX's own test of this, ``tests/distributed/test_mesh_rollout.py::
test_trainer_step_identity``, needs four devices).

One module-scoped spawn (``distributed/mesh.py:run_ranks``, torch on one
thread a rank) runs every scenario while this process computes JAX's
references; each scenario is then its own test case.  Weights are JAX's
draws carried across with ``from_jax_params``; keys draw with
``jax.random`` (``JaxKey``); both packages' rewards are patched to the
same mixed 0/1 rewards (the verifier gives a random model 0 everywhere),
or for DAPO to ``test_torch_ppo_dapo._stub_rewards`` (degenerate groups).

* **The collectives' gradients** (``distributed/comm.py``): the GRPO
  actor loss of a tiny qwen3-shaped model with qk-norm, tied and untied
  heads, 4 query / 2 KV heads (sharded) and 6 / 3 (KV replicated, queries
  gathered), over a batch whose data shards hold different numbers of
  response tokens.  Each rank's gradient of each of its parameter shards,
  finished on the mesh (``mesh.LossRows.finish``), must equal the matching
  slice of JAX's ``jax.grad`` of the loss on the whole batch within
  ``GRAD_RTOL`` of the leaf's largest magnitude.
* **The trainer**: two GRPO ``train_step``s (spec variant, KL reference),
  one PPO step and one DAPO step with a resample round against JAX's
  ``Trainer``: tokens, lengths, ``n_generated``/``n_reused``, rewards and
  counters equal; loss and grad norm within ``LOSS_RTOL`` (JAX's atol
  1e-4 of ``test_trainer_step_identity`` at these magnitudes); each
  rank's parameter shards and moments within ``_adam_tol``:
  ``test_torch_train._update_tol``'s budget (a gradient error of
  ``GRAD_NOISE`` of the tensor's largest, 1e-6 of the operands) carried
  through AdamW's moments step by step, as at a second step the update
  m̂ / (√v̂ + eps) can cancel where the two steps' gradients oppose.
  Every rank's step log is the same.
* **The async loop**: K = 0 ``"pc"`` equal to the synchronous mesh
  trainer (tokens, losses, parameters bit for bit); ``"ppcc"`` at K = 0
  (a re-verified step) and K = 1 (an importance-corrected one) against
  JAX's ``AsyncTrainer``.
* **The watchdog**: a snapshot written on the mesh (one whole tree, by
  rank 0) read with JAX's loader holds JAX's parameters after the step;
  restored into a fresh mesh trainer it continues as the uninterrupted
  run does, bit for bit.
* **launch/steps.py**: the train step (naive, and chunked with two
  microbatches) and the verify step (naive and chunked) on the mesh
  against JAX's, and the serve step against the single process.
* **The sinks**: the drafted loop's ledger rows and decision records on
  the data-sharded mesh equal the single process's (two drafted epochs);
  ``launch/serve.py --ledger --decision-log --trace-dir --metrics`` on
  the mesh writes what the single process writes (the attribution's
  token counts, each request's decision outcomes, each request's trace
  lane; the engine-step features differ, as a shard's engine counts its
  own steps); ``MetricsBoard``'s merge of the shards' published
  registries equals the collective one; a kill agreed by a model group
  (``AgreedStop``) stops both its
  ranks at one chunk, and the gathered snapshot resumes to the
  uninterrupted responses.

The update launches no kernel (``kernels/__init__.py:refuse_grad``: the
grad route is the differentiable attention).  About 150 s alone (one
process, 8 cores).
"""
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint.io import load_pytree as jax_load_pytree  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro.rl import async_loop as jax_async  # noqa: E402
from repro.rl import trainer as jax_trainer  # noqa: E402
from repro.rl.losses import PolicyLossConfig as JaxPolicyLossConfig  # noqa: E402
from repro.core.backoff import BackoffConfig as JaxBackoffConfig  # noqa: E402
from repro.serving.rollout_service import WeightSync as JaxWeightSync  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.core import SpecConfig  # noqa: E402
from repro_torch.core.backoff import BackoffConfig  # noqa: E402
from repro_torch.data.tokenizer import VOCAB_SIZE  # noqa: E402
from repro_torch.distributed.mesh import (LossRows,  # noqa: E402
                                          MeshConfig, _slice, model_rank,
                                          param_specs, run_ranks,
                                          shard_caches, shard_params)
from repro_torch.engine.generate import positions_from_mask  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.rl import async_loop  # noqa: E402
from repro_torch.rl import trainer as port_trainer  # noqa: E402
from repro_torch.rl import watchdog  # noqa: E402
from repro_torch.rl.async_loop import AsyncConfig, AsyncTrainer  # noqa: E402
from repro_torch.rl.critic import critic_from_jax_params  # noqa: E402
from repro_torch.rl.losses import PolicyLossConfig  # noqa: E402
from repro_torch.rl.trainer import RLConfig, Trainer  # noqa: E402
from repro_torch.rl.watchdog import TrainWatchdog, WatchdogConfig  # noqa: E402
from repro_torch.serving.mesh_server import MetricsBoard  # noqa: E402
from repro_torch.serving.rollout_service import WeightSync  # noqa: E402
from test_torch_mesh import CFGS as ROLL_CFGS  # noqa: E402
from test_torch_mesh import _inputs, _kill_requests, _step_keys  # noqa: E402
from test_torch_ppo_dapo import _stub_rewards  # noqa: E402
from test_torch_rollout import JaxKey, JaxKeyBatch  # noqa: E402
from test_torch_train import (GRAD_NOISE, LOSS_RTOL, TOL,  # noqa: E402
                              _datasets, _mixed_rewards, _update_tol)

WORLD = 4
GROUP = 4
SERVE_ARGS = ["--device", "cpu", "--smoke", "--draft", "2", "--ledger",
              "--requests", "6", "--max-new-tokens", "8"]
LR = 1e-3
GRAD_RTOL = 1e-5        # a gradient shard, of its leaf's largest magnitude
ARCH_KW = dict(vocab_size=max(VOCAB_SIZE, 64), num_kv_heads=2)


def _tiny(**kw):
    base = dict(name="mesh-train-tiny", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=VOCAB_SIZE,
                max_seq_len=256, qk_norm=True)
    base.update(kw)
    return base


# (config, policy-loss settings): qk-norm throughout; tied and untied
# heads; 4/2 heads (KV sharded) and 6/3 (KV replicated, queries gathered);
# both aggregations and an entropy bonus
GRAD_CASES = {
    "kv2-untied-seq": (_tiny(), dict(agg="seq", kl_coef=0.5)),
    "kv2-tied-token": (_tiny(tie_embeddings=True),
                       dict(agg="token", kl_coef=0.5, entropy_coef=0.1)),
    "kv3of6-untied-token": (_tiny(num_heads=6, num_kv_heads=3, head_dim=16),
                            dict(agg="token", kl_coef=0.5)),
    "kv3of6-tied-seq": (_tiny(num_heads=6, num_kv_heads=3, head_dim=16,
                              tie_embeddings=True),
                        dict(agg="seq", kl_coef=0.5, entropy_coef=0.1)),
}
STEPS_CFG = _tiny()


def _mixed(responses, lengths, answers):
    return _mixed_rewards(len(answers), GROUP)


def _arch_cfgs():
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    return (jax_get_config("qwen3-1.7b").reduced(**ARCH_KW),
            get_config("qwen3-1.7b").reduced(**ARCH_KW))


def _rl_kw(algo="grpo", **kw):
    return dict(dict(algo=algo, group_size=GROUP, prompts_per_batch=2,
                     max_new_tokens=6), **kw)


def _jax_trainer(algo="grpo", **kw):
    from repro.rl.trainer import RLConfig as JaxRLConfig
    from repro.core import SpecConfig as JaxSpecConfig
    jcfg, _ = _arch_cfgs()
    jds, _ = _datasets()
    return jax_trainer.Trainer(
        jcfg, JaxRLConfig(optim=jax_adamw.AdamWConfig(lr=LR),
                          critic_optim=jax_adamw.AdamWConfig(lr=LR),
                          **_rl_kw(algo, **kw)),
        JaxSpecConfig(), jds, jax.random.PRNGKey(0))


def _grad_batch(B=8, P=4, N=6, seed=0):
    """Left-padded prompts and responses whose masks give the two data
    shards (rows 0-3, 4-7) different token counts."""
    rng = np.random.default_rng(seed)
    L = P + N
    tokens = rng.integers(3, VOCAB_SIZE - 1, (B, L)).astype(np.int32)
    pm = np.ones((B, P), bool)
    pm[1, :2] = pm[5, :1] = False
    lengths = np.array([6, 2, 5, 1, 6, 6, 4, 6])
    rm = np.arange(N)[None] < lengths[:, None]
    return dict(tokens=tokens, mask=np.concatenate([pm, rm], 1),
                resp_mask=rm, P=P,
                lp_old=-rng.random((B, N)).astype(np.float32) * 3,
                adv=rng.normal(0, 1, (B, N)).astype(np.float32) * rm,
                ref_lp=-rng.random((B, N)).astype(np.float32) * 3)


def _steps_batch(B=8, T=16, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, VOCAB_SIZE, (B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    pos[2, :3] = -1
    pos[2, 3:] -= 3
    return dict(tokens=tokens, positions=pos,
                dlp=np.full((B, T), -1.5, np.float32),
                u=rng.random((B, T)).astype(np.float32),
                dlen=np.array([T, T // 2, 3, T, 1, T, 9, T], np.int32))


def _data():
    """Everything both sides share, as numpy."""
    grad = {name: jax.tree.map(np.asarray, JM.init_lm(
        jax.random.PRNGKey(i), JaxModelConfig(**kw)))
        for i, (name, (kw, _)) in enumerate(GRAD_CASES.items())}
    return {
        "grad_params": grad, "grad_batch": _grad_batch(),
        "params": jax.tree.map(np.asarray, _jax_trainer().params),
        "critic": jax.tree.map(np.asarray,
                               _jax_trainer("ppo").critic_params),
        "steps_params": jax.tree.map(np.asarray, JM.init_lm(
            jax.random.PRNGKey(7), JaxModelConfig(**STEPS_CFG))),
        "steps_batch": _steps_batch(),
        "draft_params": [jax.tree.map(np.asarray, JM.init_lm(
            jax.random.PRNGKey(s), JaxModelConfig(**ROLL_CFGS["a"])))
            for s in (0, 42)],
        "draft_inputs": _inputs(8, 10)[:2],
        "draft_keys": _step_keys(_inputs(8, 10)[2], 2),
        "kill": _kill_requests()}


# ------------------------------------------------------------ the ranks


def _np(named):
    return {k: v.detach().float().numpy().copy() for k, v in named.items()}


def _local(model):
    return _np(dict(model.named_parameters()))


def _rb(rb):
    return {"response": rb.response, "length": rb.length,
            "response_mask": rb.response_mask, "prompt": rb.prompt,
            "metrics": dict(rb.metrics)}


def _clean(m):
    return {k: float(v) for k, v in m.items() if not k.endswith("_time")
            and k != "service_wait_s"}


def _spy_update(seen):
    update = adamw.update

    def spy(cfg, params, grads, state, **kw):
        seen[id(params[0])] = list(grads)
        return update(cfg, params, grads, state, **kw)

    adamw.update = spy
    return update


def _rank_grads(mesh, data, name):
    kw, loss_kw = GRAD_CASES[name]
    cfg = ModelConfig(**kw)
    model = shard_params(mesh, cfg, from_jax_params(
        data["grad_params"][name], cfg, device="cpu"))
    b = data["grad_batch"]
    t = {k: torch.as_tensor(v) for k, v in b.items() if k != "P"}
    rows = LossRows(mesh, t["resp_mask"].shape[0])
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    loss, info = port_trainer._actor_loss_fn(
        model, cfg, PolicyLossConfig(**loss_kw), rows.take(t["tokens"]),
        rows.take(t["mask"]), b["P"], rows.take(t["lp_old"]),
        rows.take(t["adv"]), rows.take(t["resp_mask"]),
        rows.take(t["ref_lp"]), 1.0, 1.0, count=rows.count(t["resp_mask"]),
        rows=rows.whole_rows)
    loss.backward()
    grads = [p.grad for p in params]
    assert rows.sharded
    rows.finish(model, grads)
    names = [n for n, _ in model.named_parameters()]
    total = rows.sum({"loss": loss.detach(), **info})
    return {"grads": _np(dict(zip(names, grads))),
            "info": {k: float(v) for k, v in total.items()},
            "specs": param_specs(model), "model_rank": model_rank(mesh)}


def _port_trainer(mesh, data, algo="grpo", **kw):
    _, cfg = _arch_cfgs()
    _, ds = _datasets()
    rl = RLConfig(optim=adamw.AdamWConfig(lr=LR),
                  critic_optim=adamw.AdamWConfig(lr=LR),
                  **_rl_kw(algo, **kw))
    tr = Trainer(cfg, rl, SpecConfig(), ds, JaxKey(jax.random.PRNGKey(0)),
                 model=from_jax_params(data["params"], cfg, device="cpu"),
                 device="cpu", mesh=mesh)
    if tr.critic is not None:
        tr.critic = shard_params(mesh, cfg, critic_from_jax_params(
            data["critic"], cfg, device="cpu"))
        tr.critic_opt_state = adamw.init(port_trainer.trainable(tr.critic))
    return tr


def _state(tr, seen):
    """A trainer's local shards after a step: parameters, the gradients
    AdamW received, moments; the critic's too."""
    out = {"params": _local(tr.model),
           "grads": _np(dict(zip([n for n, _ in tr.model.named_parameters()],
                                 seen[id(next(tr.model.parameters()))])))}
    names = [n for n, _ in tr.model.named_parameters()]
    for k in ("mu", "nu"):
        out[k] = _np(dict(zip(names, tr.opt_state[k])))
    if tr.critic is not None:
        cn = [n for n, _ in tr.critic.named_parameters()]
        out["critic"] = _local(tr.critic)
        out["critic_grads"] = _np(dict(zip(
            cn, seen[id(next(tr.critic.parameters()))])))
    out["specs"] = param_specs(tr.model)
    return out


def _rank_steps(mesh, data, algo, n, **kw):
    seen = {}
    update = _spy_update(seen)
    try:
        tr = _port_trainer(mesh, data, algo, **kw)
        out = []
        for _ in range(n):
            m = tr.train_step()
            out.append({"metrics": _clean(m), "rb": _rb(tr.last_rb),
                        **_state(tr, seen)})
    finally:
        adamw.update = update
    return out


def _rank_async(mesh, data, acfg, n):
    tr = _port_trainer(mesh, data)
    log = []
    optimize = tr.optimize

    def spy(rb, rewards, times, **kw):
        log.append((np.array(rb.response), np.array(rb.length),
                    kw.get("behaviour_lp") is not None))
        return optimize(rb, rewards, times, **kw)

    tr.optimize = spy
    at = AsyncTrainer(tr, AsyncConfig(**acfg), sync=WeightSync(
        BackoffConfig(base=0.0, max_attempts=3), sleep=lambda d: None))
    got = [_clean(m) for m in at.run(n)]
    return {"metrics": got, "log": log, "counters": at.counters(),
            "params": _local(tr.model)}


def _rank_watchdog(mesh, data, ckpt_dir):
    a = _port_trainer(mesh, data)
    a.watchdog = TrainWatchdog(WatchdogConfig(checkpoint_dir=ckpt_dir,
                                              snapshot_every=100))
    a.train_step()                                    # snapshots step 0
    after1 = _local(a.model)
    batch = a.collector.sample(1)
    uninterrupted = {k: v for k, v in _clean(a.train_step(batch)).items()
                     if not k.startswith("watchdog_")}
    b = _port_trainer(mesh, data)                     # same start, no steps
    b.opt_state["step"] = 7
    assert a.watchdog.restore(b)
    restored = _local(b.model)
    b.step_idx = 1
    resumed = _clean(b.train_step(batch))
    return {"after1": after1, "restored": restored,
            "equal_after": all(torch.equal(x, y) for x, y in zip(
                a.model.parameters(), b.model.parameters())),
            "equal_moments": all(torch.equal(x, y) for x, y in zip(
                a.opt_state["mu"] + a.opt_state["nu"],
                b.opt_state["mu"] + b.opt_state["nu"])),
            "uninterrupted": uninterrupted, "resumed": resumed,
            "snapshots": a.watchdog.snapshots}


def _rank_async_checkpoint(mesh, data, ckpt_dir):
    """The async pair saved on the mesh after two steps (rank 0 writes)
    and restored into a fresh pair (each rank keeps its slices as it
    reads): the trainer's shards and moments and the service's shards."""
    def pair():
        return AsyncTrainer(_port_trainer(mesh, data), AsyncConfig(
            staleness_window=1, buffer_capacity=4, schedule="ppcc"),
            sync=WeightSync(BackoffConfig(base=0.0, max_attempts=3),
                            sleep=lambda d: None))

    def tensors(at):
        tr = at.trainer
        return list(tr.model.parameters()) + tr.opt_state["mu"] \
            + tr.opt_state["nu"] + list(at.service.model.parameters())

    a = pair()
    a.run(2)
    a.save(ckpt_dir)
    b = pair()
    assert b.restore(ckpt_dir)
    return {"equal": [torch.equal(x, y)
                      for x, y in zip(tensors(a), tensors(b))],
            "versions": [(at.version, at.service.version) for at in (a, b)],
            "files": sorted(os.listdir(ckpt_dir))}


def _rank_launch_steps(mesh, data):
    cfg = ModelConfig(**STEPS_CFG)
    whole = from_jax_params(data["steps_params"], cfg, device="cpu")
    b = data["steps_batch"]
    ocfg = adamw.AdamWConfig(lr=LR, clip_norm=1e9)
    out = {}
    for name, kw in (("naive", {}), ("chunked_mb2", dict(
            ce_impl="chunked", ce_chunk=4, microbatch=2))):
        model = shard_params(mesh, cfg, from_jax_params(
            data["steps_params"], cfg, device="cpu"))
        opt = adamw.init(list(model.parameters()))
        step = steps.make_train_step(cfg, ocfg, mesh=mesh, **kw)
        _, _, loss, gnorm = step(model, opt, b["tokens"], b["positions"])
        out[name] = {"loss": float(loss), "grad_norm": float(gnorm),
                     "params": _local(model), "specs": param_specs(model)}
    model = shard_params(mesh, cfg, whole)
    for name, kw in (("verify_naive", {}), ("verify_chunked", dict(
            score_impl="chunked", score_chunk=4))):
        n, lp = steps.make_verify_step(cfg, mesh=mesh, **kw)(
            model, b["tokens"], b["positions"], b["dlp"], b["u"], b["dlen"],
            0.5)
        out[name] = (n.numpy(), lp.numpy())
    # the serve step: a prefilled cache cut to this rank, one token
    toks = torch.as_tensor(b["tokens"][:, :8])
    pos = positions_from_mask(torch.ones_like(toks, dtype=torch.bool))
    caches = M.init_cache(cfg, 8, 12, device="cpu")
    M.prefill(whole, cfg, toks, pos, caches)
    nxt = torch.as_tensor(b["tokens"][:, 8:9])
    logits, _ = steps.make_serve_step(cfg, mesh=mesh)(
        model, nxt, torch.full((8, 1), 8, dtype=torch.int32),
        shard_caches(cfg, caches, mesh), 8)
    ref, _ = M.decode_step(whole, cfg, nxt, torch.full((8, 1), 8,
                                                       dtype=torch.int32),
                           caches, 8)
    out["serve"] = (logits.numpy(), ref.numpy())
    return out


def _drafted_epochs(models, cfg, data, mesh=None):
    """Two drafted one-pass epochs (the second under other weights, so
    drafts are rejected) with the ledger and decision log configured:
    each epoch's rows, the ledger's rows and the decision records (the
    step's wall time aside)."""
    from repro_torch import obs
    from repro_torch.core import RolloutCache, rollout
    from repro_torch.drafting import DraftConfig
    from repro_torch.engine.generate import GenerateConfig
    from repro_torch.obs.ledger import (DECISION_OUTCOMES, DecisionLog,
                                        TokenLedger)
    led, dec = TokenLedger(enabled=True), DecisionLog(None, enabled=True)
    obs.configure(ledger=led, decisions=dec)
    try:
        prompts, mask = data["draft_inputs"]
        gen = GenerateConfig(max_new_tokens=12, eos_id=VOCAB_SIZE - 1)
        spec = SpecConfig(variant="spec",
                          draft=DraftConfig(kind="ngram", draft_k=4))
        cache = RolloutCache(group_size=2)
        rbs = []
        for step, model in enumerate(models):
            rb = rollout(model, cfg, gen, spec, prompts, mask, list(range(8)),
                         cache, JaxKeyBatch(data["draft_keys"][step]), step,
                         mesh=mesh)
            rbs.append((rb.response.copy(), rb.length.copy(),
                        dict(rb.metrics)))
        keep = [i for i, k in enumerate(DECISION_OUTCOMES) if k != "step_ms"]
        recs = [(str(r), st, f, tuple(o[i] for i in keep))
                for r, st, f, o in dec._recs]
        return {"rbs": rbs, "recs": recs, "rows": {
            str(k): bytes(v) for k, v in led.rows().items()}}
    finally:
        obs.reset()


def _rank_sinks(mesh, data, out_dir):
    """The drafted loop's sinks on the mesh; the serve launcher's sinks on
    the mesh (rank 0 writes under ``out_dir``); a kill agreed by shard 0's
    model group."""
    import contextlib
    import io
    import socket

    from repro_torch import obs
    from repro_torch.engine.generate import GenerateConfig
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serving import (EngineKilled, FaultEvent, Request,
                                     make_slot_engine)
    cfg = ModelConfig(**ROLL_CFGS["a"])
    models = [shard_params(mesh, cfg, from_jax_params(p, cfg, device="cpu"))
              for p in data["draft_params"]]
    out = {"drafted": _drafted_epochs(models, cfg, data, mesh)}
    buf = io.StringIO()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]          # rank 0's is the one served
    with contextlib.redirect_stdout(buf):
        launch_serve.main(SERVE_ARGS + [
            "--trace-dir", os.path.join(out_dir, "trace"),
            "--decision-log", os.path.join(out_dir, "dec"),
            "--metrics", str(port),
            "--mesh-data", "2", "--mesh-model", "2"])
    obs.reset()
    out["serve"] = buf.getvalue()
    # AgreedStop: rank 0 alone is signalled; its model group stops together
    gen = GenerateConfig(max_new_tokens=10, eos_id=VOCAB_SIZE - 1)

    def server():
        srv = make_slot_engine(models[0], cfg, gen, mesh=mesh, num_slots=4,
                               prompt_width=8)
        srv.engine.faults = launch_serve.AgreedStop(
            mesh.get_group("model"), torch.device("cpu"))
        for r in data["kill"]:
            srv.submit(Request(**r))
        return srv

    whole = server().run()
    first = server()
    if torch.distributed.get_rank() == 0:
        first.engine.faults.events.append(FaultEvent("kill", at_step=1))
    killed = False
    try:
        first.run()
    except EngineKilled:
        killed = True
    state = first.state_dict()
    second = server()
    second.load_state_dict(state)
    resumed = second.run()
    out["agreed"] = {
        "killed": killed, "steps": first.engine.steps,
        "whole": {i: r.tokens.tolist() for i, r in whole.items()},
        "resumed": {i: r.tokens.tolist() for i, r in resumed.items()}}
    # MetricsBoard: each shard publishes after its chunks; the merge of
    # the latest publications needs no collective
    board_dir = os.path.join(out_dir, "board")
    os.makedirs(board_dir, exist_ok=True)
    srv = server()
    board = MetricsBoard(srv, mesh, board_dir)
    srv.run()
    mine = os.path.exists(board._path(srv.shard))
    want = srv.metrics_registry().as_dict()
    board.publish(force=True)
    torch.distributed.barrier()
    out["board"] = {"published": mine, "writer": board.writer,
                    "want": want, "got": board.registry().as_dict()}
    return out


def _rank_main(rank, path, ckpt_dir):
    with open(path, "rb") as f:
        data = pickle.load(f)
    mesh = MeshConfig(data=2, model=2, require=True).build("cpu")
    for mod in (port_trainer, async_loop):
        mod.batch_rewards = _mixed
    async_loop.make_key = lambda seed, device=None: JaxKey(
        jax.random.PRNGKey(seed))
    for mod in (watchdog, async_loop):
        mod.key_state = lambda k: np.asarray(k.key, np.int64)
        mod.key_from_state = lambda w, dev: JaxKey(
            jnp.asarray(np.asarray(w, np.int64), jnp.uint32))
    out = {"grads": {name: _rank_grads(mesh, data, name)
                     for name in GRAD_CASES}}
    out["grpo"] = _rank_steps(mesh, data, "grpo", 2)
    out["ppo"] = _rank_steps(mesh, data, "ppo", 1)
    port_trainer.batch_rewards = _stub_rewards
    out["dapo"] = _rank_steps(mesh, data, "dapo", 1, max_resample_rounds=2)
    port_trainer.batch_rewards = _mixed
    out["async_pc"] = _rank_async(mesh, data, dict(
        staleness_window=0, buffer_capacity=2, schedule="pc"), 2)
    for k in (0, 1):
        out[f"async_ppcc_k{k}"] = _rank_async(mesh, data, dict(
            staleness_window=k, buffer_capacity=4, schedule="ppcc"), 2)
    out["watchdog"] = _rank_watchdog(mesh, data, ckpt_dir)
    out["async_ckpt"] = _rank_async_checkpoint(mesh, data, os.path.join(
        os.path.dirname(ckpt_dir), "async_ckpt"))
    out["steps"] = _rank_launch_steps(mesh, data)
    out["sinks"] = _rank_sinks(mesh, data, os.path.join(
        os.path.dirname(ckpt_dir), "serve_mesh"))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results (a future: the ranks run while the tests
    compute JAX's references), the shared data and the snapshot dir."""
    data = _data()
    tmp = tmp_path_factory.mktemp("mesh_train")
    path, ckpt = tmp / "data.pkl", tmp / "wd"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(run_ranks, _rank_main, WORLD,
                          (str(path), str(ckpt)), device="cpu", timeout=420)
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


def _named(tree, cfg, critic=False):
    """A JAX params tree by the port's parameter names (numpy float32)."""
    mod = (critic_from_jax_params(tree, cfg, device="cpu") if critic
           else from_jax_params(tree, cfg, device="cpu"))
    return {k: v.detach().float().numpy() for k, v in mod.named_parameters()}


def _mine(whole, specs, r):
    """The slice of each whole tensor that model rank ``r`` holds."""
    return {k: _slice(torch.as_tensor(v), specs.get(k, ()), 2, r).numpy()
            for k, v in whole.items()}


# ------------------------------------------------ steps in one process

STEP_ARCHS = ("qwen3-1.7b", "mixtral-8x22b", "rwkv6-3b", "deepseek-v3-671b")


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_step_functions_match_jax_in_one_process(ranks, arch):
    """``launch/steps.py`` in one process for each family (dense, MoE with
    its router losses, RWKV6, MLA): the cases of
    ``tests/distributed/test_launch_steps.py``, the chunked cross entropy
    against the naive one and the chunked scores against the direct ones
    (within JAX's 1e-5), and a train step of two chunked microbatches
    against JAX's (loss and grad norm within ``LOSS_RTOL``).  First in the
    file, while the ranks run (``ranks`` starts them)."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.engine.sampling import logprobs_of
    jcfg = jax_get_config(arch).reduced(vocab_size=64)
    cfg = get_config(arch).reduced(vocab_size=64)
    jparams = JM.init_lm(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    B, T = 4, 16
    rng = np.random.default_rng(3)
    tokens = rng.integers(3, 64, (B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    t, p = torch.as_tensor(tokens), torch.as_tensor(pos)
    with torch.no_grad():
        logits, _ = M.forward(model, cfg, t, p)
        hidden, _ = M.hidden_states(model, cfg, t, p)
        s, c = steps._ce_naive_sum(logits, t, p)
        s2, c2 = steps._ce_chunked_sum(model, cfg, hidden, t, p, chunk=4)
        direct = logprobs_of(logits[:, :-1], t[:, 1:])
        direct = torch.cat([torch.zeros_like(direct[:, :1]), direct], 1)
        chunked = steps._score_chunked(model, cfg, hidden, t, chunk=4)
    np.testing.assert_allclose(float(s2 / c2), float(s / c), rtol=1e-5)
    np.testing.assert_allclose(chunked.numpy(), direct.numpy(), atol=1e-5)
    ocfg = dict(lr=LR, clip_norm=1e9)
    kw = dict(ce_impl="chunked", ce_chunk=4, microbatch=2)
    _, _, jloss, jgn = jax_steps.make_train_step(
        jcfg, jax_adamw.AdamWConfig(**ocfg), **kw)(
        jparams, jax_adamw.init(jparams), jnp.asarray(tokens),
        jnp.asarray(pos))
    opt = adamw.init(list(model.parameters()))
    _, opt, loss, gn = steps.make_train_step(
        cfg, adamw.AdamWConfig(**ocfg), **kw)(model, opt, tokens, pos)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=LOSS_RTOL)
    assert opt["step"] == 1
    assert not any(q.requires_grad for q in model.parameters())


# ------------------------------------------------------------ gradients


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_gradient_shards_match_jax_grad(ranks, name):
    """Each rank's finished gradient of each parameter shard == the slice
    of JAX's ``jax.grad`` of the same loss on the whole batch."""
    _, data = ranks[0], ranks[1]
    kw, loss_kw = GRAD_CASES[name]
    jcfg = JaxModelConfig(**kw)
    b = data["grad_batch"]
    pcfg = JaxPolicyLossConfig(**loss_kw)

    def loss(p):
        return jax_trainer._actor_loss_fn(
            p, jcfg, pcfg, jnp.asarray(b["tokens"]), jnp.asarray(b["mask"]),
            b["P"], jnp.asarray(b["lp_old"]), jnp.asarray(b["adv"]),
            jnp.asarray(b["resp_mask"]), jnp.asarray(b["ref_lp"]), 1.0, 1.0,
            jcfg.router_aux_coef, jcfg.router_z_coef)

    (jloss, jinfo), jgrad = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, data["grad_params"][name]))
    want = _named(jax.tree.map(np.asarray, jgrad), ModelConfig(**kw))
    counts = b["resp_mask"].reshape(2, -1).sum(1)
    assert counts[0] != counts[1]
    res = [r["grads"][name] for r in _results(ranks)]
    for rank, got in enumerate(res):
        mine = _mine(want, got["specs"], got["model_rank"])
        assert set(mine) == set(got["grads"])
        for k, w in mine.items():
            g = got["grads"][k]
            assert g.shape == w.shape, (k, g.shape, w.shape)
            assert np.abs(w).max() > 0, f"{k}: zero"
            d = np.abs(g.astype(np.float64) - w).max()
            assert d <= GRAD_RTOL * np.abs(w).max(), (
                f"rank {rank} {k}: max diff {d}, largest {np.abs(w).max()}")
        np.testing.assert_allclose(got["info"]["loss"], float(jloss),
                                   rtol=LOSS_RTOL, atol=TOL)
        for k in ("clip_frac", "approx_kl", "ratio_mean", "entropy",
                  "kl_ref"):
            np.testing.assert_allclose(got["info"][k], float(jinfo[k]),
                                       rtol=LOSS_RTOL, atol=TOL, err_msg=k)
    # the ranks of a model group hold the same replicated gradients
    for r in (0, 1):
        for k, g in res[r]["grads"].items():
            if "model" not in res[r]["specs"].get(k, ()):
                np.testing.assert_array_equal(g, res[r + 2]["grads"][k])


# ------------------------------------------------------------ the trainer


def _jax_steps(monkeypatch, algo, n, rewards=_mixed, **kw):
    """JAX's trainer through ``n`` steps: per step its metrics, rollout,
    parameters (and critic's) before and after, moments after."""
    monkeypatch.setattr(jax_trainer, "batch_rewards", rewards)
    jtr = _jax_trainer(algo, **kw)
    out = []
    for _ in range(n):
        before = (jax.tree.map(np.asarray, jtr.params),
                  None if jtr.critic_params is None else
                  jax.tree.map(np.asarray, jtr.critic_params))
        m = jtr.train_step()
        out.append({"metrics": m, "rb": jtr.last_rb, "before": before,
                    "params": jax.tree.map(np.asarray, jtr.params),
                    "critic": None if jtr.critic_params is None else
                    jax.tree.map(np.asarray, jtr.critic_params),
                    "mu": jax.tree.map(np.asarray, jtr.opt_state["mu"]),
                    "nu": jax.tree.map(np.asarray, jtr.opt_state["nu"])})
    return out


def _scale(grad_norm):
    return min(1.0, 1.0 / (grad_norm + 1e-9))


def _adam_tol(p0, grads, lr, noise=GRAD_NOISE, b1=0.9, b2=0.999, eps=1e-8,
              wd=0.01, rtol=1e-6):
    """Bounds on a parameter's and its moments' distance from JAX's after
    AdamW steps from ``p0`` with the clipped gradients ``grads`` (one a
    step), each wrong by up to ``noise`` of its largest magnitude:
    ``_update_tol``'s model carried through the moments.  Returns
    (parameter, mu, nu) bounds."""
    e = np.zeros(np.shape(p0))
    m, v, dm, dv = (np.zeros_like(e) for _ in range(4))
    p = np.abs(np.asarray(p0, np.float64))
    for k, g in enumerate(grads, 1):
        g = np.asarray(g, np.float64)
        d = noise * np.abs(g).max()
        m, dm = b1 * m + (1 - b1) * g, b1 * dm + (1 - b1) * d
        v = b2 * v + (1 - b2) * g * g
        dv = b2 * dv + (1 - b2) * (2 * np.abs(g) * d + d * d)
        c1, c2 = 1 - b1 ** k, 1 - b2 ** k
        sv = np.sqrt(v / c2)
        lo = np.sqrt(np.maximum(v - dv, 0.0) / c2)
        du = (dm / c1) / (lo + eps) \
            + (np.abs(m) / c1) * (sv - lo) / ((lo + eps) * (sv + eps))
        e = e * (1 + lr * wd) + lr * np.minimum(du, 2.0) + rtol * (p + lr)
    return (e, dm + rtol * np.abs(m) + 1e-12,
            dv + rtol * np.abs(v) + 1e-12)


def _assert_steps(ranks, key, want, *, critic=False):
    _, cfg = _arch_cfgs()
    results = _results(ranks)
    for rank, res in enumerate(results):
        got = res[key]
        r = rank % 2
        hist, chist = {}, {}
        for step, (g, w) in enumerate(zip(got, want)):
            jrb, rb = w["rb"], g["rb"]
            for name in ("prompt", "response", "response_mask", "length"):
                np.testing.assert_array_equal(
                    rb[name], np.asarray(getattr(jrb, name)),
                    err_msg=f"rank {rank} step {step} {name}")
            wm = w["metrics"]
            assert set(g["metrics"]) == {k for k in wm if not k.endswith(
                "_time")}, set(g["metrics"]) ^ set(wm)
            for k, v in wm.items():
                if k.endswith("_time"):
                    continue
                if k in ("n_generated", "n_reused", "gen_steps",
                         "total_generated_tokens", "reward_mean"):
                    assert g["metrics"][k] == v, (rank, step, k)
                np.testing.assert_allclose(
                    g["metrics"][k], v, rtol=LOSS_RTOL, atol=TOL,
                    err_msg=f"rank {rank} step {step} {k}")
            specs = g["specs"]
            # the actor's own clip scale (PPO's step log carries the
            # critic's norm): from the port's whole gradient
            gn = (_actor_norm(results, key, step) if critic
                  else g["metrics"]["grad_norm"])
            p0 = _mine(_named(want[0]["before"][0], cfg), specs, r)
            for k, gr in g["grads"].items():
                hist.setdefault(k, []).append(gr * _scale(gn))
            wants = {name: _mine(_named(w[name], cfg), specs, r)
                     for name in ("params", "mu", "nu")}
            for k in p0:
                tols = _adam_tol(p0[k], hist[k], LR)
                for name, t in zip(("params", "mu", "nu"), tols):
                    d = np.abs(g[name][k].astype(np.float64)
                               - wants[name][k])
                    bad = d > t
                    assert not bad.any(), (
                        f"rank {rank} step {step} {name} {k}: "
                        f"{int(bad.sum())} off, max {d.max()}")
            if critic:
                wc = _mine(_named(w["critic"], cfg, critic=True), specs, r)
                cb = _mine(_named(want[0]["before"][1], cfg, critic=True),
                           specs, r)
                for k, wv in wc.items():
                    chist.setdefault(k, []).append(
                        g["critic_grads"][k]
                        * _scale(g["metrics"]["grad_norm"]))
                    t = _adam_tol(cb[k], chist[k], LR)[0]
                    d = np.abs(g["critic"][k].astype(np.float64) - wv)
                    assert not (d > t).any(), f"rank {rank} critic {k}"


def _actor_norm(results, key, step):
    """The actor's global gradient norm from the ranks' finished shards
    (rank 0 and 1: the two model ranks of data shard 0)."""
    tot = 0.0
    for r in (0, 1):
        g = results[r][key][step]
        for k, v in g["grads"].items():
            cut = "model" in g["specs"].get(k, ())
            if cut or r == 0:
                tot += float(np.sum(np.square(v.astype(np.float64))))
    return tot ** 0.5


def test_grpo_train_steps_match_jax(ranks, monkeypatch):
    """Two GRPO ``train_step``s (the spec variant: epoch 1 one-pass, KL to
    the reference) on the mesh == JAX's single device."""
    want = _jax_steps(monkeypatch, "grpo", 2)
    _assert_steps(ranks, "grpo", want)
    got = _results(ranks)[0]["grpo"][-1]["metrics"]
    assert got["one_pass"] == 1.0 and got["n_reused"] > 0
    assert got["kl_ref"] != 0.0 and got["grad_norm"] > 0


def test_ppo_train_step_matches_jax(ranks, monkeypatch):
    """One PPO step: values over each data rank's rows gathered, GAE on
    the whole batch, the critic's update, then the actor's."""
    want = _jax_steps(monkeypatch, "ppo", 1)
    _assert_steps(ranks, "ppo", want, critic=True)
    assert _results(ranks)[0]["ppo"][0]["metrics"]["critic_loss"] > 0


def test_dapo_train_step_with_a_resample_round_matches_jax(ranks,
                                                          monkeypatch):
    """One DAPO step whose degenerate groups are re-rolled on the mesh
    (the resample batch is sharded over the data axis too)."""
    want = _jax_steps(monkeypatch, "dapo", 1, rewards=_stub_rewards,
                      max_resample_rounds=2)
    _assert_steps(ranks, "dapo", want)
    assert want[0]["metrics"]["gen_steps"] > 1


def test_every_rank_logs_the_same_step(ranks):
    results = _results(ranks)
    for key in ("grpo", "ppo", "dapo"):
        base = [s["metrics"] for s in results[0][key]]
        for res in results[1:]:
            assert [s["metrics"] for s in res[key]] == base, key


# ------------------------------------------------------------ async


def _jax_async(monkeypatch, acfg, n):
    for mod in (jax_trainer, jax_async):
        monkeypatch.setattr(mod, "batch_rewards", _mixed)
    jtr = _jax_trainer()
    log = []
    optimize = jtr.optimize

    def spy(rb, rewards, times, **kw):
        log.append((np.array(rb.response), np.array(rb.length),
                    kw.get("behaviour_lp") is not None))
        return optimize(rb, rewards, times, **kw)

    jtr.optimize = spy
    jat = jax_async.AsyncTrainer(jtr, jax_async.AsyncConfig(**acfg),
                                 sync=JaxWeightSync(JaxBackoffConfig(
                                     base=0.0, max_attempts=3),
                                     sleep=lambda d: None))
    return jat.run(n), log, jat.counters()


def test_async_k0_is_identical_to_the_sync_mesh_trainer(ranks):
    """K = 0, ``"pc"``: the async loop over the mesh trainer equals the
    synchronous mesh trainer bit for bit (tokens, losses, weights)."""
    for res in _results(ranks):
        at, sync = res["async_pc"], res["grpo"]
        for (resp, length, is_), s in zip(at["log"], sync):
            np.testing.assert_array_equal(resp, s["rb"]["response"])
            np.testing.assert_array_equal(length, s["rb"]["length"])
            assert not is_
        for m, s in zip(at["metrics"], sync):
            assert m["loss"] == s["metrics"]["loss"]
            assert m["grad_norm"] == s["metrics"]["grad_norm"]
        for k, v in at["params"].items():
            np.testing.assert_array_equal(v, sync[-1]["params"][k])
        assert at["counters"]["async_exact_steps"] == 2


@pytest.mark.parametrize("k", [0, 1], ids=["reverified", "is_corrected"])
def test_async_ppcc_matches_jax(ranks, monkeypatch, k):
    """``"ppcc"``: the second step consumes a trajectory one version old,
    re-verified under the current weights (K = 0) or importance-corrected
    (K = 1), on the mesh as in JAX."""
    want, jlog, jcounters = _jax_async(monkeypatch, dict(
        staleness_window=k, buffer_capacity=4, schedule="ppcc"), 2)
    for res in _results(ranks):
        got = res[f"async_ppcc_k{k}"]
        for (r, n, is_), (jr, jn, jis) in zip(got["log"], jlog):
            np.testing.assert_array_equal(r, jr)
            np.testing.assert_array_equal(n, jn)
            assert is_ == jis
        for g, w in zip(got["metrics"], want):
            for key, v in w.items():
                if key.endswith("_time") or key == "service_wait_s":
                    continue
                np.testing.assert_allclose(g[key], v, rtol=LOSS_RTOL,
                                           atol=TOL, err_msg=key)
        assert got["counters"] == jcounters
    c = _results(ranks)[0][f"async_ppcc_k{k}"]["counters"]
    assert (c["async_reverified"], c["async_is_steps"]) == \
        ((1.0, 0.0) if k == 0 else (0.0, 1.0))


# ------------------------------------------------------------ watchdog


def test_watchdog_snapshot_loads_into_jax_and_restores(ranks, monkeypatch):
    """The mesh's snapshot after step 0 is one whole tree that JAX's
    loader reads: its parameters are JAX's after the step (as the port's
    single device's are, within ``_update_tol``), and restored into a
    fresh mesh trainer the next step equals the uninterrupted one bit for
    bit."""
    _, data, ckpt = ranks
    results = _results(ranks)
    want = _jax_steps(monkeypatch, "grpo", 1)[0]
    tree, meta = jax_load_pytree(os.path.join(ckpt, "watchdog_000000"))
    assert meta["step"] == 0
    _, cfg = _arch_cfgs()
    model = M.LM(cfg, device="cpu")
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.as_tensor(np.array(tree["params"][k])))
    from repro_torch.models.convert import to_jax_params
    got = to_jax_params(model)
    jtr = _jax_trainer()
    assert jax.tree.structure(got) == jax.tree.structure(jtr.params)
    jtr.params = jax.tree.map(jnp.asarray, got)      # JAX's trainer takes it
    g0 = results[0]["grpo"][0]
    before = _named(want["before"][0], cfg)
    wants = _named(want["params"], cfg)
    assert set(wants) == set(tree["params"])
    for k, w in wants.items():
        p = np.asarray(tree["params"][k], np.float64)
        assert p.shape == w.shape
        if "model" in g0["specs"].get(k, ()):
            # the whole gradient from the two model ranks' shards
            dim = g0["specs"][k].index("model")
            grad = np.concatenate([results[r]["grpo"][0]["grads"][k]
                                   for r in (0, 1)], axis=dim)
        else:
            grad = g0["grads"][k]
        t = _update_tol(before[k], grad, LR,
                        _scale(g0["metrics"]["grad_norm"]))
        assert not (np.abs(p - w) > t).any(), k
    for res in results:
        w = res["watchdog"]
        assert w["snapshots"] == 1
        for k, v in w["after1"].items():
            np.testing.assert_array_equal(w["restored"][k], v)
        assert w["equal_after"] and w["equal_moments"]
        assert w["resumed"] == w["uninterrupted"]


def test_async_pair_checkpoint_on_the_mesh_restores_every_shard(ranks):
    """``AsyncTrainer.save`` on the mesh writes one checkpoint (rank 0's),
    and ``restore`` into a fresh pair brings back every rank's parameter
    and moment shards and the service's shards bit for bit."""
    res = [r["async_ckpt"] for r in _results(ranks)]
    for r in res:
        assert r["equal"] and all(r["equal"])
        assert r["versions"][0] == r["versions"][1]
        assert r["files"] == res[0]["files"] and "latest" in r["files"]


# ------------------------------------------------------------ launch/steps


@pytest.mark.parametrize("name", ["naive", "chunked_mb2"])
def test_train_step_on_the_mesh_matches_jax(ranks, name):
    """``make_train_step`` on the mesh (the cross entropy over the whole
    batch's count, two microbatches summed as JAX's scan) == JAX's
    ``make_train_step`` on one device."""
    _, data = ranks[0], ranks[1]
    jcfg = JaxModelConfig(**STEPS_CFG)
    b = data["steps_batch"]
    ocfg = jax_adamw.AdamWConfig(lr=LR, clip_norm=1e9)
    params = jax.tree.map(jnp.asarray, data["steps_params"])
    kw = {} if name == "naive" else dict(ce_impl="chunked", ce_chunk=4,
                                         microbatch=2)
    p1, _, loss, gnorm = jax_steps.make_train_step(jcfg, ocfg, **kw)(
        params, jax_adamw.init(params), jnp.asarray(b["tokens"]),
        jnp.asarray(b["positions"]))

    def ce(p):
        logits, _ = JM.forward(p, jcfg, jnp.asarray(b["tokens"]),
                               jnp.asarray(b["positions"]))
        return jax_steps._ce_naive(p, jcfg, logits, jnp.asarray(b["tokens"]),
                                   jnp.asarray(b["positions"]))

    cfg = ModelConfig(**STEPS_CFG)
    grads = _named(jax.tree.map(np.asarray, jax.grad(ce)(params)), cfg)
    before = _named(data["steps_params"], cfg)
    want = _named(jax.tree.map(np.asarray, p1), cfg)
    for rank, res in enumerate(_results(ranks)):
        got = res["steps"][name]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], float(gnorm),
                                   rtol=LOSS_RTOL)
        r = rank % 2
        for k, w in _mine(want, got["specs"], r).items():
            g0 = _mine(before, got["specs"], r)[k]
            gr = _mine(grads, got["specs"], r)[k]
            # two microbatches reorder the float32 sums (JAX's own test
            # holds them within atol 5e-5 of the full batch)
            t = _update_tol(g0, gr, LR, 1.0) + (5e-5 if kw else 0.0)
            d = np.abs(got["params"][k].astype(np.float64) - w)
            assert not (d > t).any(), f"rank {rank} {k}: max {d.max()}"


@pytest.mark.parametrize("name", ["verify_naive", "verify_chunked"])
def test_verify_step_on_the_mesh_matches_jax(ranks, name):
    _, data = ranks[0], ranks[1]
    jcfg = JaxModelConfig(**STEPS_CFG)
    b = data["steps_batch"]
    kw = {} if name == "verify_naive" else dict(score_impl="chunked",
                                                 score_chunk=4)
    n, lp = jax_steps.make_verify_step(jcfg, **kw)(
        jax.tree.map(jnp.asarray, data["steps_params"]),
        jnp.asarray(b["tokens"]), jnp.asarray(b["positions"]),
        jnp.asarray(b["dlp"]), jnp.asarray(b["u"]), jnp.asarray(b["dlen"]),
        0.5)
    for res in _results(ranks):
        gn, glp = res["steps"][name]
        np.testing.assert_array_equal(gn, np.asarray(n))
        np.testing.assert_allclose(glp, np.asarray(lp), atol=1e-5)


def test_serve_step_on_the_mesh_matches_the_single_process(ranks):
    for res in _results(ranks):
        got, ref = res["steps"]["serve"]
        np.testing.assert_allclose(got, ref, atol=1e-5)


# ------------------------------------------------------------ the sinks


def test_drafted_loop_sinks_on_the_mesh_match_the_single_process(ranks):
    """The drafted loop's ledger rows and decision records on the
    data-sharded mesh == the single process's, on every rank."""
    _, data = ranks[0], ranks[1]
    cfg = ModelConfig(**ROLL_CFGS["a"])
    want = _drafted_epochs([from_jax_params(p, cfg, device="cpu")
                            for p in data["draft_params"]], cfg, data)
    assert want["recs"] and want["rows"]
    assert want["rbs"][1][2]["n_reused"] > 0
    for res in _results(ranks):
        got = res["sinks"]["drafted"]
        for (r, n, _), (wr, wn, _) in zip(got["rbs"], want["rbs"]):
            np.testing.assert_array_equal(r, wr)
            np.testing.assert_array_equal(n, wn)
        assert got["rows"] == want["rows"]
        assert len(got["recs"]) == len(want["recs"])
        for g, w in zip(got["recs"], want["recs"]):
            assert g[:2] == w[:2]
            np.testing.assert_allclose(g[2], w[2], rtol=1e-6, atol=1e-6)
            assert g[3] == w[3]


def _prom_counts(path):
    with open(path) as f:
        return sorted(ln for ln in f if ln.startswith("attrib_tokens"))


def _lanes(path):
    import json
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return sorted({(e.get("args") or {}).get("name", "") for e in events
                   if e.get("ph") == "M"})


def _by_row(path):
    from repro_torch.obs.ledger import DECISION_OUTCOMES, load_dataset
    d = load_dataset(path)
    keep = [i for i, k in enumerate(DECISION_OUTCOMES) if k != "step_ms"]
    out = {}
    for row, o in zip(d["row"], d["outcomes"]):
        out.setdefault(str(row), []).append(tuple(o[keep].tolist()))
    return out


def test_serve_sinks_on_the_mesh_match_the_single_process(ranks, tmp_path):
    """``launch/serve.py``'s sinks on the mesh: rank 0 writes every shard's
    attribution token counts and request lanes, and each data shard's
    first model rank its decision records, which load together into each
    request's outcomes, in order, as the single process writes them."""
    from repro_torch import obs
    from repro_torch.launch import serve as launch_serve
    _, _, ckpt = ranks
    results = _results(ranks)
    mesh_dir = os.path.join(os.path.dirname(ckpt), "serve_mesh")
    try:
        assert launch_serve.main(SERVE_ARGS + [
            "--trace-dir", str(tmp_path / "trace"),
            "--decision-log", str(tmp_path / "dec")]) == 0
    finally:
        obs.reset()
    assert _prom_counts(os.path.join(mesh_dir, "trace", "metrics.prom")) \
        == _prom_counts(tmp_path / "trace" / "metrics.prom")
    assert _by_row(os.path.join(mesh_dir, "dec")) == \
        _by_row(str(tmp_path / "dec"))
    # each data shard's first model rank writes its own decision files
    assert sorted(f for f in os.listdir(os.path.join(mesh_dir, "dec"))
                  if f.endswith(".npz")) == ["decisions-s0-00000.npz",
                                             "decisions-s1-00000.npz"]
    assert _lanes(os.path.join(mesh_dir, "trace", "trace.json")) == \
        _lanes(tmp_path / "trace" / "trace.json")
    out = results[0]["sinks"]["serve"]
    assert "shards=2" in out and "served 6/6" in out
    assert "metrics: http://localhost:" in out
    assert all(r["sinks"]["serve"] == "" for r in results[1:])


def test_metrics_board_merges_every_shard_without_a_collective(ranks):
    """``MetricsBoard``: each data shard's first model rank publishes its
    registry after its chunks, and the merge of the latest publications,
    read on any rank, equals the writers' collective merge
    (``metrics_registry``) but for the wall clock each reads."""
    res = [r["sinks"]["board"] for r in _results(ranks)]
    assert [r["writer"] for r in res] == [True, False, True, False]
    assert all(r["published"] for r in res)     # by the shard's writer
    def clean(d):
        return {k: v for k, v in d.items() if k != "wall_time"}

    for r in res:                              # one board, read anywhere
        assert clean(r["got"]) == clean(res[0]["got"])
    for r in res[::2]:
        # the writers' collective merge: the other model rank's holds its
        # own clocks' timings
        assert r["want"]["completed"] > 0 and r["want"]["num_shards"] == 2
        assert clean(r["got"]) == clean(r["want"])


def test_agreed_stop_stops_a_model_group_together(ranks):
    """A kill seen by rank 0 alone stops its model group (ranks 0 and 1)
    at one chunk; shard 1 runs on; the gathered snapshot resumes every
    shard to the uninterrupted responses."""
    res = [r["sinks"]["agreed"] for r in _results(ranks)]
    assert [r["killed"] for r in res] == [True, True, False, False]
    assert res[0]["steps"] == res[1]["steps"]
    for r in res:
        assert r["resumed"] == r["whole"]

