"""The port's PPO critic and DAPO's dynamic sampling on the CPU against
``repro``: ``rl/critic.py``, its parameter conversion, one PPO
``Trainer.optimize``, two PPO and two DAPO ``Trainer.train_step`` calls,
``_subset_batch``/``_merge_rollouts``, the SPEC-RL × DAPO resample
finding, and the launcher's ``--algo ppo|dapo``.

Parameters come from JAX's ``init_lm``/``init_critic`` through
``from_jax_params``/``critic_from_jax_params``; random draws are shared
through ``JaxKey``.  Float32 throughout.  Tolerances, stated where used:

* values: within 1e-5 (float32 sums over the trunk in another order);
* one ``optimize``: as ``tests/test_torch_train.py``'s GRPO one (losses
  and grad norms within rtol 1e-4, every gradient leaf of the actor and of
  the critic within 5e-5 of that leaf's largest, both updated parameter
  trees within ``_update_tol``);
* train steps: tokens, lengths, ``n_generated``, ``n_reused`` and
  ``gen_steps`` equal; the other step-log numbers within rtol 1e-4, atol
  1e-6; the same key sets;
* ``_subset_batch``/``_merge_rollouts``: equal.

``batch_rewards`` is replaced in both packages by the same deterministic
function of the response tokens (and, for DAPO, of the prompt's answer,
so that some groups are degenerate): a random model earns 0 everywhere
from the verifier, which leaves GAE's returns 0 and makes every DAPO group
degenerate.
"""
import math
import re

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import SpecConfig as JaxSpecConfig  # noqa: E402
from repro.core.spec_rollout import RolloutBatch as JaxRolloutBatch  # noqa: E402
from repro.data.dataset import PromptBatch as JaxPromptBatch  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.rl import critic as jax_critic  # noqa: E402
from repro.rl import trainer as jax_trainer  # noqa: E402
from repro.rl.trainer import RLConfig as JaxRLConfig  # noqa: E402
from repro.rl.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SpecConfig  # noqa: E402
from repro_torch.core.spec_rollout import RolloutBatch  # noqa: E402
from repro_torch.data.dataset import PromptBatch  # noqa: E402
from repro_torch.data.tokenizer import VOCAB_SIZE  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.rl.critic import (critic_from_jax_params,  # noqa: E402
                                   critic_to_jax_params)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.rl import critic as port_critic  # noqa: E402
from repro_torch.rl import trainer as port_trainer  # noqa: E402
from repro_torch.rl.trainer import RLConfig, Trainer  # noqa: E402
from test_torch_rollout import JaxKey  # noqa: E402
from test_torch_train import (LOSS_RTOL, TOL, _capture_jax_grads,  # noqa: E402
                              _capture_port_grads, _check_grad_tree,
                              _check_grads, _check_params, _check_tree,
                              _datasets, _grads_tree, _mixed_rewards, _model,
                              _port_rb)

VALUE_TOL = 1e-5
ARCHS = {"qwen3-1.7b": {"num_kv_heads": 2}, "rwkv6-3b": {"scan_chunk": 4}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one CPU thread for the module: the reduced models' small
    ops gain nothing from more, while test processes sharing the cores
    lose much to them (each process's threads would compete for the same
    cores)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **extra):
    kw = dict(vocab_size=max(VOCAB_SIZE, 64), **ARCHS[arch], **extra)
    return jax_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def _critic(cfg, jparams):
    return critic_from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                  device="cpu")


# ---------------------------------------------------------------- critic


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_values_matches_jax(arch, grad):
    """Values of left-padded rows with a padded tail, through the no-grad
    route (the kernels' plain versions on the CPU) and the gradient route
    (``dot_product_attention``; rwkv6-3b's ``wkv_scan`` in chunks of 4),
    within VALUE_TOL, and exactly 0 off the mask."""
    jcfg, cfg = _cfgs(arch)
    jparams = jax_critic.init_critic(jax.random.PRNGKey(3), jcfg)
    critic = _critic(cfg, jparams)
    rng = np.random.default_rng(9)
    toks = rng.integers(3, cfg.vocab_size, (3, 11)).astype(np.int32)
    mask = np.ones((3, 11), bool)
    mask[0, :4] = False
    mask[1, 8:] = False
    want = np.asarray(jax_critic.forward_values(jparams, jcfg, toks, mask))
    critic.requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        got = port_critic.forward_values(critic, cfg, torch.from_numpy(toks),
                                         torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.requires_grad == grad
    got = got.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_TOL)
    assert np.all(got[~mask] == 0.0) and np.abs(got[mask]).max() > 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_critic_to_jax_params_inverts_critic_from_jax_params(arch):
    jcfg, cfg = _cfgs(arch)
    want = jax.tree.map(np.asarray,
                        jax_critic.init_critic(jax.random.PRNGKey(4), jcfg))
    got = critic_to_jax_params(critic_from_jax_params(want, cfg,
                                                      device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)


def test_init_critic_counts_and_draws():
    """The critic is the actor less its head plus a (d_model, 1) head with
    a bias; its parameters are frozen; the bias starts at 0; a seed draws
    the same critic twice."""
    _, cfg = _cfgs("qwen3-1.7b")
    actor = M.init_lm(cfg, seed=0, device="cpu")
    critic = port_critic.init_critic(cfg, seed=5, device="cpu")
    assert M.count_params(critic) == (M.count_params(actor)
                                      - actor.lm_head.kernel.numel()
                                      + cfg.d_model + 1)
    assert not any(p.requires_grad for p in critic.parameters())
    assert float(critic.value_head.bias) == 0.0
    again = port_critic.init_critic(cfg, seed=5, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(critic.parameters(),
                                                  again.parameters()))


# ---------------------------------------------------------------- trainers


def _trainers(arch, algo, *, lr=1e-3, critic_lr=1e-3, spec=None, **rl_extra):
    """JAX's Trainer and the port's from the same parameters (actor and,
    for PPO, critic) and key."""
    jcfg, cfg = _cfgs(arch)
    rl_kw = dict(dict(algo=algo, group_size=4, prompts_per_batch=2,
                      max_new_tokens=6), **rl_extra)
    jrl = JaxRLConfig(optim=jax_adamw.AdamWConfig(lr=lr),
                      critic_optim=jax_adamw.AdamWConfig(lr=critic_lr),
                      **rl_kw)
    rl = RLConfig(optim=adamw.AdamWConfig(lr=lr),
                  critic_optim=adamw.AdamWConfig(lr=critic_lr), **rl_kw)
    jspec, pspec = spec or (JaxSpecConfig(), SpecConfig())
    jds, ds = _datasets()
    jtr = JaxTrainer(jcfg, jrl, jspec, jds, jax.random.PRNGKey(0))
    tr = Trainer(cfg, rl, pspec, ds, JaxKey(jax.random.PRNGKey(0)),
                 model=_model(cfg, jtr.params), device="cpu")
    assert (tr.critic is None) == (jtr.critic_params is None)
    assert (tr.ref_model is None) == (jtr.ref_params is None)
    if tr.critic is not None:
        tr.critic = _critic(cfg, jtr.critic_params)
        tr.critic_opt_state = adamw.init(port_trainer.trainable(tr.critic))
    return jtr, tr


def _capture_critic_grads(monkeypatch):
    """Spy on JAX's ``_update_critic``: it also leaves ``jax.grad`` of its
    value loss on the same inputs in the returned list."""
    out = []
    jupdate = jax_trainer._update_critic

    def jspy(cparams, copt, cfg, ocfg, ft, fm, resp_start, returns, old, rm):
        def loss(p):
            v = jax_critic.forward_values(p, cfg, ft, fm)[:, resp_start:]
            return jax_trainer.value_loss(v, returns, old, rm)
        out.append(jax.grad(loss)(cparams))
        return jupdate(cparams, copt, cfg, ocfg, ft, fm, resp_start, returns,
                       old, rm)

    monkeypatch.setattr(jax_trainer, "_update_critic", jspy)
    return out


@pytest.mark.parametrize("algo", ["gpro", "PPO", ""])
def test_unknown_algo_raises(algo):
    """A name outside ``ALGOS`` is refused where the config is made, not
    trained as a mix of PPO's loss settings and GRPO's advantages."""
    with pytest.raises(ValueError, match="unknown algo"):
        RLConfig(algo=algo)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_one_ppo_optimize_matches_jax(arch, monkeypatch):
    """One PPO ``optimize`` on one collected rollout with seeded mixed
    rewards: values → GAE → the critic's update → the actor's, the step
    log (whose ``grad_norm`` and ``lr`` are the critic's, as in JAX's),
    every gradient leaf of both models against ``jax.grad`` and both
    updated parameter trees."""
    lr = 1e-3
    jtr, tr = _trainers(arch, "ppo", lr=lr, critic_lr=lr)
    _, jrb, _, jtimes = jtr._collect(jtr.collector.sample(0))
    rewards = _mixed_rewards(jrb.prompt.shape[0], 4)
    before, cbefore = jtr.params, jtr.critic_params
    jgrads = _capture_jax_grads(monkeypatch)
    cgrads = _capture_critic_grads(monkeypatch)
    grads = _capture_port_grads(monkeypatch)
    want = jtr.optimize(jrb, rewards, dict(jtimes))
    got = tr.optimize(_port_rb(jrb), rewards, dict(jtimes))
    assert set(got) == set(want)
    assert {"values_time", "update_critic_time", "critic_loss"} <= set(got)
    assert "ref_time" not in got and "kl_ref" not in got
    for k in ("loss", "critic_loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, atol=TOL,
                                   err_msg=k)
    for k in ("clip_frac", "approx_kl"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                   err_msg=k)
    assert got["lr"] == want["lr"] and want["critic_loss"] > 0
    assert not any(p.requires_grad for p in tr.critic.parameters())
    critic_grads = _grads_tree(tr.critic, grads, critic_to_jax_params)
    _check_grads(tr, grads, jgrads[0])
    _check_grad_tree(critic_grads, cgrads[0])
    # the actor's own grad norm: the port's gradient against JAX's
    actor_norm = float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                                   for g in jax.tree.leaves(jgrads[0]))))
    _check_params(tr, jtr, grads, before, lr, actor_norm)
    _check_tree(critic_to_jax_params(tr.critic), jtr.critic_params, cbefore,
                critic_grads, lr, want["grad_norm"])


def _stub_rewards(responses, lengths, answers):
    """0/1 from the parity of the response's token sum; 0 for every row of
    a prompt whose answer is even (a degenerate group, whatever the
    responses)."""
    out = np.zeros((len(answers),), np.float32)
    for i, ans in enumerate(answers):
        if int(ans) % 2:
            out[i] = float(int(np.asarray(responses[i, :int(lengths[i])],
                                          np.int64).sum()) % 2)
    return out


@pytest.mark.parametrize("algo", ["ppo", "dapo"])
def test_two_train_steps_match_jax(algo, monkeypatch):
    """Two full ``train_step`` calls of each package (epoch 0 vanilla,
    epoch 1 one-pass spec), the same reward stub patched into both: equal
    tokens, lengths, reuse counts and ``gen_steps`` (DAPO's resample
    rounds included), equal step-log keys, the rest within rtol 1e-4."""
    monkeypatch.setattr(jax_trainer, "batch_rewards", _stub_rewards)
    monkeypatch.setattr(port_trainer, "batch_rewards", _stub_rewards)
    jtr, tr = _trainers("qwen3-1.7b", algo, lr=5e-7, critic_lr=1e-5,
                        max_resample_rounds=2)
    for step in range(2):
        want = jtr.train_step()
        got = tr.train_step()
        jrb, rb = jtr.last_rb, tr.last_rb
        for name in ("prompt", "response", "response_mask", "length"):
            np.testing.assert_array_equal(getattr(rb, name),
                                          np.asarray(getattr(jrb, name)),
                                          err_msg=f"step {step} {name}")
        assert set(got) == set(want)
        for k, v in want.items():
            if k.endswith("_time"):
                continue
            if k in ("n_generated", "n_reused", "gen_steps",
                     "total_generated_tokens"):
                assert got[k] == v, f"step {step} {k}: {got[k]} != {v}"
            np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, atol=TOL,
                                       err_msg=f"step {step} {k}")
    assert got["one_pass"] == 1.0 and got["n_reused"] > 0
    if algo == "dapo":
        # at least one group was degenerate and re-rolled
        assert tr.gen_steps > 2
    else:
        assert got["critic_loss"] > 0 and got["values_time"] > 0


# ---------------------------------------------------------------- DAPO


def _batches(rng, B=12, P=5, G=4):
    tokens = rng.integers(3, 50, (B, P)).astype(np.int32)
    mask = rng.random((B, P)) < 0.8
    lists = dict(cache_keys=list(range(100, 100 + B)),
                 answers=list(rng.integers(0, 9, B)),
                 problem_ids=[i // G for i in range(B)])
    return (PromptBatch(tokens=tokens, mask=mask, epoch=3, **lists),
            JaxPromptBatch(tokens=tokens, mask=mask, epoch=3, **lists))


def _rollouts(rng, B, N=6, **metrics):
    arrays = dict(prompt=rng.integers(3, 50, (B, 5)).astype(np.int32),
                  prompt_mask=rng.random((B, 5)) < 0.8,
                  response=rng.integers(3, 50, (B, N)).astype(np.int32),
                  response_mask=rng.random((B, N)) < 0.7,
                  behaviour_logprobs=-rng.random((B, N)).astype(np.float32),
                  length=rng.integers(0, N + 1, B).astype(np.int32))
    base = dict(n_generated=7.0, n_reused=3.0, decode_time=0.5)
    m = {**base, **metrics}
    return (RolloutBatch(**arrays, metrics=dict(m),
                         n=rng.integers(0, N, B).astype(np.int32)),
            JaxRolloutBatch(**arrays, metrics=dict(m)))


@pytest.mark.parametrize("groups", [[0], [1, 2], [0, 2]])
def test_subset_batch_and_merge_rollouts_match_jax(groups):
    G = 4
    rng = np.random.default_rng(len(groups) + groups[0])
    idxs = np.array(groups)
    batch, jbatch = _batches(rng)
    got = port_trainer._subset_batch(batch, idxs, G)
    want = jax_trainer._subset_batch(jbatch, idxs, G)
    for name in ("tokens", "mask"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for name in ("cache_keys", "answers", "problem_ids", "epoch"):
        assert getattr(got, name) == getattr(want, name), name
    rb, jrb = _rollouts(rng, 12)
    rb2, jrb2 = _rollouts(rng, G * len(groups), n_generated=11.0,
                          n_reused=5.0, decode_time=9.0)
    got = port_trainer._merge_rollouts(rb, rb2, idxs, G)
    want = jax_trainer._merge_rollouts(jrb, jrb2, idxs, G)
    for name in ("prompt", "prompt_mask", "response", "response_mask",
                 "behaviour_logprobs", "length"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.metrics == want.metrics
    rows = port_trainer._group_rows(idxs, G)
    np.testing.assert_array_equal(got.n[rows], rb2.n)
    keep = np.setdiff1d(np.arange(12), rows)
    np.testing.assert_array_equal(got.n[keep], rb.n[keep])
    assert rb.metrics["n_generated"] == 7.0     # inputs untouched


def _round_spy(collector, rounds):
    """Record each ``rollout_once`` of a collector: (its rows' cache keys,
    its RolloutBatch)."""
    once = collector.rollout_once

    def spy(params, batch, epoch):
        rb = once(params, batch, epoch)
        rounds.append((list(batch.cache_keys), rb))
        return rb
    collector.rollout_once = spy


@pytest.mark.parametrize("lenience", [math.e ** 0.5, 0.99],
                         ids=["e^0.5", "0.99"])
def test_spec_rl_dapo_resample_reuses_the_round_it_replaces(lenience,
                                                            monkeypatch):
    """A property of the reference, carried over: DAPO's resample rounds
    run ``rollout_once`` on the same prompts in the same epoch, after the
    first round has put its responses into the SPEC-RL cache, so each
    round drafts from the round before and verifies it under the same
    parameters.  With every reward 0 (every group degenerate) and two
    resample rounds: at lenience e^0.5 (≥ 1, every draft token accepted)
    each resample generates nothing and returns the first round's
    responses, in JAX and in the port; at 0.99 the port's per-round counts
    and tokens equal JAX's."""
    zeros = lambda r, l, a: np.zeros((len(a),), np.float32)  # noqa: E731
    monkeypatch.setattr(jax_trainer, "batch_rewards", zeros)
    monkeypatch.setattr(port_trainer, "batch_rewards", zeros)
    jtr, tr = _trainers("qwen3-1.7b", "dapo", max_new_tokens=8,
                        max_resample_rounds=2,
                        spec=(JaxSpecConfig(lenience=lenience),
                              SpecConfig(lenience=lenience)))
    jrounds, rounds = [], []
    _round_spy(jtr.collector, jrounds)
    _round_spy(tr.collector, rounds)
    batch = jtr.collector.sample(0)
    jtr._collect(batch)
    tr._collect(tr.collector.sample(0))
    assert len(rounds) == len(jrounds) == 3
    B = batch.tokens.shape[0]
    for i, ((keys, rb), (jkeys, jrb)) in enumerate(zip(rounds, jrounds)):
        assert keys == jkeys == list(batch.cache_keys), f"round {i}"
        np.testing.assert_array_equal(rb.response, np.asarray(jrb.response))
        np.testing.assert_array_equal(rb.length, np.asarray(jrb.length))
        for k in ("n_generated", "n_reused", "one_pass"):
            assert rb.metrics[k] == jrb.metrics[k], f"round {i} {k}"
    first = rounds[0][1]
    assert first.metrics["n_reused"] == 0
    if lenience > 1:
        for i, (_, rb) in enumerate(rounds[1:], 1):
            for r in (rb, jrounds[i][1]):
                assert r.metrics["n_generated"] == 0, f"round {i}"
                assert r.metrics["n_reused"] == int(first.length.sum())
                np.testing.assert_array_equal(np.asarray(r.response),
                                              first.response)
    else:
        assert rounds[1][1].metrics["n_reused"] > 0
    assert tr.gen_steps == jtr.gen_steps == 3 and B == 8


# ---------------------------------------------------------------- launcher

# JAX's ``_step_line`` (repro/launch/train.py) without the draft fields
STEP_LINE = re.compile(r"^step +\d+ reward=\d\.\d{3} gen_tok= *\d+ "
                       r"reused= *\d+$")


@pytest.mark.parametrize("algo", ["ppo", "dapo"])
def test_launcher_runs_ppo_and_dapo_on_the_cpu(algo, capsys):
    assert launch_train.main(["--device", "cpu", "--smoke", "--steps", "2",
                              "--algo", algo]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=qwen3-1.7b-smoke")
    assert len(lines) == 3 and all(STEP_LINE.match(ln) for ln in lines[1:])
    assert [ln.split()[:2] for ln in lines[1:]] == [["step", "0"],
                                                    ["step", "1"]]
