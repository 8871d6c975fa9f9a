"""The four architectures of the port's mixture-of-experts slice and
deepseek-v3-671b on the CPU against the JAX model, with JAX's parameters
carried across by ``from_jax_params``: deepseek-7b (MHA, G = 1),
qwen1.5-110b (QKV bias), granite-34b (MQA, a GELU MLP), mixtral-8x22b (MoE,
sliding window) and deepseek-v3-671b (MLA over a latent cache, MoE with a
shared expert after a dense layer, an MTP head), each ``reduced()`` in
float32, mixtral also with ``moe_impl="dispatch"`` and a window of 5
(shorter than the sequences, so it masks).

Held: ``forward`` logits and aux, ``score``, prefill plus decode steps and
the caches, ``realign_decode_cache``, and a two-epoch one-pass ``rollout``
(tokens, lengths and counts equal to JAX's, keys through ``JaxKey``); then
one GRPO ``optimize`` of reduced mixtral (dispatch) with the tolerances of
``test_torch_train.py``'s optimize.  jamba-v0.1-52b's, pixtral-12b's and
whisper-tiny's configs are checked here with the others (their models:
``test_torch_mamba.py``, ``test_torch_frontends.py``; deepseek-v3's MLA
layer, MTP, slot engines and GRPO step: ``test_torch_mla.py``), and the two
frontends go through the port's twin of ``tests/test_archs_smoke.py``:
forward shapes, one LM-loss train step and one serve step.  Inputs are
numpy arrays from a seed; torch runs on one thread; JAX's model functions
run under ``jax.jit`` (one compile each in place of one per operation),
each case's model pair built once with JAX's forward and score from one
jitted call.  Logits, caches and log-probs within atol 1e-4 (float32
through two layers summed in another order)."""
import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.core.spec_rollout as jax_spec_rollout  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import RolloutCache as JaxRolloutCache  # noqa: E402
from repro.core import SpecConfig as JaxSpecConfig  # noqa: E402
from repro.engine.generate import GenerateConfig as JaxGenerateConfig  # noqa: E402
from repro.engine.generate import positions_from_mask as jax_positions  # noqa: E402
from repro.engine.generate import score as jax_score  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core import RolloutCache, SpecConfig, rollout  # noqa: E402
from repro_torch.data.dataset import PromptDataset  # noqa: E402
from repro_torch.data.tokenizer import EOS_ID, PAD_ID  # noqa: E402
from repro_torch.engine.generate import (GenerateConfig,  # noqa: E402
                                         positions_from_mask, score)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.attention import cache_leaves  # noqa: E402
from repro_torch.models.blocks import check_supported  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.rewards.mathgen import MathTaskConfig, generate_problems  # noqa: E402
from test_torch_rollout import JaxKey  # noqa: E402
from test_torch_train import (LOSS_RTOL, TOL, _capture_jax_grads,  # noqa: E402
                              _capture_port_grads, _check_grads,
                              _check_params, _close, _mixed_rewards,
                              _port_rb, _trainers)

ATOL = 1e-4
B, P, STEPS = 3, 10, 4
ARCHS = {
    "deepseek-7b": ("deepseek-7b", {}),
    "qwen1.5-110b": ("qwen1.5-110b", {}),
    "granite-34b": ("granite-34b", {}),
    "mixtral-8x22b": ("mixtral-8x22b", {}),
    "mixtral-dispatch-w5": ("mixtral-8x22b", {"moe_impl": "dispatch",
                                              "sliding_window": 5}),
    "deepseek-v3-671b": ("deepseek-v3-671b", {}),
}
NEW_ARCHS = ("deepseek-7b", "qwen1.5-110b", "granite-34b", "mixtral-8x22b",
             "jamba-v0.1-52b", "pixtral-12b", "whisper-tiny",
             "deepseek-v3-671b")
FRONTENDS = ("pixtral-12b", "whisper-tiny")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    tokens = rng.integers(3, 512, (B, P)).astype(np.int32)
    mask = np.ones((B, P), bool)
    mask[1, :4] = False                       # left padding
    mask[2, :P - 1] = False                   # a one-token prompt
    nxt = rng.integers(3, 512, (B, STEPS)).astype(np.int32)
    return tokens, mask, nxt


@pytest.fixture(scope="module")
def built(inputs):
    """(jcfg, cfg, params, model, ref) per case id, built once and shared
    by the forward, score, prefill and rollout tests: ``ref`` holds JAX's
    forward (logits, aux) and score on ``inputs`` from one jitted call."""
    tokens, mask, _ = inputs
    cache = {}

    def get(case):
        if case not in cache:
            arch, kw = ARCHS[case]
            jcfg = jax_get_config(arch).reduced(**kw)
            cfg = get_config(arch).reduced(**kw)
            params = JM.init_lm(jax.random.PRNGKey(0), jcfg)
            model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
            jt, jm = jnp.asarray(tokens), jnp.asarray(mask)
            fwd, sc = jax.jit(lambda p: (
                JM.forward(p, jcfg, jt, jax_positions(jm)),
                jax_score(p, jcfg, jt, jm, return_entropy=True)))(params)
            cache[case] = jcfg, cfg, params, model, {"forward": fwd,
                                                     "score": sc}
        return cache[case]
    return get


@functools.lru_cache(maxsize=None)
def _jax_fns(jcfg):
    """JAX's prefill, decode step and realign for one config, each under
    ``jax.jit``."""
    return dict(
        prefill=jax.jit(lambda p, t, pos, c: JM.prefill(p, jcfg, t, pos, c)),
        decode=jax.jit(lambda p, t, pos, c, start, length, kv_start:
                       JM.decode_step(p, jcfg, t, pos, c, start,
                                      kv_length=length, kv_start=kv_start)),
        realign=jax.jit(lambda c, shift, valid, width: JM.realign_decode_cache(
            jcfg, c, shift, valid, width, impl="interpret"),
            static_argnums=3))


def _near(got, want, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_arch_registered_with_jax_config(arch):
    """The port's config is JAX's, field for field; its model holds JAX's
    parameter count (checked per case below; deepseek-v3-671b's whole
    count in ``test_torch_mla.py``) and passes the support gate."""
    import dataclasses
    assert arch in ARCH_IDS
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jax_get_config(arch))
    check_supported(get_config(arch))


def _frontend_inputs(cfg, Bs=2, T=12):
    """JAX's smoke inputs, from numpy: row 0 left-padded by 3; a vision
    prefix and the full positions over it, or encoder memory from stub
    frames."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(3, cfg.vocab_size, (Bs, T)).astype(np.int32)
    positions = np.stack([np.r_[np.full(3, -1), np.arange(T - 3)],
                          np.arange(T)]).astype(np.int32)
    tokens = np.where(positions >= 0, tokens, 0)
    return torch.from_numpy(tokens), torch.from_numpy(positions), rng


def _frontend_extras(model, cfg, rng, Bs=2):
    if not cfg.encoder_layers:
        return {}
    frames = rng.normal(size=(Bs, cfg.encoder_frames, cfg.d_model))
    enc, pos = M.encode(model, cfg, torch.from_numpy(frames.astype(np.float32)))
    return {"encoder_out": enc, "encoder_positions": pos}


@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_forward_shapes_no_nans(arch):
    cfg = get_config(arch).reduced()
    model = M.init_lm(cfg, seed=0, device="cpu")
    tokens, positions, rng = _frontend_inputs(cfg)
    kw = _frontend_extras(model, cfg, rng)
    if cfg.num_prefix_embeddings:
        Pv = cfg.num_prefix_embeddings
        kw["prefix_embeds"] = torch.from_numpy(rng.normal(
            size=(2, Pv, cfg.d_model)).astype(np.float32))
        vis = torch.arange(Pv, dtype=torch.int32)[None].expand(2, Pv)
        positions = torch.cat([vis, torch.where(positions >= 0,
                                                positions + Pv, -1)], 1)
    logits, _ = M.forward(model, cfg, tokens, positions, **kw)
    assert logits.shape == (2, tokens.shape[1], cfg.vocab_size)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_one_train_step(arch):
    """One LM-loss step, the encoder output passed to ``forward`` as JAX's
    test does: a finite loss, a positive gradient norm, and AdamW moves
    the parameters."""
    from repro_torch.optim import adamw
    cfg = get_config(arch).reduced()
    model = M.init_lm(cfg, seed=0, device="cpu")
    tokens, positions, rng = _frontend_inputs(cfg)
    kw = _frontend_extras(model, cfg, rng)
    params = [p for p in model.parameters()]
    for p in params:
        p.requires_grad_(True)
    logits, _ = M.forward(model, cfg, tokens, positions, **kw)
    logp = torch.log_softmax(logits[:, :-1].float(), -1)
    nll = -logp.gather(-1, tokens[:, 1:].long()[..., None])[..., 0]
    mask = (positions[:, 1:] >= 0).float()
    loss = (nll * mask).sum() / mask.sum()
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    gnorm = adamw.global_norm(grads)
    assert torch.isfinite(loss) and torch.isfinite(gnorm) and gnorm > 0
    before = [p.detach().clone() for p in params]
    with torch.no_grad():
        adamw.update(adamw.AdamWConfig(lr=1e-3), params, grads,
                     adamw.init(params))
    assert any(not torch.allclose(a, b) for a, b in zip(before, params))


@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_one_serve_step(arch):
    """Prefill and one decode step against the cache (the encoder memory
    at both), no NaN, the right shape."""
    cfg = get_config(arch).reduced()
    model = M.init_lm(cfg, seed=0, device="cpu")
    tokens, positions, rng = _frontend_inputs(cfg)
    kw = _frontend_extras(model, cfg, rng)
    Bs, T = tokens.shape
    caches = M.init_cache(cfg, Bs, T + 2, device="cpu")
    logits, caches = M.prefill(model, cfg, tokens, positions, caches, **kw)
    nxt = logits[:, -1:].argmax(-1).to(torch.int32)
    dlogits, _ = M.decode_step(model, cfg, nxt, positions[:, -1:] + 1,
                               caches, T, **kw)
    assert dlogits.shape == (Bs, 1, cfg.vocab_size)
    assert torch.isfinite(dlogits).all()


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_forward_logits_and_aux_match(built, inputs, case):
    jcfg, cfg, params, model, ref = built(case)
    assert M.count_params(model) == sum(
        x.size for x in jax.tree.leaves(params))
    tokens, mask, _ = inputs
    want, want_aux = ref["forward"]
    got, got_aux = M.forward(model, cfg, torch.from_numpy(tokens),
                             positions_from_mask(torch.from_numpy(mask)))
    _near(got, want, "forward logits")
    assert set(got_aux) == set(want_aux)
    for k in want_aux:
        np.testing.assert_allclose(got_aux[k].numpy(), np.asarray(want_aux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert bool(want_aux) == (cfg.num_experts > 0)


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_score_matches(built, inputs, case):
    jcfg, cfg, params, model, ref = built(case)
    tokens, mask, _ = inputs
    want = ref["score"]
    got = score(model, cfg, tokens, mask, return_entropy=True)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    for name in ("logprobs", "entropy"):
        _near(got[name], want[name], f"score {name}")


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_prefill_decode_and_realign_match(built, inputs, case):
    """prefill, teacher-forced decode steps with live bounds (a done row
    in the last step), the caches, then ``realign_decode_cache``."""
    jcfg, cfg, params, model, _ = built(case)
    tokens, mask, nxt = inputs
    S = P + STEPS
    fns = _jax_fns(jcfg)
    jc = JM.init_cache(jcfg, B, S)
    jl, jc = fns["prefill"](params, jnp.asarray(tokens),
                            jax_positions(jnp.asarray(mask)), jc)
    tc = M.init_cache(cfg, B, S, device="cpu")
    tl, tc = M.prefill(model, cfg, torch.from_numpy(tokens),
                       positions_from_mask(torch.from_numpy(mask)), tc)
    _near(tl, jl, "prefill logits")
    p_len = mask.sum(1).astype(np.int32)
    for s in range(STEPS):
        pos = (p_len + s)[:, None].astype(np.int32)
        if s == STEPS - 1:
            pos[0] = -1                          # a done row
        kw = dict(kv_length=P + 1 + s, kv_start=P - p_len)
        jl, jc = fns["decode"](params, jnp.asarray(nxt[:, s:s + 1]),
                               jnp.asarray(pos), jc, jnp.int32(P + s),
                               *(jnp.asarray(kw[k])
                                 for k in ("kv_length", "kv_start")))
        tl, tc = M.decode_step(model, cfg, torch.from_numpy(nxt[:, s:s + 1]),
                               torch.from_numpy(pos), tc, P + s,
                               kv_length=kw["kv_length"],
                               kv_start=torch.from_numpy(kw["kv_start"]))
        _near(tl, jl, f"decode step {s} logits")
    leaves = cache_leaves(tc[0]["self"])       # k, v; MLA's ckv, krope
    assert set(tc[0]["self"]) == set(jc[0]["self"]) == {*leaves, "pos"}
    for name in leaves:
        _near(tc[0]["self"][name], jc[0]["self"][name], f"cache {name}")
    np.testing.assert_array_equal(tc[0]["self"]["pos"].numpy(),
                                  np.asarray(jc[0]["self"]["pos"]))
    shift = np.array([0, 3, 2], np.int32)
    valid = (p_len + STEPS - shift).astype(np.int32)
    jr = fns["realign"](jc, jnp.asarray(shift), jnp.asarray(valid), S)
    tr = M.realign_decode_cache(cfg, tc, torch.from_numpy(shift),
                                torch.from_numpy(valid), S)
    np.testing.assert_array_equal(tr[0]["self"]["pos"].numpy(),
                                  np.asarray(jr[0]["self"]["pos"]))
    for name in leaves:
        _near(tr[0]["self"][name], jr[0]["self"][name], f"rolled {name}")


@pytest.mark.parametrize("case", sorted(set(ARCHS) - {"mixtral-8x22b"}))
def test_two_epoch_rollout_matches_jax(built, case):
    """Epoch 0 vanilla, epoch 1 the one-pass branch (lenience 0.8), through
    one RolloutCache each: tokens, lengths, masks and counts equal to
    JAX's, behaviour log-probs within 1e-4.  Mixtral runs it with
    ``dispatch`` and a window of 5 (the ``dense`` strategy is held by the
    tests above and in ``test_torch_moe.py``), for the time it saves."""
    jcfg, cfg, params, model, _ = built(case)
    problems = generate_problems(MathTaskConfig(num_problems=2, seed=0))
    batch = next(PromptDataset(problems, max_prompt_len=12).epochs(
        2, 4, 1, shuffle=False))
    N = 12
    jgen = JaxGenerateConfig(max_new_tokens=N, eos_id=EOS_ID, pad_id=PAD_ID)
    gen = GenerateConfig(max_new_tokens=N, eos_id=EOS_ID, pad_id=PAD_ID)
    jspec = JaxSpecConfig(variant="spec", lenience=0.8,
                          verify_impl="interpret", compact_impl="interpret")
    spec = SpecConfig(variant="spec", lenience=0.8)
    jcache, cache = JaxRolloutCache(group_size=4), RolloutCache(group_size=4)
    key = jax.random.PRNGKey(3)
    for epoch in (0, 1):
        key, sub = jax.random.split(key)
        want = jax_spec_rollout.rollout(
            params, jcfg, jgen, jspec, jnp.asarray(batch.tokens),
            jnp.asarray(batch.mask), batch.cache_keys, jcache, sub, epoch)
        got = rollout(model, cfg, gen, spec, batch.tokens, batch.mask,
                      batch.cache_keys, cache, JaxKey(sub), epoch)
        np.testing.assert_array_equal(got.response, want.response)
        np.testing.assert_array_equal(got.length, want.length)
        np.testing.assert_array_equal(got.response_mask, want.response_mask)
        _near(got.behaviour_logprobs, want.behaviour_logprobs, "logprobs")
        for k in ("one_pass", "n_generated", "n_reused", "prefill_passes"):
            assert got.metrics[k] == want.metrics[k], k
    assert got.metrics["one_pass"] == 1.0 and got.metrics["n_reused"] > 0


def test_mixtral_grpo_optimize_matches_jax(monkeypatch):
    """One ``optimize`` of reduced mixtral (``moe_impl="dispatch"``) on one
    collected rollout with seeded mixed rewards: the loss with the router
    losses, ``moe_lb_loss``, grad norm, every gradient leaf and every
    updated parameter, as ``test_one_grpo_optimize_matches_jax``."""
    lr = 1e-3
    jtr, tr = _trainers("mixtral-8x22b", lr, moe_impl="dispatch")
    batch = jtr.collector.sample(0)
    _, jrb, _, jtimes = jtr._collect(batch)
    rewards = _mixed_rewards(jrb.prompt.shape[0], 4)
    before = jtr.params
    jgrads = _capture_jax_grads(monkeypatch)
    grads = _capture_port_grads(monkeypatch)
    want = jtr.optimize(jrb, rewards, dict(jtimes))
    got = tr.optimize(_port_rb(jrb), rewards, dict(jtimes))
    assert set(got) == set(want) and "moe_lb_loss" in got
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL,
                               atol=TOL, err_msg="loss")
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=LOSS_RTOL, err_msg="grad_norm")
    _close(got["moe_lb_loss"], want["moe_lb_loss"], "moe_lb_loss")
    _check_grads(tr, grads, jgrads[0])
    _check_params(tr, jtr, grads, before, lr, want["grad_norm"])
