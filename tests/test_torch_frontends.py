"""The modality frontends of the port on the CPU against the JAX model:
pixtral-12b's vision prefix and whisper-tiny's encoder-decoder, each
``reduced()`` in float32 with JAX's parameters carried across by
``from_jax_params`` and numpy inputs from a seed.

Held: ``encode`` (1e-5 of the largest value); ``forward`` with a prefix
(over full positions) and with encoder memory (1e-4 of the largest
|logit|); prefill plus decode steps and their caches (1e-4); ``generate``
token for token (log-probs 1e-5); the port's prefixed ``score`` against
JAX's ``forward`` + ``logprobs_of`` over full positions (1e-5: JAX's own
``score`` raises, shown below); whisper's two-epoch one-pass ``rollout``
against JAX's, and pixtral's two-pass epoch 1 piecewise (JAX's rollout
raises there): its verify log-probs against the composed JAX score, its
rejection positions against JAX's ``spec_verify`` reference on them, its
continuation against JAX's ``generate`` on prompt ⊕ accepted prefix with
the same keys.  Then the non-causal plain flash attention against JAX's
``flash_attention_ref``, the kernel's tile list at 131,072 keys against a
numpy recomputation, the wrapper's limit, the cross-attention trunk
without encoder memory (JAX lets position t see token t + 1; the port
raises), the full configs' parameter counts against ``jax.eval_shape``,
and the launchers.  Torch runs on one thread; JAX's model functions under
``jax.jit``."""
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
from repro.engine import generate as jax_generate_mod  # noqa: E402
from repro.engine.generate import GenerateConfig as JaxGenerateConfig  # noqa: E402
from repro.engine.sampling import logprobs_of as jax_logprobs_of  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro.kernels.spec_verify.ref import spec_verify_ref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RolloutCache, SpecConfig, rollout  # noqa: E402
from repro_torch.core.spec_rollout import use_one_pass  # noqa: E402
from repro_torch.core.verify import verify_and_prefill  # noqa: E402
from repro_torch.data.dataset import PromptDataset  # noqa: E402
from repro_torch.data.tokenizer import EOS_ID, PAD_ID  # noqa: E402
from repro_torch.engine.generate import (GenerateConfig, generate,  # noqa: E402
                                         positions_from_mask,
                                         prefix_positions, score)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.rewards.mathgen import MathTaskConfig, generate_problems  # noqa: E402
from test_torch_rollout import JaxKey  # noqa: E402

ARCHS = ("pixtral-12b", "whisper-tiny")
B, P, STEPS = 3, 10, 4
LP_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(jcfg, cfg, params, model) of the reduced arch, built once."""
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    params = JM.init_lm(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return jcfg, cfg, params, model


@functools.lru_cache(maxsize=None)
def _jax_fns(jcfg):
    """JAX's encode, forward, prefill and decode step under ``jax.jit``."""
    return dict(
        encode=jax.jit(lambda p, f: JM.encode(p, jcfg, f)),
        forward=jax.jit(lambda p, t, pos, kw: JM.forward(p, jcfg, t, pos,
                                                         **kw)[0]),
        prefill=jax.jit(lambda p, t, pos, c, kw: JM.prefill(p, jcfg, t, pos,
                                                            c, **kw)),
        decode=jax.jit(lambda p, t, pos, c, start, length, kv_start, kw:
                       JM.decode_step(p, jcfg, t, pos, c, start,
                                      kv_length=length, kv_start=kv_start,
                                      **kw)))


def _inputs(seed=0, b=B, p=P):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, 512, (b, p)).astype(np.int32)
    mask = np.ones((b, p), bool)
    mask[1, :4] = False                       # left padding
    mask[2, :p - 1] = False                   # a one-token prompt
    tokens = np.where(mask, tokens, 0).astype(np.int32)
    nxt = rng.integers(3, 512, (b, STEPS)).astype(np.int32)
    return tokens, mask, nxt


def _extras(arch, b=B, seed=7):
    """(JAX kwargs, port kwargs) of the arch's stub conditioning from
    numpy: patch embeddings, or frames through each package's encoder."""
    jcfg, cfg, params, model = _pair(arch)
    rng = np.random.default_rng(seed)
    if cfg.num_prefix_embeddings:
        pre = rng.normal(size=(b, cfg.num_prefix_embeddings, cfg.d_model)
                         ).astype(np.float32)
        return ({"prefix_embeds": jnp.asarray(pre)},
                {"prefix_embeds": torch.from_numpy(pre)})
    frames = rng.normal(size=(b, cfg.encoder_frames, cfg.d_model)
                        ).astype(np.float32)
    je, jp = _jax_fns(jcfg)["encode"](params, jnp.asarray(frames))
    te, tp = M.encode(model, cfg, torch.from_numpy(frames))
    return ({"encoder_out": je, "encoder_positions": jp},
            {"encoder_out": te, "encoder_positions": tp})


def _full_positions(arch, mask):
    """Positions over [prefix | tokens] for pixtral, over the tokens for
    whisper (the positions ``generate``'s prefill uses)."""
    cfg = _pair(arch)[1]
    pos = positions_from_mask(torch.from_numpy(mask))
    if cfg.num_prefix_embeddings:
        pos = prefix_positions(pos, cfg.num_prefix_embeddings)
    return pos.numpy()


def _rel_close(got, want, rel, what):
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=rel * scale, rtol=0, err_msg=what)


def test_encode_matches_jax():
    jcfg, cfg, params, model = _pair("whisper-tiny")
    rng = np.random.default_rng(1)
    frames = rng.normal(size=(2, cfg.encoder_frames, cfg.d_model)
                        ).astype(np.float32)
    je, jp = _jax_fns(jcfg)["encode"](params, jnp.asarray(frames))
    te, tp = M.encode(model, cfg, torch.from_numpy(frames))
    _rel_close(te, je, 1e-5, "encoder_out")
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_conditioning_matches_jax(arch):
    """pixtral: ``M.forward(positions_full, prefix_embeds=...)``; whisper:
    ``M.forward`` with ``encode``'s output; logits over the token slots
    only, within 1e-4 of the largest |logit|."""
    jcfg, cfg, params, model = _pair(arch)
    tokens, mask, _ = _inputs()
    jkw, tkw = _extras(arch)
    pos = _full_positions(arch, mask)
    want = _jax_fns(jcfg)["forward"](params, jnp.asarray(tokens),
                                     jnp.asarray(pos), jkw)
    got, _ = M.forward(model, cfg, torch.from_numpy(tokens),
                       torch.from_numpy(pos), **tkw)
    assert got.shape == (B, P, cfg.vocab_size)
    _rel_close(got, want, 1e-4, f"{arch} forward logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_caches_match_jax(arch):
    """prefill over [prefix | prompt] (pixtral, the vision slots ahead of
    the pads, no ``kv_start``) or the prompt with encoder memory at every
    call (whisper, ``kv_start`` the pads), then teacher-forced decode steps
    (a done row in the last); logits and caches within 1e-4."""
    jcfg, cfg, params, model = _pair(arch)
    tokens, mask, nxt = _inputs(2)
    jkw, tkw = _extras(arch)
    Pv = cfg.num_prefix_embeddings
    S = Pv + P + STEPS
    fns = _jax_fns(jcfg)
    pos = _full_positions(arch, mask)
    jc = JM.init_cache(jcfg, B, S)
    jl, jc = fns["prefill"](params, jnp.asarray(tokens), jnp.asarray(pos),
                            jc, jkw)
    tc = M.init_cache(cfg, B, S, device="cpu")
    tl, tc = M.prefill(model, cfg, torch.from_numpy(tokens),
                       torch.from_numpy(pos), tc, **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               err_msg="prefill logits")
    step_kw = {k: v for k, v in jkw.items() if k != "prefix_embeds"}
    tstep_kw = {k: v for k, v in tkw.items() if k != "prefix_embeds"}
    p_len = mask.sum(1).astype(np.int32)
    W = Pv + P
    for s in range(STEPS):
        step_pos = (p_len + Pv + s)[:, None].astype(np.int32)
        if s == STEPS - 1:
            step_pos[0] = -1                     # a done row
        kv_start = None if Pv else (P - p_len).astype(np.int32)
        jl, jc = fns["decode"](params, jnp.asarray(nxt[:, s:s + 1]),
                               jnp.asarray(step_pos), jc, jnp.int32(W + s),
                               jnp.int32(W + 1 + s),
                               None if kv_start is None
                               else jnp.asarray(kv_start), step_kw)
        tl, tc = M.decode_step(
            model, cfg, torch.from_numpy(nxt[:, s:s + 1]),
            torch.from_numpy(step_pos), tc, W + s, kv_length=W + 1 + s,
            kv_start=None if kv_start is None else torch.from_numpy(kv_start),
            **tstep_kw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   err_msg=f"decode step {s} logits")
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[0]["self"][name].numpy(),
                                   np.asarray(jc[0]["self"][name]), atol=1e-4,
                                   err_msg=f"cache {name}")
    np.testing.assert_array_equal(tc[0]["self"]["pos"].numpy(),
                                  np.asarray(jc[0]["self"]["pos"]))


def _gen_cfgs(N):
    return (JaxGenerateConfig(max_new_tokens=N, eos_id=EOS_ID, pad_id=PAD_ID),
            GenerateConfig(max_new_tokens=N, eos_id=EOS_ID, pad_id=PAD_ID))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax(arch):
    """``generate`` with the prefix or the encoder memory, sampled at
    temperature 1 from ``JaxKey`` streams, a row budget and a row done from
    the start: tokens token for token, log-probs within 1e-5."""
    jcfg, cfg, params, model = _pair(arch)
    tokens, mask, _ = _inputs(3)
    jkw, tkw = _extras(arch)
    jgen, gen = _gen_cfgs(8)
    key = jax.random.PRNGKey(5)
    budget = np.array([8, 3, 8], np.int32)
    done = np.array([False, False, True])
    want = jax_generate_mod.generate(
        params, jcfg, jgen, jnp.asarray(tokens), jnp.asarray(mask), key,
        jnp.asarray(done), jnp.asarray(budget), **jkw)
    got = generate(model, cfg, gen, tokens, mask, JaxKey(key),
                   initial_done=done, row_budget=budget, **tkw)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["length"].numpy(),
                                  np.asarray(want["length"]))
    np.testing.assert_allclose(got["logprobs"].numpy(),
                               np.asarray(want["logprobs"]), atol=LP_ATOL,
                               rtol=0)
    assert int(got["n_generated"]) > 0


def _composed_jax_score(params, jcfg, tokens, mask, prefix_embeds):
    """JAX's ``score`` as it is meant to run with a vision prefix: its
    ``forward`` over the full positions, then ``logprobs_of`` shifted and
    masked as ``score`` does."""
    pos = positions_from_mask(torch.from_numpy(np.array(mask)))
    pos = prefix_positions(pos, prefix_embeds.shape[1]).numpy()
    logits = _jax_fns(jcfg)["forward"](params, jnp.asarray(tokens),
                                       jnp.asarray(pos),
                                       {"prefix_embeds": prefix_embeds})
    lp_next = jax_logprobs_of(logits[:, :-1], jnp.asarray(tokens)[:, 1:],
                              1.0, 1.0)
    lp = jnp.concatenate([jnp.zeros_like(lp_next[:, :1]), lp_next], axis=1)
    m = jnp.asarray(mask)
    valid = m & jnp.concatenate([jnp.zeros_like(m[:, :1]), m[:, :-1]], axis=1)
    return np.asarray(jnp.where(valid, lp, 0.0)), np.asarray(valid)


def test_jax_prefixed_score_raises():
    """The reference's ``score`` builds positions over the tokens alone and
    hands them to ``forward``, which slices off the prefix's share: it
    raises (ROADMAP Queue 3, "Kept on purpose")."""
    jcfg, _, params, _ = _pair("pixtral-12b")
    tokens, mask, _ = _inputs()
    jkw, _ = _extras("pixtral-12b")
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jax_generate_mod.score(params, jcfg, jnp.asarray(tokens),
                               jnp.asarray(mask), **jkw)


def test_prefixed_score_matches_composed_jax():
    jcfg, cfg, params, model = _pair("pixtral-12b")
    tokens, mask, _ = _inputs(4)
    jkw, tkw = _extras("pixtral-12b")
    want, valid = _composed_jax_score(params, jcfg, tokens, mask,
                                      jkw["prefix_embeds"])
    got = score(model, cfg, tokens, mask, **tkw)
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_allclose(got["logprobs"].numpy(), want, atol=LP_ATOL,
                               rtol=0)


def _rollout_batch(group=4, prompts=2, max_prompt_len=12):
    problems = generate_problems(MathTaskConfig(num_problems=prompts, seed=0))
    return next(PromptDataset(problems, max_prompt_len=max_prompt_len
                              ).epochs(prompts, group, 1, shuffle=False))


def _check_rollout(got, want_resp, want_len, want_lp, what):
    np.testing.assert_array_equal(got.response, want_resp, err_msg=what)
    np.testing.assert_array_equal(got.length, want_len, err_msg=what)
    np.testing.assert_allclose(got.behaviour_logprobs, want_lp,
                               atol=LP_ATOL, rtol=0, err_msg=what)


def test_whisper_two_epoch_rollout_matches_jax():
    """Epoch 0 vanilla, epoch 1 the one-pass branch (verify-prefill with the
    encoder memory, compaction, resume), against JAX's rollout: tokens,
    lengths, ``n`` and counts equal, log-probs within 1e-5."""
    jcfg, cfg, params, model = _pair("whisper-tiny")
    batch = _rollout_batch()
    Bt = batch.tokens.shape[0]
    jkw, tkw = _extras("whisper-tiny", b=Bt)
    N = 12
    jgen, gen = _gen_cfgs(N)
    jspec = JaxSpecConfig(variant="spec", lenience=0.8,
                          verify_impl="interpret", compact_impl="interpret")
    spec = SpecConfig(variant="spec", lenience=0.8)
    jcache, cache = JaxRolloutCache(group_size=4), RolloutCache(group_size=4)
    key = jax.random.PRNGKey(3)
    for epoch in (0, 1):
        key, sub = jax.random.split(key)
        want = jax_spec_rollout.rollout(
            params, jcfg, jgen, jspec, jnp.asarray(batch.tokens),
            jnp.asarray(batch.mask), batch.cache_keys, jcache, sub, epoch,
            **jkw)
        got = rollout(model, cfg, gen, spec, batch.tokens, batch.mask,
                      batch.cache_keys, cache, JaxKey(sub), epoch, **tkw)
        _check_rollout(got, want.response, want.length,
                       want.behaviour_logprobs, f"epoch {epoch}")
        for k in ("one_pass", "n_generated", "n_reused", "prefill_passes"):
            assert got.metrics[k] == want.metrics[k], k
    assert got.metrics["one_pass"] == 1.0 and got.metrics["n_reused"] > 0


def test_pixtral_two_epoch_rollout_matches_jax_piecewise():
    """Epoch 0 (vanilla, the prefix in front) against JAX's rollout; epoch
    1 takes the two-pass branch, where JAX's rollout raises in its
    ``score``, so it is held piece by piece with the rollout's own keys:
    the verify log-probs against the composed JAX score, ``n`` against
    JAX's ``spec_verify`` reference on those log-probs with the same
    uniforms, and the continuation against JAX's ``generate`` on the
    left-aligned prompt ⊕ accepted prefix behind the same prefix."""
    jcfg, cfg, params, model = _pair("pixtral-12b")
    batch = _rollout_batch()
    Bt, Pt = batch.tokens.shape
    rng = np.random.default_rng(11)
    # one image a prompt, shared by its group's rows
    pre = np.repeat(rng.normal(size=(Bt // 4, cfg.num_prefix_embeddings,
                                     cfg.d_model)).astype(np.float32), 4, 0)
    jkw = {"prefix_embeds": jnp.asarray(pre)}
    tkw = {"prefix_embeds": torch.from_numpy(pre)}
    N = 12
    jgen, gen = _gen_cfgs(N)
    lenience = 0.8
    jspec = JaxSpecConfig(variant="spec", lenience=lenience)
    spec = SpecConfig(variant="spec", lenience=lenience)
    assert not use_one_pass(cfg, spec, tkw)
    with pytest.raises(ValueError, match="prefix_embeds"):
        use_one_pass(cfg, SpecConfig(variant="spec", one_pass="on"), tkw)
    jcache, cache = JaxRolloutCache(group_size=4), RolloutCache(group_size=4)
    key = jax.random.PRNGKey(3)
    key, sub0 = jax.random.split(key)
    want0 = jax_spec_rollout.rollout(
        params, jcfg, jgen, jspec, jnp.asarray(batch.tokens),
        jnp.asarray(batch.mask), batch.cache_keys, jcache, sub0, 0, **jkw)
    got0 = rollout(model, cfg, gen, spec, batch.tokens, batch.mask,
                   batch.cache_keys, cache, JaxKey(sub0), 0, **tkw)
    _check_rollout(got0, want0.response, want0.length,
                   want0.behaviour_logprobs, "epoch 0")

    key, sub1 = jax.random.split(key)
    got = rollout(model, cfg, gen, spec, batch.tokens, batch.mask,
                  batch.cache_keys, cache, JaxKey(sub1), 1, **tkw)
    assert got.metrics["one_pass"] == 0.0
    assert got.metrics["prefill_passes"] == 2.0

    # the reference, piece by piece, with rollout's key splits
    drafts = jcache.batch_get(batch.cache_keys, N, jspec.cache_lag)
    d_tok, d_lp, d_len, d_eos = (jnp.asarray(drafts[k]) for k in (
        "draft_tokens", "draft_logprobs", "draft_len", "draft_eos"))
    rkey, vsub = jax.random.split(sub1)
    rkey, gsub = jax.random.split(rkey)
    d_mask = jnp.arange(N)[None, :] < d_len[:, None]
    full = jnp.concatenate([jnp.asarray(batch.tokens),
                            jnp.where(d_mask, d_tok, 0)], axis=1)
    fmask = jnp.concatenate([jnp.asarray(batch.mask), d_mask], axis=1)
    lp_all, _ = _composed_jax_score(params, jcfg, np.asarray(full),
                                    np.asarray(fmask), jkw["prefix_embeds"])
    lp_curr = jnp.asarray(lp_all[:, Pt:])
    u = jax.random.uniform(vsub, (Bt, N))
    n = spec_verify_ref(lp_curr, d_lp, u, d_len, float(np.log(lenience)))
    np.testing.assert_array_equal(got.n, np.asarray(n))
    assert np.any((got.n > 0) & (got.n < N))
    full_reuse = (n == d_len) & d_eos
    prefix_mask = jnp.arange(N)[None, :] < n[:, None]
    combined = jnp.concatenate([jnp.asarray(batch.tokens),
                                jnp.where(prefix_mask, d_tok, PAD_ID)], axis=1)
    cmask = jnp.concatenate([jnp.asarray(batch.mask), prefix_mask], axis=1)
    aligned, aligned_mask = jax_spec_rollout.left_align(combined, cmask)
    cont = jax_generate_mod.generate(
        params, jcfg, jgen, aligned, aligned_mask, gsub, full_reuse, N - n,
        **jkw)
    resp, lp, _, length = jax_spec_rollout.assemble(
        d_tok, lp_curr, n, cont["tokens"], cont["logprobs"], cont["length"],
        pad_id=PAD_ID)
    _check_rollout(got, np.asarray(resp), np.asarray(length), np.asarray(lp),
                   "epoch 1")
    assert got.metrics["n_reused"] == int(n.sum())
    assert got.metrics["n_generated"] == int(cont["n_generated"])


def test_verify_and_prefill_refuses_a_prefix():
    _, cfg, _, model = _pair("pixtral-12b")
    tokens, mask, _ = _inputs()
    draft = torch.zeros((B, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="prefix_embeds"):
        verify_and_prefill(model, cfg, torch.from_numpy(tokens),
                           torch.from_numpy(mask), draft,
                           torch.zeros((B, 4)), torch.full((B,), 4),
                           JaxKey(jax.random.PRNGKey(0)), 0.0,
                           **_extras("pixtral-12b")[1])


@pytest.mark.parametrize("T,S", [(1, 37), (5, 5), (70, 130)])
def test_flash_plain_non_causal_matches_jax_ref(T, S):
    """``flash_attention_plain(causal=False)`` against JAX's
    ``flash_attention_ref``: padding keys, a query row at q_pos -1 (which
    attends like any other), T = 1, T = S and T != S; within 1e-5."""
    rng = np.random.default_rng(T + S)
    Bq, Hq, Hkv, D = 2, 4, 2, 16
    q = rng.normal(size=(Bq, Hq, T, D)).astype(np.float32)
    k = rng.normal(size=(Bq, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(Bq, Hkv, S, D)).astype(np.float32)
    q_pos = np.tile(np.arange(T, dtype=np.int32), (Bq, 1))
    q_pos[1, 0] = -1
    k_pos = np.tile(np.arange(S, dtype=np.int32), (Bq, 1))
    k_pos[1, :min(3, S - 1)] = -1
    want = np.asarray(flash_attention_ref(*(jnp.asarray(a) for a in (
        q, k, v, q_pos, k_pos)), causal=False))
    got = flash_ops.flash_attention(*(torch.from_numpy(a) for a in (
        q, k, v, q_pos, k_pos)), causal=False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="causal call at T > 1"):
        flash_ops.flash_attention(torch.from_numpy(q[:, :, :1]),
                                  torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(q_pos[:, :1]),
                                  torch.from_numpy(k_pos))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 4096)])
def test_live_key_tiles_at_131072_keys(causal, window):
    """The kernel's tile list at its largest S, 131,072 keys (2,048 tiles),
    against a numpy recomputation of the rule: a live key, at or below the
    tile's largest q_pos when causal, past its smallest q_pos - window; a
    query tile of padding (the last) lists nothing causal and every live
    tile non-causal."""
    S = flash_ops.MAX_KEYS
    T = 2 * flash_ops.BQ + 30
    rng = np.random.default_rng(3)
    k_pos = np.arange(S, dtype=np.int32)[None].repeat(2, 0)
    k_pos[1, rng.integers(0, S, 20_000)] = -1
    q_pos = np.full((2, T), -1, np.int32)
    q_pos[0, :128] = np.sort(rng.integers(0, S, 128))
    q_pos[1, :128] = np.arange(S - 128, S)
    live = flash_ops.live_key_tiles(torch.from_numpy(q_pos),
                                    torch.from_numpy(k_pos), causal=causal,
                                    window=window).numpy()
    BQ, BK = flash_ops.BQ, flash_ops.BK
    nq, nk = -(-T // BQ), S // BK
    assert live.shape == (2, nq, nk) and nk == 2048
    kp = k_pos.reshape(2, 1, nk, BK).astype(np.int64)
    want = np.zeros((2, nq, nk), bool)
    for i in range(nq):
        rows = q_pos[:, i * BQ:(i + 1) * BQ].astype(np.int64)
        qmax = rows.max(1)[:, None, None]
        qmin = np.where(rows >= 0, rows, np.iinfo(np.int64).max)
        qmin = np.where(np.arange(rows.shape[1])[None] < T - i * BQ,
                        rows, np.iinfo(np.int64).max).min(1)[:, None, None]
        ok = kp[:, 0] >= 0
        if causal:
            ok &= kp[:, 0] <= qmax
        if window:
            ok &= kp[:, 0] > qmin - window
        want[:, i] = ok.any(-1)
    np.testing.assert_array_equal(live, want)
    assert live[:, -1].any() == (not causal)


def test_flash_wrapper_refuses_131073_keys():
    """The kernel entry takes 131,072 keys and refuses one more, before
    any launch (meta tensors: the checks need no card)."""
    meta = dict(device="meta")
    bf = dict(dtype=torch.bfloat16, **meta)
    i32 = dict(dtype=torch.int32, **meta)
    S = flash_ops.MAX_KEYS + 1
    q = torch.empty(1, 4, 1, 64, **bf)
    kv = torch.empty(1, 4, S, 64, **bf)
    with pytest.raises(ValueError, match="at most 131072 keys"):
        flash_ops.flash_attention_cuda(q, kv, kv, torch.empty(1, 1, **i32),
                                       torch.empty(1, S, **i32), causal=False)
    kv = torch.empty(1, 4, S - 1, 64, **bf)
    flash_ops._check_kernel_inputs(q, kv, kv, torch.empty(1, 1, **i32),
                                   torch.empty(1, S - 1, **i32))


def test_cross_attention_trunk_without_encoder_out():
    """What JAX does with a cross-attention trunk and no ``encoder_out``:
    its cross-attention attends the decoder's own tokens without a causal
    mask, so the logit at position t moves when token t + 1 changes.  The
    port raises instead (ROADMAP Queue 3, "Kept on purpose")."""
    jcfg, cfg, params, model = _pair("whisper-tiny")
    tokens, mask, _ = _inputs()
    tokens = np.where(mask, tokens, 0)
    pos = jnp.asarray(_full_positions("whisper-tiny", mask))
    fwd = _jax_fns(jcfg)["forward"]
    a = np.asarray(fwd(params, jnp.asarray(tokens), pos, {}))
    changed = tokens.copy()
    changed[0, 5] = (changed[0, 5] + 1) % 512
    b = np.asarray(fwd(params, jnp.asarray(changed), pos, {}))
    assert np.abs(a[0, 4] - b[0, 4]).max() > 1e-3       # t = 4 sees t + 1
    with pytest.raises(ValueError, match="needs encoder_out"):
        M.forward(model, cfg, torch.from_numpy(tokens), torch.from_numpy(
            np.array(pos)))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameter_count_matches_jax(arch):
    """The full configs (pixtral-12b's 40 layers, whisper-tiny's 4 + 4)
    built on the meta device hold ``jax.eval_shape``'s parameter count."""
    jcfg = jax_get_config(arch)
    shapes = jax.eval_shape(lambda k: JM.init_lm(k, jcfg),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    model = M.LM(get_config(arch), device=torch.device("meta"))
    assert M.count_params(model) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_fixed_batch(arch, capsys):
    """``launch.serve --engine fixed`` serves every request with the stub
    conditioning; ``--engine slots`` refuses the modality extras."""
    from repro_torch.launch import serve
    rc = serve.main(["--arch", arch, "--engine", "fixed", "--device", "cpu",
                     "--requests", "4", "--max-new-tokens", "6"])
    out = capsys.readouterr().out
    assert rc == 0 and "served 4 requests" in out, out
    with pytest.raises(SystemExit, match="modality extras"):
        serve.main(["--arch", arch, "--engine", "slots", "--device", "cpu"])


def test_train_launcher_refuses_whisper():
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match="needs encoder_out"):
        train.main(["--arch", "whisper-tiny", "--smoke", "--device", "cpu"])
