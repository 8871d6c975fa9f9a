"""The port's model on the CPU against the JAX model, with JAX's random
parameters carried across by ``from_jax_params``: logits of ``forward``,
``prefill`` and ``decode_step`` and the caches they fill, at the reduced
qwen3-1.7b with num_kv_heads=2 (G = 2) in float32.

Tolerance: atol 1e-4 on logits and caches (float32 through two layers of
matmuls summed in another order)."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.engine.generate import positions_from_mask as jax_positions  # noqa: E402
from repro.engine.generate import score as jax_score  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.engine.generate import positions_from_mask, score  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

ATOL = 1e-4
B, P, STEPS = 3, 10, 4


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


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("qwen3-1.7b").reduced(num_kv_heads=2)
    cfg = get_config("qwen3-1.7b").reduced(num_kv_heads=2)
    params = JM.init_lm(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return jcfg, cfg, params, model


@pytest.fixture(scope="module")
def inputs(models):
    _, cfg, _, _ = models
    rng = np.random.default_rng(0)
    tokens = rng.integers(3, cfg.vocab_size, (B, P)).astype(np.int32)
    mask = np.ones((B, P), bool)
    mask[1, :4] = False                       # left padding
    mask[2, :P - 1] = False                   # a one-token prompt
    nxt = rng.integers(3, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    return tokens, mask, nxt


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0, err_msg=what)


def test_configs_and_parameters_carry_across(models):
    jcfg, cfg, params, model = models
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert cfg.num_heads // cfg.num_kv_heads == 2
    n_jax = sum(x.size for x in jax.tree.leaves(params))
    assert M.count_params(model) == n_jax
    wq = np.asarray(params["trunk"][0]["attn"]["wq"]["kernel"][1])
    np.testing.assert_array_equal(model.layers[1].attn.wq.kernel.numpy(), wq)


def test_forward_logits_match(models, inputs):
    jcfg, cfg, params, model = models
    tokens, mask, _ = inputs
    want, _ = JM.forward(params, jcfg, jnp.asarray(tokens),
                         jax_positions(jnp.asarray(mask)))
    got, _ = M.forward(model, cfg, torch.from_numpy(tokens),
                       positions_from_mask(torch.from_numpy(mask)))
    _close(got, want, "forward logits")


@pytest.mark.parametrize("temperature,top_p", [(1.0, 1.0), (0.7, 0.9)])
def test_score_matches(models, inputs, temperature, top_p):
    """Teacher-forced log-probs and entropies of ``engine.generate.score``."""
    jcfg, cfg, params, model = models
    tokens, mask, _ = inputs
    want = jax_score(params, jcfg, jnp.asarray(tokens), jnp.asarray(mask),
                     temperature=temperature, top_p=top_p,
                     return_entropy=True)
    got = score(model, cfg, tokens, mask, temperature=temperature,
                top_p=top_p, return_entropy=True)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    for name in ("logprobs", "entropy"):
        _close(got[name], want[name], f"score {name}")


def test_prefill_and_decode_steps_match(models, inputs):
    """prefill, then teacher-forced decode steps with live bounds, one done
    row (position -1) in the last step; logits and every cache buffer."""
    jcfg, cfg, params, model = models
    tokens, mask, nxt = inputs
    S = P + STEPS
    jpos = jax_positions(jnp.asarray(mask))
    jc = JM.init_cache(jcfg, B, S)
    jl, jc = JM.prefill(params, jcfg, jnp.asarray(tokens), jpos, jc)
    tc = M.init_cache(cfg, B, S, device="cpu")
    tl, tc = M.prefill(model, cfg, torch.from_numpy(tokens),
                       positions_from_mask(torch.from_numpy(mask)), tc)
    _close(tl, jl, "prefill logits")
    p_len = mask.sum(1).astype(np.int32)
    for s in range(STEPS):
        pos = (p_len + s)[:, None].astype(np.int32)
        if s == STEPS - 1:
            pos[0] = -1                          # a done row
        kw = dict(kv_length=P + 1 + s, kv_start=P - p_len)
        jl, jc = JM.decode_step(params, jcfg, jnp.asarray(nxt[:, s:s + 1]),
                                jnp.asarray(pos), jc, P + s,
                                **{k: jnp.asarray(v) for k, v in kw.items()})
        tl, tc = M.decode_step(model, cfg, torch.from_numpy(nxt[:, s:s + 1]),
                               torch.from_numpy(pos), tc, P + s,
                               kv_length=kw["kv_length"],
                               kv_start=torch.from_numpy(kw["kv_start"]))
        _close(tl, jl, f"decode step {s} logits")
    for name in ("k", "v"):
        _close(tc[0]["self"][name], jc[0]["self"][name], f"cache {name}")
    np.testing.assert_array_equal(tc[0]["self"]["pos"].numpy(),
                                  np.asarray(jc[0]["self"]["pos"]))


@pytest.mark.parametrize("bounds", ["explicit", "none"])
def test_decode_step_routes_blocks_like_jax(models, inputs, monkeypatch,
                                            bounds):
    """A T = 3 block at a slot per row, after a prefill: with explicit
    live bounds it takes the decode kernel's op (JAX's ``_decode_shaped``),
    without them the flash op over the whole cache, as JAX takes its
    full-S path; the logits match JAX's either way (the draft engine's
    parity tests are in test_torch_drafting.py)."""
    import repro_torch.models.attention as A
    jcfg, cfg, params, model = models
    tokens, mask, nxt = inputs
    S, T = P + STEPS, 3
    jc = JM.init_cache(jcfg, B, S)
    _, jc = JM.prefill(params, jcfg, jnp.asarray(tokens),
                       jax_positions(jnp.asarray(mask)), jc)
    tc = M.init_cache(cfg, B, S, device="cpu")
    M.prefill(model, cfg, torch.from_numpy(tokens),
              positions_from_mask(torch.from_numpy(mask)), tc)
    write = np.array([P, P + 1, P], np.int32)
    p_len = mask.sum(1).astype(np.int32)
    pos = (p_len + write - P)[:, None] + np.arange(T, dtype=np.int32)
    pos[2, 1:] = -1                              # draft padding
    kw = {}
    if bounds == "explicit":
        kw = dict(kv_length=write + T, kv_start=write - pos[:, 0])
    routes = []
    for name in ("_decode_attention", "flash_attention"):
        fn = getattr(A, name)
        monkeypatch.setattr(A, name, lambda *a, _f=fn, _n=name, **k: (
            routes.append(_n), _f(*a, **k))[1])
    jl, _ = JM.decode_step(params, jcfg, jnp.asarray(nxt[:, :T]),
                           jnp.asarray(pos), jc, jnp.asarray(write),
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    tl, _ = M.decode_step(model, cfg, torch.from_numpy(nxt[:, :T]),
                          torch.from_numpy(pos), tc, torch.from_numpy(write),
                          **{k: torch.from_numpy(v) for k, v in kw.items()})
    live = pos >= 0
    _close(tl.numpy()[live], np.asarray(jl)[live], "block logits")
    want = "_decode_attention" if bounds == "explicit" else "flash_attention"
    assert routes == [want] * cfg.num_layers, routes


def test_realign_decode_cache_matches(models, inputs):
    """The compaction: pos rewritten in closed form, k/v rolled per row."""
    jcfg, cfg, params, model = models
    tokens, mask, _ = inputs
    jpos = jax_positions(jnp.asarray(mask))
    jc = JM.init_cache(jcfg, B, 2 * P)
    _, jc = JM.prefill(params, jcfg, jnp.asarray(tokens), jpos, jc)
    tc = M.init_cache(cfg, B, 2 * P, device="cpu")
    _, tc = M.prefill(model, cfg, torch.from_numpy(tokens),
                      positions_from_mask(torch.from_numpy(mask)), tc)
    shift = np.array([0, 3, P], np.int32)
    valid = (mask.sum(1) - np.array([0, 1, 0])).astype(np.int32)
    jr = JM.realign_decode_cache(jcfg, jc, jnp.asarray(shift),
                                 jnp.asarray(valid), P, impl="interpret")
    tr = M.realign_decode_cache(cfg, tc, torch.from_numpy(shift),
                                torch.from_numpy(valid), P)
    np.testing.assert_array_equal(tr[0]["self"]["pos"].numpy(),
                                  np.asarray(jr[0]["self"]["pos"]))
    for name in ("k", "v"):
        _close(tr[0]["self"][name], jr[0]["self"][name], f"rolled {name}")
