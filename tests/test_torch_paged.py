"""The port's paged KV layout (§13) on the CPU: dense against paged in the
port, and the port against ``repro`` with ``cache_layout="paged"``, on the
functional paths (``generate`` and the one-pass ``rollout``) and the
paged cache operations (decode step, compaction, slot admission).

The paged layout's plain versions gather the pools back to the exact
logical width the dense cache holds, so within the port paged and dense
are bit-identical (tokens and logprobs, ``assert_array_equal``); against
JAX (reduced qwen3-1.7b, num_kv_heads=2, float32, JAX's weights and noise)
tokens, lengths and ``n`` are identical and logprobs/logits within atol
1e-4.  JAX paged caches cross to the port as they are (pools, ``table``,
``pos``), and cache operations on the same cache agree exactly."""
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
from repro.engine.generate import generate as jax_generate  # noqa: E402
from repro.engine.generate import positions_from_mask as jax_positions  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RolloutCache, SpecConfig, rollout  # noqa: E402
from repro_torch.data.tokenizer import EOS_ID, PAD_ID  # noqa: E402
from repro_torch.engine.generate import (GenerateConfig, generate,  # noqa: E402
                                         positions_from_mask)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from test_torch_rollout import JaxKey  # noqa: E402

ATOL = 1e-4
B, P, N = 3, 8, 11                # cache width 19: not block-aligned


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
def prompts(models):
    _, cfg, _, _ = models
    rng = np.random.default_rng(1)
    prompt = rng.integers(3, cfg.vocab_size, (B, P)).astype(np.int32)
    mask = np.ones((B, P), bool)
    mask[0, :3] = False            # mixed prompt lengths
    mask[2, :1] = False
    return np.where(mask, prompt, 0).astype(np.int32), mask


def _paged(cfg, bs=4):
    return cfg.replace(cache_layout="paged", kv_block_size=bs)


def caches_from_jax(jc):
    """A JAX cache pytree (dense or paged: pools, ``table``, ``pos``) as
    the port's per-run dicts of tensors."""
    return [{"self": {k: torch.from_numpy(np.array(v))
                      for k, v in run["self"].items()}} for run in jc]


def _assert_same(got, want, exact: bool):
    for name in ("tokens", "length"):
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]))
    if exact:
        np.testing.assert_array_equal(np.asarray(got["logprobs"]),
                                      np.asarray(want["logprobs"]))
    else:
        np.testing.assert_allclose(np.asarray(got["logprobs"]),
                                   np.asarray(want["logprobs"]), atol=ATOL)


@pytest.mark.parametrize("bs", [4, 8])
def test_paged_generate_identity(models, prompts, bs):
    """Paged generate is bit-identical to the port's dense layout and
    identical to JAX's paged run (the twin of
    tests/engine/test_paged_generate.py:52)."""
    jcfg, cfg, params, model = models
    prompt, mask = prompts
    kw = dict(max_new_tokens=N, temperature=0.7, eos_id=EOS_ID, pad_id=PAD_ID)
    key = jax.random.PRNGKey(7)
    dense = generate(model, cfg, GenerateConfig(**kw), prompt, mask,
                     JaxKey(key))
    paged = generate(model, _paged(cfg, bs), GenerateConfig(**kw), prompt,
                     mask, JaxKey(key))
    _assert_same(paged, dense, exact=True)
    want = jax_generate(params, _paged(jcfg, bs), JaxGenerateConfig(**kw),
                        jnp.asarray(prompt), jnp.asarray(mask), key)
    _assert_same(paged, want, exact=False)


def test_paged_one_pass_rollout_identity(models, prompts):
    """Three SPEC-RL steps (prefill, then verify → compaction through
    paged_gather, the roll and paged_slot_write → resume): paged equals
    dense exactly in the port and JAX's paged rollout at every step (the
    twin of tests/engine/test_paged_generate.py:78)."""
    jcfg, cfg, params, model = models
    prompt, mask = prompts
    kw = dict(max_new_tokens=N, temperature=0.7, eos_id=EOS_ID, pad_id=PAD_ID)
    pids = list(range(B))
    outs = {}
    for layout, c in (("dense", cfg), ("paged", _paged(cfg))):
        cache = RolloutCache(history=4)
        outs[layout] = [rollout(model, c, GenerateConfig(**kw),
                                SpecConfig(variant="spec", one_pass="on"),
                                prompt, mask, pids, cache,
                                JaxKey(jax.random.PRNGKey(100 + step)), step)
                        for step in range(3)]
    jcache = JaxRolloutCache(history=4)
    want = [jax_spec_rollout.rollout(
        params, _paged(jcfg), JaxGenerateConfig(**kw),
        JaxSpecConfig(variant="spec", one_pass="on"), jnp.asarray(prompt),
        jnp.asarray(mask), pids, jcache, jax.random.PRNGKey(100 + step), step)
        for step in range(3)]
    reused = 0
    for d, p, w in zip(outs["dense"], outs["paged"], want):
        np.testing.assert_array_equal(p.response, d.response)
        np.testing.assert_array_equal(p.length, d.length)
        np.testing.assert_array_equal(p.behaviour_logprobs,
                                      d.behaviour_logprobs)
        np.testing.assert_array_equal(p.n, d.n)
        np.testing.assert_array_equal(p.response, w.response)
        np.testing.assert_array_equal(p.length, w.length)
        np.testing.assert_allclose(p.behaviour_logprobs,
                                   w.behaviour_logprobs, atol=ATOL)
        assert p.metrics["n_reused"] == w.metrics["n_reused"]
        reused += int(p.metrics["n_reused"])
    assert reused > 0                     # the resume path actually ran


def _jax_paged_prefill(jcfg, params, prompt, mask, width):
    jc = JM.init_cache(_paged(jcfg), B, width)
    _, jc = JM.prefill(params, _paged(jcfg), jnp.asarray(prompt),
                       jax_positions(jnp.asarray(mask)), jc)
    return jc


def test_decode_step_on_a_jax_paged_cache(models, prompts):
    """A cache JAX prefilled crosses to the port; decode steps on it (one
    done row) give JAX's logits, pools and positions."""
    jcfg, cfg, params, model = models
    prompt, mask = prompts
    W = P + 5
    jc = _jax_paged_prefill(jcfg, params, prompt, mask, W)
    tc = caches_from_jax(jc)
    assert tc[0]["self"]["table"].dtype == torch.int32
    p_len = mask.sum(1).astype(np.int32)
    rng = np.random.default_rng(3)
    for s in range(3):
        tok = rng.integers(3, cfg.vocab_size, (B, 1)).astype(np.int32)
        pos = (p_len + s)[:, None].astype(np.int32)
        pos[1] = -1
        kw = dict(kv_length=P + 1 + s, kv_start=P - p_len)
        jl, jc = JM.decode_step(params, _paged(jcfg), jnp.asarray(tok),
                                jnp.asarray(pos), jc, P + s,
                                kv_length=kw["kv_length"],
                                kv_start=jnp.asarray(kw["kv_start"]))
        tl, tc = M.decode_step(model, _paged(cfg), torch.from_numpy(tok),
                               torch.from_numpy(pos), tc, P + s,
                               kv_length=kw["kv_length"],
                               kv_start=torch.from_numpy(kw["kv_start"]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
    np.testing.assert_array_equal(tc[0]["self"]["pos"].numpy(),
                                  np.asarray(jc[0]["self"]["pos"]))
    np.testing.assert_allclose(tc[0]["self"]["k"].numpy(),
                               np.asarray(jc[0]["self"]["k"]), atol=ATOL)


def test_paged_realign_matches_jax_exactly(models, prompts):
    """Compaction of a JAX-prefilled paged cache: gather, roll, re-page."""
    jcfg, cfg, params, model = models
    prompt, mask = prompts
    W = 2 * P + 1
    jc = _jax_paged_prefill(jcfg, params, prompt, mask, W)
    shift = np.array([0, 3, P], np.int32)
    valid = (mask.sum(1) - np.array([0, 1, 0])).astype(np.int32)
    want = JM.realign_decode_cache(_paged(jcfg), jc, jnp.asarray(shift),
                                   jnp.asarray(valid), P, impl="interpret")
    got = M.realign_decode_cache(_paged(cfg), caches_from_jax(jc),
                                 torch.from_numpy(shift),
                                 torch.from_numpy(valid), P)
    for name in ("k", "v", "pos", "table"):
        np.testing.assert_array_equal(got[0]["self"][name].numpy(),
                                      np.asarray(want[0]["self"][name]))


def test_write_cache_slots_paged_matches_jax_exactly(models):
    """Dense admitted rows, narrower than the paged width, re-paged into
    their slots' blocks; every other block untouched."""
    jcfg, cfg, _, _ = models
    rng = np.random.default_rng(9)
    dst = JM.init_cache(_paged(jcfg), 4, 14)
    src = JM.init_cache(jcfg, 2, 11)

    def fill(caches):
        return [{"self": {
            k: (v if k == "table" else
                jnp.asarray(rng.integers(-1, 9, v.shape), jnp.int32)
                if k == "pos" else
                jnp.asarray(rng.standard_normal(v.shape), jnp.float32))
            for k, v in run["self"].items()}} for run in caches]

    dst, src = fill(dst), fill(src)
    slots = np.array([2, 0], np.int32)
    want = JM.write_cache_slots(_paged(jcfg), dst, src, jnp.asarray(slots),
                                impl="interpret")
    got = M.write_cache_slots(_paged(cfg), caches_from_jax(dst),
                              caches_from_jax(src), torch.from_numpy(slots))
    for name in ("k", "v", "pos", "table"):
        np.testing.assert_array_equal(got[0]["self"][name].numpy(),
                                      np.asarray(want[0]["self"][name]))
