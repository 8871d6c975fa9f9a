"""The port's slot serving on the CPU against ``repro.serving``: per-row key
streams, per-row cache writes, the slot admission scatter, the ``SlotEngine``
(vanilla and speculative-prefix admission), ``rollout(backfill="slots")``
and the serve launcher.

Random draws are shared: ``JaxKeyBatch`` (``test_torch_rollout.py``) wraps
(B, 2) JAX keys and draws row b's noise with ``jax.random`` from key b, as
JAX's per-row sampling does, so tokens, accept uniforms and rejection
positions are the reference's bit for bit.  At the reduced qwen3-1.7b with
num_kv_heads=2 (G = 2) in float32: tokens, lengths, ``n_accepted``/``n``
and finish reasons identical, logprobs and logits within atol 1e-4
(float32 through two layers summed in another order), cache writes exact.
"""
import math

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
from repro.core import verify as jax_verify  # noqa: E402
from repro.engine import sampling as jax_sampling  # noqa: E402
from repro.engine.generate import GenerateConfig as JaxGenerateConfig  # noqa: E402
from repro.engine.generate import positions_from_mask as jax_positions  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import SlotEngine as JaxSlotEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RolloutCache, SpecConfig, rollout  # noqa: E402
from repro_torch.core.verify import _accept_uniforms  # noqa: E402
from repro_torch.data.tokenizer import EOS_ID, PAD_ID  # noqa: E402
from repro_torch.engine import sampling  # noqa: E402
from repro_torch.engine.generate import (GenerateConfig, generate,  # noqa: E402
                                         positions_from_mask)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import (FaultPlan, PagedSlotEngine,  # noqa: E402
                                 Request, SlotEngine, make_slot_engine)
from test_torch_rollout import JaxKey, JaxKeyBatch, row_keys  # noqa: E402

ATOL = 1e-4
B, P, N = 6, 8, 12


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
    mask[0, :3] = False                    # mixed prompt lengths
    mask[3, :2] = False
    return np.where(mask, prompt, 0).astype(np.int32), mask


def _caches_to_torch(jc):
    return [{"self": {k: torch.from_numpy(np.array(v))
                      for k, v in run["self"].items()}} for run in jc]


@pytest.mark.parametrize("temperature,top_p", [(1.0, 1.0), (0.7, 0.9)])
def test_per_row_sampling_and_verify_uniforms_match_jax(temperature, top_p):
    """(B, 2) keys: split, sample and the accept uniforms row by row."""
    rng = np.random.default_rng(3)
    logits = (3.0 * rng.standard_normal((5, 50))).astype(np.float32)
    keys = row_keys(9, 5)
    _, sub = jax_sampling.split_key(keys)
    want_tok, want_lp = jax_sampling.sample(sub, jnp.asarray(logits),
                                            temperature, top_p)
    _, tsub = sampling.split_key(JaxKeyBatch(keys))
    tok, lp = sampling.sample(tsub, torch.from_numpy(logits), temperature,
                              top_p)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), atol=1e-6)
    np.testing.assert_array_equal(
        _accept_uniforms(JaxKeyBatch(keys), 5, 17).numpy(),
        np.asarray(jax_verify._accept_uniforms(keys, 5, 17)))
    # the port's expansion of one key into per-request keys is JAX's
    np.testing.assert_array_equal(
        np.asarray(sampling.request_keys(JaxKey(jax.random.PRNGKey(9)),
                                         5).keys), np.asarray(keys))


def test_key_batch_rows_do_not_depend_on_grouping():
    """The port's own key batch: a row's stream is a function of its key
    alone — split, restacked in another order and batch size, it draws the
    same noise — and its uniforms are uniform."""
    kb = sampling.request_keys(sampling.make_key(5, "cpu"), 6)
    a, _ = sampling.split_key(kb)
    sub = sampling.stack_keys([kb[4], kb[1]])
    b, _ = sampling.split_key(sub)
    full = a.gumbel((6, 64))
    np.testing.assert_array_equal(b.gumbel((2, 64)).numpy(),
                                  full[[4, 1]].numpy())
    moved = sampling.stack_keys([kb[i] for i in range(6)])
    moved[0] = kb[3]
    np.testing.assert_array_equal(moved.uniform((6, 8))[0].numpy(),
                                  kb.uniform((6, 8))[3].numpy())
    u = kb.uniform((6, 20000)).numpy()
    assert np.all((u >= 0) & (u < 1))
    assert np.all(np.abs(u.mean(1) - 0.5) < 0.01)
    assert len({tuple(r) for r in kb.words.tolist()}) == 6


def test_write_cache_slots_matches_jax(models):
    """Admission scatter into a persistent dense cache: duplicate slots
    carry identical rows (the engine pads a group with its row 0); every
    other slot stays bit-identical."""
    jcfg, cfg, _, _ = models
    rng = np.random.default_rng(5)
    dst = JM.init_cache(jcfg, 5, 14)
    src = JM.init_cache(jcfg, 3, 14)

    def fill(caches):
        return [{"self": {
            k: (rng.integers(-1, 9, v.shape).astype(np.int32) if k == "pos"
                else rng.standard_normal(v.shape).astype(np.float32))
            for k, v in run["self"].items()}} for run in caches]

    dst, src = fill(dst), fill(src)
    for name in ("k", "v", "pos"):
        src[0]["self"][name][:, 2] = src[0]["self"][name][:, 0]
    slots = np.array([3, 1, 3], np.int32)
    want = JM.write_cache_slots(jcfg, jax.tree.map(jnp.asarray, dst),
                                jax.tree.map(jnp.asarray, src),
                                jnp.asarray(slots), impl="interpret")
    got = M.write_cache_slots(cfg, _caches_to_torch(dst),
                              _caches_to_torch(src), torch.from_numpy(slots))
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[0]["self"][name].numpy(),
                                      np.asarray(want[0]["self"][name]))
    for s in (0, 2, 4):
        np.testing.assert_array_equal(got[0]["self"]["k"][:, s].numpy(),
                                      dst[0]["self"]["k"][:, s])


def test_decode_step_with_per_row_cache_start_matches_jax(models, prompts):
    """Rows at different depths: each writes its token at its own slot and
    attends over [kv_start, write + 1)."""
    jcfg, cfg, params, model = models
    prompt, mask = prompts
    S = P + 8
    jc = JM.init_cache(jcfg, B, S)
    _, jc = JM.prefill(params, jcfg, jnp.asarray(prompt),
                       jax_positions(jnp.asarray(mask)), jc)
    tc = M.init_cache(cfg, B, S, device="cpu")
    _, tc = M.prefill(model, cfg, torch.from_numpy(prompt),
                      positions_from_mask(torch.from_numpy(mask)), tc)
    p_len = mask.sum(1).astype(np.int32)
    depth = np.array([0, 3, 1, 5, 2, 0], np.int32)
    rng = np.random.default_rng(7)
    for s in range(3):
        start = (P + depth + s).astype(np.int32)
        pos = (p_len + depth + s)[:, None].astype(np.int32)
        pos[2] = -1                                   # a done row
        tok = rng.integers(3, cfg.vocab_size, (B, 1)).astype(np.int32)
        kv_start = (start - pos[:, 0]).astype(np.int32)
        kv_start[2] = P - p_len[2]
        jl, jc = JM.decode_step(params, jcfg, jnp.asarray(tok),
                                jnp.asarray(pos), jc, jnp.asarray(start),
                                kv_length=jnp.asarray(start + 1),
                                kv_start=jnp.asarray(kv_start))
        tl, tc = M.decode_step(model, cfg, torch.from_numpy(tok),
                               torch.from_numpy(pos), tc,
                               torch.from_numpy(start),
                               kv_length=torch.from_numpy(start + 1),
                               kv_start=torch.from_numpy(kv_start))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
    np.testing.assert_array_equal(tc[0]["self"]["pos"].numpy(),
                                  np.asarray(jc[0]["self"]["pos"]))
    np.testing.assert_allclose(tc[0]["self"]["k"].numpy(),
                               np.asarray(jc[0]["self"]["k"]), atol=ATOL)


BUDGET = np.array([N, 3, 7, N, 1, 5], np.int32)


def _serve_both(models, prompts, keys, *, spec_prefix=False, drafts=None,
                vkeys=None, lenience=1.0):
    """The same requests through JAX's SlotEngine and the port's."""
    jcfg, cfg, params, model = models
    prompt, mask = prompts
    kw = dict(num_slots=2, prompt_width=P, chunk_steps=4,
              spec_prefix=spec_prefix, log_lenience=math.log(lenience))
    jeng = JaxSlotEngine(params, jcfg, JaxGenerateConfig(
        max_new_tokens=N, eos_id=EOS_ID, pad_id=PAD_ID), **kw)
    teng = SlotEngine(model, cfg, GenerateConfig(
        max_new_tokens=N, eos_id=EOS_ID, pad_id=PAD_ID), **kw)
    kn = np.asarray(keys)
    for i in range(B):
        row = prompt[i, P - int(mask[i].sum()):]
        extra = {}
        if drafts is not None:
            extra = dict(draft_tokens=drafts[i][0], draft_logprobs=drafts[i][1],
                         draft_eos=drafts[i][2])
        jeng.submit(JaxRequest(
            request_id=i, prompt=row, key=kn[i],
            max_new_tokens=int(BUDGET[i]),
            verify_key=None if vkeys is None else np.asarray(vkeys)[i],
            **extra))
        teng.submit(Request(
            request_id=i, prompt=row, key=JaxKeyBatch(keys)[i],
            max_new_tokens=int(BUDGET[i]),
            verify_key=None if vkeys is None else JaxKeyBatch(vkeys)[i],
            **extra))
    return jeng.run(), teng.run(), jeng.stats(), teng.stats()


def _assert_responses(got, want):
    for i in range(B):
        g, w = got[i], want[i]
        assert (g.length, g.finish_reason, g.n_accepted) == \
            (w.length, w.finish_reason, w.n_accepted), i
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=ATOL)


def test_slot_engine_matches_jax_and_fixed_generate(models, prompts):
    """2 slots drain 6 requests with long-tailed budgets: identical to
    JAX's engine, and every row equals the port's fixed-batch generate
    under the same per-row keys (the twin of
    tests/serving/test_slot_equivalence.py:41)."""
    _, cfg, _, model = models
    keys = row_keys(7, B)
    want, got, jst, st = _serve_both(models, prompts, keys)
    _assert_responses(got, want)
    for k in ("completed", "admitted", "engine_steps", "generated_tokens",
              "occupancy"):
        assert st[k] == jst[k], k
    assert st["pending"] == 0 and st["completed"] == B
    prompt, mask = prompts
    ref = generate(model, cfg, GenerateConfig(max_new_tokens=N, eos_id=EOS_ID,
                                              pad_id=PAD_ID),
                   prompt, mask, JaxKeyBatch(keys), row_budget=BUDGET)
    for i in range(B):
        L = int(ref["length"][i])
        assert got[i].length == L
        np.testing.assert_array_equal(got[i].tokens,
                                      ref["tokens"][i, :L].numpy())
        np.testing.assert_allclose(got[i].logprobs,
                                   ref["logprobs"][i, :L].numpy(), atol=1e-5)


def test_slot_engine_spec_prefix_matches_jax(models, prompts):
    """Speculative-prefix admission at lenience 0.8 over drafts from a
    vanilla first pass (one emptied): n_accepted, tokens, lengths and
    finish reasons identical to JAX's engine."""
    first, _, _, _ = _serve_both(models, prompts, row_keys(7, B))
    drafts = [(first[i].tokens, first[i].logprobs,
               first[i].finish_reason == "eos") for i in range(B)]
    drafts[2] = (drafts[2][0][:0], drafts[2][1][:0], False)
    want, got, jst, st = _serve_both(
        models, prompts, row_keys(13, B), spec_prefix=True, drafts=drafts,
        vkeys=row_keys(17, B), lenience=0.8)
    _assert_responses(got, want)
    assert st["reused_tokens"] == jst["reused_tokens"]
    n = [got[i].n_accepted for i in range(B)]
    assert any(0 < n[i] < len(drafts[i][0]) for i in range(B)), n
    for i in range(B):
        np.testing.assert_allclose(got[i].prefix_logprobs,
                                   want[i].prefix_logprobs, atol=ATOL)


def test_backfill_slots_rollout_matches_jax_and_fixed(models, prompts):
    """Two epochs of rollout(backfill="slots") (epoch 0 vanilla admission,
    epoch 1 speculative-prefix admission) equal JAX's, and equal the
    port's fixed-batch rollout under the same (B, 2) keys."""
    jcfg, cfg, params, model = models
    prompt, mask = prompts
    ids = list(range(B))
    jgen = JaxGenerateConfig(max_new_tokens=N, eos_id=EOS_ID, pad_id=PAD_ID)
    gen = GenerateConfig(max_new_tokens=N, eos_id=EOS_ID, pad_id=PAD_ID)
    jspec = JaxSpecConfig(variant="spec", lenience=0.8, backfill="slots",
                          backfill_slots=2)
    spec = SpecConfig(variant="spec", lenience=0.8, backfill="slots",
                      backfill_slots=2)
    fixed_spec = SpecConfig(variant="spec", lenience=0.8)
    jcache = JaxRolloutCache()
    cache, fcache = RolloutCache(), RolloutCache()
    for epoch in (0, 1):
        keys = row_keys(21 + epoch, B)
        want = jax_spec_rollout.rollout(params, jcfg, jgen, jspec,
                                        jnp.asarray(prompt),
                                        jnp.asarray(mask), ids, jcache, keys,
                                        epoch)
        got = rollout(model, cfg, gen, spec, prompt, mask, ids, cache,
                      JaxKeyBatch(keys), epoch)
        fixed = rollout(model, cfg, gen, fixed_spec, prompt, mask, ids,
                        fcache, JaxKeyBatch(keys), epoch)
        for other, tol in ((want, ATOL), (fixed, 1e-5)):
            np.testing.assert_array_equal(got.response, other.response)
            np.testing.assert_array_equal(got.length, other.length)
            np.testing.assert_array_equal(got.response_mask,
                                          other.response_mask)
            np.testing.assert_allclose(got.behaviour_logprobs,
                                       other.behaviour_logprobs, atol=tol)
        for k in ("one_pass", "n_generated", "n_reused", "admissions",
                  "engine_steps", "backfill_slots", "slot_occupancy"):
            assert got.metrics[k] == want.metrics[k], k
        assert set(got.metrics) == set(want.metrics)
        np.testing.assert_array_equal(got.n, fixed.n)
    assert got.metrics["one_pass"] == 1.0 and got.metrics["n_reused"] > 0


def test_serve_launcher_runs_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--smoke", "--spec-prefix",
                       "--arrival-every", "2", "--requests", "6"]) == 0
    out = capsys.readouterr().out
    assert "engine=slots(spec=True" in out and "served 6/6" in out


def test_unported_engine_features_raise(models):
    """The mesh still raises for the families its part 3 carries (MLA
    here), naming its ROADMAP item, before it reads the mesh (the dense
    GQA family's MeshSlotServer is held against JAX in
    test_torch_mesh.py); §10 faults, deadlines, a paged config and the §9
    draft engine (an enabled ``DraftConfig``: draft_k slots of headroom; a
    disabled one is no draft) now build their engines."""
    from repro_torch.configs import get_config
    from repro_torch.drafting import DraftConfig
    _, cfg, _, model = models
    gen = GenerateConfig(max_new_tokens=4)
    kw = dict(num_slots=2, prompt_width=4)
    mla = get_config("deepseek-v3-671b").reduced()
    for bad in (dict(mesh=object()),):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 item 11 "):
            make_slot_engine(model, mla, gen, **kw, **bad)
    for ok in (dict(faults=FaultPlan()), dict(deadline_steps=8)):
        eng = make_slot_engine(model, cfg, gen, **kw, **ok)
        assert type(eng) is SlotEngine
    eng = make_slot_engine(model, cfg, gen, **kw,
                           draft=DraftConfig(kind="ngram", draft_k=3))
    assert type(eng) is SlotEngine and eng.draft is not None
    assert eng.cache_len == 4 + 4 + 3
    eng = make_slot_engine(model, cfg, gen, **kw, draft=DraftConfig())
    assert eng.draft is None and eng.cache_len == 8
    eng = make_slot_engine(model, cfg.replace(cache_layout="paged"), gen,
                           **kw)
    assert type(eng) is PagedSlotEngine
