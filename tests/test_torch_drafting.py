"""The port's §9 draft engine on the CPU against ``repro.drafting``: the own
copies of ``NGramDraftSource``, ``DraftController`` and ``DraftConfig``,
``residual_sample``, the block decode (``decode_step`` at T = k + 1 with a
write slot per row, dense and paged) and ``pad_cache``, ``draft_step``
(greedy, temperature 1 and the edge cases), ``drafted_generate`` and the
drafted ``rollout``, at the reduced qwen3-1.7b with num_kv_heads=2 (G = 2)
in float32, JAX's parameters carried across by ``from_jax_params`` and
keys through ``JaxKey`` / ``JaxKeyBatch`` (``test_torch_rollout.py``).

Tolerances: integer outputs (tokens, counts, rejection positions, pos,
DraftStats) equal; logits within 1e-5 and the caches' live K/V within
1e-5 (float32 through two layers summed in another order: a few ulps of
values of order 1); log-probs within 1e-5 at one step and 1e-4 over a
rollout (as ``test_torch_rollout.py``); ``residual_sample``'s log-probs
within 1e-6.  The distribution check is JAX's chi-squared bar, on the
port's own key streams."""
import copy

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
from repro.drafting import DraftConfig as JaxDraftConfig  # noqa: E402
from repro.drafting import DraftController as JaxDraftController  # noqa: E402
from repro.drafting import NGramDraftSource as JaxNGramDraftSource  # noqa: E402
from repro.drafting import drafted_generate as jax_drafted_generate  # noqa: E402
from repro.drafting.engine import _prefill_seed as jax_prefill_seed  # noqa: E402
from repro.drafting.step import draft_step as jax_draft_step  # noqa: E402
from repro.engine import sampling as jax_sampling  # noqa: E402
from repro.engine.generate import GenerateConfig as JaxGenerateConfig  # noqa: E402
from repro.engine.generate import generate as jax_generate  # noqa: E402
from repro.engine.generate import positions_from_mask as jax_positions  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RolloutCache, SpecConfig, rollout  # noqa: E402
from repro_torch.data.dataset import PromptDataset  # noqa: E402
from repro_torch.data.tokenizer import EOS_ID, PAD_ID  # noqa: E402
from repro_torch.drafting import (DraftConfig, DraftController,  # noqa: E402
                                  NGramDraftSource, drafted_generate)
from repro_torch.drafting.engine import _prefill_seed  # noqa: E402
from repro_torch.drafting.step import block_width, draft_step  # noqa: E402
from repro_torch.engine import sampling  # noqa: E402
from repro_torch.engine.generate import (GenerateConfig, generate,  # noqa: E402
                                         positions_from_mask)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.rewards.mathgen import MathTaskConfig, generate_problems  # noqa: E402
from test_torch_rollout import JaxKey, JaxKeyBatch, row_keys  # noqa: E402

ATOL = 1e-5
B, P, N = 4, 8, 14


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
    prompt = np.zeros((B, P), np.int32)
    mask = np.zeros((B, P), bool)
    rng = np.random.RandomState(3)
    for b in range(B):
        L = int(rng.randint(3, P + 1))
        prompt[b, P - L:] = rng.randint(3, cfg.vocab_size, L)
        mask[b, P - L:] = True
    return prompt, mask


def _gens(**kw):
    return JaxGenerateConfig(**kw), GenerateConfig(**kw)


# ------------------------------------------------------------ own copies


def _streams(seed, rows=3, vocab=7):
    """Seeded contexts, corpora and tail streams with many repeats (a small
    vocabulary, so grams recur)."""
    rng = np.random.default_rng(seed)
    ctx = [rng.integers(0, vocab, int(rng.integers(0, 12))).tolist()
           for _ in range(rows)]
    corpus = [[rng.integers(0, vocab, int(rng.integers(0, 20))).astype(
        np.int32) for _ in range(int(rng.integers(0, 4)))]
        for _ in range(rows)]
    tails = [[rng.integers(0, vocab, int(rng.integers(0, 5))).tolist()
              for _ in range(8)] for _ in range(rows)]
    return ctx, corpus, tails


@pytest.mark.parametrize("kw", [dict(kind="ngram"),
                                dict(kind="ngram", min_ngram=2, max_ngram=4),
                                dict(kind="ngram", use_siblings=False)])
def test_ngram_source_matches_jax(kw):
    """Every proposal (each k, with and without a pending token) after
    every extension, on seeded streams and corpora."""
    for seed in range(3):
        ctx, corpus, tails = _streams(seed)
        got = NGramDraftSource(DraftConfig(**kw), len(ctx))
        want = JaxNGramDraftSource(JaxDraftConfig(**kw), len(ctx))
        for row in range(len(ctx)):
            got.reset(row, ctx[row], corpus[row])
            want.reset(row, ctx[row], corpus[row])
            for tail in tails[row]:
                for k in (0, 1, 3, 8):
                    for pending in (None, 2):
                        np.testing.assert_array_equal(
                            got.propose(row, k, pending),
                            want.propose(row, k, pending))
                got.extend(row, tail)
                want.extend(row, tail)
        assert got.rows == want.rows


@pytest.mark.parametrize("kw", [dict(kind="ngram"),
                                dict(kind="ngram", adaptive=False),
                                dict(kind="ngram", k_min=2, draft_k=5,
                                     accept_ema=0.3, accept_init=0.9)])
def test_draft_controller_matches_jax(kw):
    rng = np.random.default_rng(11)
    got = DraftController(DraftConfig(**kw), 3)
    want = JaxDraftController(JaxDraftConfig(**kw), 3)
    for step in range(40):
        row = int(rng.integers(0, 3))
        assert got.draft_len(row) == want.draft_len(row)
        prop = int(rng.integers(0, 9))
        acc = int(rng.integers(0, prop + 1))
        got.update(row, prop, acc)
        want.update(row, prop, acc)
        if step % 13 == 12:
            got.reset(row)
            want.reset(row)
        np.testing.assert_array_equal(got.rate, want.rate)


@pytest.mark.parametrize("kw", [dict(kind="tree"), dict(min_ngram=0),
                                dict(min_ngram=3, max_ngram=2),
                                dict(draft_k=0), dict(k_min=9),
                                dict(accept_ema=1.0), dict()])
def test_draft_config_validate_refuses_like_jax(kw):
    def outcome(cls):
        try:
            cls(**kw).validate()
            return None
        except AssertionError:
            return "refused"
    assert outcome(DraftConfig) == outcome(JaxDraftConfig)
    assert DraftConfig(**kw).enabled == JaxDraftConfig(**kw).enabled


# ------------------------------------------------------- residual_sample


@pytest.mark.parametrize("temperature,top_p", [(1.0, 1.0), (0.8, 0.9),
                                               (0.0, 1.0)])
def test_residual_sample_matches_jax(temperature, top_p):
    """Mixed ban masks (a row banned at its argmax, one not banned, one
    banned at a rare token), scalar and per-row keys."""
    rng = np.random.default_rng(5)
    Bs, V = 6, 40
    logits = (3.0 * rng.standard_normal((Bs, V))).astype(np.float32)
    banned = rng.integers(0, V, Bs).astype(np.int32)
    banned[0] = int(np.argmax(logits[0]))
    mask = np.array([True, False, True, True, False, True])
    for jkey, tkey in ((jax.random.PRNGKey(4), JaxKey(jax.random.PRNGKey(4))),
                       (row_keys(7, Bs), JaxKeyBatch(row_keys(7, Bs)))):
        want_t, want_lp = jax_sampling.residual_sample(
            jkey, jnp.asarray(logits), jnp.asarray(banned), jnp.asarray(mask),
            temperature, top_p)
        got_t, got_lp = sampling.residual_sample(
            tkey, torch.from_numpy(logits), torch.from_numpy(banned),
            torch.from_numpy(mask), temperature, top_p)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
        np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp),
                                   atol=1e-6, rtol=0)
        if temperature > 0:
            hit = mask & (got_t.numpy() == banned)
            assert not hit.any(), "a banned token was drawn"


# ------------------------------------------- block decode and pad_cache


def _dense_view(buf, table, S):
    """(run, B, Hkv, S, D) of a dense buffer, or of a paged pool through
    its (run, B, nb) table."""
    if table is None:
        return buf
    from repro_torch.kernels.decode_attention.ops import gather_paged_kv
    return torch.stack([gather_paged_kv(buf[r], table[r], S)
                        for r in range(table.shape[0])])


def _jax_caches_to_torch(jc):
    return [{"self": {k: torch.from_numpy(np.array(v))
                      for k, v in run["self"].items()}} for run in jc]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_pad_cache_matches_jax(models, prompts, layout):
    """pad_cache after a prefill: pos padded with -1, K/V with zeros; a
    paged cache grows its tables by whole identity-stripe blocks only when
    the rounding slack runs out (extra 1 fits it, 9 does not)."""
    jcfg, cfg, params, model = models
    prompt, mask = prompts
    if layout == "paged":
        jcfg = jcfg.replace(cache_layout="paged", kv_block_size=4)
        cfg = cfg.replace(cache_layout="paged", kv_block_size=4)
    S = P + 2                                     # 10 slots: 3 blocks of 4
    jc = JM.init_cache(jcfg, B, S)
    _, jc = JM.prefill(params, jcfg, jnp.asarray(prompt),
                       jax_positions(jnp.asarray(mask)), jc)
    tc = M.init_cache(cfg, B, S, device="cpu")
    M.prefill(model, cfg, torch.from_numpy(prompt),
              positions_from_mask(torch.from_numpy(mask)), tc)
    for extra in (1, 9):
        want = JM.pad_cache(jcfg, jc, extra)
        got = M.pad_cache(cfg, tc, extra)
        for g, w in zip(got, want):
            assert set(g["self"]) == set(w["self"])
            for name in ("pos", "table"):
                if name in w["self"]:
                    np.testing.assert_array_equal(g["self"][name].numpy(),
                                                  np.asarray(w["self"][name]))
            for name in ("k", "v"):
                np.testing.assert_allclose(g["self"][name].numpy(),
                                           np.asarray(w["self"][name]),
                                           atol=ATOL, rtol=0)
    assert M.pad_cache(cfg, tc, 0) is tc


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_step_block_matches_jax(models, prompts, layout):
    """decode_step with a T = k + 1 block at a write slot per row (rows at
    different depths, draft padding and a done row at position -1), with
    explicit live bounds: logits within 1e-5 of JAX's, pos equal and the
    live K/V within 1e-5.  The paged cache has blocks of 4, so a block of
    5 crosses a block boundary."""
    jcfg, cfg, params, model = models
    prompt, mask = prompts
    if layout == "paged":
        jcfg = jcfg.replace(cache_layout="paged", kv_block_size=4)
        cfg = cfg.replace(cache_layout="paged", kv_block_size=4)
    K = 4
    S = P + 3 + K + 1
    jc = JM.init_cache(jcfg, B, S)
    _, jc = JM.prefill(params, jcfg, jnp.asarray(prompt),
                       jax_positions(jnp.asarray(mask)), jc)
    tc = M.init_cache(cfg, B, S, device="cpu")
    M.prefill(model, cfg, torch.from_numpy(prompt),
              positions_from_mask(torch.from_numpy(mask)), tc)
    rng = np.random.default_rng(2)
    block = rng.integers(3, cfg.vocab_size, (B, K + 1)).astype(np.int32)
    p_len = mask.sum(1).astype(np.int32)
    write = np.array([P, P + 1, P + 3, P + 2], np.int32)   # own depths
    next_pos = p_len + (write - P)
    draft_len = np.array([K, 2, 0, K], np.int32)
    pos = np.where(np.arange(K + 1)[None, :] <= draft_len[:, None],
                   next_pos[:, None] + np.arange(K + 1)[None, :], -1)
    pos[3] = -1                                            # a done row
    pos = pos.astype(np.int32)
    kv_length = write + 1 + K
    kv_start = write - next_pos
    jl, jc = JM.decode_step(params, jcfg, jnp.asarray(block), jnp.asarray(pos),
                            jc, jnp.asarray(write),
                            kv_length=jnp.asarray(kv_length),
                            kv_start=jnp.asarray(kv_start))
    tl, tc = M.decode_step(model, cfg, torch.from_numpy(block),
                           torch.from_numpy(pos), tc, torch.from_numpy(write),
                           kv_length=torch.from_numpy(kv_length),
                           kv_start=torch.from_numpy(kv_start))
    assert tl.shape == (B, K + 1, cfg.vocab_size)
    live = pos >= 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=ATOL, rtol=0)
    jsc, tsc = jc[0]["self"], tc[0]["self"]
    np.testing.assert_array_equal(tsc["pos"].numpy(), np.asarray(jsc["pos"]))
    views, jviews = {}, {}
    for name in ("k", "v"):
        views[name], jviews[name] = (
            _dense_view(sc[name], sc.get("table"), S)
            for sc in (tsc, _jax_caches_to_torch(jc)[0]["self"]))
    keep = tsc["pos"].numpy() >= 0                          # (run, B, S)
    for name in ("k", "v"):
        got = views[name].numpy().transpose(0, 1, 3, 2, 4)[keep]
        want = jviews[name].numpy().transpose(0, 1, 3, 2, 4)[keep]
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=name)


# ------------------------------------------------------------ draft_step


def _step_states(models, prompt, mask, jgen, gen, K, key=1):
    """The same prefilled state on both sides (JAX's ``_prefill_seed`` and
    the port's, keys through ``JaxKey``)."""
    jcfg, cfg, params, model = models
    jk = jax.random.PRNGKey(key)
    jpre = jax_prefill_seed(params, jcfg, jgen, jnp.asarray(prompt),
                            jnp.asarray(mask), jk, extra=K)
    tpre = _prefill_seed(model, cfg, gen, torch.from_numpy(prompt),
                         torch.from_numpy(mask), JaxKey(jk), extra=K)
    np.testing.assert_array_equal(tpre["tok0"].numpy(),
                                  np.asarray(jpre["tok0"]))
    Bp = prompt.shape[0]
    jst = dict(caches=jpre["caches"], cur_tok=jpre["tok0"],
               cur_lp=jpre["lp0"], done=jnp.zeros((Bp,), bool),
               count=jnp.zeros((Bp,), jnp.int32),
               budget=jnp.full((Bp,), jgen.max_new_tokens, jnp.int32),
               next_pos=jpre["next_pos"],
               write_idx=jnp.full((Bp,), prompt.shape[1], jnp.int32),
               keys=jpre["key"])
    tst = dict(caches=tpre["caches"], cur_tok=tpre["tok0"],
               cur_lp=tpre["lp0"], done=torch.zeros((Bp,), dtype=torch.bool),
               count=torch.zeros((Bp,), dtype=torch.int32),
               budget=torch.full((Bp,), gen.max_new_tokens, dtype=torch.int32),
               next_pos=tpre["next_pos"],
               write_idx=torch.full((Bp,), prompt.shape[1], dtype=torch.int32),
               keys=tpre["key"])
    return jst, tst


def _both_steps(models, jst, tst, jgen, gen, dt, dl, K, u_width=0, **over):
    jcfg, cfg, params, model = models
    jkw = {k: jnp.asarray(v) for k, v in over.items()}
    tkw = {k: torch.from_numpy(np.asarray(v)) for k, v in over.items()}
    want = jax_draft_step(params, jcfg, jgen, **{**jst, **jkw},
                          draft_tokens=jnp.asarray(dt),
                          draft_len=jnp.asarray(dl), K=K, u_width=u_width)
    got = draft_step(model, cfg, gen, **{**tst, **tkw},
                     draft_tokens=torch.from_numpy(dt),
                     draft_len=torch.from_numpy(dl), K=K, u_width=u_width)
    for name in ("tokens", "emitted", "accepted", "proposed", "cur_tok",
                 "done", "count", "next_pos", "write_idx"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    for name in ("logprobs", "cur_lp"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=ATOL, rtol=0, err_msg=name)
    np.testing.assert_array_equal(
        got["caches"][0]["self"]["pos"].numpy(),
        np.asarray(want["caches"][0]["self"]["pos"]))
    return got, want


@pytest.fixture(scope="module")
def greedy_stream(models, prompts):
    jcfg, cfg, params, model = models
    prompt, mask = prompts
    jgen, gen = _gens(max_new_tokens=N, temperature=0.0, eos_id=-1)
    van = jax_generate(params, jcfg, jgen, jnp.asarray(prompt),
                       jnp.asarray(mask), jax.random.PRNGKey(1))
    mine = generate(model, cfg, gen, prompt, mask,
                    sampling.make_key(1, "cpu"))
    np.testing.assert_array_equal(mine["tokens"].numpy(),
                                  np.asarray(van["tokens"]))
    return np.asarray(van["tokens"])


def _edge_drafts(van, K, V):
    """Row 0: no draft; row 1: the true greedy continuation (full accept);
    row 2: first token wrong; row 3: first right, second wrong."""
    dt = np.zeros((B, K), np.int32)
    dl = np.zeros((B,), np.int32)
    dt[1] = van[1, 1:1 + K]
    dl[1] = K
    dt[2, 0] = (van[2, 1] + 1) % V
    dl[2] = 1
    dt[3, :2] = [van[3, 1], (van[3, 2] + 1) % V]
    dl[3] = 2
    return dt, dl


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_draft_step_matches_jax(models, prompts, greedy_stream, temperature):
    """One macro-step, with the greedy stream's continuations as drafts (a
    full accept, rejections at 0 and 1, no draft); at temperature 1 with
    u_width = 8 > K, so the uniforms are drawn wide and sliced."""
    _, cfg, _, _ = models
    prompt, mask = prompts
    jgen, gen = _gens(max_new_tokens=N, temperature=temperature, eos_id=-1)
    K = 3
    jst, tst = _step_states(models, prompt, mask, jgen, gen, K)
    dt, dl = _edge_drafts(greedy_stream, K, cfg.vocab_size)
    got, _ = _both_steps(models, jst, tst, jgen, gen, dt, dl, K, u_width=8)
    if temperature == 0.0:
        van = greedy_stream
        emitted = got["emitted"].numpy()
        np.testing.assert_array_equal(emitted, [1, 1 + K, 1, 2])
        np.testing.assert_array_equal(got["accepted"].numpy(), [0, K, 0, 1])
        for b in range(B):
            m = emitted[b]
            np.testing.assert_array_equal(got["tokens"][b, :m].numpy(),
                                          van[b, :m])
            assert int(got["cur_tok"][b]) == van[b, m]
        np.testing.assert_array_equal(got["write_idx"].numpy(), P + emitted)


def test_draft_step_mid_draft_eos_truncates(models, prompts, greedy_stream):
    van = greedy_stream
    r = next(b for b in range(B) if van[b, 2] not in (van[b, 0], van[b, 1]))
    eos = int(van[r, 2])
    jgen, gen = _gens(max_new_tokens=N, temperature=0.0, eos_id=eos)
    K = 4
    jst, tst = _step_states(models, *prompts, jgen, gen, K)
    dt = np.zeros((B, K), np.int32)
    dl = np.zeros((B,), np.int32)
    dt[r] = van[r, 1:1 + K]                 # the accepted run holds eos
    dl[r] = K
    got, _ = _both_steps(models, jst, tst, jgen, gen, dt, dl, K)
    assert bool(got["done"][r]) and int(got["emitted"][r]) == 3
    np.testing.assert_array_equal(got["tokens"][r, :3].numpy(), van[r, :3])


def test_draft_step_budget_truncates(models, prompts, greedy_stream):
    van = greedy_stream
    jgen, gen = _gens(max_new_tokens=N, temperature=0.0, eos_id=-1)
    K = 4
    jst, tst = _step_states(models, *prompts, jgen, gen, K)
    dt = np.zeros((B, K), np.int32)
    dt[1] = van[1, 1:1 + K]
    dl = np.zeros((B,), np.int32)
    dl[1] = K
    budget = np.full((B,), N, np.int32)
    budget[1] = 2                           # room for 2 of the 1 + K tokens
    got, _ = _both_steps(models, jst, tst, jgen, gen, dt, dl, K,
                         budget=budget)
    assert int(got["emitted"][1]) == 2 and bool(got["done"][1])


def test_draft_step_done_rows_are_inert(models, prompts):
    jgen, gen = _gens(max_new_tokens=N, temperature=1.0)
    K = 3
    jst, tst = _step_states(models, *prompts, jgen, gen, K)
    done = np.zeros(B, bool)
    done[0] = True
    dt = np.full((B, K), 5, np.int32)
    dl = np.full((B,), K, np.int32)
    got, _ = _both_steps(models, jst, tst, jgen, gen, dt, dl, K, done=done)
    assert int(got["emitted"][0]) == 0 and int(got["proposed"][0]) == 0
    assert int(got["write_idx"][0]) == P
    assert int(got["cur_tok"][0]) == int(tst["cur_tok"][0])


def test_block_width_matches_jax():
    from repro.drafting.step import block_width as jax_block_width
    for k_max in (1, 4, 8):
        for prop in range(0, 10):
            assert block_width(prop, k_max) == jax_block_width(prop, k_max)


# ------------------------------------------------------ drafted_generate


def test_drafted_generate_greedy_equals_vanilla(models, prompts):
    """Greedy drafted output is the port's vanilla ``generate``'s, token for
    token, dense and paged, with a corpus that makes drafts land."""
    _, cfg, _, model = models
    prompt, mask = prompts
    gen = GenerateConfig(max_new_tokens=N, temperature=0.0, eos_id=-1)
    van = generate(model, cfg, gen, prompt, mask, sampling.make_key(1, "cpu"))
    corpus = [[van["tokens"][b].numpy()] for b in range(B)]
    for c in (cfg, cfg.replace(cache_layout="paged", kv_block_size=4)):
        for draft, corp in ((DraftConfig(kind="ngram", draft_k=4), None),
                            (DraftConfig(kind="ngram", draft_k=6,
                                         adaptive=False), corpus)):
            out = drafted_generate(model, c, gen, prompt, mask,
                                   sampling.make_key(1, "cpu"), draft,
                                   corpus=corp)
            np.testing.assert_array_equal(out["tokens"].numpy(),
                                          van["tokens"].numpy())
            np.testing.assert_array_equal(out["length"].numpy(),
                                          van["length"].numpy())
            if corp is not None:
                assert out["stats"].tokens_per_forward > 1.5


def test_drafted_generate_sampled_matches_jax(models, prompts):
    """At temperature 1 with a sibling corpus (the rows' own vanilla
    streams, so drafts are proposed on most steps), the port's drafted
    stream is JAX's, token for token, and the DraftStats are equal (the
    paged layout's drafted loop is held to JAX's through the slot
    engines, tests/test_torch_draft_serving.py)."""
    jcfg, cfg, params, model = models
    prompt, mask = prompts
    jgen, gen = _gens(max_new_tokens=N, temperature=1.0, eos_id=EOS_ID,
                      pad_id=PAD_ID)
    key = jax.random.PRNGKey(8)
    van = jax_generate(params, jcfg, jgen, jnp.asarray(prompt),
                       jnp.asarray(mask), key)
    corpus = [[np.asarray(van["tokens"][b])] for b in range(B)]
    jd = JaxDraftConfig(kind="ngram", draft_k=4)
    want = jax_drafted_generate(params, jcfg, jgen, jnp.asarray(prompt),
                                jnp.asarray(mask), key, jd, corpus=corpus)
    got = drafted_generate(model, cfg, gen, prompt, mask, JaxKey(key),
                           DraftConfig(kind="ngram", draft_k=4),
                           corpus=corpus)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["length"].numpy(),
                                  np.asarray(want["length"]))
    np.testing.assert_allclose(got["logprobs"].numpy(),
                               np.asarray(want["logprobs"]), atol=1e-4,
                               rtol=0)
    assert vars(got["stats"]) == vars(want["stats"])
    assert got["stats"].proposed > 0


def _chi2_stat(counts, probs, n):
    """Goodness-of-fit over cells with expectation >= 5 (rest pooled),
    ``tests/drafting/test_draft_equivalence.py``'s."""
    exp = probs * n
    big = exp >= 5.0
    stat = float(np.sum((counts[big] - exp[big]) ** 2 / exp[big]))
    rest_c, rest_e = counts[~big].sum(), exp[~big].sum()
    df = int(big.sum()) - 1
    if rest_e > 0:
        stat += float((rest_c - rest_e) ** 2 / rest_e)
        df += 1
    return stat, df


def _chi2_crit(df):
    # JAX's bar: a generous upper critical value (~p < 1e-4) on fixed seeds
    return df + 4.0 * np.sqrt(2.0 * df) + 10.0


@pytest.mark.parametrize("temperature,top_p", [(1.0, 1.0), (0.8, 0.9)])
def test_rejection_sampling_distribution(temperature, top_p):
    """The token after a drafted position is distributed as p, drawn with
    the port's own per-row key streams (``request_keys`` of ``make_key``):
    the accept path (the draft token) and the reject path (the residual
    sample) reassemble p.  Chi-squared against the true adjusted
    distribution at JAX's bar, vanilla ``sample`` held to the same bar;
    JAX's tiny config (V = 32) with the port's own random weights."""
    V, R = 32, 512
    cfg = ModelConfig(name="t", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=V)
    model = M.init_lm(cfg, seed=0, device="cpu")
    gen = GenerateConfig(max_new_tokens=N, temperature=temperature,
                         top_p=top_p)
    rng = np.random.RandomState(3)
    prompt = rng.randint(3, V, P).astype(np.int32)
    rows = torch.from_numpy(np.broadcast_to(prompt, (R, P)).copy())
    rmask = torch.ones((R, P), dtype=torch.bool)
    pre = _prefill_seed(model, cfg, gen, rows, rmask,
                        sampling.make_key(2, "cpu"), extra=2)
    cur = torch.full((R,), int(pre["tok0"][0]), dtype=torch.int32)
    one = [{"self": {k: v[:, :1].clone() for k, v in run["self"].items()}}
           for run in pre["caches"]]
    logits1, _ = M.decode_step(model, cfg, cur[:1, None],
                               pre["next_pos"][:1, None], one,
                               torch.tensor([P], dtype=torch.int32))
    p_true = torch.exp(sampling.adjust_logits(logits1[0, 0], temperature,
                                              top_p)).numpy()
    g = int(np.argsort(p_true)[-2])         # a plausible (not argmax) draft

    counts = np.zeros(V, np.int64)
    for rep in range(4):
        caches = copy.deepcopy(pre["caches"])
        keys = sampling.request_keys(sampling.make_key(100 + rep, "cpu"), R)
        out = draft_step(model, cfg, gen, caches, cur, pre["lp0"],
                         torch.zeros((R,), dtype=torch.bool),
                         torch.zeros((R,), dtype=torch.int32),
                         torch.full((R,), N, dtype=torch.int32),
                         pre["next_pos"], torch.full((R,), P,
                                                     dtype=torch.int32),
                         keys, torch.full((R, 1), g, dtype=torch.int32),
                         torch.ones((R,), dtype=torch.int32), K=1)
        nxt = np.where(out["accepted"].numpy() > 0, g, out["cur_tok"].numpy())
        np.add.at(counts, nxt, 1)
    stat, df = _chi2_stat(counts.astype(np.float64), p_true, 4 * R)
    assert stat < _chi2_crit(df), (stat, df)

    vcounts = np.zeros(V, np.int64)
    for rep in range(4):
        keys = sampling.request_keys(sampling.make_key(200 + rep, "cpu"), R)
        tok, _ = sampling.sample(keys, logits1[0, 0].expand(R, V),
                                 temperature, top_p)
        np.add.at(vcounts, tok.numpy(), 1)
    vstat, vdf = _chi2_stat(vcounts.astype(np.float64), p_true, 4 * R)
    assert vstat < _chi2_crit(vdf), (vstat, vdf)
    assert counts[g] > 0 and p_true[g] > 0.01   # the accept path fires


# ------------------------------------------------------- drafted rollout


def test_drafted_rollout_matches_jax(models, monkeypatch):
    """Two epochs of ``rollout`` with ``SpecConfig(draft=DraftConfig(
    kind="ngram", draft_k=4))``: epoch 0 through ``drafted_generate``,
    epoch 1 the one-pass branch through ``drafted_resume`` from prompt ⊕
    draft[:n] with the sibling corpus.  Tokens, lengths, ``n`` and the
    draft metrics equal JAX's; log-probs within 1e-4."""
    jcfg, cfg, params, model = models
    problems = generate_problems(MathTaskConfig(num_problems=2, seed=0))
    batch = next(PromptDataset(problems, max_prompt_len=16).epochs(
        2, 4, 1, shuffle=False))
    Nr = 12
    jgen, gen = _gens(max_new_tokens=Nr, eos_id=EOS_ID, pad_id=PAD_ID)
    jspec = JaxSpecConfig(variant="spec", lenience=0.8,
                          verify_impl="interpret", compact_impl="interpret",
                          draft=JaxDraftConfig(kind="ngram", draft_k=4))
    spec = SpecConfig(variant="spec", lenience=0.8,
                      draft=DraftConfig(kind="ngram", draft_k=4))
    jcache, cache = JaxRolloutCache(group_size=4), RolloutCache(group_size=4)
    jax_n = {}
    verify = jax_spec_rollout.verify_and_prefill

    def spy(*args, **kw):
        out = verify(*args, **kw)
        jax_n["n"] = np.asarray(out["n"])
        return out

    monkeypatch.setattr(jax_spec_rollout, "verify_and_prefill", spy)
    key = jax.random.PRNGKey(3)
    draft_keys = ("draft_accept_rate", "draft_mean_len", "tokens_per_forward",
                  "decode_forwards")
    for epoch in (0, 1):
        key, sub = jax.random.split(key)
        want = jax_spec_rollout.rollout(
            params, jcfg, jgen, jspec, jnp.asarray(batch.tokens),
            jnp.asarray(batch.mask), batch.cache_keys, jcache, sub, epoch)
        got = rollout(model, cfg, gen, spec, batch.tokens, batch.mask,
                      batch.cache_keys, cache, JaxKey(sub), epoch)
        np.testing.assert_array_equal(got.response, want.response)
        np.testing.assert_array_equal(got.length, want.length)
        np.testing.assert_allclose(got.behaviour_logprobs,
                                   want.behaviour_logprobs, atol=1e-4)
        for k in ("one_pass", "n_generated", "n_reused") + draft_keys:
            assert got.metrics[k] == want.metrics[k], k
        assert set(got.metrics) == set(want.metrics)
        assert got.metrics["decode_forwards"] > 0
    np.testing.assert_array_equal(got.n, jax_n["n"])
    assert got.metrics["one_pass"] == 1.0


def test_rwkv_trunk_decodes_vanilla_with_drafting_on():
    """An RWKV trunk cannot drop a rejected draft: ``use_drafting`` is
    False there, as in JAX, and a rollout with drafting on is the vanilla
    rollout, token for token, with JAX's drafting-off metrics."""
    from repro.core.spec_rollout import use_drafting as jax_use_drafting
    from repro_torch.core.spec_rollout import use_drafting
    cfg = get_config("rwkv6-3b").reduced()
    jcfg = jax_get_config("rwkv6-3b").reduced()
    on = DraftConfig(kind="ngram", draft_k=4)
    assert not use_drafting(cfg, SpecConfig(draft=on))
    assert not jax_use_drafting(jcfg, JaxSpecConfig(
        draft=JaxDraftConfig(kind="ngram", draft_k=4)), {})
    qwen = get_config("qwen3-1.7b").reduced()
    assert use_drafting(qwen, SpecConfig(draft=on))
    assert not use_drafting(qwen, SpecConfig())
    assert SpecConfig().draft == DraftConfig() and not DraftConfig().enabled
    model = M.init_lm(cfg, seed=0, device="cpu")
    gen = GenerateConfig(max_new_tokens=6, eos_id=EOS_ID, pad_id=PAD_ID)
    toks = np.full((2, 4), 5, np.int32)
    mask = np.ones((2, 4), bool)
    outs = [rollout(model, cfg, gen, SpecConfig(draft=d), toks, mask, [0, 1],
                    RolloutCache(), sampling.make_key(0, "cpu"), 0)
            for d in (on, DraftConfig())]
    np.testing.assert_array_equal(outs[0].response, outs[1].response)
    assert outs[0].metrics["tokens_per_forward"] == 1.0
    assert outs[0].metrics["decode_forwards"] == 0.0
    with pytest.raises(ValueError, match="attention-only"):
        drafted_generate(model, cfg, gen, toks, mask,
                         sampling.make_key(0, "cpu"), on)
