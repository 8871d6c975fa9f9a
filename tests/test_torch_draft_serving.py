"""The port's drafted slot engines on the CPU against ``repro.serving``:
``SlotEngine(draft=...)`` and the ``PagedSlotEngine`` with the §9 draft
chunk, their §10 fault paths (a ``draft_exc`` fault and a NaN in a draft
block), the drafted ``rollout(backfill="slots")``, greedy identity with the
engine that does not draft (JAX's ``tests/serving/test_draft_serving.py``),
kill-and-resume of the draft state, and the launchers' ``--draft``.

The reduced qwen3-1.7b with num_kv_heads=2 (G = 2) in float32, JAX's
parameters through ``from_jax_params``, keys through ``JaxKeyBatch``.
Tolerances: tokens, lengths, finish reasons, ``n`` and every counter
(``draft_*``, ``fault_*``, engine steps) equal; log-probs within 1e-4
(float32 through two layers summed in another order)."""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.spec_rollout as jax_spec_rollout  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import RolloutCache as JaxRolloutCache  # noqa: E402
from repro.core import SpecConfig as JaxSpecConfig  # noqa: E402
from repro.drafting import DraftConfig as JaxDraftConfig  # noqa: E402
from repro.engine.generate import GenerateConfig as JaxGenerateConfig  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import FaultEvent as JaxFaultEvent  # noqa: E402
from repro.serving import FaultPlan as JaxFaultPlan  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving.mesh_server import \
    make_slot_engine as jax_make_slot_engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RolloutCache, SpecConfig, rollout  # noqa: E402
from repro_torch.data.tokenizer import EOS_ID, PAD_ID  # noqa: E402
from repro_torch.drafting import DraftConfig  # noqa: E402
from repro_torch.engine.generate import GenerateConfig  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import (FaultEvent, FaultPlan,  # noqa: E402
                                 PagedSlotEngine, Request, SlotEngine,
                                 make_slot_engine)
from test_torch_rollout import JaxKeyBatch, row_keys  # noqa: E402

ATOL = 1e-4
P, N, R = 8, 12, 6
BUDGET = np.array([N, 3, 7, N, 1, 5], np.int32)
DRAFT_COUNTERS = ("draft_proposed", "draft_accepted", "decode_forwards",
                  "decode_emitted", "draft_forwards", "engine_steps",
                  "completed", "retried_requests", "quarantined_requests")
FAULT_COUNTERS = ("fault_injected", "fault_draft_errors",
                  "fault_draft_disabled", "fault_nan_events",
                  "fault_quarantines")


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


@pytest.fixture(autouse=True)
def jax_snapshot_keys(monkeypatch):
    """Snapshot key words come back as JAX-drawing key batches."""
    monkeypatch.setattr(SlotEngine, "key_type", JaxKeyBatch)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("qwen3-1.7b").reduced(num_kv_heads=2)
    cfg = get_config("qwen3-1.7b").reduced(num_kv_heads=2)
    params = JM.init_lm(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(3, cfg.vocab_size - 1,
                           rng.randint(3, P + 1)).astype(np.int32)
               for _ in range(R)]
    return jcfg, cfg, params, model, prompts, row_keys(5, R)


def _layout(cfg, layout):
    return cfg if layout == "dense" else cfg.replace(cache_layout="paged",
                                                     kv_block_size=4)


def _reqs(prompts, keys, jax_side, corpus=None):
    out = []
    for i, p in enumerate(prompts):
        key = np.asarray(keys)[i] if jax_side else JaxKeyBatch(keys)[i]
        cls = JaxRequest if jax_side else Request
        r = cls(request_id=i, prompt=p, key=key,
                max_new_tokens=int(BUDGET[i]))
        if corpus is not None:
            r.ngram_corpus = corpus[i]
        out.append(r)
    return out


def _serve(setup, *, layout="dense", temperature=1.0, events=(),
           corpus=None, draft_k=4, sides=("jax", "port"), slots=2):
    """The same requests through JAX's engine and the port's (or one of
    them), drafting unless ``draft_k`` is 0; returns {side: (engine,
    responses)}."""
    jcfg, cfg, params, model, prompts, keys = setup
    kw = dict(max_new_tokens=N, eos_id=cfg.vocab_size - 1,
              temperature=temperature)
    out = {}
    for side in sides:
        jax_side = side == "jax"
        if jax_side:
            eng = jax_make_slot_engine(
                params, _layout(jcfg, layout), JaxGenerateConfig(**kw),
                num_slots=slots, prompt_width=P, chunk_steps=4,
                draft=(JaxDraftConfig(kind="ngram", draft_k=draft_k)
                       if draft_k else None),
                faults=JaxFaultPlan([JaxFaultEvent(*e) for e in events]))
        else:
            eng = make_slot_engine(
                model, _layout(cfg, layout), GenerateConfig(**kw),
                num_slots=slots, prompt_width=P, chunk_steps=4,
                draft=(DraftConfig(kind="ngram", draft_k=draft_k)
                       if draft_k else None),
                faults=FaultPlan([FaultEvent(*e) for e in events]))
        for r in _reqs(prompts, keys, jax_side, corpus):
            eng.submit(r)
        out[side] = (eng, eng.run())
    return out


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for i in want:
        g, w = got[i], want[i]
        assert (g.finish_reason, g.length, g.n_accepted, g.retries) == \
            (w.finish_reason, w.length, w.n_accepted, w.retries), i
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=ATOL)


@pytest.fixture(scope="module")
def corpus(setup):
    """Each request's undrafted greedy output: a corpus that makes drafts
    land (accepts under greedy, proposals under sampling)."""
    _, resp = _serve(setup, temperature=0.0, draft_k=0, sides=("port",)
                     )["port"]
    return [[resp[i].tokens] for i in range(R)]


@pytest.mark.parametrize("layout,temperature,fault", [
    ("dense", 1.0, "none"), ("dense", 0.0, "draft_exc"),
    ("paged", 1.0, "draft_exc"), ("paged", 0.0, "nan")])
def test_drafted_slot_engine_matches_jax(setup, corpus, layout, temperature,
                                         fault):
    """2 slots drain 6 requests with long-tailed budgets through the draft
    chunk: every response, the draft counters and the fault counters equal
    JAX's.  A ``draft_exc`` on requests 0 and 4 turns their drafting off
    (they decode through the plain (B, 2) block); a NaN on request 1
    poisons its block, which the host-side guard rolls back and retries."""
    events = {"none": (),
              "draft_exc": (("draft_exc", 0, 0), ("draft_exc", 0, 4)),
              "nan": (("nan", 0, 1),)}[fault]
    out = _serve(setup, layout=layout, temperature=temperature,
                 events=events, corpus=corpus)
    (jeng, want), (eng, got) = out["jax"], out["port"]
    _assert_same(got, want)
    st, jst = eng.stats(), jeng.stats()
    for k in DRAFT_COUNTERS + FAULT_COUNTERS:
        assert st[k] == jst[k], (k, st[k], jst[k])
    for k in ("accept_rate", "mean_draft_len", "tokens_per_forward"):
        assert st[k] == pytest.approx(jst[k], abs=1e-12), k
    assert st["draft_proposed"] > 0
    assert type(eng) is (SlotEngine if layout == "dense" else PagedSlotEngine)
    if fault == "draft_exc":
        assert st["fault_draft_errors"] == 2 == st["fault_draft_disabled"]
    if fault == "nan":
        assert st["fault_nan_events"] == 1 and got[1].retries == 1
    if temperature == 0.0:
        assert st["draft_accepted"] > 0 and st["tokens_per_forward"] > 1.0


def test_undrafted_engine_counts_draft_exc_like_jax(setup):
    """An engine that does not draft still counts a due ``draft_exc`` event
    as injected, and nothing else moves, as JAX's does."""
    out = _serve(setup, draft_k=0, events=(("draft_exc", 0, 0),
                                           ("draft_exc", 2, 3)))
    (jeng, want), (eng, got) = out["jax"], out["port"]
    _assert_same(got, want)
    st, jst = eng.stats(), jeng.stats()
    for k in FAULT_COUNTERS + ("engine_steps",):
        assert st[k] == jst[k], (k, st[k], jst[k])
    assert st["fault_injected"] == 2 and st["fault_draft_errors"] == 0


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_drafted_slots_greedy_identity(setup, corpus, layout):
    """Greedy: the drafted engine's tokens are the undrafted engine's,
    request by request, in fewer engine steps; the undrafted engine shows
    the same stats schema, zeroed."""
    base = _serve(setup, layout=layout, temperature=0.0, draft_k=0,
                  sides=("port",))["port"]
    drafted = _serve(setup, layout=layout, temperature=0.0, corpus=corpus,
                     sides=("port",))["port"]
    (e0, r0), (e1, r1) = base, drafted
    for i in range(R):
        np.testing.assert_array_equal(r1[i].tokens, r0[i].tokens)
        np.testing.assert_allclose(r1[i].logprobs, r0[i].logprobs, atol=ATOL)
    s0, s1 = e0.stats(), e1.stats()
    assert s1["engine_steps"] < s0["engine_steps"]
    assert s1["tokens_per_forward"] > 1.5 and 0.0 < s1["accept_rate"] <= 1.0
    assert s0["tokens_per_forward"] == 0.0 and s0["draft_proposed"] == 0.0


def test_drafted_engine_kill_and_resume(setup, corpus):
    """A drafted engine stopped after 3 chunks, its ``state_dict`` loaded
    into a fresh engine and drained, gives the uninterrupted run's
    responses and draft counters (the n-gram index is rebuilt from the
    saved streams and corpora)."""
    jcfg, cfg, params, model, prompts, keys = setup
    gen = GenerateConfig(max_new_tokens=N, eos_id=cfg.vocab_size - 1)

    def engine():
        eng = SlotEngine(model, cfg, gen, num_slots=2, prompt_width=P,
                         draft=DraftConfig(kind="ngram", draft_k=4))
        for r in _reqs(prompts, keys, False, corpus):
            eng.submit(r)
        return eng

    whole = engine()
    want = whole.run()
    first = engine()
    first.run(max_chunks=3)
    state = first.state_dict()
    assert "draft" in state
    resumed = SlotEngine(model, cfg, gen, num_slots=2, prompt_width=P,
                         draft=DraftConfig(kind="ngram", draft_k=4))
    resumed.load_state_dict(state)
    got = resumed.run()
    _assert_same(got, want)
    for k in ("draft_proposed", "draft_accepted", "decode_forwards",
              "decode_emitted", "engine_steps"):
        assert resumed.stats()[k] == whole.stats()[k], k


def test_drafted_backfill_rollout_matches_jax(setup):
    """Two epochs of ``rollout(backfill="slots")`` with the draft engine
    (epoch 0 vanilla admission, epoch 1 speculative-prefix admission, the
    rows' sibling corpus on each request) equal JAX's: tokens, lengths,
    ``n`` (through ``n_reused``) and the draft metrics.  The paged
    engine's draft chunk is held to JAX's above."""
    jcfg, cfg, params, model, prompts, _ = setup
    prompt = np.zeros((R, P), np.int32)
    mask = np.zeros((R, P), bool)
    for i, p in enumerate(prompts):
        prompt[i, P - len(p):] = p
        mask[i, P - len(p):] = True
    ids = list(range(R))
    kw = dict(max_new_tokens=N, eos_id=EOS_ID, pad_id=PAD_ID)
    jspec = JaxSpecConfig(variant="spec", lenience=0.8, backfill="slots",
                          backfill_slots=2,
                          draft=JaxDraftConfig(kind="ngram", draft_k=4))
    spec = SpecConfig(variant="spec", lenience=0.8, backfill="slots",
                      backfill_slots=2,
                      draft=DraftConfig(kind="ngram", draft_k=4))
    jcache, cache = JaxRolloutCache(group_size=3), RolloutCache(group_size=3)
    for epoch in (0, 1):
        keys = row_keys(21 + epoch, R)
        want = jax_spec_rollout.rollout(
            params, jcfg, JaxGenerateConfig(**kw), jspec, jnp.asarray(prompt),
            jnp.asarray(mask), ids, jcache, keys, epoch)
        got = rollout(model, cfg, GenerateConfig(**kw), spec, prompt, mask,
                      ids, cache, JaxKeyBatch(keys), epoch)
        np.testing.assert_array_equal(got.response, want.response)
        np.testing.assert_array_equal(got.length, want.length)
        np.testing.assert_allclose(got.behaviour_logprobs,
                                   want.behaviour_logprobs, atol=ATOL)
        for k in ("one_pass", "n_generated", "n_reused", "admissions",
                  "engine_steps", "draft_accept_rate", "draft_mean_len",
                  "tokens_per_forward", "decode_forwards"):
            assert got.metrics[k] == want.metrics[k], k
        assert set(got.metrics) == set(want.metrics)
    assert got.metrics["one_pass"] == 1.0 and got.metrics["n_reused"] > 0
    assert got.metrics["decode_forwards"] > 0


def test_train_launcher_drafts_on_cpu(capsys):
    assert train.main(["--device", "cpu", "--smoke", "--steps", "2",
                       "--draft", "2"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("step")]
    assert len(lines) == 2 and all("tok/fwd=" in ln and "draft_acc=" in ln
                                   and "draft_len=" in ln for ln in lines)


def test_serve_launcher_drafts_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--smoke", "--spec-prefix",
                       "--draft", "2", "--requests", "6"]) == 0
    out = capsys.readouterr().out
    assert "served 6/6" in out and "  draft: tok/fwd=" in out
    with pytest.raises(SystemExit, match="--draft"):
        serve.main(["--device", "cpu", "--smoke", "--engine", "fixed",
                    "--draft", "2"])
