"""The §11/§14 observatory hooks of the port against ``repro`` on the CPU.

The same reduced qwen3-1.7b (num_kv_heads=2, float32) and the same keys
(``JaxKey`` / ``JaxKeyBatch``) run through both packages, each with its own
ledger, tracer and decision log configured process-global, through a
two-epoch one-pass ``rollout`` (with and without §9 drafting), a spec-prefix
serve on the ``SlotEngine`` and the ``PagedSlotEngine`` (GRPO groups, so
followers share prompt blocks), a timeout retry and a quarantine, and one
GRPO ``train_step`` with alerts.  Held equal across the packages:

* every ledger row, byte for byte, and the category counts;
* the decision records' rows and steps, features and outcomes within 1e-6,
  absolute or relative: the surprisal is a float32 log-prob (up to about
  10 in size) that the packages round a few ulp apart (``step_ms`` is wall
  time and only has to be positive);
* the span and event names on every trace lane;
* the histogram sample counts of the registries (``serve.*``,
  ``rollout.*``, ``draft.*``, ``train.*``);
* ``compile_counts()`` per entry, from emptied caches (``jax.clear_caches``
  and the port's signature sets), with one difference kept on purpose: a
  fault run's NaN injection adds a ``decode_chunk`` signature in the port
  only (ROADMAP Queue 3).

With the observatory off, the port's tokens and log-probs are
bit-identical to its run with the observatory on.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.obs as jobs  # noqa: E402
import repro.obs.alerts as jalerts  # noqa: E402
import repro.obs.ledger as jledger  # noqa: E402
import repro_torch.obs as obs  # noqa: E402
import repro_torch.obs.alerts as alerts  # noqa: E402
import repro_torch.obs.ledger as ledger  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import RolloutCache as JaxRolloutCache  # noqa: E402
from repro.core import SpecConfig as JaxSpecConfig  # noqa: E402
from repro.core.spec_rollout import rollout as jax_rollout  # noqa: E402
from repro.drafting import DraftConfig as JaxDraftConfig  # noqa: E402
from repro.engine.generate import GenerateConfig as JaxGenerateConfig  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import FaultEvent as JaxFaultEvent  # noqa: E402
from repro.serving import FaultPlan as JaxFaultPlan  # noqa: E402
from repro.serving import PagedSlotEngine as JaxPagedSlotEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import SlotEngine as JaxSlotEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RolloutCache, SpecConfig, rollout  # noqa: E402
from repro_torch.data.dataset import PromptDataset  # noqa: E402
from repro_torch.data.tokenizer import EOS_ID, PAD_ID  # noqa: E402
from repro_torch.drafting import DraftConfig  # noqa: E402
from repro_torch.engine.generate import GenerateConfig  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.rewards.mathgen import MathTaskConfig, generate_problems  # noqa: E402
from repro_torch.serving import (FaultEvent, FaultPlan,  # noqa: E402
                                 PagedSlotEngine, Request, SlotEngine)
from test_torch_rollout import JaxKey, JaxKeyBatch, row_keys  # noqa: E402

TOL = 1e-6
P, N, R = 8, 10, 6


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("qwen3-1.7b").reduced(num_kv_heads=2)
    cfg = get_config("qwen3-1.7b").reduced(num_kv_heads=2)
    params = JM.init_lm(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return jcfg, cfg, params, model


class Sinks:
    """One package's observatory: ledger, tracer, decision log and the
    process-global registry, configured through ``mod.configure``."""

    def __init__(self, mod, led_mod):
        self.mod = mod
        self.ledger = led_mod.TokenLedger()
        self.tracer = mod.Tracer(enabled=True)
        self.decisions = led_mod.DecisionLog()
        self.registry = mod.MetricsRegistry()
        mod.configure(tracer=self.tracer, registry=self.registry,
                      ledger=self.ledger, decisions=self.decisions)

    def lanes(self):
        out = {}
        for sp in self.tracer.spans:
            out.setdefault(sp.track, set()).add(sp.name)
        for ev in self.tracer.events:
            out.setdefault(ev.track, set()).add("event:" + ev.name)
        return out


def _clear_compile_counts():
    jax.clear_caches()
    for e in alerts._JIT_ENTRIES.values():
        e.signatures.clear()


@pytest.fixture
def sinks():
    """Both packages' sinks, configured; the inert defaults come back
    after the test.  Compile counts start from empty caches."""
    _clear_compile_counts()
    both = Sinks(jobs, jledger), Sinks(obs, ledger)
    yield both
    jobs.reset()
    obs.reset()


def _assert_ledgers_equal(jl, tl):
    assert tl.violations == 0 and tl.finalized == jl.finalized > 0
    assert tl.counts_dict() == jl.counts_dict()
    rows, jrows = tl.rows(), jl.rows()
    assert sorted(rows, key=str) == sorted(jrows, key=str)
    for rid, plane in rows.items():
        np.testing.assert_array_equal(plane, jrows[rid], err_msg=str(rid))


def _assert_decisions_equal(jd, td):
    assert len(td._recs) == len(jd._recs)
    for (tr_, ts, tf, to), (jr, js, jf, jo) in zip(td._recs, jd._recs):
        assert (tr_, ts) == (jr, js)
        np.testing.assert_allclose(tf, jf, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(to[:4], jo[:4], rtol=TOL, atol=TOL)
        assert to[4] > 0.0


def _counts(d, prefixes):
    return {k: v for k, v in d.items()
            if k.startswith(prefixes) and k.endswith("_count")}


def _assert_obs_equal(js, ts, registry_prefixes=("rollout.", "draft.",
                                                  "train.", "serve.")):
    _assert_ledgers_equal(js.ledger, ts.ledger)
    _assert_decisions_equal(js.decisions, ts.decisions)
    assert ts.lanes() == js.lanes()
    jd, td = js.registry.as_dict(), ts.registry.as_dict()
    assert _counts(td, registry_prefixes) == _counts(jd, registry_prefixes)


def _compile_deltas(extra=None):
    got, want = alerts.compile_counts(), jalerts.compile_counts()
    for name, n in (extra or {}).items():
        want[name] += n
    assert got == want
    assert sum(got.values()) > 0


# ---------------------------------------------------------------- rollout


def _batch():
    problems = generate_problems(MathTaskConfig(num_problems=2, seed=0))
    return next(PromptDataset(problems, max_prompt_len=16).epochs(
        2, 4, 1, shuffle=False))


def _port_epochs(models, spec, gen, batch):
    _, cfg, _, model = models
    cache, out = RolloutCache(group_size=4), []
    key = jax.random.PRNGKey(3)
    for epoch in (0, 1):
        key, sub = jax.random.split(key)
        out.append(rollout(model, cfg, gen, spec, batch.tokens, batch.mask,
                           batch.cache_keys, cache, JaxKey(sub), epoch))
    return out


@pytest.mark.parametrize("drafted", [False, True], ids=["plain", "drafted"])
def test_rollout_observatory_matches_jax(models, sinks, drafted):
    """Epoch 0 vanilla (drafted: ``drafted_generate`` on the rollout's
    bound rows), epoch 1 the one-pass branch (drafted: ``drafted_resume``
    extending the same rows past ``REUSED_PREFIX``)."""
    jcfg, cfg, params, model = models
    js, ts = sinks
    batch = _batch()
    kw = dict(max_new_tokens=N, eos_id=EOS_ID, pad_id=PAD_ID)
    jgen, gen = JaxGenerateConfig(**kw), GenerateConfig(**kw)
    jdraft = JaxDraftConfig(kind="ngram", draft_k=4) if drafted \
        else JaxDraftConfig()
    draft = DraftConfig(kind="ngram", draft_k=4) if drafted \
        else DraftConfig()
    jspec = JaxSpecConfig(variant="spec", lenience=0.8,
                          verify_impl="interpret", compact_impl="interpret",
                          draft=jdraft)
    spec = SpecConfig(variant="spec", lenience=0.8, draft=draft)
    jcache = JaxRolloutCache(group_size=4)
    key = jax.random.PRNGKey(3)
    for epoch in (0, 1):
        key, sub = jax.random.split(key)
        want = jax_rollout(params, jcfg, jgen, jspec,
                           jnp.asarray(batch.tokens), jnp.asarray(batch.mask),
                           batch.cache_keys, jcache, sub, epoch)
    on = _port_epochs(models, spec, gen, batch)
    np.testing.assert_array_equal(on[1].response, np.asarray(want.response))
    _assert_obs_equal(js, ts)
    _compile_deltas()
    counts = ts.ledger.counts_dict()
    assert counts["reused_prefix"] == on[1].metrics["n_reused"] > 0
    assert counts["prompt"] == 2 * int(batch.mask.sum())
    lanes = ts.lanes()
    assert lanes["rollout"] == {"rollout", "generate", "verify", "compact",
                                "decode", "assembly"}
    assert ("draft" in lanes) == drafted
    if drafted:
        assert len(ts.decisions) > 0
        assert counts["fresh"] + counts["draft_bonus"] \
            + counts["draft_accepted"] == sum(
                rb.metrics["n_generated"] for rb in on)
    else:
        assert counts["fresh"] == sum(rb.metrics["n_generated"] for rb in on)
    # the observatory off: the same tokens and log-probs, bit for bit
    obs.reset()
    off = _port_epochs(models, spec, gen, batch)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a.response, b.response)
        np.testing.assert_array_equal(a.behaviour_logprobs,
                                      b.behaviour_logprobs)
        np.testing.assert_array_equal(a.n, b.n)


# ---------------------------------------------------------------- engines


def _prompts(cfg):
    rng = np.random.RandomState(0)
    return [rng.randint(3, cfg.vocab_size - 1,
                        rng.randint(3, P + 1)).astype(np.int32)
            for _ in range(R)]


def _requests(jax_side, prompts, keys, *, ids=None, groups=False,
              drafts=None, vkeys=None):
    out = []
    ids = list(range(len(prompts))) if ids is None else ids
    for j, (i, p) in enumerate(zip(ids, prompts)):
        kw = dict(request_id=i, prompt=p, max_new_tokens=N)
        if groups:                      # GRPO groups of 3: followers share
            kw["group_id"] = j // 3
            kw["prompt"] = prompts[(j // 3) * 3]
        if jax_side:
            kw["key"] = np.asarray(keys)[j]
        else:
            kw["key"] = JaxKeyBatch(keys)[j]
        if drafts is not None:
            toks, lps = drafts[j]
            kw.update(draft_tokens=toks, draft_logprobs=lps,
                      verify_key=np.asarray(vkeys)[j] if jax_side
                      else JaxKeyBatch(vkeys)[j])
        out.append((JaxRequest if jax_side else Request)(**kw))
    return out


def _serve_port(models, layout, spec_kw, prompts, keys, vkeys, groups,
                drafts_from=None):
    _, cfg, _, model = models
    cfg = cfg.replace(cache_layout=layout, kv_block_size=4)
    gen = GenerateConfig(max_new_tokens=N, eos_id=cfg.vocab_size - 1)
    cls = PagedSlotEngine if layout == "paged" else SlotEngine
    eng = cls(model, cfg, gen, num_slots=2, prompt_width=P, chunk_steps=4,
              **spec_kw)
    drafts = None
    if drafts_from is not None:
        drafts = [(drafts_from[i].tokens, drafts_from[i].logprobs)
                  for i in range(R)]
    for r in _requests(False, prompts, keys, groups=groups, drafts=drafts,
                       vkeys=vkeys, ids=None if drafts is None else
                       [100 + i for i in range(R)]):
        eng.submit(r)
    return eng, eng.run()


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_slot_engines_observatory_matches_jax(models, sinks, layout,
                                              monkeypatch):
    """Pass 1 vanilla (paged: GRPO groups of 3, so four followers map
    their leader's prompt blocks: SHARED_PROMPT_BLOCK), pass 2 with
    speculative-prefix admission of pass 1's outputs at log-lenience -0.5,
    so drafts part-accept (REUSED_PREFIX, then FRESH); the dense pass 2
    also drafts (§9 decision records)."""
    monkeypatch.setattr(SlotEngine, "key_type", JaxKeyBatch)
    jcfg, cfg, params, model = models
    js, ts = sinks
    prompts, keys, vkeys = _prompts(cfg), row_keys(5, R), row_keys(11, R)
    groups = layout == "paged"
    jc = jcfg.replace(cache_layout=layout, kv_block_size=4)
    jgen = JaxGenerateConfig(max_new_tokens=N, eos_id=cfg.vocab_size - 1)
    jcls = JaxPagedSlotEngine if groups else JaxSlotEngine
    spec_kw = dict(spec_prefix=True, log_lenience=-0.5)
    if not groups:
        spec_kw["draft"] = "draft"
    engines = []
    for jax_side in (True, False):
        passes = []
        for kw in ({}, spec_kw):
            kw = dict(kw)
            if kw.get("draft"):
                kw["draft"] = (JaxDraftConfig if jax_side else DraftConfig)(
                    kind="ngram", draft_k=3)
            if jax_side:
                eng = jcls(params, jc, jgen, num_slots=2, prompt_width=P,
                           chunk_steps=4, **kw)
                prev = passes[-1][1] if passes else None
                drafts = None if prev is None else [
                    (prev[i].tokens, prev[i].logprobs) for i in range(R)]
                for r in _requests(True, prompts, keys, groups=groups,
                                   drafts=drafts, vkeys=vkeys,
                                   ids=None if prev is None else
                                   [100 + i for i in range(R)]):
                    eng.submit(r)
                passes.append((eng, eng.run()))
            else:
                prev = passes[-1][1] if passes else None
                passes.append(_serve_port(models, layout, kw, prompts, keys,
                                          vkeys, groups, drafts_from=prev))
        engines.append(passes)
    (jp1, jp2), (tp1, tp2) = engines
    for (je, jr), (te, tr_) in ((jp1, tp1), (jp2, tp2)):
        assert sorted(tr_) == sorted(jr)
        for i in jr:
            np.testing.assert_array_equal(tr_[i].tokens, jr[i].tokens)
        jst, st = je.metrics_registry().as_dict(), te.metrics_registry(
        ).as_dict()
        assert _counts(st, ("serve.",)) == _counts(jst, ("serve.",))
        assert {k: v for k, v in st.items() if k.startswith(
            ("ledger.", "compiles."))} == {k: v for k, v in jst.items()
                                           if k.startswith(("ledger.",
                                                            "compiles."))}
        assert set(st) == set(jst)
    _assert_obs_equal(js, ts)
    _compile_deltas()
    counts = ts.ledger.counts_dict()
    assert counts["reused_prefix"] > 0 and counts["fresh"] > 0
    assert (counts["shared_prompt_block"] > 0) == groups
    if groups:
        assert "admit_shared" in ts.lanes()["engine"]
        assert tp1[0].metrics_registry().as_dict()["paged_num_blocks"] > 0
    else:
        assert len(ts.decisions) > 0
    # the observatory off: the same responses, bit for bit
    obs.reset()
    _, off1 = _serve_port(models, layout, {}, prompts, keys, vkeys, groups)
    _, off2 = _serve_port(models, layout, {**spec_kw, "draft": DraftConfig(
        kind="ngram", draft_k=3)} if not groups else spec_kw, prompts, keys,
        vkeys, groups, drafts_from=off1)
    for on, off in ((tp1[1], off1), (tp2[1], off2)):
        for i in on:
            np.testing.assert_array_equal(on[i].tokens, off[i].tokens)
            np.testing.assert_array_equal(on[i].logprobs, off[i].logprobs)


def test_retry_and_quarantine_provenance_matches_jax(models, sinks,
                                                     monkeypatch):
    """A spec-prefix engine with a stall on request 0 (deadline 6: a
    timeout, its partial output re-verified on retry: RETRY_STITCHED) and
    a NaN on request 3 (a quarantine: QUARANTINE_CLAMPED)."""
    monkeypatch.setattr(SlotEngine, "key_type", JaxKeyBatch)
    jcfg, cfg, params, model = models
    js, ts = sinks
    prompts, keys, vkeys = _prompts(cfg), row_keys(5, R), row_keys(11, R)
    events = [("stall", 0, 0, 10 ** 6), ("nan", 4, 3)]
    kw = dict(num_slots=2, prompt_width=P, chunk_steps=4, spec_prefix=True,
              deadline_steps=6)
    jgen = JaxGenerateConfig(max_new_tokens=N, eos_id=cfg.vocab_size - 1)
    gen = GenerateConfig(max_new_tokens=N, eos_id=cfg.vocab_size - 1)
    jeng = JaxSlotEngine(params, jcfg, jgen, faults=JaxFaultPlan(
        [JaxFaultEvent(*e) for e in events]), **kw)

    def port_engine():
        return SlotEngine(model, cfg, gen, faults=FaultPlan(
            [FaultEvent(*e) for e in events]), **kw)

    eng = port_engine()
    drafts = [(np.zeros(0, np.int32), np.zeros(0, np.float32))] * R
    for e, side in ((jeng, True), (eng, False)):
        for r in _requests(side, prompts, keys, drafts=drafts, vkeys=vkeys):
            e.submit(r)
    want, got = jeng.run(), eng.run()
    for i in want:
        assert (got[i].retries, got[i].finish_reason) == \
            (want[i].retries, want[i].finish_reason)
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)
    _assert_obs_equal(js, ts)
    _compile_deltas(extra={"decode_chunk": 1})
    counts = ts.ledger.counts_dict()
    assert counts["retry_stitched"] > 0 and counts["quarantine_clamped"] > 0
    lanes = ts.lanes()
    assert {"event:timeout", "event:retry"} <= lanes["req/0"]
    assert {"event:quarantine", "event:retry"} <= lanes["req/3"]
    # the observatory off: the same responses, bit for bit
    obs.reset()
    off_eng = port_engine()
    for r in _requests(False, prompts, keys, drafts=drafts, vkeys=vkeys):
        off_eng.submit(r)
    off = off_eng.run()
    for i in got:
        np.testing.assert_array_equal(got[i].tokens, off[i].tokens)
        np.testing.assert_array_equal(got[i].logprobs, off[i].logprobs)


# ---------------------------------------------------------------- trainer


def test_train_step_observatory_and_alerts_match_jax(models, sinks):
    """One GRPO ``train_step`` of JAX's and the port's trainers from the
    same parameters and key, each with ``tracer=`` and ``alerts=``: the
    stage spans and the enclosing ``train_step`` on the trainer lane, the
    rollout lane, the ``train.*`` histograms, the ``ledger_*`` step
    metrics, the alert manager's keys, and every stage span equal to its
    stage timer."""
    from test_torch_train import _datasets, _model

    from repro.optim import adamw as jax_adamw
    from repro.rl.trainer import RLConfig as JaxRLConfig
    from repro.rl.trainer import Trainer as JaxTrainer
    from repro_torch.optim import adamw
    from repro_torch.rl.trainer import RLConfig, Trainer

    js, ts = sinks
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        kw = dict(vocab_size=64, num_kv_heads=2)
        jcfg = jax_get_config("qwen3-1.7b").reduced(**kw)
        cfg = get_config("qwen3-1.7b").reduced(**kw)
        rl_kw = dict(group_size=4, prompts_per_batch=2, max_new_tokens=6)
        jds, ds = _datasets()
        jtr = JaxTrainer(jcfg, JaxRLConfig(optim=jax_adamw.AdamWConfig(
            lr=1e-3), **rl_kw), JaxSpecConfig(), jds, jax.random.PRNGKey(0),
            tracer=js.tracer, alerts=jalerts.AlertManager(tracer=js.tracer))
        tr = Trainer(cfg, RLConfig(optim=adamw.AdamWConfig(lr=1e-3),
                                   **rl_kw), SpecConfig(), ds,
                     JaxKey(jax.random.PRNGKey(0)),
                     model=_model(cfg, jtr.params), device="cpu",
                     tracer=ts.tracer,
                     alerts=alerts.AlertManager(tracer=ts.tracer))
        want, got = jtr.train_step(), tr.train_step()
    finally:
        torch.set_num_threads(threads)
    assert set(got) == set(want)
    for k in want:
        if k.startswith(("ledger_", "alerts_")):
            assert got[k] == want[k], k
    assert got["ledger_violations"] == 0.0 and got["ledger_finalized"] == 8.0
    assert got["ledger_tokens_fresh"] == got["n_generated"]
    _assert_obs_equal(js, ts)
    lanes = ts.lanes()
    assert lanes["trainer"] == {"reward", "collect", "old_logprob", "ref",
                                "adv", "update_actor", "train_step"}
    spans = {sp.name: sp for sp in ts.tracer.spans if sp.track == "trainer"}
    for name in ("reward", "collect", "old_logprob", "ref", "adv",
                 "update_actor"):
        assert spans[name].dur == pytest.approx(got[f"{name}_time"], abs=1e-9)
    step = spans["train_step"]
    assert all(step.t0 <= sp.t0 and sp.t1 <= step.t1 for sp in spans.values())
    assert tr.alerts.watchdog is None
    reg = ts.registry.as_dict()
    assert reg["ledger.tokens_prompt"] == got["ledger_tokens_prompt"]


# ----------------------------------------------------------- kill-and-resume


def test_kill_resume_carries_histograms_and_skips_unbegun_rows(
        models, sinks, tmp_path, monkeypatch):
    """An engine killed at step 8 and resumed from its ``state_dict`` (the
    port's through ``save_server_state`` on disk) into an engine with a
    fresh ledger: the ``serve.*`` histograms come back with the engine
    (``"obs"``) and end with the counts of an uninterrupted run; the
    ledger is not in the snapshot, so rows admitted before the kill are
    neither extended nor finalized (``has_row``), and the rows begun after
    it equal the uninterrupted run's.  JAX's engine, killed at the same
    step with the same histograms, fails on the first such row instead
    (ROADMAP Queue 3).  The reference's ``"obs"`` subtree, written by
    JAX's ``save_pytree``, loads into the port's registry with the same
    counts."""
    from repro.checkpoint.io import save_pytree as jax_save_pytree
    from repro.serving import EngineKilled as JaxEngineKilled
    from repro_torch.checkpoint.io import (load_pytree, load_server_state,
                                           save_server_state)
    from repro_torch.serving import EngineKilled
    monkeypatch.setattr(SlotEngine, "key_type", JaxKeyBatch)
    jcfg, cfg, params, model = models
    prompts, keys = _prompts(cfg), row_keys(5, R)
    kw = dict(num_slots=2, prompt_width=P, chunk_steps=4)
    jgen = JaxGenerateConfig(max_new_tokens=N, eos_id=cfg.vocab_size - 1)
    gen = GenerateConfig(max_new_tokens=N, eos_id=cfg.vocab_size - 1)

    def make(jax_side, ledger_obj=None, kill=True):
        plan_cls, ev_cls = ((JaxFaultPlan, JaxFaultEvent) if jax_side
                            else (FaultPlan, FaultEvent))
        faults = plan_cls([ev_cls("kill", 8)]) if kill else None
        if jax_side:
            return JaxSlotEngine(params, jcfg, jgen, faults=faults,
                                 ledger=ledger_obj, **kw)
        return SlotEngine(model, cfg, gen, faults=faults, ledger=ledger_obj,
                          **kw)

    jeng, eng = make(True), make(False)
    for e, side in ((jeng, True), (eng, False)):
        for r in _requests(side, prompts, keys):
            e.submit(r)
    with pytest.raises(JaxEngineKilled):
        jeng.run()
    with pytest.raises(EngineKilled):
        eng.run()
    jstate = jeng.state_dict()
    path = str(tmp_path / "snap")
    save_server_state(path, eng)
    killed_counts = _counts(eng.metrics.as_dict(), ("serve.",))
    assert killed_counts == _counts(jeng.metrics.as_dict(), ("serve.",))
    assert killed_counts["serve.ttft_ms_count"] > 0

    jled, led = jledger.TokenLedger(), ledger.TokenLedger()
    jres, res = make(True, jled, kill=False), make(False, led, kill=False)
    jres.load_state_dict(jstate)
    load_server_state(path, res)
    assert _counts(res.metrics.as_dict(), ("serve.",)) == killed_counts
    got = res.run()
    # the reference opens a row for a request admitted before the kill at
    # its first post-resume append, then fails its conservation check
    # (ROADMAP Queue 3); the port leaves such rows alone
    with pytest.raises(jledger.LedgerError):
        jres.run()
    whole_led = ledger.TokenLedger()
    whole = make(False, whole_led, kill=False)
    for r in _requests(False, prompts, keys):
        whole.submit(r)
    want = whole.run()
    for i in want:
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)
    assert led.violations == 0 and 0 < led.finalized < R
    rows = led.rows()
    assert led.finalized == len(rows)       # rows begun before: skipped
    for rid, plane in rows.items():
        np.testing.assert_array_equal(plane, whole_led.row(rid))
    assert {k: v for k, v in _counts(res.metrics.as_dict(),
                                     ("serve.",)).items()} == \
        _counts(whole.metrics.as_dict(), ("serve.",))

    jax_save_pytree(str(tmp_path / "obs"), jstate["obs"])
    reg = obs.MetricsRegistry()
    reg.load_state_dict(load_pytree(str(tmp_path / "obs"))[0])
    assert _counts(reg.as_dict(), ("serve.",)) == killed_counts
