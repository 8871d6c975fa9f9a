"""§10 hardening of the port's slot engine on the CPU against
``repro.serving`` (the twin of tests/serving/test_faults.py), and the serve
launcher's paged and §10 flags.

Every recovery arc is driven by the same injected, seeded ``FaultPlan``
through JAX's ``SlotEngine`` and the port's, on the same weights (the
reduced qwen3-1.7b, num_kv_heads=2, float32) and keys (``JaxKeyBatch``):
tokens, lengths, finish reasons, retries and every ``fault_*`` and
lifecycle counter are compared exactly, log-probs within atol 1e-4.  Rows
untouched by faults also stay token-identical to a fault-free run.  The
one divergence (JAX's decode-implementation ladder on a second quarantine)
is stated in its test.
"""
import signal

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.backoff import BackoffConfig as JaxBackoffConfig  # noqa: E402
from repro.engine.generate import GenerateConfig as JaxGenerateConfig  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import EngineKilled as JaxEngineKilled  # noqa: E402
from repro.serving import FaultEvent as JaxFaultEvent  # noqa: E402
from repro.serving import FaultPlan as JaxFaultPlan  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import SlotEngine as JaxSlotEngine  # noqa: E402
from repro.serving import seeded_plan as jax_seeded_plan  # noqa: E402
from repro_torch.checkpoint.io import load_pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.backoff import (BackoffConfig,  # noqa: E402
                                      RetriesExhausted, retry)
from repro_torch.engine.generate import GenerateConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import (EngineKilled, FaultEvent,  # noqa: E402
                                 FaultPlan, PagedSlotEngine, Request,
                                 SlotEngine, seeded_plan)
from repro_torch.serving import engine_loop  # noqa: E402
from repro_torch.serving.request import (FINISH_BUDGET, FINISH_EOS,  # noqa: E402
                                         FINISH_FULL_REUSE, FINISH_SHED,
                                         FINISH_TIMEOUT)
from test_torch_rollout import JaxKeyBatch, row_keys  # noqa: E402

ATOL = 1e-4
P, N, R = 8, 12, 6
SUCCESS = {FINISH_EOS, FINISH_BUDGET, FINISH_FULL_REUSE}
KILLED = (EngineKilled, JaxEngineKilled)


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


def _gens(vocab, temperature=1.0):
    kw = dict(max_new_tokens=N, eos_id=vocab - 1, temperature=temperature)
    return JaxGenerateConfig(**kw), GenerateConfig(**kw)


def _reqs(prompts, keys, jax_side, ids=None, **kw):
    ids = range(len(prompts)) if ids is None else ids
    if jax_side:
        return [JaxRequest(request_id=i, prompt=p, key=np.asarray(keys)[j],
                           max_new_tokens=N, **kw)
                for j, (i, p) in enumerate(zip(ids, prompts))]
    return [Request(request_id=i, prompt=p, key=JaxKeyBatch(keys)[j],
                    max_new_tokens=N, **kw)
            for j, (i, p) in enumerate(zip(ids, prompts))]


def _factory(prompts, jax_side):
    """Burst requests 100 + i, keyed by ``fold_in(PRNGKey(99), i)``."""
    def make(i):
        key = jax.random.fold_in(jax.random.PRNGKey(99), i)[None]
        return _reqs([prompts[i % R]], key, jax_side, ids=[100 + i])[0]
    return make


def _plans(events, **kw):
    """One plan per engine (events fire once)."""
    return (JaxFaultPlan([JaxFaultEvent(*e) for e in events], **kw),
            FaultPlan([FaultEvent(*e) for e in events], **kw))


def _engines(setup, *, slots=2, temperature=1.0, jplan=None, plan=None,
             jbackoff=None, backoff=None, **ekw):
    jcfg, cfg, params, model, _, _ = setup
    jgen, gen = _gens(cfg.vocab_size, temperature)
    kw = dict(num_slots=slots, prompt_width=P, chunk_steps=4, **ekw)
    return (JaxSlotEngine(params, jcfg, jgen, faults=jplan,
                          retry_backoff=jbackoff, **kw),
            SlotEngine(model, cfg, gen, faults=plan, retry_backoff=backoff, **kw))


def _serve(setup, req_kw=None, events=(), factory=False, n=R, **kw):
    _, _, _, _, prompts, keys = setup
    jp, tp = ((dict(request_factory=_factory(prompts, side)) if factory
               else {}) for side in (True, False))
    jplan, plan = (JaxFaultPlan([JaxFaultEvent(*e) for e in events], **jp),
                   FaultPlan([FaultEvent(*e) for e in events], **tp))
    jeng, eng = _engines(setup, jplan=jplan, plan=plan, **kw)
    for side, e in ((True, jeng), (False, eng)):
        for r in _reqs(prompts[:n], keys[:n], side, **(req_kw or {})):
            e.submit(r)
    return jeng, eng, jeng.run(), eng.run()


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for i in want:
        g, w = got[i], want[i]
        assert (g.finish_reason, g.length, g.n_accepted, g.retries) == \
            (w.finish_reason, w.length, w.n_accepted, w.retries), i
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=ATOL)


COUNTERS = ("completed", "admitted", "submitted", "engine_steps",
            "timeouts", "quarantined_requests", "retried_requests",
            "shed_requests", "rejected_requests", "pending")


def _assert_counters(eng, jeng, skip=()):
    st, jst = eng.stats(), jeng.stats()
    fault = [k for k in jst if k.startswith("fault_")]
    assert sorted(fault) == sorted(k for k in st if k.startswith("fault_"))
    for k in list(COUNTERS) + fault:
        if k not in skip:
            assert st[k] == jst[k], (k, st[k], jst[k])
    return st


@pytest.fixture(scope="module")
def baseline(setup):
    """Fault-free tokens through the port's plain engine (3 slots)."""
    got = _serve(setup, slots=3)[3]
    return {i: got[i].tokens.copy() for i in got}


def test_hardened_clean_run_identity(setup, baseline):
    """Guards + deadlines + bounded queue + an empty plan: tokens equal
    JAX's and the unhardened run's, every fault counter 0."""
    jeng, eng, want, got = _serve(setup, deadline_steps=10 ** 6,
                                  max_queue=64)
    _assert_same(got, want)
    st = _assert_counters(eng, jeng)
    for i in range(R):
        np.testing.assert_array_equal(got[i].tokens, baseline[i])
    assert all(v == 0 for k, v in st.items() if k.startswith("fault_"))


def test_nan_quarantine_retries_token_identical(setup, baseline):
    """Injected non-finite logits quarantine the row in-chunk; the retry
    regenerates from the request's own key, so even targeted rows end
    token-identical, as in JAX."""
    jeng, eng, want, got = _serve(setup, events=[("nan", 0, 0),
                                                 ("nan", 6, 3)])
    _assert_same(got, want)
    st = _assert_counters(eng, jeng)
    for i in range(R):
        assert got[i].finish_reason in SUCCESS
        np.testing.assert_array_equal(got[i].tokens, baseline[i])
    assert got[0].retries == 1 and got[3].retries == 1
    assert (st["fault_injected"], st["fault_nan_events"],
            st["fault_quarantines"], st["retried_requests"]) == (2, 2, 2, 2)
    assert eng.faults.exhausted()


def test_stall_trips_deadline_and_retries(setup, baseline):
    jeng, eng, want, got = _serve(setup, events=[("stall", 0, 0, 10 ** 6)],
                                  deadline_steps=64)
    _assert_same(got, want)
    st = _assert_counters(eng, jeng)
    for i in range(R):
        np.testing.assert_array_equal(got[i].tokens, baseline[i])
    assert got[0].retries == 1
    assert st["timeouts"] == 1 and st["fault_timeouts"] == 1
    assert st["fault_quarantines"] == 0


def test_retries_exhausted_fails_with_clean_partial(setup, baseline):
    jeng, eng, want, got = _serve(setup, events=[("stall", 0, 0, 10 ** 6)],
                                  deadline_steps=64,
                                  req_kw={"max_retries": 0})
    _assert_same(got, want)
    st = _assert_counters(eng, jeng)
    r0 = got[0]
    assert r0.finish_reason == FINISH_TIMEOUT and 0 < r0.length < N
    np.testing.assert_array_equal(r0.tokens, baseline[0][:r0.length])
    assert st["fault_failed"] == 1


@pytest.mark.parametrize("overflow,served", [("reject", (0, 1)),
                                             ("shed-oldest", (4, 5))])
def test_backpressure(setup, baseline, overflow, served):
    """A bounded queue: 'reject' refuses the newcomers, 'shed-oldest' drops
    the queue head; shed requests resolve at once, the rest complete."""
    jeng, eng, want, got = _serve(setup, slots=1, max_queue=2,
                                  overflow=overflow)
    _assert_same(got, want)
    st = _assert_counters(eng, jeng)
    for i in range(R):
        if i in served:
            np.testing.assert_array_equal(got[i].tokens, baseline[i])
        else:
            assert got[i].finish_reason == FINISH_SHED and got[i].length == 0
    assert st["shed_requests"] == 4 and st["fault_failed"] == 4
    assert st["rejected_requests"] == (4 if overflow == "reject" else 0)


def test_burst_overflows_bounded_queue(setup, baseline):
    jeng, eng, want, got = _serve(setup, events=[("burst", 0, -1, 5)],
                                  factory=True, n=2, max_queue=4)
    _assert_same(got, want)
    st = _assert_counters(eng, jeng)
    for i in (0, 1):
        np.testing.assert_array_equal(got[i].tokens, baseline[i])
    shed = [i for i in got if got[i].finish_reason == FINISH_SHED]
    assert len(shed) == 3 and st["fault_injected"] == 1


def test_kill_raises_at_chunk_boundary(setup):
    jeng, eng = _engines(setup, jplan=_plans([("kill", 8)])[0],
                         plan=_plans([("kill", 8)])[1])
    _, _, _, _, prompts, keys = setup
    for side, e in ((True, jeng), (False, eng)):
        for r in _reqs(prompts, keys, side):
            e.submit(r)
        with pytest.raises(KILLED):
            e.run()
    assert eng.steps == jeng.steps == 8
    assert eng.scheduler.num_active > 0
    assert sorted(eng.responses) == sorted(jeng.responses)
    _assert_counters(eng, jeng)


def test_seeded_chaos_plan(setup, baseline):
    """A seeded mixed plan (nan + stall + burst) against a hardened engine:
    the same plan as JAX's (the copy of ``seeded_plan`` draws the same
    events), the same outcome, untargeted rows token-identical."""
    _, _, _, _, prompts, keys = setup
    kw = dict(request_ids=range(R), max_step=12, n_nan=2, n_stall=1,
              n_burst=1, burst_size=3)
    jplan = jax_seeded_plan(0, request_factory=_factory(prompts, True), **kw)
    plan = seeded_plan(0, request_factory=_factory(prompts, False), **kw)
    assert [(e.kind, e.at_step, e.request_id, e.count)
            for e in plan.events] == [(e.kind, e.at_step, e.request_id,
                                       e.count) for e in jplan.events]
    targeted = plan.targeted_requests()
    assert targeted
    jeng, eng = _engines(setup, jplan=jplan, plan=plan, deadline_steps=64,
                         max_queue=9, overflow="shed-oldest")
    for side, e in ((True, jeng), (False, eng)):
        for r in _reqs(prompts, keys, side, max_retries=3):
            e.submit(r)
    want, got = jeng.run(), eng.run()
    _assert_same(got, want)
    st = _assert_counters(eng, jeng)
    assert set(got) == set(range(R)) | {100, 101, 102}
    for i in set(range(R)) - targeted:
        if got[i].finish_reason != FINISH_SHED:
            np.testing.assert_array_equal(got[i].tokens, baseline[i])
    assert plan.exhausted() and st["fault_injected"] == len(plan.events)
    assert st["retried_requests"] > 0 and eng.scheduler.idle


def test_retry_backoff_holds_then_completes(setup, baseline):
    """With a BackoffConfig the reclaimed request waits out its backoff on
    the engine's step clock, then completes token-identically (as JAX)."""
    bo = dict(base=8.0, factor=2.0, max_delay=64.0)
    jeng, eng, want, got = _serve(setup, events=[("stall", 0, 0, 10 ** 6)],
                                  deadline_steps=64,
                                  jbackoff=JaxBackoffConfig(**bo),
                                  backoff=BackoffConfig(**bo))
    _assert_same(got, want)
    _assert_counters(eng, jeng)
    for i in range(R):
        np.testing.assert_array_equal(got[i].tokens, baseline[i])
    assert got[0].retries == 1 and not eng._retry_hold
    cfg = BackoffConfig(**bo, jitter=0.1, seed=3)
    assert cfg.schedule() == JaxBackoffConfig(**bo, jitter=0.1,
                                              seed=3).schedule()
    calls, slept = [], []

    def flaky():
        calls.append(1)
        raise OSError("down")

    with pytest.raises(RetriesExhausted):
        retry(flaky, BackoffConfig(max_attempts=3), sleep=slept.append)
    assert len(calls) == 3 and slept == [0.05, 0.1]


def test_retry_backoff_hold_rides_kill_resume(setup):
    """A held retry is in-flight work: it survives state_dict /
    load_state_dict, and an engine with no holds writes no such key."""
    _, _, _, _, prompts, keys = setup
    bo = BackoffConfig(base=8.0, factor=2.0, max_delay=64.0)
    _, eng = _engines(setup, plan=FaultPlan([FaultEvent("stall", 0, 0,
                                                        10 ** 6)]),
                      deadline_steps=64, backoff=bo)
    for r in _reqs(prompts, keys, False):
        eng.submit(r)
    while not eng._retry_hold:
        eng.run(max_chunks=1)
    st = eng.state_dict()
    assert "retry_hold" in st and len(st["retry_hold"]) == 1
    _, eng2 = _engines(setup, deadline_steps=64, backoff=bo)
    eng2.load_state_dict(st)
    assert eng2._retry_hold[0][0] == eng._retry_hold[0][0]
    r1, r2 = eng.run(), eng2.run()
    for i in r1:
        np.testing.assert_array_equal(r1[i].tokens, r2[i].tokens)
        np.testing.assert_array_equal(r1[i].logprobs, r2[i].logprobs)
    _, eng3 = _engines(setup, slots=3)
    for r in _reqs(prompts, keys, False):
        eng3.submit(r)
    eng3.run()
    assert "retry_hold" not in eng3.state_dict()


def test_second_strike_keeps_the_kernel_route(setup):
    """Divergence from JAX, on purpose: two quarantines of one request walk
    JAX's decode impl down its ladder (auto → blocked, one
    ``fault_impl_fallbacks``); the port counts the strike and retries on
    the same route — ``cfg.decode_impl`` unchanged, no fallback counted —
    because its only other route is the plain version, which on the card
    would hide the kernel.  Everything else is JAX's: the request retries
    twice and completes with JAX's tokens."""
    jeng, eng, want, got = _serve(setup, n=2, req_kw={"max_retries": 2},
                                  events=[("nan", 0, 0), ("nan", 12, 0)])
    _assert_same(got, want)
    st = _assert_counters(eng, jeng, skip=("fault_impl_fallbacks",))
    assert got[0].finish_reason in SUCCESS and got[0].retries == 2
    assert st["fault_quarantines"] == 2
    assert jeng.cfg.decode_impl == "blocked"
    assert jeng.stats()["fault_impl_fallbacks"] == 1
    assert eng.cfg.decode_impl == "auto" and st["fault_impl_fallbacks"] == 0


def test_serve_launcher_paged_and_hardened_on_cpu(capsys, monkeypatch):
    """--cache-layout paged serves through the PagedSlotEngine, with the
    §10 flags reaching it."""
    engines = []
    make = serve.make_slot_engine

    def spy(*args, **kw):
        engines.append(make(*args, **kw))
        return engines[-1]

    monkeypatch.setattr(serve, "make_slot_engine", spy)
    assert serve.main(["--device", "cpu", "--smoke", "--cache-layout",
                       "paged", "--kv-block-size", "8", "--deadline-steps",
                       "64", "--max-queue", "16", "--overflow",
                       "shed-oldest", "--requests", "6"]) == 0
    out = capsys.readouterr().out
    assert "engine=slots(spec=False" in out and "served 6/6" in out
    (eng,) = engines
    assert type(eng) is PagedSlotEngine and eng.cfg.kv_block_size == 8
    assert (eng.deadline_steps, eng.scheduler.max_queue,
            eng.scheduler.overflow) == (64, 16, "shed-oldest")
    assert eng.allocator.blocks_in_use == 0


def test_serve_launcher_snapshots_on_interrupt(capsys, tmp_path,
                                               monkeypatch):
    """SIGTERM mid-chunk stops the serve at the next chunk boundary and
    writes the exact server state to --state-path."""
    run_chunk = engine_loop.SlotEngine._run_chunk
    calls = []

    def signalled(self, steps=None):
        calls.append(1)
        if len(calls) == 2:
            signal.raise_signal(signal.SIGTERM)
        return run_chunk(self, steps)

    monkeypatch.setattr(engine_loop.SlotEngine, "_run_chunk", signalled)
    before = signal.getsignal(signal.SIGTERM)
    path = str(tmp_path / "state")
    assert serve.main(["--device", "cpu", "--smoke", "--cache-layout",
                       "paged", "--kv-block-size", "8", "--requests", "6",
                       "--state-path", path]) == 0
    out = capsys.readouterr().out
    assert "[interrupted]" in out and path in out
    tree, meta = load_pytree(path)
    assert meta["kind"] == "server_state" and meta["requests"] == 6
    assert int(tree["meta"]["steps"]) == 16 and "paged" in tree
    assert signal.getsignal(signal.SIGTERM) == before     # handler restored
