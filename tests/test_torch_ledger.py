"""The port's §14 token-provenance ledger, decision log and savings
attribution (``repro_torch.obs.ledger`` / ``obs.attrib``) against
``repro.obs`` on the CPU: every case of ``tests/obs/test_ledger.py``, each
run through both packages with the port held to the reference's planes,
counts, errors and reports (exactly: both are integer bookkeeping and the
same float arithmetic), the conservation property under hypothesis, and
decision-log directories crossing the packages in both directions.
"""
import os

import numpy as np
import pytest
from hypothesis_compat import given, settings, st

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.obs import attrib as jattrib  # noqa: E402
from repro.obs import ledger as jledger  # noqa: E402
from repro_torch.obs import attrib, ledger  # noqa: E402
from repro_torch.obs.ledger import (CATEGORY_NAMES, DECISION_FEATURES,  # noqa: E402
                                    DECISION_OUTCOMES, DRAFT_ACCEPTED,
                                    DRAFT_BONUS, FRESH, PROMPT,
                                    QUARANTINE_CLAMPED, RETRY_STITCHED,
                                    REUSED_PREFIX, DecisionLog, LedgerError,
                                    TokenLedger, categorize_draft_block,
                                    load_dataset)

BOTH = (jledger, ledger)


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


def test_constants_match_jax():
    for name in ("UNSET", "PROMPT", "REUSED_PREFIX", "DRAFT_ACCEPTED",
                 "DRAFT_BONUS", "FRESH", "RETRY_STITCHED",
                 "QUARANTINE_CLAMPED", "SHARED_PROMPT_BLOCK",
                 "NUM_CATEGORIES", "CATEGORY_NAMES", "SAVINGS_CATEGORIES",
                 "DECISION_SCHEMA_VERSION", "DECISION_FEATURES",
                 "DECISION_OUTCOMES", "SOURCE_NONE", "SOURCE_NGRAM",
                 "SOURCE_CACHE"):
        assert getattr(ledger, name) == getattr(jledger, name), name
    assert attrib.MECHANISMS == jattrib.MECHANISMS


# ------------------------------------------------------------ unit behaviour


def test_row_records_in_order_and_conserves():
    planes = []
    for mod in BOTH:
        led = mod.TokenLedger()
        led.begin_row("r", 3)
        led.append("r", REUSED_PREFIX, 4)
        led.append("r", FRESH, 2)
        planes.append(led.row("r"))
        assert led.finalize("r", 9).tolist() == planes[-1].tolist()
        assert led.finalized == 1 and led.violations == 0
    assert planes[1].tolist() == [PROMPT] * 3 + [REUSED_PREFIX] * 4 \
        + [FRESH] * 2
    np.testing.assert_array_equal(planes[1], planes[0])
    assert planes[1].dtype == planes[0].dtype == np.uint8


def test_finalize_rejects_length_mismatch():
    msgs = []
    for mod in BOTH:
        led = mod.TokenLedger()
        led.begin_row("r", 2)
        led.append("r", FRESH, 1)
        with pytest.raises(mod.LedgerError) as err:
            led.finalize("r", 5)
        assert led.violations == 1 and led.finalized == 0
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]
    led = TokenLedger()
    led.begin_row("u", 0)
    led.append("u", ledger.UNSET, 1)       # an UNSET byte never finalizes
    with pytest.raises(LedgerError):
        led.finalize("u", 1)


def test_disabled_ledger_is_inert():
    for mod in BOTH:
        led = mod.TokenLedger(enabled=False)
        led.begin_row("r", 3)
        led.append("r", FRESH, 100)
        led.finalize("r", 0)       # any expectation passes: nothing recorded
        assert led.category_counts().sum() == 0
    assert ledger.NULL_LEDGER.enabled is False
    assert ledger.NULL_DECISION_LOG.enabled is False


def test_retry_category_switches_reuse_class():
    for mod in BOTH:
        led = mod.TokenLedger()
        led.note_retry("r", "deadline")
        assert led.retry_category("r") == RETRY_STITCHED
        led.note_retry("q", "quarantine")
        assert led.retry_category("q") == QUARANTINE_CLAMPED
        led.clear_retry("r")
        assert led.retry_category("r") == RETRY_STITCHED


@pytest.mark.parametrize("emitted", [0, 1, 2, 4, 9])
@pytest.mark.parametrize("carry_bonus", [False, True])
def test_categorize_draft_block_matches_jax(emitted, carry_bonus):
    got = categorize_draft_block(emitted, carry_bonus)
    assert got == jledger.categorize_draft_block(emitted, carry_bonus)
    if emitted:
        assert got[0] == (DRAFT_BONUS if carry_bonus else FRESH, 1)
        assert sum(n for _, n in got) == emitted
    assert categorize_draft_block(4, False) == [(FRESH, 1),
                                                (DRAFT_ACCEPTED, 3)]


def test_bind_unbind_stack():
    for mod in BOTH:
        led = mod.TokenLedger()
        assert led.bound_row(0) is None
        led.bind(["a", "b"])
        assert led.bound_row(0) == "a" and led.bound_row(1) == "b"
        led.bind(["c"])
        assert led.bound_row(0) == "c"
        led.unbind()
        assert led.bound_row(1) == "b"
        led.unbind()
        assert led.bound_row(0) is None


def test_drop_last_truncate_reserve_and_clear():
    outs = []
    for mod in BOTH:
        led = mod.TokenLedger()
        base = led.reserve(3)
        assert led.reserve(2) == base + 3
        led.begin_row(base, 2)
        led.append(base, FRESH, 5)
        led.drop_last(base, 2)
        led.truncate(base, 4)
        led.drop_last("missing", 1)
        assert led.has_row(base) and not led.has_row("missing")
        outs.append((led.row(base).tolist(), led.counts_dict()))
        led.clear()
        assert led.rows() == {} and led.reserve(1) == 0
    assert outs[1] == outs[0]
    assert outs[1][0] == [PROMPT, PROMPT, FRESH, FRESH]


# ------------------------------------------------------- conservation property


def _replay(mod, events, prompt_len):
    led = mod.TokenLedger()
    led.begin_row("r", prompt_len)
    n = prompt_len
    for cat, k in events:
        led.append("r", cat, k)
        n += k
    led.finalize("r", n)
    return led


_CATS = (REUSED_PREFIX, DRAFT_ACCEPTED, DRAFT_BONUS, FRESH, RETRY_STITCHED,
         QUARANTINE_CLAMPED)


@settings(max_examples=100, deadline=None)
@given(prompt_len=st.integers(0, 16),
       events=st.lists(st.tuples(st.sampled_from(_CATS),
                                 st.integers(0, 8)), max_size=24))
def test_conservation_over_random_traces(prompt_len, events):
    led, jled = (_replay(m, events, prompt_len) for m in (ledger, jledger))
    total = prompt_len + sum(k for _, k in events)
    assert int(led.category_counts().sum()) == total
    assert led.violations == 0
    np.testing.assert_array_equal(led.row("r"), jled.row("r"))
    np.testing.assert_array_equal(led.category_counts(),
                                  jled.category_counts())


def test_conservation_over_seeded_traces():
    """Deterministic twin of the property (runs with or without
    hypothesis)."""
    rng = np.random.RandomState(7)
    for _ in range(50):
        p = int(rng.randint(0, 16))
        events = [(int(rng.choice(_CATS)), int(rng.randint(0, 8)))
                  for _ in range(rng.randint(0, 24))]
        led, jled = (_replay(m, events, p) for m in (ledger, jledger))
        assert int(led.category_counts().sum()) == \
            p + sum(k for _, k in events)
        assert led.counts_dict() == jled.counts_dict()


def test_rollout_end_to_end_conservation():
    """A drafted spec rollout of the reference's tiny config, three steps
    in both packages (keys through ``JaxKey``): every port row conserves,
    no UNSET byte survives, and the port's rows and counts are JAX's."""
    from repro.core.cache import RolloutCache as JRolloutCache
    from repro.core.spec_rollout import SpecConfig as JSpecConfig
    from repro.core.spec_rollout import rollout as jrollout
    from repro.drafting import DraftConfig as JDraftConfig
    from repro.engine.generate import GenerateConfig as JGenerateConfig
    from repro.models import model as JM
    from repro.models.config import ModelConfig as JModelConfig
    from repro.obs import configure as jconfigure
    from repro.obs import reset as jreset
    from repro_torch.core import RolloutCache, SpecConfig, rollout
    from repro_torch.drafting import DraftConfig
    from repro_torch.engine.generate import GenerateConfig
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.convert import from_jax_params
    from repro_torch.obs import configure, reset
    from test_torch_rollout import JaxKey

    shape = dict(name="t", num_layers=2, d_model=64, num_heads=4,
                 num_kv_heads=2, d_ff=128, vocab_size=32)
    jcfg, cfg = JModelConfig(**shape), ModelConfig(**shape)
    params = JM.init_lm(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    B, P = 4, 6
    rng = np.random.RandomState(3)
    prompts = rng.randint(3, 32, (B, P)).astype(np.int32)
    mask = np.ones((B, P), bool)
    jcache, cache = JRolloutCache(), RolloutCache()
    jled, led = jledger.TokenLedger(), TokenLedger()
    jconfigure(ledger=jled)
    configure(ledger=led)
    try:
        key = jax.random.PRNGKey(1)
        for step in range(3):   # step 0 cold, steps 1-2 verify + reuse
            key, sub = jax.random.split(key)
            jrollout(params, jcfg, JGenerateConfig(max_new_tokens=8),
                     JSpecConfig(variant="spec", draft=JDraftConfig(
                         kind="ngram", draft_k=2)),
                     jnp.asarray(prompts), jnp.asarray(mask),
                     list(range(B)), jcache, sub, step)
            rb = rollout(model, cfg, GenerateConfig(max_new_tokens=8),
                         SpecConfig(variant="spec", draft=DraftConfig(
                             kind="ngram", draft_k=2)),
                         prompts, mask, list(range(B)), cache, JaxKey(sub),
                         step)
    finally:
        reset()
        jreset()
    assert led.violations == 0 and led.finalized == 3 * B
    for plane in led.rows().values():
        assert (plane != 0).all()       # no UNSET bytes survive finalize
    counts = led.counts_dict()
    assert counts["prompt"] == 3 * B * P
    assert counts["reused_prefix"] > 0 and rb.metrics["n_reused"] > 0
    assert counts == jled.counts_dict()
    assert led.rows().keys() == jled.rows().keys()
    for rid, plane in led.rows().items():
        np.testing.assert_array_equal(plane, jled.row(rid))


# ------------------------------------------------------- decision round-trip


def _fill(mod, out, shard_rows=3):
    dec = mod.DecisionLog(out, shard_rows=shard_rows)
    for i in range(8):
        dec.record(f"row{i % 2}", i,
                   {"surprisal": float(i), "draft_k": 2.0},
                   {"accepted": float(i % 3), "emitted": 1.0})
    dec.flush()
    return dec


def test_decision_log_roundtrip(tmp_path):
    out = str(tmp_path / "dec")
    dec = _fill(ledger, out)
    assert dec.shards_written >= 2     # shard_rows=3 forced rotation
    assert dec.records_total == 8 and len(dec) == 0
    ds = load_dataset(out)
    assert ds["features"].shape == (8, len(DECISION_FEATURES))
    assert ds["outcomes"].shape == (8, len(DECISION_OUTCOMES))
    si = DECISION_FEATURES.index("surprisal")
    np.testing.assert_array_equal(ds["features"][:, si],
                                  np.arange(8, dtype=np.float32))
    qi = DECISION_FEATURES.index("queue_depth")
    assert (ds["features"][:, qi] == 0).all()   # unset columns default to 0
    assert sorted(set(ds["row"].tolist())) == ["row0", "row1"]


@pytest.mark.parametrize("writer,reader", [(ledger, jledger),
                                           (jledger, ledger)],
                         ids=["port_to_jax", "jax_to_port"])
def test_decision_log_crosses_packages(tmp_path, writer, reader):
    """A directory written by one package loads in the other; both
    packages write the same JSONL bytes and the same NPZ arrays."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _fill(writer, a)
    _fill(reader, b)
    got, want = reader.load_dataset(a), reader.load_dataset(b)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        if name.endswith(".jsonl"):
            with open(os.path.join(a, name), "rb") as fa, \
                    open(os.path.join(b, name), "rb") as fb:
                assert fa.read() == fb.read(), name


def test_decision_schema_drift_rejected(tmp_path):
    out = str(tmp_path / "dec")
    dec = DecisionLog(out)
    dec.record("r", 0, {}, {})
    dec.flush()
    shard = os.path.join(out, "decisions-00000.npz")
    with np.load(shard, allow_pickle=False) as z:
        data = dict(z)
    data["schema_version"] = np.int64(99)
    np.savez(shard, **data)
    with pytest.raises(ValueError, match="schema"):
        load_dataset(out)
    with pytest.raises(FileNotFoundError):
        load_dataset(str(tmp_path))


# ------------------------------------------------------------- attribution


def _counts():
    counts = {name: 0 for name in CATEGORY_NAMES}
    counts.update(prompt=10, reused_prefix=40, draft_accepted=20,
                  draft_bonus=5, fresh=25, shared_prompt_block=8,
                  retry_stitched=3, quarantine_clamped=2)
    return counts


def test_attribution_prices_mechanisms():
    rep = attrib.build_report(_counts(), t_token_s=0.01,
                              t_prompt_token_s=0.002, actual_s=1.0)
    assert rep.total_tokens == 113
    assert rep.saved_s["spec_prefix"] == pytest.approx(0.40)
    assert rep.saved_s["draft"] == pytest.approx(0.20)
    assert rep.saved_s["shared_prompt"] == pytest.approx(8 * 0.002)
    assert rep.saved_s["retry_reverify"] == pytest.approx(0.05)
    assert rep.baseline_s == pytest.approx(1.0 + rep.total_saved_s)
    d = rep.as_dict()
    assert d["attrib.speedup"] == pytest.approx(rep.baseline_s / 1.0)
    jrep = jattrib.build_report(_counts(), t_token_s=0.01,
                                t_prompt_token_s=0.002, actual_s=1.0)
    assert d == jrep.as_dict()
    assert rep.summary() == jrep.summary()
    with pytest.raises(ValueError):
        attrib.build_report(np.zeros(3), t_token_s=0.01)


def test_attribution_from_ledger_and_counter_events():
    from repro.obs import MetricsRegistry as JMetricsRegistry
    from repro_torch.obs import MetricsRegistry
    reps = []
    for mod, amod in ((ledger, attrib), (jledger, jattrib)):
        led = mod.TokenLedger()
        led.begin_row("r", 4)
        led.append("r", REUSED_PREFIX, 6)
        led.append("r", FRESH, 2)
        led.finalize("r", 12)
        reps.append(amod.build_report(led, t_token_s=0.5, epoch=3))
    rep, jrep = reps
    assert rep.counts["reused_prefix"] == 6
    assert rep.saved_s["spec_prefix"] == pytest.approx(3.0)
    evs = rep.counter_events(ts_s=1.5)
    assert evs and all(e["ts"] == 1.5 and e["track"] == "attrib"
                       for e in evs)
    assert evs == jrep.counter_events(ts_s=1.5)
    assert rep.summary() == jrep.summary()
    assert rep.to_registry(MetricsRegistry()).as_dict() == \
        jrep.to_registry(JMetricsRegistry()).as_dict()


@pytest.mark.parametrize("reg", [
    {}, {"serve.token_ms_mean": 20.0, "serve.token_ms_count": 5},
    {"serve.token_ms_mean": 20.0, "serve.token_ms_count": 0},
    {"rollout.decode_s_sum": 4.0, "rollout.generated_tokens": 100.0}],
    ids=["none", "serve", "serve_empty", "rollout"])
def test_measured_token_cost_fallbacks(reg):
    assert attrib.measured_token_cost(reg) == \
        jattrib.measured_token_cost(reg)
    assert attrib.measured_token_cost(
        {"serve.token_ms_mean": 20.0,
         "serve.token_ms_count": 5}) == pytest.approx(0.02)
