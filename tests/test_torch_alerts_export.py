"""The port's §14 alert rules, recompile sentinel and memory gauges
(``repro_torch.obs.alerts``) and its §11 exporters (``obs.export``) on the
CPU, against ``repro.obs``.

The rules run the canned series of ``tests/obs/test_alerts.py`` through
both packages' managers and must fire the same events at the same steps.
The exporters must write, from the fake-clock scenario of
``tests/obs/test_exports.py`` built with each package's own tracer and
registry, the golden files under ``tests/obs/golden/`` byte for byte (and
so the reference's bytes), the same JSONL records, and serve the same
Prometheus text over HTTP on an ephemeral port.  The sentinel has no JAX
API to copy: its signature rules are tested here directly.
"""
import json
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.obs import MetricsRegistry as JMetricsRegistry  # noqa: E402
from repro.obs import Tracer as JTracer  # noqa: E402
from repro.obs import alerts as jalerts  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro_torch.obs import MetricsRegistry, Tracer  # noqa: E402
from repro_torch.obs import alerts, export  # noqa: E402
from repro_torch.obs.alerts import (SEV_CRIT, AlertManager, AlertRule,  # noqa: E402
                                    compile_counts, default_rules,
                                    record_compile_gauges,
                                    record_device_memory, register_jit_entry)

GOLDEN = Path(__file__).resolve().parent / "obs" / "golden"


# ------------------------------------------------------------------ rules


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


def _both(rules_fn, series, **kw):
    """Feed ``series`` (a list of (metrics, step)) to a port and a JAX
    manager built from ``rules_fn(module)``; return both event lists as
    comparable tuples."""
    out = []
    for mod in (alerts, jalerts):
        am = mod.AlertManager(rules_fn(mod), **kw)
        evs = []
        for m, step in series:
            evs += am.evaluate(m, step=step)
        out.append(([(e.rule, e.metric, e.value, e.threshold, e.step,
                      e.severity, e.message) for e in evs], am.as_dict()))
    assert out[0] == out[1]
    return out[0]


def test_rules_match_jax_rule_for_rule():
    assert [r.__dict__ for r in default_rules()] == \
        [r.__dict__ for r in jalerts.default_rules()]
    with pytest.raises(ValueError):
        AlertRule("bad", "x", "sideways", 0.0)
    with pytest.raises(ValueError):
        AlertManager([AlertRule("a", "x", "above", 0.0),
                      AlertRule("a", "y", "above", 0.0)])


def test_threshold_rule_edge_triggered():
    evs, d = _both(lambda m: [m.AlertRule("low", "x", "below", 0.5)],
                   [({"x": v}, i) for i, v in
                    enumerate((1.0, 0.4, 0.3, 0.6, 0.2))])
    # fires once entering the bad region, re-arms after clearing, again
    assert [e[4] for e in evs] == [1, 4] and d["alerts_fired"] == 2.0


def test_warmup_suppresses_early_samples():
    evs, _ = _both(lambda m: [m.AlertRule("low", "x", "below", 0.5,
                                          warmup=3)],
                   [({"x": 0.0}, i) for i in range(4)])
    assert [e[4] for e in evs] == [3]


def test_trend_rule_needs_full_window():
    evs, _ = _both(lambda m: [m.AlertRule("up", "x", "trend_up", 0.0,
                                          window=4)],
                   [({"x": v}, i) for i, v in
                    enumerate((1.0, 2.0, 3.0, 4.0, 4.0, 4.0, 4.0, 4.0))])
    assert [e[0] for e in evs] == ["up"]


def test_missing_metric_is_inert():
    evs, _ = _both(lambda m: m.default_rules(),
                   [({"loss": 1.0}, i) for i in range(20)])
    assert evs == []


def test_default_rules_fire_on_canned_collapse():
    series = [({"accept_rate": 0.5 if s < 6 else 0.01,
                "paged_alloc_failures": 0.0 if s < 7 else 2.0}, s)
              for s in range(8)]
    evs, _ = _both(lambda m: m.default_rules(), series)
    assert {e[0] for e in evs} == {"draft_accept_collapse",
                                   "pool_alloc_failures"}


def test_recompile_rule_fires_on_cache_growth():
    totals = (1, 2, 3, 4, 4, 4, 4, 4, 5, 6, 7, 8)
    evs, _ = _both(lambda m: [r for r in m.default_rules()
                              if r.name == "recompile_steady_state"],
                   [({"compiles.total": float(t)}, i)
                    for i, t in enumerate(totals)])
    assert [(e[0], e[4]) for e in evs] == [("recompile_steady_state", 8)]


def test_events_route_to_tracer_and_watchdog(tmp_path):
    from repro_torch.rl.watchdog import TrainWatchdog, WatchdogConfig
    tr = Tracer(enabled=True)
    wd = TrainWatchdog(WatchdogConfig(checkpoint_dir=str(tmp_path)))
    am = AlertManager([AlertRule("boom", "x", "above", 0.0,
                                 severity=SEV_CRIT, message="m")],
                      tracer=tr, watchdog=wd)
    evs = am.evaluate({"x": 1.0}, step=7)
    assert len(evs) == 1 and evs[0].step == 7 and evs[0].severity == SEV_CRIT
    assert [(e.name, e.track) for e in tr.events] == [("alert/boom",
                                                       "alerts")]
    assert tr.events[0].args == evs[0].as_args()
    assert wd.alert_events == 1 and wd.crit_alert_events == 1
    assert wd.last_alert == "boom"
    assert wd.as_dict()["watchdog_crit_alert_events"] == 1.0
    am.evaluate(MetricsRegistry.from_flat({"x": 2.0}), step=8)  # registry in
    assert wd.alert_events == 1                      # still active: no edge


# ------------------------------------------------------- recompile sentinel


@pytest.fixture
def entry():
    names = []

    def make(name, fn, static=()):
        names.append(name)
        return register_jit_entry(name, fn, static=static)

    yield make
    for name in names:
        alerts._JIT_ENTRIES.pop(name, None)


def test_sentinel_counts_signatures_like_a_jit_cache(entry):
    """Shapes, dtypes and devices key; static arguments key by value;
    other Python scalars by type; keywords as passed; a nested enrolled
    call adds nothing (JAX's inner jit cache does not grow while an outer
    program traces it) — each rule checked against jax.jit itself."""
    def inner(x, k=1):
        return x * k

    counted_inner = entry("t_inner", inner, static=("k",))

    def outer(x, s, k=1, y=None):
        return counted_inner(x, k=k) + (0 if y is None else 1)

    f = entry("t_outer", outer, static=("k",))
    calls = [((torch.zeros(2), 1.0), {}), ((torch.zeros(2), 2.0), {}),
             ((torch.zeros(3), 1.0), {}), ((torch.zeros(3), 1), {}),
             ((torch.zeros(3, dtype=torch.int32), 1), {}),
             ((torch.zeros(3), 1.0), {"k": 1}), ((torch.zeros(3), 1.0),
                                                  {"k": 2}),
             ((torch.zeros(3), 1.0), {"y": None}),
             ((torch.zeros(3), 1.0), {"y": torch.zeros(3)})]
    assert f(torch.ones(2), 1.0, k=3).tolist() == [3.0, 3.0]
    alerts._JIT_ENTRIES["t_outer"].signatures.clear()
    for args, kw in calls:
        f(*args, **kw)
    assert compile_counts()["t_outer"] == 8
    assert compile_counts()["t_inner"] == 0          # only ever nested
    jf = jax.jit(lambda x, s, k=1, y=None: x * k + (0 if y is None else 1),
                 static_argnames=("k",))
    for args, kw in calls:
        kw = {k: (None if v is None else v.numpy()) if k == "y" else v
              for k, v in kw.items()}
        jf(jax.numpy.asarray(args[0].numpy()), args[1], **kw)
    assert jf._cache_size() == 8


def test_sentinel_keys_modules_by_structure_and_walks_containers(entry):
    f = entry("t_walk", lambda m, caches: None)
    a, b = torch.nn.Linear(2, 3), torch.nn.Linear(2, 3)
    caches = [{"self": {"k": torch.zeros(2, 4), "v": torch.zeros(2, 4)}}]
    f(a, caches)
    f(b, caches)                            # same structure: same signature
    f(torch.nn.Linear(3, 3), caches)
    f(a, [{"self": {"k": torch.zeros(2, 5), "v": torch.zeros(2, 4)}}])
    f(a, caches + caches)
    assert compile_counts()["t_walk"] == 4


def test_registered_entries_feed_compile_gauges(entry):
    g = entry("t_gauge", lambda x: x * 2)
    g(torch.zeros(4))
    reg = MetricsRegistry()
    record_compile_gauges(reg)
    d = reg.as_dict()
    assert d["compiles.t_gauge"] == 1.0
    assert d["compiles.total"] == sum(compile_counts().values())


def test_engine_modules_enroll_their_entries_under_jax_names():
    import repro.core.verify           # noqa: F401
    import repro.drafting.step         # noqa: F401
    import repro.serving.engine_loop   # noqa: F401
    import repro_torch.core.verify     # noqa: F401
    import repro_torch.drafting.step   # noqa: F401
    import repro_torch.serving.engine_loop   # noqa: F401
    names = {"admit_vanilla", "admit_spec", "write_slots", "decode_chunk",
             "draft_step", "verify_drafts", "verify_and_prefill"}
    assert names <= set(alerts._JIT_ENTRIES)
    assert names <= set(jalerts._JIT_ENTRIES)
    from repro_torch.core import verify
    assert verify.verify_and_prefill.sentinel_entry is \
        alerts._JIT_ENTRIES["verify_and_prefill"]


def test_record_device_memory_reads_the_cuda_allocator(monkeypatch):
    reg = MetricsRegistry()
    record_device_memory(reg)            # no card here: no gauges
    assert not [k for k in reg.as_dict() if k.startswith("device.")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda: {
        "allocated_bytes.all.current": 5, "allocated_bytes.all.peak": 9})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda: (1, 80))
    record_device_memory(reg)
    assert {k: v for k, v in reg.as_dict().items()
            if k.startswith("device.")} == {
        "device.bytes_in_use": 5.0, "device.peak_bytes_in_use": 9.0,
        "device.bytes_limit": 80.0}


def test_paged_pool_gauges_exported():
    from repro_torch.engine.generate import GenerateConfig
    from repro_torch.engine.sampling import make_key
    from repro_torch.models import model as M
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving import Request
    from repro_torch.serving.paged_engine import PagedSlotEngine

    cfg = ModelConfig(name="t", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=32,
                      cache_layout="paged", kv_block_size=8)
    model = M.init_lm(cfg, seed=0, device="cpu")
    eng = PagedSlotEngine(model, cfg, GenerateConfig(max_new_tokens=4),
                          num_slots=2, prompt_width=8, chunk_steps=2)
    rng = np.random.RandomState(0)
    for i in range(2):
        eng.submit(Request(request_id=i,
                           prompt=rng.randint(3, 32, 5).astype(np.int32),
                           key=make_key(5, "cpu").fold_in(i),
                           max_new_tokens=4))
    eng.run()
    d = eng.metrics_registry().as_dict()
    assert 0.0 <= d["paged_pool_pressure"] <= 1.0
    assert d["paged_bytes_in_use"] >= 0.0
    assert d["paged_peak_bytes_in_use"] > 0.0
    st = eng.stats()        # the flat view of the same registry
    assert set(st) == set(d)
    assert {k: v for k, v in st.items() if k != "wall_time"} == \
        {k: v for k, v in d.items() if k != "wall_time"}


# ---------------------------------------------------------------- exports


def _scenario(tracer_cls, registry_cls):
    """``tests/obs/test_exports.py``'s fixed request lifecycle + trainer
    step (exact binary fractions, so ts * 1e6 is platform-stable)."""
    eng = tracer_cls(clock=lambda: 0.0)
    eng.complete("queued", "req/0", 0.0, 0.25, cat="queue", retries=0)
    eng.complete("admit", "req/0", 0.25, 0.3125, cat="admit", slot=0,
                 n_accepted=3)
    eng.complete("decode_chunk", "req/0", 0.3125, 0.5, cat="decode", steps=4)
    eng.event("retry", "req/0", cat="fault", ts=0.5, slot=0)
    eng.complete("decode_chunk", "req/0", 0.5625, 0.75, cat="decode", steps=4)
    eng.complete("request", "req/0", 0.0, 0.78125, cat="lifecycle",
                 reason="complete", tokens=7, retries=1)
    eng.complete("queued", "req/10", 0.0, 0.625, cat="queue", retries=0)
    eng.complete("admit", "engine", 0.25, 0.3125, cat="admit", rows=1)
    eng.complete("decode_chunk", "engine", 0.3125, 0.5, cat="decode",
                 steps=4, busy=1, emitted=4)
    trn = tracer_cls(clock=lambda: 0.0)
    trn.complete("collect", "trainer", 0.0, 0.8125, cat="train", step=0)
    trn.complete("update_actor", "trainer", 0.8125, 0.875, cat="train",
                 step=0)
    trn.complete("train_step", "trainer", 0.0, 0.875, cat="train", step=0)
    reg = registry_cls()
    reg.inc("serve.generated_tokens", 28)
    reg.inc("serve.reused_tokens", 3)
    reg.inc("serve.busy_slot_steps", 9)
    reg.inc("serve.total_slot_steps", 12)
    reg.set("serve.num_slots", 4.0, agg="sum")
    reg.ratio("serve.occupancy", "serve.busy_slot_steps",
              "serve.total_slot_steps")
    for v in (0.25, 0.5, 0.5, 2.0, 16.0):
        reg.observe("serve.ttft_ms", v)
    reg.observe("serve.reuse_len", 0.0)
    return {"engine": eng, "trainer": trn}, reg


@pytest.mark.parametrize("name", ["trace.json", "metrics.prom"])
def test_exports_equal_the_goldens_and_jax(tmp_path, name):
    tracers, reg = _scenario(Tracer, MetricsRegistry)
    jtracers, jreg = _scenario(JTracer, JMetricsRegistry)
    got, want = tmp_path / ("port_" + name), tmp_path / ("jax_" + name)
    if name == "trace.json":
        export.write_chrome_trace(got, tracers)
        jexport.write_chrome_trace(want, jtracers)
    else:
        export.write_prometheus(got, reg)
        jexport.write_prometheus(want, jreg)
    assert got.read_bytes() == (GOLDEN / name).read_bytes()
    assert got.read_bytes() == want.read_bytes()


def test_chrome_trace_with_counters_and_one_tracer_matches_jax():
    from repro.obs.attrib import build_report as jbuild
    from repro_torch.obs.attrib import build_report
    counts = {"prompt": 4, "reused_prefix": 6, "fresh": 2}
    tracers, _ = _scenario(Tracer, MetricsRegistry)
    jtracers, _ = _scenario(JTracer, JMetricsRegistry)
    got = export.chrome_trace(tracers["engine"], counters=build_report(
        counts, 0.5).counter_events(1.5))
    want = jexport.chrome_trace(jtracers["engine"], counters=jbuild(
        counts, 0.5).counter_events(1.5))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    procs = {e["args"]["name"] for e in got["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert procs == {"repro"}
    assert {e["name"] for e in got["traceEvents"] if e["ph"] == "C"} == {
        "tokens_by_provenance", "saved_seconds"}


def test_jsonl_records_and_final_metrics(tmp_path):
    tracers, reg = _scenario(Tracer, MetricsRegistry)
    jtracers, jreg = _scenario(JTracer, JMetricsRegistry)
    p, jp = tmp_path / "events.jsonl", tmp_path / "jax.jsonl"
    export.write_jsonl(p, tracers, reg)
    jexport.write_jsonl(jp, jtracers, jreg)
    assert p.read_bytes() == jp.read_bytes()
    recs = [json.loads(ln) for ln in p.read_text().splitlines()]
    assert recs[-1]["type"] == "metrics"
    assert recs[-1]["metrics"]["serve.occupancy"] == 0.75
    assert {r["type"] for r in recs[:-1]} == {"span", "event"}
    spans = [r for r in recs if r["type"] == "span"]
    assert all(r["dur"] == r["t1"] - r["t0"] for r in spans)
    eng = [r for r in recs[:-1] if r["proc"] == "engine"]
    ts = [r.get("t0", r.get("ts")) for r in eng]
    assert ts == sorted(ts)


def test_metrics_http_endpoint_on_an_ephemeral_port():
    _, reg = _scenario(Tracer, MetricsRegistry)
    srv = export.start_metrics_server(lambda: reg, port=0)
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
            assert r.status == 200
            assert "version=0.0.4" in r.headers["Content-Type"]
            body = r.read().decode()
        assert body == export.prometheus_text(reg)
        assert body == (GOLDEN / "metrics.prom").read_text()
        reg.inc("serve.generated_tokens", 1)    # a live provider
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
            assert "repro_serve_generated_tokens_total 29.0" in \
                r.read().decode()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=5)
    finally:
        srv.shutdown()
        srv.server_close()


def test_prometheus_text_escapes_and_special_values():
    reg, jreg = MetricsRegistry(), JMetricsRegistry()
    for r in (reg, jreg):
        r.set("a.b-c", float("nan"))
        r.set("inf", float("inf"))
        r.set("ninf", float("-inf"))
        r.observe("h", 1e-9)
    text = export.prometheus_text(reg, namespace="ns")
    assert text == jexport.prometheus_text(jreg, namespace="ns")
    assert "ns_a_b_c NaN" in text and "ns_inf +Inf" in text
    assert text.endswith("\n")


# ------------------------------------------------- launchers and analysis


@pytest.fixture
def obs_reset():
    """The serve launcher's --decision-log installs a process-global log;
    put the inert sinks back after the test."""
    from repro_torch import obs
    yield
    obs.reset()


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("flag", ["--ledger", "--decision-log",
                                  "--trace-dir", "--trace-sample-rate",
                                  "--metrics", "--assert-compile-stable"])
def test_observatory_serve_flags_run_on_the_cpu(flag, tmp_path, capsys,
                                                obs_reset):
    """Each §11/§14 flag of the serve launcher on a drafted smoke serve on
    the CPU (spec-prefix, but for the decision log), with JAX's lines and
    files."""
    from repro_torch.launch import serve
    from repro_torch.obs.ledger import load_dataset
    out = tmp_path / "out"
    argv = {"--ledger": ["--ledger"],
            "--decision-log": ["--decision-log", str(out)],
            "--trace-dir": ["--trace-dir", str(out)],
            "--trace-sample-rate": ["--trace-dir", str(out),
                                    "--trace-sample-rate", "0.0"],
            "--metrics": ["--metrics", str(_free_port())],
            "--assert-compile-stable": ["--assert-compile-stable"]}[flag]
    # the spec-prefix serve reuses its whole first pass (nothing decodes,
    # so nothing is drafted): the decision log serves without it
    spec = [] if flag == "--decision-log" else ["--spec-prefix",
                                                "--arrival-every", "2"]
    assert serve.main(["--device", "cpu", "--smoke", "--draft", "2"]
                      + spec + argv) == 0
    text = capsys.readouterr().out
    assert f"engine=slots(spec={bool(spec)}, shards=1)" in text
    if flag == "--ledger":
        assert "speculation economics" in text
    if flag == "--decision-log":
        n = len(load_dataset(str(out))["row"])
        assert n > 0 and f"decisions: {n} records" in text
    if "--trace-dir" in argv:
        assert sorted(p.name for p in out.iterdir()) == [
            "events.jsonl", "metrics.prom", "trace.json"]
        tracks = {e["args"]["name"] for e in json.loads(
            (out / "trace.json").read_text())["traceEvents"]
            if e["name"] == "thread_name"}
        assert "engine" in tracks
        assert any(t.startswith("req/") for t in tracks) == \
            (flag == "--trace-dir")
    if flag == "--metrics":
        assert "metrics: http://localhost:" in text
    if flag == "--assert-compile-stable":
        assert text.rstrip().endswith("0 new on identical replay")


def test_compile_stability_refuses_a_sentinel_that_counted_nothing(
        monkeypatch, capsys):
    """The flag must never pass vacuously: with every count at 0 it
    fails."""
    from repro_torch.launch import serve
    monkeypatch.setattr(serve, "compile_counts", lambda: {"decode_chunk": 0})
    with pytest.raises(SystemExit, match="counted a call"):
        serve.main(["--device", "cpu", "--smoke", "--requests", "2",
                    "--assert-compile-stable"])


def test_analysis_attrib_and_decisions_rebuild_the_reports(tmp_path, capsys,
                                                           obs_reset):
    """``launch.analysis attrib`` on a served ``events.jsonl`` prints the
    launcher's in-process table (priced from the run's own
    ``serve.token_ms``), as JAX's analysis does on the same file;
    ``decisions`` summarises a port-written decision log like JAX's."""
    from repro.launch import analysis as janalysis
    from repro_torch.launch import analysis, serve
    t, d = tmp_path / "t", tmp_path / "d"
    assert serve.main(["--device", "cpu", "--smoke", "--draft", "2",
                       "--ledger", "--trace-dir", str(t),
                       "--decision-log", str(d)]) == 0
    served = capsys.readouterr().out
    table = served[served.index("speculation economics"):].splitlines()
    table = [ln for ln in table[:10] if not ln.startswith("  actual")]
    report = tmp_path / "r.json"
    assert analysis.main(["attrib", str(t / "events.jsonl"), "--json",
                          str(report)]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[:len(table) - 1] == table[:-1]
    assert janalysis.main(["attrib", str(t / "events.jsonl")]) == 0
    assert capsys.readouterr().out.splitlines() == got[:-1]
    assert json.loads(report.read_text())["attrib.total_tokens"] > 0
    assert analysis.main(["decisions", str(d)]) == 0
    mine = capsys.readouterr().out
    assert janalysis.main(["decisions", str(d)]) == 0
    assert capsys.readouterr().out == mine
    assert "decision records" in mine
