"""The port's metrics registry and span tracer (``repro_torch.obs``) on the
CPU against ``repro.obs`` on the same values: bucket edges, percentiles,
``as_dict``, ``merge``, the ``state_dict`` round trip through each
package's checkpoint writer, ``extend_summary``, ``summarize(percentiles=
True)``, and the tracer's spans and events under an injected clock.

Values come from seeded numpy generators.  Everything bucket-derived is
exact (integer counts); histogram sums and means are float64 on both
sides and summed in the same order, so they are compared exactly too."""
import itertools

import numpy as np
import pytest

import repro.obs as jobs
from repro.checkpoint.io import load_pytree as jax_load_pytree
from repro.checkpoint.io import save_pytree as jax_save_pytree
from repro.core.metrics import summarize as jax_summarize
from repro.obs import registry as jax_registry
from repro_torch import obs
from repro_torch.checkpoint.io import load_pytree, save_pytree
from repro_torch.core.metrics import summarize
from repro_torch.obs import registry


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


class FakeClock:
    """Monotonic fake clock: each read advances by ``tick``."""

    def __init__(self, tick=1.0):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


def _values(seed, n=500):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.lognormal(1.0, 1.5, n),
                           rng.exponential(0.01, n // 5),
                           [0.0, -1.0, 1.0, 2 ** 0.25, 2 ** 0.5]])
    rng.shuffle(vals)
    return vals


def _fill(pkg, seed):
    """One registry of each kind of metric, the same values for both."""
    r = pkg.MetricsRegistry()
    rng = np.random.default_rng(seed)
    r.inc("tokens", float(rng.integers(1, 100)))
    r.inc("den", float(rng.integers(1, 100)))
    r.ratio("rate", "tokens", "den", scale=100.0)
    for agg in ("last", "max", "min", "sum"):
        r.set(f"g_{agg}", float(rng.normal()), agg=agg)
    for v in _values(seed, 200):
        r.observe("lat.verify_ms", v)
    return r


def test_bucket_edges_match_jax():
    for v in np.concatenate([_values(0), [1e-12, 1e12]]):
        assert registry.bucket_index(v) == jax_registry.bucket_index(v), v
    for i in range(-80, 80):
        assert registry.bucket_edge(i) == jax_registry.bucket_edge(i)
    assert registry._ZERO_IDX == jax_registry._ZERO_IDX
    assert registry.bucket_edge(registry._ZERO_IDX) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_percentiles_and_summary_match_jax(seed):
    vals = _values(seed)
    got = obs.Histogram.from_values(vals)
    want = jobs.Histogram.from_values(vals)
    assert got.buckets == want.buckets
    for q in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
        assert got.percentile(q) == want.percentile(q), q
    assert got.summary() == want.summary()
    assert obs.Histogram().summary() == jobs.Histogram().summary()
    assert obs.extend_summary(vals) == jobs.extend_summary(vals)


def test_as_dict_merge_and_ratio_match_jax():
    got = [_fill(obs, s) for s in range(3)]
    want = [_fill(jobs, s) for s in range(3)]
    for g, w in zip(got, want):
        assert g.as_dict() == w.as_dict()
        assert g.names() == w.names()
    for order in itertools.permutations(range(3)):
        g = obs.MetricsRegistry.merged([got[i] for i in order]).as_dict()
        w = jobs.MetricsRegistry.merged([want[i] for i in order]).as_dict()
        assert g == w, order
    flat = {"loss": 0.25, "step": 3.0, "reward_mean": float("nan")}
    g = obs.MetricsRegistry.from_flat(flat).as_dict()
    w = jobs.MetricsRegistry.from_flat(flat).as_dict()
    assert list(g) == list(w) and np.allclose(
        list(g.values()), list(w.values()), equal_nan=True)
    with pytest.raises(AssertionError):
        obs.MetricsRegistry().inc("bad/name")
    with pytest.raises(AssertionError):
        got[0].set("tokens", 1.0)             # a counter is not a gauge


def test_state_dict_round_trip_and_crosses_packages(tmp_path):
    r, jr = _fill(obs, 5), _fill(jobs, 5)
    r.observe("zero", 0.0)
    jr.observe("zero", 0.0)
    st, jst = r.state_dict(), jr.state_dict()
    assert set(st) == set(jst)
    for name in st:
        assert set(st[name]) == set(jst[name]), name
        for k in st[name]:
            np.testing.assert_array_equal(st[name][k], jst[name][k])
            assert np.asarray(st[name][k]).dtype == \
                np.asarray(jst[name][k]).dtype, (name, k)
    # the port's writer, then the port's and JAX's registries load it
    save_pytree(str(tmp_path / "obs"), {"obs": st})
    tree, _ = load_pytree(str(tmp_path / "obs"))
    r2 = obs.MetricsRegistry()
    r2.load_state_dict(tree["obs"])
    assert r2.as_dict() == r.as_dict()
    jtree, _ = jax_load_pytree(str(tmp_path / "obs"))
    jr2 = jobs.MetricsRegistry()
    jr2.load_state_dict(jtree["obs"])
    assert set(jr2.as_dict()) == set(r.as_dict())
    # and JAX's file into the port's registry
    jax_save_pytree(str(tmp_path / "jobs"), {"obs": jst})
    tree, _ = load_pytree(str(tmp_path / "jobs"))
    r3 = obs.MetricsRegistry()
    r3.load_state_dict(tree["obs"])
    assert r3.as_dict() == r.as_dict()
    r3.observe("lat.verify_ms", 1.0)          # keeps accumulating
    assert r3.as_dict()["lat.verify_ms_count"] == \
        r.as_dict()["lat.verify_ms_count"] + 1


def test_summarize_percentiles_match_jax():
    rng = np.random.default_rng(4)
    hist = [{"rollout_time": float(v), "loss": float(w)}
            for v, w in zip(rng.lognormal(size=100), rng.normal(size=100))]
    hist.append({"loss": 0.5})
    keys = ["rollout_time", "loss", "absent"]
    for pct in (False, True):
        got = summarize(hist, keys, percentiles=pct)
        want = jax_summarize(hist, keys, percentiles=pct)
        assert list(got) == list(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k
    assert "rollout_time_p95" in got and "absent" not in got


def _trace(pkg, rate):
    tr = pkg.Tracer(clock=FakeClock(0.5), capacity=6, sample_rate=rate)
    with tr.span("outer", "main", cat="train", step=1):
        h = tr.begin("inner", "main", x=1)
        tr.event("ev", "main", cat="fault", reason="nan")
        tr.end(h, y=2)
        tr.end(h)                              # double end: no-op
    tr.end(999)                                # never opened: no-op
    for i in range(8):                         # ring eviction
        tr.complete(f"s{i}", f"req/{i % 3}", float(i), i + 0.25)
        tr.event(f"e{i}", "engine", ts=float(i))
    spans = [(s.name, s.track, s.cat, s.t0, s.t1, s.depth, s.args, s.dur)
             for s in tr.spans]
    events = [(e.name, e.track, e.cat, e.ts, e.args) for e in tr.events]
    picks = [tr.sampled(i) for i in range(500)]
    out = (spans, events, tr.dropped_spans, tr.dropped_events, tr.tracks(),
           picks)
    tr.clear()
    return out + (tr.tracks(), tr.dropped_spans)


@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
def test_tracer_spans_events_and_sampling_match_jax(rate):
    assert _trace(obs, rate) == _trace(jobs, rate)


def test_disabled_tracer_and_global_accessors():
    reads = []
    tr = obs.Tracer(enabled=False, clock=lambda: reads.append(1) or 0.0)
    assert tr.begin("a") == -1
    with tr.span("b"):
        pass
    tr.complete("c", "t", 0.0, 1.0)
    tr.event("d")
    assert not tr.spans and not tr.events and reads == []
    assert obs.NULL_TRACER.enabled is False
    assert obs.get_tracer() is obs.NULL_TRACER
    mine = obs.MetricsRegistry()
    live = obs.Tracer(clock=FakeClock())
    obs.configure(tracer=live, registry=mine)
    try:
        assert obs.get_tracer() is live and obs.get_registry() is mine
    finally:
        obs.reset()
    assert obs.get_tracer() is obs.NULL_TRACER
    assert obs.get_registry() is not mine
    assert set(obs.__all__) <= set(jobs.__all__)
