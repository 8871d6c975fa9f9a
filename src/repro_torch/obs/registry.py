"""Unified metrics registry (DESIGN.md §11; own copy of
``repro/obs/registry.py``, which imports only ``math`` and numpy): typed
counters / gauges / log-bucketed histograms / derived ratios behind one
namespaced schema.  Values are Python floats and numpy arrays; no tensor
goes in.

The metric *type* carries the merge semantics: every shard exports a
``MetricsRegistry`` and ``merge`` combines the *union* of names:

* ``Counter``   — summed;
* ``Gauge``     — combined by its declared ``agg`` (max / min / sum / last);
* ``Histogram`` — merged bucket-wise (associative and commutative);
* ``Ratio``     — never merged directly: it names its numerator/denominator
  counters and re-derives after *they* merge (sum-of-parts, not
  mean-of-means — idle shards do not dilute busy ones).

Histograms are log-bucketed (bucket edges grow by ``2**0.25`` ≈ 19%), so
p50/p95/p99 are exact to one bucket's relative width at any scale, merging
is exact (buckets align by construction), and state is O(#occupied
buckets).  ``state_dict``/``load_state_dict`` round-trip through the
port's ``checkpoint/io`` all-array pytree writer, so kill-and-resume keeps
monotonic counters and latency history (§10 discipline).  The trainer
watchdog's stall verdict reads a ``Histogram``'s p95.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence

import numpy as np

# bucket edges: (_BASE ** i, _BASE ** (i+1)] — four buckets per octave
_BASE = 2.0 ** 0.25
_LOG_BASE = math.log(_BASE)
_ZERO_IDX = -(10 ** 9)            # the v <= 0 bucket (upper edge 0)

_AGGS = ("last", "max", "min", "sum")


def bucket_index(v: float) -> int:
    if v <= 0.0:
        return _ZERO_IDX
    # +1e-9: keep exact powers of _BASE in their own bucket under fp round
    return int(math.floor(math.log(v) / _LOG_BASE + 1e-9))


def bucket_edge(idx: int) -> float:
    """Upper edge of bucket ``idx`` (inclusive)."""
    return 0.0 if idx == _ZERO_IDX else _BASE ** (idx + 1)


class Counter:
    kind = "counter"
    __slots__ = ("v",)

    def __init__(self, v: float = 0.0):
        self.v = float(v)

    def add(self, x: float) -> None:
        self.v += float(x)

    def combine(self, other: "Counter") -> None:
        self.v += other.v


class Gauge:
    kind = "gauge"
    __slots__ = ("v", "agg")

    def __init__(self, v: float = 0.0, agg: str = "last"):
        assert agg in _AGGS, agg
        self.v = float(v)
        self.agg = agg

    def set(self, x: float) -> None:
        self.v = float(x)

    def combine(self, other: "Gauge") -> None:
        if self.agg == "max":
            self.v = max(self.v, other.v)
        elif self.agg == "min":
            self.v = min(self.v, other.v)
        elif self.agg == "sum":
            self.v += other.v
        else:                                    # "last": newest wins
            self.v = other.v


class Histogram:
    """Log-bucketed histogram with exact min/max/sum and bucket-merge."""
    kind = "histogram"
    __slots__ = ("buckets", "count", "total", "vmin", "vmax")

    def __init__(self):
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, v: float) -> None:
        v = float(v)
        idx = bucket_index(v)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def combine(self, other: "Histogram") -> None:
        for idx, c in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + c
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 100].  Returns the upper edge of the bucket holding the
        q-th sample, clamped to the exact observed [vmin, vmax] — so the
        relative error is at most one bucket width (~19%)."""
        if not self.count:
            return 0.0
        target = max(1, math.ceil(q / 100.0 * self.count))
        cum = 0
        for idx in sorted(self.buckets):
            cum += self.buckets[idx]
            if cum >= target:
                return float(min(self.vmax, max(self.vmin, bucket_edge(idx))))
        return float(self.vmax)

    def summary(self) -> Dict[str, float]:
        empty = not self.count
        return {"count": float(self.count), "sum": float(self.total),
                "mean": self.mean,
                "min": 0.0 if empty else float(self.vmin),
                "max": 0.0 if empty else float(self.vmax),
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}

    @classmethod
    def from_values(cls, values: Iterable[float]) -> "Histogram":
        h = cls()
        for v in values:
            h.record(v)
        return h


class Ratio:
    """A derived metric: ``num_name / den_name`` over sibling counters.

    Holds no state of its own — ``value`` re-reads the (possibly merged)
    counters, so the mesh-gathered ratio is always sum(num)/sum(den)."""
    kind = "ratio"
    __slots__ = ("num", "den", "scale")

    def __init__(self, num: str, den: str, scale: float = 1.0):
        self.num = num
        self.den = den
        self.scale = float(scale)

    def combine(self, other: "Ratio") -> None:
        assert (self.num, self.den) == (other.num, other.den), \
            (self.num, self.den, other.num, other.den)


class MetricsRegistry:
    """Named, typed metrics with type-driven cross-shard merge."""

    def __init__(self):
        self._m: Dict[str, object] = {}

    # ------------------------------------------------------------- accessors

    def _get(self, name: str, cls, *args, **kw):
        m = self._m.get(name)
        if m is None:
            assert "/" not in name, \
                f"metric name {name!r} may not contain '/' (pytree separator)"
            m = cls(*args, **kw)
            self._m[name] = m
        assert isinstance(m, cls), (name, type(m).__name__, cls.__name__)
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str, agg: str = "last") -> Gauge:
        return self._get(name, Gauge, 0.0, agg)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def ratio(self, name: str, num: str, den: str,
              scale: float = 1.0) -> Ratio:
        return self._get(name, Ratio, num, den, scale)

    # ------------------------------------------------------------ shorthands

    def inc(self, name: str, v: float = 1.0) -> None:
        self.counter(name).add(v)

    def set(self, name: str, v: float, agg: str = "last") -> None:
        self.gauge(name, agg).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).record(v)

    @classmethod
    def from_flat(cls, d: Dict[str, float]) -> "MetricsRegistry":
        """Lift a flat float dict into a registry of gauges — the audit
        gate every step-log surface (trainer, async loop) passes its
        metrics through so the namespace stays one ``as_dict`` schema."""
        reg = cls()
        for k, v in d.items():
            reg.set(k, float(v))
        return reg

    def names(self) -> List[str]:
        return list(self._m)

    def get(self, name: str):
        return self._m.get(name)

    # ----------------------------------------------------------------- merge

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold ``other`` in, type-driven, over the UNION of names — a
        metric present on any shard is present in the merged view."""
        for name, m in other._m.items():
            mine = self._m.get(name)
            if mine is None:
                self._m[name] = _copy_metric(m)
            else:
                assert mine.kind == m.kind, (name, mine.kind, m.kind)
                mine.combine(m)
        return self

    @classmethod
    def merged(cls, regs: Sequence["MetricsRegistry"]) -> "MetricsRegistry":
        out = cls()
        for r in regs:
            out.merge(r)
        return out

    # ------------------------------------------------------------- flat view

    def as_dict(self) -> Dict[str, float]:
        """The audited flat namespace (DESIGN.md §11 table): counters and
        gauges by name, ratios re-derived from their counters, histograms
        expanded to ``name_{count,sum,mean,min,max,p50,p95,p99}``."""
        out: Dict[str, float] = {}
        for name, m in self._m.items():
            if isinstance(m, (Counter, Gauge)):
                out[name] = float(m.v)
            elif isinstance(m, Ratio):
                num = self._m.get(m.num)
                den = self._m.get(m.den)
                n = float(num.v) if isinstance(num, (Counter, Gauge)) else 0.0
                d = float(den.v) if isinstance(den, (Counter, Gauge)) else 0.0
                out[name] = m.scale * n / d if d else 0.0
            else:
                for k, v in m.summary().items():
                    out[f"{name}_{k}"] = v
        return out

    # -------------------------------------------- exact state (§10 resume)

    def state_dict(self) -> Dict:
        """All-array pytree (checkpoint/io compatible — string metadata is
        encoded as uint8 so every leaf is an array)."""
        st: Dict = {}
        for name, m in self._m.items():
            if isinstance(m, Counter):
                st[name] = {"kind": np.int64(0), "v": np.float64(m.v)}
            elif isinstance(m, Gauge):
                st[name] = {"kind": np.int64(1), "v": np.float64(m.v),
                            "agg": np.int64(_AGGS.index(m.agg))}
            elif isinstance(m, Histogram):
                idx = np.asarray(sorted(m.buckets), np.int64)
                cnt = np.asarray([m.buckets[i] for i in sorted(m.buckets)],
                                 np.int64)
                st[name] = {"kind": np.int64(2), "idx": idx, "cnt": cnt,
                            "count": np.int64(m.count),
                            "total": np.float64(m.total),
                            "vmin": np.float64(m.vmin if m.count else 0.0),
                            "vmax": np.float64(m.vmax if m.count else 0.0)}
            else:
                st[name] = {"kind": np.int64(3), "scale": np.float64(m.scale),
                            "num": _enc(m.num), "den": _enc(m.den)}
        return st

    def load_state_dict(self, state: Dict) -> None:
        self._m.clear()
        for name, s in state.items():
            kind = int(s["kind"])
            if kind == 0:
                self._m[name] = Counter(float(s["v"]))
            elif kind == 1:
                g = Gauge(float(s["v"]), _AGGS[int(s["agg"])])
                self._m[name] = g
            elif kind == 2:
                h = Histogram()
                idx = np.asarray(s["idx"], np.int64)
                cnt = np.asarray(s["cnt"], np.int64)
                h.buckets = {int(i): int(c) for i, c in zip(idx, cnt)}
                h.count = int(s["count"])
                h.total = float(s["total"])
                h.vmin = float(s["vmin"]) if h.count else math.inf
                h.vmax = float(s["vmax"]) if h.count else -math.inf
                self._m[name] = h
            else:
                self._m[name] = Ratio(_dec(s["num"]), _dec(s["den"]),
                                      float(s["scale"]))


def _enc(name: str) -> np.ndarray:
    return np.frombuffer(name.encode("utf-8"), np.uint8).copy()


def _dec(arr) -> str:
    return bytes(np.asarray(arr, np.uint8).tolist()).decode("utf-8")


def _copy_metric(m):
    if isinstance(m, Counter):
        return Counter(m.v)
    if isinstance(m, Gauge):
        return Gauge(m.v, m.agg)
    if isinstance(m, Ratio):
        return Ratio(m.num, m.den, m.scale)
    h = Histogram()
    h.combine(m)
    return h


def extend_summary(values: Sequence[float]) -> Dict[str, float]:
    """min/max/p50/p95/p99 of ``values`` via the histogram helper — the
    ``core.metrics.summarize`` percentile backend."""
    h = Histogram.from_values(values)
    s = h.summary()
    return {k: s[k] for k in ("min", "max", "p50", "p95", "p99")}
