"""Metric alert rules + recompile sentinel + memory gauges (DESIGN.md §14;
after ``repro/obs/alerts.py``).

The §11 registry records everything and judges nothing: a draft-acceptance
collapse or a steady-state recompile storm is invisible until a bench
regresses.  ``AlertManager`` closes that gap with declarative rules
evaluated over registry dumps each training step:

- ``below`` / ``above``: the metric crossed a threshold after ``warmup``
  observations (collapse detectors);
- ``trend_up`` / ``trend_down``: the metric moved monotonically-on-average
  across a sliding ``window`` by more than ``threshold`` (leak/storm
  detectors — pool exhaustion, staleness rise, recompiles).

Firing is edge-triggered: a rule raises one typed ``AlertEvent`` when its
predicate first becomes true and re-arms only after it clears, so a
persistent condition does not spam the trace.  Events land as instants on
the tracer's ``alerts`` track and, optionally, route into the §10
``TrainWatchdog`` via ``note_alert``.  ``AlertRule``, ``AlertEvent``,
``default_rules`` and ``AlertManager`` are the reference's, rule for rule
(the rule names and messages included).

Two parts have no JAX API to copy and are rewritten:

* **The recompile sentinel.**  JAX reads each ``jax.jit`` wrapper's
  ``_cache_size()``; the port has no traced programs.  Its device programs
  are enrolled with ``register_jit_entry(name, fn, static=...)``, which
  returns a thin wrapper that records the distinct call signatures of the
  entry as a jit cache would key them: each tensor's shape, dtype and
  device (lists, tuples and dicts walked), the arguments JAX's ``jit``
  marks static by value, other Python scalars by type, an ``nn.Module``
  by its parameters' names, shapes and dtypes.  Arguments are keyed as
  passed (positional by position, keywords by name), and a call made
  inside another enrolled entry is not counted, since a jit traced inside
  another program adds nothing to its own cache.  ``compile_counts()`` and
  the ``compiles.*`` gauges therefore mean what they mean in JAX.
* **``record_device_memory``** reads the CUDA allocator
  (``torch.cuda.memory_stats`` / ``mem_get_info``) where JAX reads
  ``jax.local_devices()[0].memory_stats()``; without a card the gauges do
  not appear, as on JAX's CPU backend.
"""
from __future__ import annotations

import functools
import inspect
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .registry import MetricsRegistry
from .trace import Tracer

SEV_WARN = "warn"
SEV_CRIT = "crit"

_KINDS = ("below", "above", "trend_up", "trend_down")


@dataclass(frozen=True)
class AlertRule:
    """One declarative predicate over a registry metric."""
    name: str                    # rule id (unique within a manager)
    metric: str                  # registry/as_dict key to watch
    kind: str                    # below | above | trend_up | trend_down
    threshold: float
    warmup: int = 0              # observations ignored before arming
    window: int = 8              # trend window (samples)
    severity: str = SEV_WARN
    message: str = ""

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"rule {self.name!r}: kind {self.kind!r} not "
                             f"in {_KINDS}")


@dataclass
class AlertEvent:
    """A rule firing: what tripped, on which value, at which step."""
    rule: str
    metric: str
    value: float
    threshold: float
    step: int
    severity: str = SEV_WARN
    message: str = ""

    def as_args(self) -> Dict[str, Any]:
        return {"rule": self.rule, "metric": self.metric,
                "value": self.value, "threshold": self.threshold,
                "severity": self.severity, "message": self.message}


def default_rules() -> List[AlertRule]:
    """The standing rule set for a SPEC-RL training run.  Rules whose
    metric never appears (e.g. paged gauges on a dense engine) are
    silently inert."""
    return [
        AlertRule("draft_accept_collapse", "accept_rate", "below", 0.05,
                  warmup=5, severity=SEV_WARN,
                  message="draft acceptance collapsed — §9 drafts are "
                          "burning verify forwards for nothing"),
        AlertRule("reuse_collapse", "reuse_rate", "below", 0.05,
                  warmup=5, severity=SEV_WARN,
                  message="SPEC-RL prefix reuse collapsed — policy has "
                          "drifted past the cached rollouts"),
        AlertRule("pool_alloc_failures", "paged_alloc_failures", "above",
                  0.0, severity=SEV_CRIT,
                  message="paged KV pool exhausted — admissions shed"),
        AlertRule("pool_exhaustion_trend", "paged_blocks_in_use",
                  "trend_up", 0.0, warmup=4, window=8,
                  message="live block watermark rising — pool heading "
                          "for exhaustion"),
        AlertRule("staleness_rise", "async.staleness", "trend_up", 0.0,
                  warmup=4, window=8,
                  message="rollout staleness rising — trainer is "
                          "outrunning the producer"),
        AlertRule("recompile_steady_state", "compiles.total", "trend_up",
                  0.0, warmup=4, window=4, severity=SEV_CRIT,
                  message="jit recompiles in steady state — a shape is "
                          "leaking into traced code"),
    ]


DEFAULT_RULES = default_rules()


class AlertManager:
    """Evaluate rules against successive registry dumps.

    ``evaluate`` takes either a ``MetricsRegistry`` or a flat
    ``as_dict()``-style mapping, appends each watched metric to its rule's
    history, and returns the events that fired this step (already emitted
    to the tracer / watchdog).
    """

    def __init__(self, rules: Optional[Sequence[AlertRule]] = None,
                 tracer: Optional[Tracer] = None, watchdog=None):
        self.rules = list(DEFAULT_RULES if rules is None else rules)
        ids = [r.name for r in self.rules]
        if len(ids) != len(set(ids)):
            raise ValueError(f"duplicate rule ids: {ids}")
        self.tracer = tracer
        self.watchdog = watchdog
        self._hist: Dict[str, deque] = {
            r.name: deque(maxlen=max(2, r.window)) for r in self.rules}
        self._seen: Dict[str, int] = {r.name: 0 for r in self.rules}
        self._active: set = set()
        self.events: List[AlertEvent] = []

    # ------------------------------------------------------------ predicate

    @staticmethod
    def _tripped(rule: AlertRule, hist: deque) -> bool:
        v = hist[-1]
        if rule.kind == "below":
            return v < rule.threshold
        if rule.kind == "above":
            return v > rule.threshold
        if len(hist) < max(2, rule.window):
            return False
        delta = hist[-1] - hist[0]
        return delta > rule.threshold if rule.kind == "trend_up" \
            else delta < -rule.threshold

    def evaluate(self, metrics: Union[MetricsRegistry, Dict[str, float]],
                 step: int = 0) -> List[AlertEvent]:
        flat = metrics.as_dict() if isinstance(metrics, MetricsRegistry) \
            else metrics
        fired: List[AlertEvent] = []
        for rule in self.rules:
            val = flat.get(rule.metric)
            if not isinstance(val, (int, float)):
                continue                       # metric absent: rule inert
            self._seen[rule.name] += 1
            if self._seen[rule.name] <= rule.warmup:
                continue        # warmup samples never enter the window —
                                # compile/pool growth during warmup must not
                                # pre-charge the trend detectors
            hist = self._hist[rule.name]
            hist.append(float(val))
            if self._tripped(rule, hist):
                if rule.name not in self._active:   # edge-trigger
                    self._active.add(rule.name)
                    ev = AlertEvent(rule=rule.name, metric=rule.metric,
                                    value=float(val),
                                    threshold=rule.threshold, step=step,
                                    severity=rule.severity,
                                    message=rule.message)
                    fired.append(ev)
            else:
                self._active.discard(rule.name)     # cleared: re-arm
        for ev in fired:
            self._emit(ev)
        self.events.extend(fired)
        return fired

    def _emit(self, ev: AlertEvent) -> None:
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.event(f"alert/{ev.rule}", "alerts",
                              cat=ev.severity, **ev.as_args())
        if self.watchdog is not None and \
                hasattr(self.watchdog, "note_alert"):
            self.watchdog.note_alert(ev)

    def as_dict(self, prefix: str = "alerts_") -> Dict[str, float]:
        out = {f"{prefix}fired": float(len(self.events)),
               f"{prefix}active": float(len(self._active))}
        for ev in self.events[-8:]:
            out.setdefault(f"{prefix}last_{ev.rule}", float(ev.step))
        return out


# --------------------------------------------------------- recompile sentinel


class _Entry:
    """One enrolled device program: the distinct call signatures seen."""

    def __init__(self, fn: Callable, static: Sequence[str]):
        self.fn = fn
        names = list(inspect.signature(fn).parameters)
        self.static = frozenset(static)
        self.static_pos = tuple(i for i, n in enumerate(names)
                                if n in self.static)
        self.signatures: set = set()


#: name → enrolled entry, filled at import time by the modules that own the
#: device programs (serving/engine_loop, drafting/step, core/verify)
_JIT_ENTRIES: Dict[str, _Entry] = {}
#: enrolled calls in progress: a call nested in another is not counted
_DEPTH = [0]
#: nn.Module → its structural signature (parameters' names/shapes/dtypes)
_MODULE_SIGS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

_SCALARS = (bool, int, float, complex, str)


def _module_sig(m) -> tuple:
    sig = _MODULE_SIGS.get(m)
    if sig is None:
        sig = (type(m).__name__,) + tuple(
            (n, tuple(p.shape), p.dtype, p.device)
            for n, p in m.named_parameters())
        _MODULE_SIGS[m] = sig
    return sig


def _sig(x) -> Any:
    """The cache key of one non-static argument."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.shape, x.dtype.str)
    if x is None:
        return None
    if isinstance(x, _SCALARS) or isinstance(x, np.generic):
        return type(x).__name__
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return ("dict",) + tuple(sorted((k, _sig(v)) for k, v in x.items()))
    if isinstance(x, torch.nn.Module):
        return _module_sig(x)
    # key objects (engine/sampling.py): a key batch keys by its row count,
    # as a (B, 2) key array keys by its shape
    return (type(x).__name__, len(x) if hasattr(x, "__len__") else None)


def _call_signature(entry: _Entry, args, kwargs) -> tuple:
    pos = tuple(a if i in entry.static_pos else _sig(a)
                for i, a in enumerate(args))
    kw = tuple(sorted((k, v if k in entry.static else _sig(v))
                      for k, v in kwargs.items()))
    return pos, kw


def register_jit_entry(name: str, fn: Callable,
                       static: Sequence[str] = ()) -> Callable:
    """Enroll a device program for the sentinel under ``name`` (the
    reference's entry names) and return the counting wrapper to call in
    its place.  ``static`` names the arguments the reference's ``jax.jit``
    marks static.  Re-enrolling a name starts its count afresh."""
    entry = _Entry(fn, static)
    _JIT_ENTRIES[name] = entry

    @functools.wraps(fn)
    def counted(*args, **kwargs):
        if _DEPTH[0]:
            return fn(*args, **kwargs)
        entry.signatures.add(_call_signature(entry, args, kwargs))
        _DEPTH[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _DEPTH[0] -= 1

    counted.sentinel_entry = entry
    return counted


def compile_counts() -> Dict[str, int]:
    """Distinct call signatures so far per enrolled entry (the reference's
    per-entry compile counts); an entry never called reports 0."""
    return {name: len(e.signatures) for name, e in _JIT_ENTRIES.items()}


def record_compile_gauges(reg: MetricsRegistry) -> None:
    """Snapshot ``compiles.<name>`` gauges plus the ``compiles.total`` the
    recompile rule watches.  agg="max": the signature sets are
    process-global, so a merge of several engines' registries must not
    double-count."""
    counts = compile_counts()
    if not counts:
        return
    for name, n in counts.items():
        reg.set(f"compiles.{name}", float(n), agg="max")
    reg.set("compiles.total", float(sum(counts.values())), agg="max")


def record_device_memory(reg: MetricsRegistry) -> None:
    """Live/peak device-memory gauges from the CUDA allocator of the
    current card; without a card the gauges do not appear."""
    if not torch.cuda.is_available():
        return
    ms = torch.cuda.memory_stats()
    reg.set("device.bytes_in_use", float(ms.get("allocated_bytes.all.current",
                                                0)), agg="last")
    reg.set("device.peak_bytes_in_use",
            float(ms.get("allocated_bytes.all.peak", 0)), agg="max")
    reg.set("device.bytes_limit", float(torch.cuda.mem_get_info()[1]),
            agg="max")
