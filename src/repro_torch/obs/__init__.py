"""Rollout observatory of the port (DESIGN.md §11): the span tracer and the
unified metrics registry (own copies of ``repro/obs/trace.py`` and
``repro/obs/registry.py``), behind process-global accessors.

Code deep in the loop (the async trainer, the rollout service, the
trajectory buffer, the trainer watchdog) reads the process-global tracer
and registry below, which launch scripts set once via ``configure`` before
building anything.  The defaults (``NULL_TRACER``, an idle registry)
satisfy the zero-overhead contract: every recording call early-returns.

The ledger and decision log (``get_ledger``, ``get_decision_log``), the
alerts, the attribution report and the exporters arrive with the
observatory hooks (ROADMAP Queue 1 item 9).
"""
from .registry import (Counter, Gauge, Histogram, MetricsRegistry, Ratio,
                       extend_summary)
from .trace import NULL_TRACER, Event, Span, Tracer

_TRACER: Tracer = NULL_TRACER
_REGISTRY: MetricsRegistry = MetricsRegistry()


def get_tracer() -> Tracer:
    return _TRACER


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def configure(tracer: Tracer = None,
              registry: MetricsRegistry = None) -> None:
    """Install process-global observability sinks (launch scripts)."""
    global _TRACER, _REGISTRY
    if tracer is not None:
        _TRACER = tracer
    if registry is not None:
        _REGISTRY = registry


def reset() -> None:
    """Back to the inert defaults (tests)."""
    global _TRACER, _REGISTRY
    _TRACER = NULL_TRACER
    _REGISTRY = MetricsRegistry()


__all__ = ["Tracer", "Span", "Event", "NULL_TRACER",
           "MetricsRegistry", "Counter", "Gauge", "Histogram", "Ratio",
           "extend_summary", "get_tracer", "get_registry", "configure",
           "reset"]
