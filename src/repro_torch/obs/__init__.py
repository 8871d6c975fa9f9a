"""Rollout observatory of the port (DESIGN.md §11, §14): the span tracer,
the unified metrics registry, the token-provenance ledger and decision log,
the alert rules and recompile sentinel, the savings attribution and the
exporters (own copies of ``repro/obs/*``; ``alerts.py`` rewrites the
sentinel and the memory gauges for torch), behind process-global
accessors.

Components that are constructed explicitly (``SlotEngine``, the trainer)
take a ``tracer=`` / ``ledger=`` kwarg; code deep in the loop (the SPEC-RL
rollout, the drafted decode loops, the async trainer, the rollout service,
the trajectory buffer, the trainer watchdog) reads the process-global
sinks below, which launch scripts set once via ``configure`` before
building anything.  The defaults (``NULL_TRACER``, an idle registry,
``NULL_LEDGER``, ``NULL_DECISION_LOG``) satisfy the zero-overhead contract:
every recording call early-returns.
"""
from .trace import NULL_TRACER, Event, Span, Tracer
from .registry import (Counter, Gauge, Histogram, MetricsRegistry, Ratio,
                       extend_summary)
from .ledger import (NULL_DECISION_LOG, NULL_LEDGER, DecisionLog,
                     LedgerError, TokenLedger)
from . import export  # noqa: F401  (re-exported submodule)

_TRACER: Tracer = NULL_TRACER
_REGISTRY: MetricsRegistry = MetricsRegistry()
_LEDGER: TokenLedger = NULL_LEDGER
_DECISIONS: DecisionLog = NULL_DECISION_LOG


def get_tracer() -> Tracer:
    return _TRACER


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def get_ledger() -> TokenLedger:
    return _LEDGER


def get_decision_log() -> DecisionLog:
    return _DECISIONS


def configure(tracer: Tracer = None,
              registry: MetricsRegistry = None,
              ledger: TokenLedger = None,
              decisions: DecisionLog = None) -> None:
    """Install process-global observability sinks (launch scripts)."""
    global _TRACER, _REGISTRY, _LEDGER, _DECISIONS
    if tracer is not None:
        _TRACER = tracer
    if registry is not None:
        _REGISTRY = registry
    if ledger is not None:
        _LEDGER = ledger
    if decisions is not None:
        _DECISIONS = decisions


def reset() -> None:
    """Back to the inert defaults (tests)."""
    global _TRACER, _REGISTRY, _LEDGER, _DECISIONS
    _TRACER = NULL_TRACER
    _REGISTRY = MetricsRegistry()
    _LEDGER = NULL_LEDGER
    _DECISIONS = NULL_DECISION_LOG


__all__ = ["Tracer", "Span", "Event", "NULL_TRACER",
           "MetricsRegistry", "Counter", "Gauge", "Histogram", "Ratio",
           "extend_summary", "export",
           "TokenLedger", "LedgerError", "NULL_LEDGER",
           "DecisionLog", "NULL_DECISION_LOG",
           "get_tracer", "get_registry", "get_ledger", "get_decision_log",
           "configure", "reset"]
