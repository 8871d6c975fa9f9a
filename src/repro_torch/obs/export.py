"""Export sinks for the rollout observatory (DESIGN.md §11; own copy of
``repro/obs/export.py``, which imports only the standard library).

Three sinks, all fed from the same ``Tracer``/``MetricsRegistry`` state so
every surface shares one namespace:

* ``chrome_trace`` — Chrome trace-event JSON, loadable in Perfetto
  (https://ui.perfetto.dev) or chrome://tracing.  Each tracer becomes a
  process (pid), each track a thread (tid) — request lanes (``req/<id>``)
  show queued → admit → decode chunks → retry/quarantine → request; engine
  and trainer lanes show the stage breakdown.
* ``write_jsonl`` — one JSON object per span/event plus a final metrics
  record: the structured log ``launch.analysis attrib`` reads back.
* ``prometheus_text`` / ``start_metrics_server`` — Prometheus text
  exposition (stdlib-only HTTP handler, opt-in via the launchers'
  ``--metrics``).

All output is deterministic given a fake clock (sorted keys, stable lane
ordering) so tests pin golden files; the process name (``"repro"``) and the
Prometheus namespace are the reference's, so both packages write the same
bytes for the same tracer and registry.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Union

from .registry import Counter, Gauge, Histogram, MetricsRegistry, bucket_edge
from .trace import Tracer

_US = 1e6      # tracer clocks are seconds; Chrome traces are microseconds


def _track_sort_key(track: str):
    """Engine/stage lanes first, request lanes ordered by numeric id."""
    if track.rsplit("/", 1)[-1].isdigit():
        head, _, tail = track.rpartition("/")
        return (1, head, int(tail))
    return (0, track, 0)


def chrome_trace(tracers: Union[Tracer, Dict[str, Tracer]],
                 counters: List[Dict] = None) -> Dict:
    """Build a Chrome trace-event object from one or more tracers.

    ``tracers`` may be a single Tracer or ``{process_name: Tracer}`` (one
    process per mesh shard / component).  ``counters`` adds "C"-phase
    counter samples (stacked series tracks, e.g. the §14 seconds-saved
    attribution): each ``{"name", "track", "ts", "values": {series: v}}``
    becomes a counter track on the first process."""
    if isinstance(tracers, Tracer):
        tracers = {"repro": tracers}
    events: List[Dict] = []
    counter_tracks = sorted({c["track"] for c in (counters or [])})
    for pid, (pname, tr) in enumerate(tracers.items()):
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name", "args": {"name": pname}})
        tracks = sorted(tr.tracks(), key=_track_sort_key)
        if pid == 0:
            tracks = tracks + [t for t in counter_tracks if t not in tracks]
        tids = {t: i for i, t in enumerate(tracks)}
        if pid == 0:
            for c in counters or []:
                events.append({"ph": "C", "pid": 0, "tid": tids[c["track"]],
                               "name": c["name"], "ts": c["ts"] * _US,
                               "args": {k: float(v)
                                        for k, v in c["values"].items()}})
        for track, tid in tids.items():
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name", "args": {"name": track}})
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_sort_index",
                           "args": {"sort_index": tid}})
        for sp in tr.spans:
            if sp.t1 is None:
                continue
            events.append({"ph": "X", "pid": pid, "tid": tids[sp.track],
                           "name": sp.name, "cat": sp.cat or "span",
                           "ts": sp.t0 * _US,
                           "dur": max(0.0, sp.dur) * _US,
                           "args": dict(sp.args)})
        for ev in tr.events:
            events.append({"ph": "i", "pid": pid, "tid": tids[ev.track],
                           "name": ev.name, "cat": ev.cat or "event",
                           "ts": ev.ts * _US, "s": "t",
                           "args": dict(ev.args)})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path, tracers, counters: List[Dict] = None) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(tracers, counters=counters), f,
                  sort_keys=True)


def write_jsonl(path, tracers, registry: MetricsRegistry = None) -> None:
    """Structured event log: one record per span/event in (t0, track) order
    per tracer, then one final ``metrics`` record with the registry view."""
    if isinstance(tracers, Tracer):
        tracers = {"repro": tracers}
    with open(path, "w") as f:
        for pname, tr in tracers.items():
            recs = [{"type": "span", "proc": pname, "track": sp.track,
                     "name": sp.name, "cat": sp.cat, "t0": sp.t0,
                     "t1": sp.t1, "dur": sp.dur, "args": dict(sp.args)}
                    for sp in tr.spans if sp.t1 is not None]
            recs += [{"type": "event", "proc": pname, "track": ev.track,
                      "name": ev.name, "cat": ev.cat, "ts": ev.ts,
                      "args": dict(ev.args)} for ev in tr.events]
            recs.sort(key=lambda r: (r.get("t0", r.get("ts", 0.0)),
                                     r["track"], r["name"]))
            for r in recs:
                f.write(json.dumps(r, sort_keys=True) + "\n")
        if registry is not None:
            f.write(json.dumps({"type": "metrics",
                                "metrics": registry.as_dict()},
                               sort_keys=True) + "\n")


# ------------------------------------------------------------- prometheus

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(namespace: str, name: str) -> str:
    return _NAME_RE.sub("_", f"{namespace}_{name}")


def _fmt(v: float) -> str:
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def prometheus_text(registry: MetricsRegistry, namespace: str = "repro") -> str:
    """Prometheus text exposition format v0.0.4 (stdlib only).

    Counters get the ``_total`` suffix; histograms emit cumulative
    ``_bucket{le=...}`` series ending in ``+Inf`` plus ``_sum``/``_count``;
    gauges and derived ratios are exposed as gauges."""
    lines: List[str] = []
    for name in sorted(registry.names()):
        m = registry.get(name)
        pn = _prom_name(namespace, name)
        if isinstance(m, Counter):
            lines.append(f"# TYPE {pn}_total counter")
            lines.append(f"{pn}_total {_fmt(m.v)}")
        elif isinstance(m, Gauge):
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {_fmt(m.v)}")
        elif isinstance(m, Histogram):
            lines.append(f"# TYPE {pn} histogram")
            cum = 0
            for idx in sorted(m.buckets):
                cum += m.buckets[idx]
                lines.append(f'{pn}_bucket{{le="{_fmt(bucket_edge(idx))}"}}'
                             f" {cum}")
            lines.append(f'{pn}_bucket{{le="+Inf"}} {m.count}')
            lines.append(f"{pn}_sum {_fmt(m.total)}")
            lines.append(f"{pn}_count {m.count}")
        else:                                   # Ratio → derived gauge
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {_fmt(registry.as_dict().get(name, 0.0))}")
    return "\n".join(lines) + "\n"


def write_prometheus(path, registry: MetricsRegistry,
                     namespace: str = "repro") -> None:
    with open(path, "w") as f:
        f.write(prometheus_text(registry, namespace))


def start_metrics_server(provider: Callable[[], MetricsRegistry],
                         port: int, namespace: str = "repro"):
    """Serve ``GET /metrics`` on a daemon thread; returns the HTTPServer
    (call ``.shutdown()`` to stop).  ``provider`` is called per scrape so
    the exposition always reflects live counters."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):                            # noqa: N802 (stdlib API)
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_response(404)
                self.end_headers()
                return
            body = prometheus_text(provider(), namespace).encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):                   # quiet by default
            pass

    srv = ThreadingHTTPServer(("", port), Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv
