"""Offline analysis over §11/§14 run artifacts (the ``attrib`` and
``decisions`` subcommands of ``repro/launch/analysis.py``).

    PYTHONPATH=src python -m repro_torch.launch.analysis attrib \\
        /tmp/t/events.jsonl
    PYTHONPATH=src python -m repro_torch.launch.analysis decisions /tmp/d

``attrib`` rebuilds the savings-attribution report from the final
``metrics`` record of an ``events.jsonl`` that a ``--ledger --trace-dir``
run wrote; ``decisions`` summarises a ``--decision-log`` directory.  The
reference module's HLO analysis (roofline counts from lowered XLA
programs) has no torch counterpart and is not here.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

from repro_torch.obs.attrib import build_report, measured_token_cost
from repro_torch.obs.ledger import CATEGORY_NAMES, load_dataset


def _load_metrics_jsonl(path: str) -> Dict[str, float]:
    """The flat registry view from an ``events.jsonl`` dump (its final
    ``metrics`` record; later records win if several were appended)."""
    metrics: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("type") == "metrics":
                metrics.update(rec["metrics"])
    return metrics


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="offline analysis over §11/§14 run artifacts")
    sub = p.add_subparsers(dest="cmd", required=True)
    pa = sub.add_parser(
        "attrib",
        help="savings attribution: provenance counts x measured decode "
             "cost -> seconds saved per mechanism (run with --ledger and "
             "--trace-dir to produce the input)")
    pa.add_argument("events", help="events.jsonl written by --trace-dir")
    pa.add_argument("--actual-s", type=float, default=None,
                    help="measured wall clock of the run; anchors the "
                         "baseline = actual + saved counterfactual")
    pa.add_argument("--token-s", type=float, default=None,
                    help="override the measured decode s/token")
    pa.add_argument("--prompt-token-s", type=float, default=None,
                    help="prefill s/token for shared-prompt pricing "
                         "(defaults to the decode cost)")
    pa.add_argument("--json", default="",
                    help="also write the report dict as JSON here")
    pd = sub.add_parser(
        "decisions",
        help="decision-dataset summary: shard count, per-column stats of "
             "a --decision-log directory")
    pd.add_argument("dir", help="directory of decisions-*.npz shards")
    args = p.parse_args(argv)

    if args.cmd == "attrib":
        m = _load_metrics_jsonl(args.events)
        counts = {name: int(m.get(f"ledger.tokens_{name}", 0))
                  for name in CATEGORY_NAMES}
        if not any(counts.values()):
            raise SystemExit(f"{args.events}: no ledger.tokens_* metrics "
                             "— produce it with --ledger --trace-dir")
        t_tok = args.token_s or measured_token_cost(m)
        if t_tok is None:
            raise SystemExit("no decode-cost metrics in the dump; "
                             "pass --token-s explicitly")
        rep = build_report(counts, t_tok,
                           t_prompt_token_s=args.prompt_token_s,
                           actual_s=args.actual_s)
        print(rep.summary())
        if args.json:
            with open(args.json, "w") as f:
                json.dump(rep.as_dict(), f, indent=2, sort_keys=True)
            print(f"report: {args.json}")
        return 0

    ds = load_dataset(args.dir)
    feats, outs = ds["features"], ds["outcomes"]
    print(f"{feats.shape[0]} decision records "
          f"({len(set(ds['row'].tolist()))} rows, "
          f"schema v{int(ds['schema_version'])})")
    for label, names, arr in (("features", ds["feature_names"], feats),
                              ("outcomes", ds["outcome_names"], outs)):
        print(label + ":")
        for j, name in enumerate(names):
            col = arr[:, j]
            print(f"  {str(name):14s} mean={col.mean():10.4f} "
                  f"min={col.min():10.4f} max={col.max():10.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
