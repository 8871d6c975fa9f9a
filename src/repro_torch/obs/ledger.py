"""Token-provenance ledger + decision-record logger (DESIGN.md §14; own
copy of ``repro/obs/ledger.py``, which imports only numpy and the standard
library).

SPEC-RL's value claim is "tokens we did not regenerate", but the aggregate
counters (``reuse_len``, ``accept_rate``) cannot say, for a given token,
*which* mechanism produced it.  The ledger answers that: every emitted
sequence gets a per-token uint8 **provenance plane** — one category byte
per position — built host-side by the same loops that already assemble the
tokens (core/spec_rollout.py, drafting/engine.py, serving/engine_loop.py,
serving/paged_engine.py), and audited by a conservation invariant: the
category counts of a finalized row sum exactly to its sequence length,
with no position left ``UNSET``.

Zero-overhead contract: the ledger is **host-side only** — it reads only
values the loops already brought to the host, so it adds no kernel launch
and no device-to-host transfer, and tokens are bit-identical with the
ledger on, off, or absent.  Every recording method early-returns on
``enabled=False``, and instrumented code guards non-trivial argument
construction behind ``ledger.enabled``.

The ``DecisionLog`` is the companion record stream a learned draft-length
controller trains on: one record per (row, macro-step) of a drafted
decode — decision-time features (surprisal of the pending token, position,
acceptance EMA, chosen draft length, source, queue depth, slot age, pool
pressure) joined to outcomes (proposed/accepted/bonus/emitted tokens, step
wall-clock from the stamps the loop already takes) — written as
schema-versioned JSONL + NPZ shards that ``load_dataset`` reassembles into
aligned feature/outcome arrays.  The shard format is the reference's, byte
for byte: a directory written by either package loads in the other.

Note on the entropy feature: full next-token logits never reach the host
in the decode loops (that round-trip is exactly what the contract above
forbids), so the recorded feature is the **surprisal** of the pending
token, ``-logprob`` of the last emitted sample — already host-resident in
``cur_lp``.  It is the standard single-sample estimator of the same
uncertainty signal.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------- categories

UNSET = 0                 # position not yet attributed (never in a final row)
PROMPT = 1                # caller-supplied prompt token, dense prefill
REUSED_PREFIX = 2         # SPEC-RL verified prefix (cached rollout, accepted)
DRAFT_ACCEPTED = 3        # §9 continuation draft token accepted by verify
DRAFT_BONUS = 4           # free token after a fully-accepted draft block
FRESH = 5                 # vanilla decode / rejection-correction sample
RETRY_STITCHED = 6        # §10 partial output re-verified after timeout/stall
QUARANTINE_CLAMPED = 7    # §10 partial output re-verified after quarantine
SHARED_PROMPT_BLOCK = 8   # §13 CoW follower prompt (prefilled once, mapped)

NUM_CATEGORIES = 9
CATEGORY_NAMES = ("unset", "prompt", "reused_prefix", "draft_accepted",
                  "draft_bonus", "fresh", "retry_stitched",
                  "quarantine_clamped", "shared_prompt_block")

#: categories that represent *work avoided* vs a vanilla decode of the same
#: sequence — the attribution report (obs/attrib.py) prices exactly these
SAVINGS_CATEGORIES = (REUSED_PREFIX, DRAFT_ACCEPTED, RETRY_STITCHED,
                      QUARANTINE_CLAMPED, SHARED_PROMPT_BLOCK)


class LedgerError(ValueError):
    """Conservation-invariant violation: a finalized row does not exactly
    partition its sequence (wrong length, or an UNSET position)."""


class TokenLedger:
    """Per-row provenance planes, keyed by an arbitrary hashable row id.

    Rows grow by appends in emission order: ``begin_row`` lays down the
    prompt plane, the decode loops append one byte per emitted token.  The
    serving engine keys rows by ``request_id``; batch loops (spec_rollout,
    the fixed-batch drafted loop) key rows from ``reserve``'s monotonic id
    space, or from an explicit ``bind`` so a nested component (the drafted
    continuation inside a one-pass rollout) extends the caller's rows
    instead of opening parallel ones.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._rows: Dict[Any, bytearray] = {}
        self._retry_cat: Dict[Any, int] = {}
        self._bound: List[Sequence[Any]] = []
        self._next_row = 0
        self.finalized = 0
        self.violations = 0

    # ------------------------------------------------------------ row space

    def reserve(self, n: int) -> int:
        """Claim ``n`` fresh integer row ids; returns the first."""
        base = self._next_row
        self._next_row += int(n)
        return base

    def bind(self, row_ids: Sequence[Any]) -> None:
        """Push an explicit loop-row → ledger-row mapping for a nested
        component (see drafting/engine.py)."""
        if not self.enabled:
            return
        self._bound.append(list(row_ids))

    def unbind(self) -> None:
        if not self.enabled:
            return
        self._bound.pop()

    def bound_row(self, b: int) -> Optional[Any]:
        """The ledger row the caller bound for loop row ``b`` (None when no
        binding is active — the component owns its own rows)."""
        if not self._bound:
            return None
        return self._bound[-1][b]

    # ------------------------------------------------------------ recording

    def begin_row(self, rid: Any, prompt_len: int = 0,
                  prompt_cat: int = PROMPT) -> None:
        """Open (or re-open, on retry re-admission) the plane for ``rid``
        with ``prompt_len`` bytes of the prompt category."""
        if not self.enabled:
            return
        self._rows[rid] = bytearray([prompt_cat]) * int(prompt_len) \
            if prompt_len else bytearray()

    def append(self, rid: Any, cat: int, n: int = 1) -> None:
        """Extend ``rid``'s plane with ``n`` tokens of category ``cat``."""
        if not self.enabled or n <= 0:
            return
        row = self._rows.get(rid)
        if row is None:
            row = self._rows[rid] = bytearray()
        row.extend(bytes([cat]) * int(n))

    def drop_last(self, rid: Any, n: int) -> None:
        """Roll back the last ``n`` positions (§10 poisoned-tail drop)."""
        if not self.enabled or n <= 0:
            return
        row = self._rows.get(rid)
        if row is not None:
            del row[len(row) - min(n, len(row)):]

    def truncate(self, rid: Any, length: int) -> None:
        """Clamp ``rid``'s plane to ``length`` (the pack-to-N clamp)."""
        if not self.enabled:
            return
        row = self._rows.get(rid)
        if row is not None and len(row) > length:
            del row[length:]

    # ----------------------------------------------------- §10 retry memory

    def note_retry(self, rid: Any, reason: str) -> None:
        """Remember why ``rid`` left its slot: its re-verified partial
        output re-enters the plane as RETRY_STITCHED (timeout / stall /
        shed) or QUARANTINE_CLAMPED (non-finite logits)."""
        if not self.enabled:
            return
        self._retry_cat[rid] = QUARANTINE_CLAMPED \
            if reason == "quarantine" else RETRY_STITCHED

    def retry_category(self, rid: Any) -> int:
        return self._retry_cat.get(rid, RETRY_STITCHED)

    def clear_retry(self, rid: Any) -> None:
        if not self.enabled:
            return
        self._retry_cat.pop(rid, None)

    # ----------------------------------------------------------- inspection

    def has_row(self, rid: Any) -> bool:
        """Whether a plane was begun for ``rid``.  Kill-and-resume does not
        persist the ledger (by design — it is telemetry, not engine state),
        so a restored engine skips finalizing rows it never saw begin."""
        return rid in self._rows

    def row(self, rid: Any) -> np.ndarray:
        """The provenance plane for ``rid`` as a uint8 array (a copy)."""
        return np.frombuffer(bytes(self._rows.get(rid, b"")), np.uint8)

    def rows(self) -> Dict[Any, np.ndarray]:
        return {rid: self.row(rid) for rid in self._rows}

    def finalize(self, rid: Any, expected_len: int) -> np.ndarray:
        """Close a row and enforce the conservation invariant: category
        counts sum to ``expected_len`` and nothing is UNSET.  Raises
        ``LedgerError`` on violation (the ledger is an *audit*; a silent
        wrong plane is worse than none)."""
        if not self.enabled:
            return np.zeros(0, np.uint8)
        plane = self.row(rid)
        if len(plane) != int(expected_len) or \
                (len(plane) and int(plane.min()) == UNSET):
            self.violations += 1
            cts = dict(zip(CATEGORY_NAMES, np.bincount(
                plane, minlength=NUM_CATEGORIES).tolist()))
            raise LedgerError(
                f"provenance row {rid!r}: {len(plane)} attributed positions "
                f"vs sequence length {int(expected_len)} (counts={cts})")
        self.finalized += 1
        return plane

    def category_counts(self) -> np.ndarray:
        """(NUM_CATEGORIES,) int64 token tallies over all live rows."""
        out = np.zeros(NUM_CATEGORIES, np.int64)
        for row in self._rows.values():
            if row:
                out += np.bincount(np.frombuffer(bytes(row), np.uint8),
                                   minlength=NUM_CATEGORIES)
        return out

    def counts_dict(self) -> Dict[str, int]:
        c = self.category_counts()
        return {name: int(c[i]) for i, name in enumerate(CATEGORY_NAMES)}

    def clear(self) -> None:
        self._rows.clear()
        self._retry_cat.clear()
        self._bound.clear()
        self._next_row = 0
        self.finalized = 0
        self.violations = 0


#: Shared disabled ledger — the default everywhere provenance is threaded.
NULL_LEDGER = TokenLedger(enabled=False)


def categorize_draft_block(emitted: int,
                           carry_bonus: bool) -> List[Tuple[int, int]]:
    """Provenance of one drafted macro-step's emission, as (cat, n) runs.

    ``drafting.step.draft_step`` emits ``[carry | accepted drafts]``: the
    first token is the PREVIOUS step's correction/seed sample — a *bonus*
    token when that step fully accepted its proposal (its verify forward
    produced the sample for free), a fresh sample otherwise — and the
    remaining ``emitted - 1`` tokens are this step's accepted drafts.
    Callers track ``carry_bonus`` per row across steps (False at admission:
    the seed sample is priced as fresh).
    """
    m = int(emitted)
    if m <= 0:
        return []
    runs: List[Tuple[int, int]] = [
        (DRAFT_BONUS if carry_bonus else FRESH, 1)]
    if m > 1:
        runs.append((DRAFT_ACCEPTED, m - 1))
    return runs


# ------------------------------------------------------------ decision log

DECISION_SCHEMA_VERSION = 1
DECISION_FEATURES = ("surprisal", "position", "accept_ema", "draft_k",
                     "draft_source", "queue_depth", "slot_age",
                     "pool_pressure")
DECISION_OUTCOMES = ("proposed", "accepted", "bonus", "emitted", "step_ms")

# draft_source encoding (feature column stays numeric for the NPZ bundle)
SOURCE_NONE = 0.0
SOURCE_NGRAM = 1.0
SOURCE_CACHE = 2.0


class DecisionLog:
    """Schema-versioned (row, macro-step) decision records.

    In-memory until ``flush`` (or until ``shard_rows`` accumulate with an
    ``out_dir`` set, which auto-rotates a shard).  Each shard is written
    twice from the same records: ``decisions-NNNNN.jsonl`` (one JSON object
    per record, human-greppable) and ``decisions-NNNNN.npz`` (the
    training-ready arrays).  ``load_dataset`` reassembles every NPZ shard
    in a directory into one aligned feature/outcome bundle.  ``part``
    joins the file names (``decisions-<part>NNNNN``), so several writers
    (the data shards of a mesh) can share a directory.
    """

    def __init__(self, out_dir: Optional[str] = None, enabled: bool = True,
                 shard_rows: int = 4096, part: str = ""):
        self.enabled = bool(enabled)
        self.out_dir = out_dir
        self.shard_rows = int(shard_rows)
        self.part = part
        self._recs: List[Tuple[Any, int, Tuple[float, ...],
                               Tuple[float, ...]]] = []
        self.shards_written = 0
        self.records_total = 0

    def record(self, row: Any, step: int, features: Dict[str, float],
               outcomes: Dict[str, float]) -> None:
        """Append one decision record.  Missing columns default to 0.0 so
        callers only pass what their layer can see (the dense engine has no
        pool pressure; the fixed-batch loop has no queue)."""
        if not self.enabled:
            return
        f = tuple(float(features.get(k, 0.0)) for k in DECISION_FEATURES)
        o = tuple(float(outcomes.get(k, 0.0)) for k in DECISION_OUTCOMES)
        self._recs.append((row, int(step), f, o))
        self.records_total += 1
        if self.out_dir is not None and len(self._recs) >= self.shard_rows:
            self._write_shard()

    def __len__(self) -> int:
        return len(self._recs)

    # -------------------------------------------------------------- output

    def _write_shard(self) -> None:
        recs, self._recs = self._recs, []
        tag = f"decisions-{self.part}{self.shards_written:05d}"
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, tag + ".jsonl"), "w") as fh:
            for row, step, f, o in recs:
                fh.write(json.dumps(
                    {"v": DECISION_SCHEMA_VERSION, "row": str(row),
                     "step": step,
                     "features": dict(zip(DECISION_FEATURES, f)),
                     "outcomes": dict(zip(DECISION_OUTCOMES, o))},
                    sort_keys=True) + "\n")
        np.savez(
            os.path.join(self.out_dir, tag + ".npz"),
            schema_version=np.int64(DECISION_SCHEMA_VERSION),
            feature_names=np.asarray(DECISION_FEATURES),
            outcome_names=np.asarray(DECISION_OUTCOMES),
            row=np.asarray([str(r) for r, _, _, _ in recs]),
            step=np.asarray([s for _, s, _, _ in recs], np.int64),
            features=np.asarray([f for _, _, f, _ in recs],
                                np.float32).reshape(len(recs),
                                                    len(DECISION_FEATURES)),
            outcomes=np.asarray([o for _, _, _, o in recs],
                                np.float32).reshape(len(recs),
                                                    len(DECISION_OUTCOMES)))
        self.shards_written += 1

    def flush(self) -> int:
        """Write any buffered records as a final shard; returns the number
        of shards on disk.  No-op without an ``out_dir``."""
        if not self.enabled or self.out_dir is None:
            return self.shards_written
        if self._recs:
            self._write_shard()
        return self.shards_written

    def clear(self) -> None:
        self._recs.clear()
        self.shards_written = 0
        self.records_total = 0


#: Shared disabled decision log — the default everywhere records are taken.
NULL_DECISION_LOG = DecisionLog(enabled=False)


def load_dataset(out_dir: str) -> Dict[str, np.ndarray]:
    """Reassemble every NPZ decision shard in ``out_dir`` into one bundle:
    ``features`` (N, F) float32 aligned with ``outcomes`` (N, O) float32,
    plus ``row``/``step`` identity columns and the schema names.  Raises on
    a schema-version or column-name mismatch — the learned controller must
    never silently train on a drifted layout."""
    shards = sorted(f for f in os.listdir(out_dir)
                    if f.startswith("decisions-") and f.endswith(".npz"))
    if not shards:
        raise FileNotFoundError(f"no decision shards under {out_dir}")
    feats, outs, rows, steps = [], [], [], []
    for name in shards:
        with np.load(os.path.join(out_dir, name), allow_pickle=False) as z:
            v = int(z["schema_version"])
            if v != DECISION_SCHEMA_VERSION:
                raise ValueError(f"{name}: schema v{v}, "
                                 f"expected v{DECISION_SCHEMA_VERSION}")
            if tuple(z["feature_names"]) != DECISION_FEATURES or \
                    tuple(z["outcome_names"]) != DECISION_OUTCOMES:
                raise ValueError(f"{name}: column names drifted")
            feats.append(z["features"])
            outs.append(z["outcomes"])
            rows.append(z["row"])
            steps.append(z["step"])
    return {"schema_version": DECISION_SCHEMA_VERSION,
            "feature_names": DECISION_FEATURES,
            "outcome_names": DECISION_OUTCOMES,
            "features": np.concatenate(feats, axis=0),
            "outcomes": np.concatenate(outs, axis=0),
            "row": np.concatenate(rows, axis=0),
            "step": np.concatenate(steps, axis=0)}
