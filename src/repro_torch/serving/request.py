"""Request / response dataclasses for the continuous-batching server.

Lifecycle (DESIGN.md §6, failure arcs §10)::

    QUEUED ──admission──► PREFILLING ──slot write──► DECODING ──eos/budget──► DONE
       │                                                │
       └◄─── bounded retry (re-admission via _admit_spec:│ timeout /
             completed tokens re-verified, not regrown) ─┘ quarantine

A request carries its own PRNG streams (``key`` for decoding, ``verify_key``
for spec-prefix acceptance), so its token output is a pure function of
(prompt, draft, keys, params) — independent of which slot it lands in, what
it is co-batched with, and when it is admitted.  That per-request determinism
is the serving layer's correctness contract: slot-scheduled output is
token-identical to fixed-batch ``generate``/``rollout`` (tested in
tests/serving/test_slot_equivalence.py), and it is also what makes retry
cheap and exact kill-and-resume possible (tests/serving/test_kill_resume.py).

Hardening fields (§10): ``deadline_steps`` bounds how many engine decode
steps a request may sit DECODING before the scheduler reclaims its slot;
``max_retries`` bounds re-admissions after a timeout or quarantine.  On
retry the tokens already generated become the request's *draft* — they
re-enter through speculative-prefix verification instead of being decoded
again — and ``base_draft_len`` remembers where the caller's original draft
ended so the final Response is still split caller-draft-prefix vs
continuation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

# request states
QUEUED = "QUEUED"
PREFILLING = "PREFILLING"
DECODING = "DECODING"
DONE = "DONE"
_STATES = (QUEUED, PREFILLING, DECODING, DONE)

# finish reasons
FINISH_EOS = "eos"
FINISH_BUDGET = "budget"
FINISH_FULL_REUSE = "full_reuse"
FINISH_TIMEOUT = "timeout"         # deadline expired, retries exhausted
FINISH_QUARANTINE = "quarantine"   # non-finite logits, retries exhausted
FINISH_SHED = "shed"               # dropped by queue backpressure
_REASONS = (FINISH_EOS, FINISH_BUDGET, FINISH_FULL_REUSE, FINISH_TIMEOUT,
            FINISH_QUARANTINE, FINISH_SHED)
FAILURE_REASONS = (FINISH_TIMEOUT, FINISH_QUARANTINE, FINISH_SHED)


@dataclass
class Request:
    """One generation request.

    prompt: (p,) int32 token ids, unpadded (the engine left-pads to its
    prompt width).  key: the decode PRNG key — the exact key ``generate``
    would be called with for this row.  A draft (tokens + behaviour
    log-probs from a previous rollout) makes the request eligible for
    speculative-prefix admission, which needs ``verify_key`` for the
    acceptance uniforms.
    """
    request_id: int
    prompt: np.ndarray
    key: np.ndarray                       # (2,) uint32 decode stream
    max_new_tokens: int
    verify_key: Optional[np.ndarray] = None
    draft_tokens: Optional[np.ndarray] = None   # (L,) int32, unpadded
    draft_logprobs: Optional[np.ndarray] = None  # (L,) float32
    draft_eos: bool = False
    # n-gram corpus for the §9 continuation draft engine: sibling / prior
    # trajectories indexed alongside the request's own stream (ignored by
    # engines built without a DraftConfig)
    ngram_corpus: Optional[list] = None
    # GRPO group handle (§13): siblings sharing a group_id carry the SAME
    # prompt, and the paged engine prefills it once — followers map the
    # leader's prompt blocks copy-on-write.  None (the default) opts out;
    # dense engines ignore it entirely.
    group_id: Optional[int] = None
    arrival_time: float = 0.0
    state: str = QUEUED
    # lifecycle timestamps (engine-relative seconds), filled by the scheduler
    queued_at: float = 0.0
    admitted_at: float = 0.0
    finished_at: float = 0.0
    # ---- §10 hardening ----
    deadline_steps: Optional[int] = None  # max engine steps DECODING
    max_retries: int = 1                  # timeout/quarantine re-admissions
    retries: int = 0
    # length of the CALLER's draft; retry drafts grow past it with the
    # request's own partial output, and harvest splits the response there
    # (-1 = not yet admitted; set by the scheduler on first submit)
    base_draft_len: int = -1
    nan_strikes: int = 0                  # quarantines suffered (ladder input)
    draft_off: bool = False               # per-request drafting kill switch

    @property
    def has_draft(self) -> bool:
        return self.draft_tokens is not None and len(self.draft_tokens) > 0

    # ---------------------------------------------------- exact serialization

    def to_state(self) -> Dict[str, np.ndarray]:
        """All-array pytree for checkpoint/io (exact kill-and-resume §10).

        Optional fields serialize as absent keys; scalars as 0-d arrays.
        ``from_state(to_state(r))`` reproduces the request bit-for-bit.
        """
        d = {
            "request_id": np.int64(self.request_id),
            "prompt": np.asarray(self.prompt, np.int32),
            "key": np.asarray(self.key, np.uint32),
            "max_new_tokens": np.int64(self.max_new_tokens),
            "draft_eos": np.bool_(self.draft_eos),
            "arrival_time": np.float64(self.arrival_time),
            "state": np.int64(_STATES.index(self.state)),
            "queued_at": np.float64(self.queued_at),
            "admitted_at": np.float64(self.admitted_at),
            "finished_at": np.float64(self.finished_at),
            "deadline_steps": np.int64(-1 if self.deadline_steps is None
                                       else self.deadline_steps),
            "max_retries": np.int64(self.max_retries),
            "retries": np.int64(self.retries),
            "base_draft_len": np.int64(self.base_draft_len),
            "nan_strikes": np.int64(self.nan_strikes),
            "draft_off": np.bool_(self.draft_off),
            "group_id": np.int64(-1 if self.group_id is None
                                 else self.group_id),
        }
        if self.verify_key is not None:
            d["verify_key"] = np.asarray(self.verify_key, np.uint32)
        if self.draft_tokens is not None:
            d["draft_tokens"] = np.asarray(self.draft_tokens, np.int32)
            d["draft_logprobs"] = np.asarray(self.draft_logprobs, np.float32)
        if self.ngram_corpus:
            d["ngram_corpus"] = {str(i): np.asarray(s, np.int32)
                                 for i, s in enumerate(self.ngram_corpus)}
        return d

    @classmethod
    def from_state(cls, d: Dict[str, np.ndarray]) -> "Request":
        def arr(k, dt):
            return np.asarray(d[k], dt) if k in d else None
        ddl = int(d["deadline_steps"])
        corpus = None
        if "ngram_corpus" in d:
            c = d["ngram_corpus"]
            corpus = [np.asarray(c[str(i)], np.int32) for i in range(len(c))]
        return cls(
            request_id=int(d["request_id"]),
            prompt=np.asarray(d["prompt"], np.int32),
            key=np.asarray(d["key"], np.uint32),
            max_new_tokens=int(d["max_new_tokens"]),
            verify_key=arr("verify_key", np.uint32),
            draft_tokens=arr("draft_tokens", np.int32),
            draft_logprobs=arr("draft_logprobs", np.float32),
            draft_eos=bool(d["draft_eos"]),
            ngram_corpus=corpus,
            arrival_time=float(d["arrival_time"]),
            state=_STATES[int(d["state"])],
            queued_at=float(d["queued_at"]),
            admitted_at=float(d["admitted_at"]),
            finished_at=float(d["finished_at"]),
            deadline_steps=None if ddl < 0 else ddl,
            max_retries=int(d["max_retries"]),
            retries=int(d["retries"]),
            base_draft_len=int(d["base_draft_len"]),
            nan_strikes=int(d["nan_strikes"]),
            draft_off=bool(d["draft_off"]),
            # absent in pre-§13 snapshots; -1 encodes None
            group_id=(None if int(d.get("group_id", -1)) < 0
                      else int(d["group_id"])))


@dataclass
class Response:
    """Completed request: reused prefix ⊕ generated continuation.

    ``tokens``/``logprobs`` are the *continuation* only (length ``length``);
    for spec-prefix admissions the accepted draft prefix (``n_accepted``
    tokens, behaviour log-probs in ``prefix_logprobs``) precedes it — the
    rl_adapter assembles the full response exactly like the fixed-batch
    ``assemble``.  For retried requests the continuation already folds in
    the re-verified partial output, so the split stays caller-draft vs
    everything-this-serving-session.  ``retries`` > 0 marks recovered
    requests; failure reasons (timeout / quarantine / shed) mean the tokens
    are best-effort partial output.
    """
    request_id: int
    tokens: np.ndarray                    # (length,) int32 continuation
    logprobs: np.ndarray                  # (length,) float32
    length: int
    finish_reason: str
    n_accepted: int = 0
    prefix_logprobs: Optional[np.ndarray] = None  # (N,) current-policy lp
    draft_len: int = 0
    slot: int = -1
    queue_time: float = 0.0               # seconds spent QUEUED
    serve_time: float = 0.0               # admission -> DONE
    retries: int = 0                      # recoveries before completion
    metrics: dict = field(default_factory=dict)

    # ---------------------------------------------------- exact serialization

    def to_state(self) -> Dict[str, np.ndarray]:
        d = {
            "request_id": np.int64(self.request_id),
            "tokens": np.asarray(self.tokens, np.int32),
            "logprobs": np.asarray(self.logprobs, np.float32),
            "length": np.int64(self.length),
            "finish_reason": np.int64(_REASONS.index(self.finish_reason)),
            "n_accepted": np.int64(self.n_accepted),
            "draft_len": np.int64(self.draft_len),
            "slot": np.int64(self.slot),
            "queue_time": np.float64(self.queue_time),
            "serve_time": np.float64(self.serve_time),
            "retries": np.int64(self.retries),
        }
        if self.prefix_logprobs is not None:
            d["prefix_logprobs"] = np.asarray(self.prefix_logprobs, np.float32)
        return d

    @classmethod
    def from_state(cls, d: Dict[str, np.ndarray]) -> "Response":
        return cls(
            request_id=int(d["request_id"]),
            tokens=np.asarray(d["tokens"], np.int32),
            logprobs=np.asarray(d["logprobs"], np.float32),
            length=int(d["length"]),
            finish_reason=_REASONS[int(d["finish_reason"])],
            n_accepted=int(d["n_accepted"]),
            prefix_logprobs=(np.asarray(d["prefix_logprobs"], np.float32)
                             if "prefix_logprobs" in d else None),
            draft_len=int(d["draft_len"]),
            slot=int(d["slot"]),
            queue_time=float(d["queue_time"]),
            serve_time=float(d["serve_time"]),
            retries=int(d["retries"]))
