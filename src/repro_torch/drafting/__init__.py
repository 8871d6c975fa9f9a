"""Draft engine: speculative continuation beyond the SPEC-RL prefix (port
of ``repro/drafting``, DESIGN.md §9).

SPEC-RL speculates only on the *reused prefix*; once the verified prefix
diverges, every continuation token costs a decode step.  This package
extends draft-and-verify into the continuation itself:

* ``NGramDraftSource``  — k-token proposals from a suffix hash map over
  the row's own prompt ⊕ generated stream plus its GRPO sibling
  trajectories (``RolloutCache.batch_siblings``);
* ``DraftController``   — per-row adaptive draft length from a running
  acceptance-rate EMA;
* ``draft_step``        — the (k+1)-token verify forward with
  rejection-sampling acceptance (``kernels/spec_verify``) over the
  decode kernels' multi-token path (``kernels/decode_attention``);
* ``drafted_generate`` / ``drafted_resume`` — host-driven decode loops
  mirroring ``engine/generate.generate`` / ``resume_from_cache``.

Greedy decoding gives the vanilla loops' tokens; temperature / top-p
sampling is distribution-correct per token, and with keys that draw as
JAX's do the sampled stream is JAX's drafted stream.
"""
from .controller import DraftConfig, DraftController
from .ngram import NGramDraftSource

__all__ = ["DraftConfig", "DraftController", "NGramDraftSource",
           "draft_step", "drafted_generate", "drafted_resume"]

_LAZY = {"draft_step": "step", "drafted_generate": "engine",
         "drafted_resume": "engine"}


def __getattr__(name):
    # engine/step pull in the model stack; loading them lazily lets
    # core.spec_rollout import DraftConfig without an import cycle
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(name)
