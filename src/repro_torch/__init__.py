"""SPEC-RL in PyTorch and CUDA for an NVIDIA H100 (sm_90a).

A port of ``repro`` (JAX, Pallas kernels for the TPU), which stays beside it
as the reference every slice of the port is tested against: same weights
(``models.convert.from_jax_params``), same inputs, same random draws.

Rules of the package:

* It imports ``torch`` and never ``jax``, and no module of ``repro`` — not
  even one that imports no JAX itself, because importing any ``repro.*``
  runs ``repro/__init__.py``, which imports JAX.  What it needs of such a
  module it keeps as its own copy: ``models/config.py``, ``configs/``,
  ``core/cache.py``, ``data/``, ``rewards/``, ``drafting/controller.py``
  and ``drafting/ngram.py``.  ``RolloutBatch`` and
  ``PromptBatch`` are built here (``core/spec_rollout.py``,
  ``data/dataset.py``), never imported.
* Paths and names mirror ``repro`` wherever that helps a reader find a
  module's counterpart; inside, it is PyTorch: ``nn.Module`` parameter
  containers, plain functions on tensors, an explicit ``device`` and
  explicit random generators (``engine/sampling.py``'s keys).
* Entry points (``models.model.init_lm``, ``models.convert.from_jax_params``,
  ``engine.sampling.make_key``) run on ``cuda`` unless the caller passes
  ``device="cpu"``; with no GPU and no ``device="cpu"`` they raise.  The
  rollout runs on whatever device the model lives on.  Nothing moves to the
  CPU quietly.
* Every TPU kernel on the ported path is a CUDA C++ kernel written by hand
  for Hopper (``csrc/*.cu``, built by ``kernels/_build.py`` with ``nvcc`` and
  bound with ``ctypes``).  Each kernel module's wrapper launches its kernel
  on a CUDA tensor or raises; it takes the plain PyTorch version only for a
  tensor that lies on the CPU.

The port runs the speculative rollout (``core.rollout``) of dense GQA
and mixture-of-experts models such as qwen3-1.7b and mixtral-8x22b, of
RWKV6 trunks such as rwkv6-3b (``models/rwkv.py``, the recurrence in
``csrc/wkv.cu``) and of attention + Mamba hybrids such as jamba-v0.1-52b
(``models/mamba.py``, the selective scan in ``csrc/mamba_scan.cu``): the
vanilla
branch, the one-pass branch (verify+prefill, cache compaction, resumed
decode) for attention trunks, and the two-pass branch (score, left-align,
re-prefill and decode) for recurrent trunks and ``one_pass="off"``; with
the fixed decode batch or, for attention trunks, drained through the
serving slot engine (``backfill="slots"``, ``serving/``), over a dense or a
paged KV cache (``cache_layout``), and the slot server (``python -m
repro_torch.launch.serve``); on attention trunks every decode loop can
draft its continuation (the §9 draft engine, ``drafting/``,
``SpecConfig(draft=DraftConfig(kind="ngram"))``), its (k+1)-token blocks
through the decode kernels.
"""
