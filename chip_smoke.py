#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

What it does, failing (nonzero exit, no result line) at the first fault:

1. prints the card's name and power limit (``nvidia-smi``), and a draw of
   a key seeded above 2**63 on the card;
2. builds the nine CUDA kernels from ``src/repro_torch/csrc`` for sm_90a
   (one ``nvcc`` per source, all started together) and prints the build
   time and ``ptxas`` register/spill lines;
3. for each kernel, at the shapes its path gives it, calls the public
   wrapper the model calls and holds its result against the plain PyTorch
   version on the same inputs.  The seven attention-path kernels run at
   the qwen3-1.7b shapes in bfloat16 (positions and bounds in the raw forms
   the wrapper converts, done rows and a row with no live slot among them;
   every pool slot outside a row's live span holds NaN): exactly for
   spec_verify, cache_roll, cache_slot_write and paged_gather, within
   ``ATTN_TOL`` for the three attentions, rows that see no key exactly 0.
   The two decode kernels also run every regime they claim, dense and
   paged (``decode_case``, NaN at every slot outside a live span): draft
   blocks of T = 4 and 8 at G = 2, a window of 16, D = 64 with 4 / 2
   heads, block size 64, live spans of one slot, of the whole cache, off
   tile edges and past S, and the slot engine's B = 8 (timed); and the
   draft engine's verify blocks of T = 9, 16 and 64 at G = 2 (G * T up to
   128, the kernels' query chunks; a done row and a row with no live slot
   among them), with the blocks of T = 2, 3, 5 and 9 of the ``draft``
   path's epoch 1 (B = 16, S = P + 2N + K, a draft length per row) timed
   like T = 1: kernel, plain version and SDPA in turns, its bound from
   that step's data, and at T = 9 ``device_ms`` and one launch a call.
   flash_attention runs a one-tile rehearsal first (B = 1, T = S = 64),
   then the epoch-1 verify, a D = 64 case at the reduced widths (4 / 2
   heads), a ragged one (T = 70, S = 130, rows of padding only) and a
   peaked one (each query's largest logit about 20), and at the epoch-0
   shapes (T = 64, S = 320) it is timed beside SDPA.
   ``wkv`` runs at the rwkv6-3b shapes in float32, at T = P + N (the verify
   score, with the pads' k = 0, w = 1), T = P (the epoch-0 prefill, the
   prompts' left pads) and T = 1 (a decode step), and at the reduced
   config's hd = 32 (T = 37), from a nonzero state, its output new and
   written over its input, within ``WKV_TOL`` of the largest magnitude, one
   launch a call at each of the three.  ``mamba_scan`` runs at
   jamba-v0.1-52b's widths (B = 16, di = 8,192, ds = 16) in float32 at
   T = P + N (the pads' dt = 0), P and 1, and at di = 200 (T = 37), from a
   nonzero state, its final state written over its input, within
   ``MAMBA_TOL`` of the largest magnitude; T = P + N also against P + N
   chained T = 1 calls through the state; one launch a call at each of the
   three.  ``spec_verify`` runs with int32
   lengths (as its callers hold them) and int64 ones (one launch a call
   with either), exactly equal to its plain version.  Then it times the
   kernel entry on
   inputs already in its form, the plain version and the yardstick: one
   PyTorch call that computes the same function where there is one, and
   for the paged decode the two-step gather + dense decode kernel (CUDA
   events, median of ``REPS`` launches, the L2 cache flushed before
   each, the three timed in turns), and each kernel's device time: the
   mean CUPTI duration of its own launches (``torch.profiler``) over
   ``REPS`` more L2-flushed calls, with the kernels a call launched (the
   decode kernels must launch once a call and nothing else), read from a
   complete trace only (``profile_window``: a lead-in of ``LEAD_IN``
   markers that takes the first records a session may drop, host time at
   the window's ends, a marker before each call and after the last).
   ``arch_kernel_checks`` then holds the attention kernels at the head
   layouts of the new configs (G = 1, 4, 6, 8, 48;
   granite-34b's draft blocks of G * T = 144 and 432; flash with a window
   of 16, over S = T = 40,960 and 65,536 with mixtral-8x22b's window of
   4,096 and over 32,768 without one, the plain version on sampled query
   rows, all timed); ``frontend_kernel_checks`` holds flash_attention at
   the frontends' shapes, each timed beside SDPA with its device time and
   bound: pixtral-12b's heads (32 / 8, D = 128) unwindowed over S = T =
   65,536 and 131,072 (the kernel's largest S; the plain version on
   sampled query rows; also with every key dead, which times the
   per-block tile scan alone), and whisper-tiny's non-causal calls (B =
   16, 6 heads of 64): the encoder over 1,500 frames, the cross-attention
   of a prefill (T = 64, left pads) and of a decode step (T = 1, done
   rows among them); ``mla_kernel_checks`` holds both attention kernels
   at deepseek-v3-671b's MLA shapes (G = 1, 128 heads, Dk = 192, Dv =
   128), each timed beside SDPA with its device time and bound: the
   decode kernel at B = 16, S = 576, T = 1, 2 and 9 (NaN outside the
   live spans, done rows and a row with no live slot), flash at the
   archs verify shape (T = S = 128, left pads) and at the config's
   max_seq_len (T = S = 8,192, the plain version on sampled rows);
4. holds the port on the card against the port on the CPU at a small size
   (the reduced qwen3-1.7b, rwkv6-3b, deepseek-7b, qwen1.5-110b,
   granite-34b, mixtral-8x22b, jamba-v0.1-52b (one full period of 8
   layers), deepseek-v3-671b (at the published MLA head dims,
   ``SMALL_OVERRIDES``, over a dense and over a paged latent cache),
   pixtral-12b (16 stub patches in front) and whisper-tiny (its encoder
   over 64 stub frames, its output compared too), mixtral also with
   ``dispatch`` and a window of 8, in bfloat16: forward, prefill,
   decode steps and, for an attention trunk without a prefix, the
   compaction roll, teacher-forced, a MoE trunk's
   routing too: the other runs replay the CPU bf16 run's expert choices),
   within the arch's ``SMALL_TOL``, and the card's bfloat16 run no further
   than ``BF16_GAP`` times the CPU's from the CPU's float32 run; the
   reduced rwkv6-3b also in float32, card vs CPU within ``SMALL_TOL_F32``
   (the attention kernels take bfloat16 only);
5. runs twenty-eight paths (random weights from a seed), each with the launch
   counts set to 0 just before it and read just after (on the mesh's
   ranks: each rank's, summed), and checks their
   outputs; ``slots``, ``paged``, ``paged_slots``, ``draft``,
   ``draft_slots``, ``observatory``, ``faults``, ``train``, ``ppo``,
   ``dapo`` and the slot engine's and paged breakdowns run the model cut to
   ``CUT_LAYERS`` of its layers (full width), ``async`` to
   ``ASYNC_LAYERS``, and ``rwkv`` ``RWKV_LAYERS`` of its 32, which pays for
   ``watchdog``, the observatory and ``mesh`` inside the time limit:
   ``mesh``     the §8 mesh (``mesh_path``): qwen3-1.7b at full width cut
                to ``MESH_LAYERS`` layers, the single-process reference first
                (its rows, its sampler records and its teacher-forced
                scores kept in numpy, the model freed), then four ``gloo``
                ranks sharing ``cuda:0`` as a (2, 2) mesh (``run_ranks``;
                a rank: 8 of 16 query heads, 4 of 8 KV heads, half the
                batch's rows), each running the two epochs of every
                ``MESH_MODES`` mode (the fixed batch and
                ``backfill="slots"``, dense and paged; per-row keys; epoch
                1 one-pass, verifying the reference's epoch-0 rows) and
                scoring the reference's rows: teacher-forced log-probs
                within ``MESH_LP_TOL``; rows equal up to their first
                parting, a parting at the accept test's position (the same
                uniform on both sides, between their two thresholds; the
                draft's log-probs within ``MESH_LP_TOL``) or at a
                sampled token whose two candidates lie among both sides'
                ``MESH_TOP_K`` best sampler scores, each score shifted by
                at most ``MESH_LP_TOL`` (``SampleRecorder``; before the
                partings every shared score too); every rank's rows equal;
                kernels 1–7 launched on every rank; a ``mesh`` line with
                times, each rank's peak GiB, the gap and the partings;
                then the trainer in the same spawn (``mesh_rank_train``):
                the reference's GRPO (with a KL reference) and PPO
                ``optimize`` of its epoch-0 rows at ``MESH_LR``, the same
                on the ranks, each rank's gradients within
                ``MESH_GRAD_GAP`` of the matching slices of the
                reference's and its updated shards (actor and critic)
                within ``update_tol`` of the reference's update (that
                limit as the gradient's noise, plus one bf16 rounding),
                the step log's loss, grad_norm, kl_ref and critic_loss
                within ``MESH_METRIC_RTOL``/``ATOL`` of the reference's,
                the old log-probs within ``MESH_LP_TOL``, no kernel in
                any update; one
                ``train_step`` whose rows part only where the recorded
                sampler scores explain it; two async steps (``"ppcc"``,
                K = 1: one exact, one importance-corrected; the published
                and served shards the trainer's, in storage of their
                own); a watchdog snapshot (whole trees, rank 0 writes)
                and its restore, bit for bit; a ``mesh train`` line;
   ``rollout``  two epochs of ``repro_torch.core.rollout`` of full-width,
                full-depth qwen3-1.7b with the fixed decode batch (epoch 0
                vanilla, epoch 1 the one-pass speculative branch);
   ``slots``    the same two epochs with ``backfill="slots"``: the batch
                drained through the slot engine, 8 slots for 16 rows, epoch
                1 by speculative-prefix admission;
   ``paged``    the fixed-batch two epochs over the paged KV layout
                (``cache_layout="paged"``): decode through the paged kernel,
                compaction through paged_gather and the slot write;
   ``paged_slots`` the ``slots`` epochs over the paged layout, through the
                ``PagedSlotEngine``: epoch 0 one prefill per GRPO group
                (4 leaders, 12 followers mapping the leader's prompt
                blocks copy-on-write), epoch 1 speculative-prefix
                admission; peak blocks, bytes saved, no fork, the pool
                empty after the drain, and every row equal to the
                ``slots`` path's (tokens, lengths, ``n``);
   ``draft``    the ``rollout`` path's two epochs with the §9 draft engine
                (``DraftConfig(kind="ngram", draft_k=8)``): epoch 0
                through ``drafted_generate``, epoch 1 the one-pass branch
                continued by ``drafted_resume``; each epoch line adds its
                macro-steps, ``draft_accept_rate``, ``draft_mean_len``,
                ``tokens_per_forward`` and the decode kernels' launches by
                T; then, outside the paths' counts, the greedy witness at
                full depth: B = 16, ``WITNESS_N`` tokens of greedy drafted decoding
                against greedy vanilla decoding, every row equal up to its
                first difference and, there, both tokens within the
                measured block-vs-step logit gap of the step's largest
                logit, the gap itself at most ``WITNESS_GAP_MAX``;
   ``draft_slots`` the drafted paged slot engine: ``rollout(backfill=
                "slots")`` over ``cache_layout="paged"`` with the draft
                engine (``DRAFT_SLOTS_N`` tokens), ``paged_decode_attention``
                at T > 1 and the dense decode kernel at 0;
   ``observatory`` the ``draft_slots`` traffic again, same model, inputs
                and keys, with the §11/§14 observatory on (a ledger, a
                tracer, a decision log): tokens, log-probs, ``n`` and every
                kernel's launches equal to ``draft_slots``' bit for bit,
                every ledger row conserved and each epoch split as its
                metrics (``observatory ledger`` lines), the wall time on
                and off, the attribution priced from ``serve.token_ms``,
                no new call signature for the recompile sentinel, and the
                exports under ``chiprun_out/observatory/`` parsed back with
                ``launch.analysis attrib`` equal to the in-process report;
   ``faults``   a ``PagedSlotEngine`` used directly on the 16 prompts
                (N = 64): a clean run, a run with a NaN on one follower
                and a stall past its deadline on another (untargeted rows
                identical to the clean run, the fault counters exact), and
                a run killed at a chunk boundary, saved with
                ``save_server_state``, loaded into a fresh engine and
                drained (all rows identical, the bf16 pools reloaded bit
                for bit; the snapshot is deleted after);
   ``train``    the GRPO train step on the model cut to ``CUT_LAYERS``: two
                ``Trainer.train_step`` calls (epoch 0 vanilla, epoch 1
                one-pass spec, the real verifier; a ``train`` line each with
                the stage split, loss, grad norm, launches by stage and peak
                memory) with the observatory on and ``AlertManager(
                default_rules())`` (``observatory train`` lines: one span
                a stage within 1 ms of its timer, the ledger growing by
                ``n_reused`` and ``n_generated``, the registry's peak
                device bytes equal to ``max_memory_allocated()``), then
                ``Trainer.optimize`` on the epoch-1 rollout with seeded
                mixed rewards, at the default lr and at 1e-3: a
                finite loss, a nonzero gradient in every parameter, no kernel
                launched by the actor update (its forward takes the
                differentiable route), ``flash_attention`` launched once a
                layer by the old-policy and by the reference scoring; then,
                after ``ppo`` and ``dapo``, with the model freed, its
                float32 witness: two layers at full width, the actor update
                on the card against the whole ``optimize`` on the CPU from
                the same weights and rollout, and the critic update on the
                card against the CPU's from the same critic, values and
                returns (and the card's bfloat16 values against the CPU's);
   ``ppo``      the GRPO trainer freed, PPO on the same model (cut) with
                its own full-width critic: one ``train_step`` (epoch 0, the
                verifier's rewards) and ``optimize`` on the ``train``
                path's epoch-1 rollout with mixed rewards (``train ppo``
                lines: values and critic-update times, critic loss, the
                actor's and the critic's grad norms, launches and peak
                memory by stage): ``flash_attention`` once a layer in the
                actor's scoring and in the values pass, no kernel in
                either update, a nonzero gradient in every critic
                parameter;
   ``dapo``     one DAPO ``train_step`` with one resample round, its
                rewards replaced for that step: groups 0 and 2 degenerate,
                exactly their 8 rows re-rolled (the one-pass branch, from
                the SPEC-RL cache the first round filled) and merged back,
                the other rows untouched (``train dapo`` line: each
                round's reuse, time and launches);
   ``async``    the §12 loop on the cut model: ``AsyncTrainer`` over
                a fresh GRPO trainer, three collections under version 0,
                then one exact, one importance-corrected and one
                re-verified step (the one-pass branch under the current
                weights); the served and the published weights equal the
                trainer's bit for bit and share no storage with them;
                ``async produce`` / ``async step`` lines with the stage
                split and peak GiB by stage, then the loop's counters;
   ``watchdog`` the trainer watchdog on the model cut to
                ``WATCHDOG_LAYERS`` layers: a healthy step snapshots, NaN
                in every parameter and moment and a NaN loss, the restore
                bit-exact in place, ``step_idx`` kept, the next step
                finite; the snapshot's bytes and save and load seconds;
   ``serve``    one run of ``python -m repro_torch.launch.serve`` on the
                card (its reduced config, ``--spec-prefix --arrival-every
                2 --ledger --trace-dir --decision-log
                --assert-compile-stable``), ending with ``0 new on
                identical replay``;
   ``rwkv``     two epochs of full-width rwkv6-3b at ``RWKV_LAYERS`` of 32
                layers (the qwen
                model freed first): epoch 1 the two-pass branch (verify
                score, left-align, re-prefill), every recurrence through
                ``wkv`` (its launches split by T), no attention or cache
                kernel launched; then,
                outside the launch counts, its witnesses in float32: the
                same two epochs (logged), and the score against prefill +
                decode steps on the same tokens, with the kernel and with
                the plain recurrence, and against the score of embeddings
                nudged by 1e-7, at ``RWKV_LAYERS`` (within ``CHAOS_FACTOR``) and
                cut to one layer (within ``CONSISTENCY_TOL``);
   ``archs``    each of deepseek-7b (8 of 30 layers), qwen1.5-110b (2 of
                80), granite-34b (4 of 88), mixtral-8x22b (4 of 56,
                ``dispatch``), jamba-v0.1-52b (8 of 32: one full period,
                ``dispatch``) and deepseek-v3-671b (4 of 61: three dense
                MLA layers and the first MoE one) at full width, built at
                that depth: the ``rollout`` path's two epochs at
                ``ARCHS_N`` tokens, the path kernels launched (jamba: the
                two-pass branch, ``mamba_scan`` by T, no ``cache_roll``),
                an ``archs`` line (parameters, peak GiB, times, counts;
                the MoE trunks' ``moe_drop_frac`` over epoch 1's verify
                input; deepseek-v3's ``mtp_logits`` from the same forward,
                finite and shaped like the logits);
   ``mixtral train``, ``jamba train``, ``deepseek train`` one GRPO
                ``train_step`` of each at one layer, full width: the
                scorings launch flash_attention (jamba's Mamba layer:
                mamba_scan) alone, the update no kernel, a MoE layer's
                ``moe_lb_loss`` finite, every MoE, Mamba and attention
                parameter of the layer with a gradient (deepseek-v3's MTP
                head, which no trainer path reads, logged as expected
                zeros);
   then, outside the paths, ``jamba consistency``: jamba cut to one layer
   in float32 (``moe_impl="dense"``), its score against its prefill +
   decode steps within ``CONSISTENCY_TOL``, as ``rwkv``'s witness;
   ``archs`` of the modality frontends at full width and depth with their
                stub conditioning from a seed, one draw a prompt
                (``FRONTEND_LAYERS``): pixtral-12b (40 layers, 256 patch
                embeddings a row; epoch 1 the two-pass branch, no
                ``cache_roll``) and whisper-tiny (4 + 4 layers, 1,500
                frames through ``encode`` once, the counts opened before
                it; epoch 1 the one-pass branch, ``cache_roll`` launched;
                flash_attention non-causal in the encoder and in every
                cross-attention, T = 1 at decode);
   ``serve frontends`` ``launch.serve --engine fixed`` of both (the
                launcher's reduced configs), every request served;
   after ``rollout``, ``slots``, ``paged`` and ``rwkv``, a ``breakdown``
   line shows where 16 decode steps of the path's decode loop (the
   rollout's at full depth, the slot engine's and the paged one's at
   ``CUT_LAYERS``, rwkv's at ``RWKV_LAYERS``) spend their time (host wall
   time, device busy time, kernel
   launches, top kernels and host ops from ``torch.profiler``, read from
   a complete trace: a marker before and after the call; the drafted
   loop's: ``tools/draft_breakdown.py``);
6. prints each phase's start and seconds, the profiler lead-in's lost
   records by session, the decode kernels' launches by path and T, each path's read
   in the same window as its launches (blocks of T > 1 on the draft paths
   and nowhere else: no earlier prefill, verify or score moved off
   ``flash_attention``), one ``{"kernels": [...]}`` JSON line (launches
   per path beside their sum), the ``nvidia-smi`` line again, and last
   ``{"ok": true, "device": {...}}``.

What is too long for the end of the output goes to ``chiprun_out/`` beside
this script: the kernels' build log (``chip_smoke_build.log``, with the
``ptxas -v`` lines) and the profiler's top 40 device kernels and host ops
(``chip_smoke_profile.tsv``).

It needs the repository's ``src/`` beside it and a CUDA device; without
either it exits nonzero before printing any result.
"""
from __future__ import annotations

import copy
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ATTN_TOL = 1e-3     # the attentions compute in float32 from the same bf16
                    # inputs; they differ only in summation order
# card vs CPU logits of the reduced configs in bfloat16 (8-bit mantissa:
# each rounding at another place moves a value of order 1 by up to 4e-3;
# two layers of them).  rwkv6-3b rounds more: its token-shift mixes and
# group norm run in bfloat16, as JAX's do, and its bfloat16 logits lie 0.119
# from its float32 ones on the CPU (qwen3-1.7b's about 0.04); the card's lay
# 0.0508 from the CPU's in four runs, qwen3-1.7b's 0.0313
SMALL_TOL = {"qwen3-1.7b": 5e-2, "rwkv6-3b": 8e-2}
# the MoE slice's configs, reduced: attention trunks like qwen3-1.7b's (G = 1
# for deepseek, qwen1.5 and mixtral, 4 for granite), held to qwen's 5e-2.
# The reduced jamba-v0.1-52b (eight layers, seven of them Mamba) barely
# survives bfloat16: in JAX itself its bfloat16 logits lie 3.05 from its
# float32 ones on the CPU (rwkv6-3b's 0.109), the port's 3.22; with the
# routing replayed the CPU's bfloat16 lies 1.18 from float32 and the
# card's 0.297 from the CPU's (on an H100; PERF.md). It is held to 0.5,
# and by BF16_GAP to the CPU's own distance from float32
SMALL_TOL.update({arch: 5e-2 for arch in ("deepseek-7b", "qwen1.5-110b",
                                          "granite-34b", "mixtral-8x22b")})
SMALL_TOL["jamba-v0.1-52b"] = 0.5
# the reduced frontends: two-layer attention trunks like qwen3-1.7b's (G = 1),
# pixtral behind 16 stub patches, whisper with a two-layer encoder over 64
# stub frames: qwen's 5e-2
SMALL_TOL.update({arch: 5e-2 for arch in ("pixtral-12b", "whisper-tiny")})
# deepseek-v3-671b, reduced: two MLA layers (the second MoE with a shared
# expert) like the other attention trunks, qwen's 5e-2, at the published
# MLA head dims (SMALL_OVERRIDES): the reduced config's Dk = 48, Dv = 32
# are no kernel shape, and the kernels raise for them on the card
SMALL_TOL["deepseek-v3-671b"] = 5e-2
SMALL_OVERRIDES = {"deepseek-v3-671b": dict(
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    kv_lora_rank=512)}
BF16_GAP = 1.5      # the card's bfloat16 run may lie at most this many times
                    # as far from the CPU's float32 run as the CPU's own
                    # bfloat16 run does
SMALL_TOL_F32 = 1e-3    # card vs CPU logits in float32 (summation order
                        # only; logits of order 3)
# the rwkv6-3b score (the verify's teacher-forced log-probs) against its
# prefill + decode steps on the same tokens, in float32 at full width (and
# jamba-v0.1-52b's at one layer, Mamba + MoE):
CONSISTENCY_TOL = 1e-3  # cut to one layer, where rounding stays at 1e-6 and a
                        # fault of the cache hand-off or the kernel would not
CHAOS_FACTOR = 3.0      # at depth, where the random weights amplify
                        # rounding (a 1e-7 nudge of the embeddings moves the
                        # log-probs by about 0.03, as far as score and decode
                        # differ): the kernel's gap at most this many times
                        # the plain recurrence's or the nudge's
CONSISTENCY_STEPS = 64
REPS = 20
SPIN_CYCLES = 1_000_000     # about 0.5 ms of the card's clock before each
                            # timed call (more than a wrapper's host time)
PROFILE_SESSIONS = 3        # profiler sessions a device_ms may take for a
                            # complete trace
PROFILE_PAD_S = 0.01        # host time at both ends of a session's window
# a profiler session can drop the first device records of its window, more
# of them the more sessions the process has profiled (the smoke's
# "profiler lead-in" line counts them).  So each window opens with LEAD_IN
# marker kernels of one cycle, waited for, which take that loss; the
# session's own markers spin MARK_CYCLES (about 50 us), and a marker is the
# session's when its device time is at least MARK_MIN_US
LEAD_IN = 256
LEAD_IN_LOST = []           # the lead-in's records lost, session by session
MARK_CYCLES = 100_000
MARK_MIN_US = 20.0
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12         # float32 outside the tensor cores
WKV_TOL = 1e-4      # wkv against its plain version, relative to the output's
                    # largest magnitude: float32 both, the state summed over up
                    # to 320 steps and y over hd terms in another order
MAMBA_TOL = 1e-4    # mamba_scan against its plain version, relative to the
                    # output's largest magnitude: float32 both, fused
                    # multiply-adds and the ds-term sum in another order,
                    # carried over up to 320 steps

# the slice's traffic
PROMPTS, GROUP, P, N = 4, 4, 64, 256
# the draft engine's paths: n-gram drafts of up to DRAFT_K tokens, so
# verify blocks of T = K + 1 in {2, 3, 5, 9}; the kernel phase checks the
# decode kernels at DRAFT_TS (G * T up to 128), times the blocks of
# DRAFT_TIMED_TS and profiles DRAFT_PROFILED_T's; the greedy witness
# decodes WITNESS_N tokens and measures the block-vs-step logit gap at
# WITNESS_TS, which may not pass WITNESS_GAP_MAX: 1.6 x the 0.078125 that
# every run on the H100 has read (a bf16 rounding; a block route that
# drifted would differ by whole logits)
DRAFT_K = 8
DRAFT_TS = (9, 16, 64)
DRAFT_TIMED_TS = (2, 3, 5, 9)
DRAFT_PROFILED_T = 9
DRAFT_SLOTS_N = 64              # cut from N to keep the smoke in 15 min
WITNESS_N, WITNESS_TS = 128, (2, 9)
WITNESS_GAP_MAX = 0.125
SLOTS = 8                       # decode slots of the slot-backfill path
# depth cuts that pay for the watchdog, observatory and mesh phases inside
# the smoke's 1,000 s target (and the 1,200 s limit on the slowest host
# seen, 1.26x slower than the fastest): these paths run the qwen3-1.7b
# model cut to CUT_LAYERS of its 28 layers at full width (``cut_depth``:
# its first layers, sharing its tensors), so their launch counts follow the
# cut model; each check of theirs is unchanged.  The slot engine's and the
# paged breakdowns run the cut model too, async ASYNC_LAYERS layers, and
# rwkv6-3b RWKV_LAYERS of its 32 layers; the greedy witness runs at full
# depth, where WITNESS_GAP_MAX was read.  (The trainer on the mesh added
# about 105 s to ``mesh``: ``train`` went from full depth to CUT_LAYERS,
# async from 14 layers to 8, rwkv from 16 to 8 and the watchdog from 4 to
# 2; the train witness compares on the card.)  (Without the earlier cuts
# the smoke
# took 1,147 s on a host where the cut one took 829 s, and the cut one
# 1,046 s on a slower host.)
CUT_LAYERS = 8
CUT_PATHS = ("slots", "paged", "paged_slots", "draft", "draft_slots",
             "observatory", "faults", "train", "ppo", "dapo")
ASYNC_LAYERS = 8
RWKV_LAYERS = 8
# the new configs at their published widths, cut in depth to what one card
# holds beside the paths' caches (ARCH_LAYERS), each through the rollout
# traffic cut to ARCHS_N new tokens as draft_slots is; mixtral's GRPO step
# at TRAIN_LAYERS layers (weights, reference, gradient and AdamW's
# moments: 14 bytes a parameter); deepseek-7b runs 8 of its 30 layers,
# the first cut when the smoke nears its 1,200 s limit on a slower host;
# jamba-v0.1-52b runs one full period of 8 layers (Mamba + MoE, Mamba +
# FFN and attention + MoE; 13.3e9 of its 51.6e9 parameters), its GRPO
# step at one layer (Mamba + MoE), as mixtral's (TRAIN_LAYERS);
# deepseek-v3-671b runs its three dense layers and its first MoE layer (4 of
# 61: 15.8e9 parameters, 29.4 GiB in bf16) and its GRPO step at one dense
# MLA layer (3.12e9 parameters, about 43.7 GB at 14 bytes a parameter: one
# MoE layer's update alone would need about 158 GB)
ARCH_LAYERS = {"deepseek-7b": 8, "qwen1.5-110b": 2, "granite-34b": 4,
               "mixtral-8x22b": 4, "jamba-v0.1-52b": 8,
               "deepseek-v3-671b": 4}
ARCHS_N = 64
# the §8 mesh: four gloo ranks sharing cuda:0 as a (data 2, model 2) mesh
# (NCCL puts no two ranks on one card), qwen3-1.7b at full width (a rank:
# 8 of 16 query heads, 4 of 8 KV heads) cut to MESH_LAYERS layers, the
# rollout traffic at ARCHS_N tokens in each MESH_MODES mode; every
# collective stages through the host, a few ms each, so the depth keeps
# the phase near a minute.  MESH_TOP_K sampler scores are kept a sample.
# MESH_LP_TOL bounds how far the mesh's log-probs (and sampler scores) lie
# from the single-process reference's: the model axis sums two bf16
# partial products where one process sums one.  0.0625 is twice the
# largest gap the H100 has shown (a sampler-score shift of 0.0314, the
# teacher-forced gap 0.0237; PERF.md §5)
MESH_SHAPE = (2, 2)
MESH_WORLD = MESH_SHAPE[0] * MESH_SHAPE[1]
MESH_LAYERS = 2
MESH_MODES = (("dense", "none"), ("dense", "slots"), ("paged", "none"),
              ("paged", "slots"))
MESH_TOP_K = 8
MESH_LP_TOL = 0.0625
MESH_TIMEOUT_S = 400
# the trainer on the mesh (the same spawn): GRPO with a KL reference, then
# one PPO update, each an ``optimize`` of the reference's epoch-0 dense rows
# with seeded mixed rewards at MESH_LR (at the default 5e-7 a bf16 weight
# would not move), then one ``train_step``, two async steps ("ppcc", K = 1:
# one exact, one importance-corrected) and a watchdog snapshot and restore.
# A rank's gradients (as AdamW receives them) must lie within
# MESH_GRAD_GAP of each tensor's largest from the matching slices of the
# reference's: bf16 partial sums put them 0.0246-0.0308 apart on the H100
# (PERF.md §5), while a gradient off by the data axis's factor, or one
# that misses its model-group sum, is off by half of its largest.  Its
# updated shards must lie within ``update_tol`` of the reference's with
# that limit as the gradient's noise, plus one bfloat16 rounding of the
# result (MESH_BF16_ULP of |p|: both sides round p - lr * ... once, and
# may land on the two sides of a rounding boundary).  AdamW's first step
# is blind to a gradient's scale, so the step log's loss, grad_norm
# (GRPO's the actor's, PPO's the critic's), kl_ref and critic_loss must
# lie within MESH_METRIC_RTOL of the reference's, plus MESH_METRIC_ATOL
# for GRPO's first-step loss and KL, which are bf16 noise about 0 (the
# gaps seen: 2.4e-5 and 3.6e-6; the relative ones 0.0018 at most)
MESH_LR = 1e-3
MESH_BF16_ULP = 2.0 ** -7
MESH_GRAD_GAP = 0.1
MESH_METRIC_RTOL, MESH_METRIC_ATOL = 0.02, 1e-3
# the MoE family on the same mesh (a spawn of its own, ``mesh moe``):
# mixtral-8x22b at full width cut to MESH_MOE_LAYERS layer, each rank with 4
# of 8 experts, 24 of 48 query heads, 4 of 8 KV heads and half the
# vocabulary (1.45e9 of 2.91e9 parameters).  Three of MESH_MODES' modes
# run: the dense and the paged fixed batch (whose realign gathers the
# pool: ``paged_gather``) and the paged slot engine hold every kernel of
# the attention path between them.  A rank's GRPO update holds its weights,
# gradients and float32 moments, about 17.4 GB; the KL reference's 2.9 GB
# more a rank do not fit four ranks on one card, so the update runs with
# kl_coef 0 (``tools/mesh_phase.py --moe --kl`` on four cards keeps it).
# The reference records its routing (``models/moe.py:RouteLog``): the
# teacher-forced scores, ``moe_drop_frac`` and the update replay it on the
# ranks, each data rank its own rows, and report ``rerouted``, the tokens
# whose own choice the replay overrode.  With one layer the MoE at position
# t routes token t alone, so a free-running row may part (or a sampler
# score shift past MESH_LP_TOL) where the sampled column's logits came
# from a token whose recorded k-th and (k+1)-th router probabilities lie
# within ROUTER_TIE_MARGIN; every rerouted token must lie within it too.
# 0.004 is twice the largest margin the H100 has shown at such a case
# (0.00183; a rerouted token's 0.00070; PERF.md §5)
MESH_MOE_ARCH = "mixtral-8x22b"
MESH_MOE_LAYERS = 1
MESH_MOE_MODES = (("dense", "none"), ("paged", "none"), ("paged", "slots"))
MESH_MOE_TIMEOUT_S = 600
ROUTER_TIE_MARGIN = 0.004
# the modality frontends at full width and depth through the same traffic
# (pixtral-12b: 40 layers, 12.2e9 parameters; whisper-tiny: 4 + 4 layers)
FRONTEND_LAYERS = {"pixtral-12b": 40, "whisper-tiny": 4}
TRAIN_LAYERS = {"mixtral-8x22b": 1, "jamba-v0.1-52b": 1,
                "deepseek-v3-671b": 1}
# deepseek-v3-671b's MLA attention after the latent's decompression: MHA
# (G = 1) over 128 heads with Dk = nope 128 + rope 64 = 192 and Dv = 128.
# The decode kernel runs at a decode step of the archs traffic (B = 16, S =
# P + 2N) at T = 1 and at draft blocks of T = 2 and 9; flash_attention at
# the archs verify shape (T = S = P + ARCHS_N) and at the config's
# max_seq_len (B = 1, the plain version on sampled query rows, REPS cut)
MLA_DECODE_TS = (1, 2, 9)
MLA_LONG_REPS = 5
LENIENCE = 0.99
SEED = 0
# the train path's float32 witness: two layers at full width, the first
# WITNESS_ROWS rows (two GRPO groups) of the epoch-1 rollout cut to
# WITNESS_COLS response columns; lr 1e-3 so that the update dominates
WITNESS_LAYERS, WITNESS_ROWS, WITNESS_COLS, WITNESS_LR = 2, 8, 64, 1e-3
# the witness's tolerances, those of tests/test_torch_train.py's optimize:
# loss and grad norm within rtol 1e-4 (the loss also atol 1e-6); gradients
# within GRAD_NOISE of each tensor's largest (card vs CPU, float32 sums in
# another order: up to 8.4e-6 measured); parameters within 1e-6 of |p| + lr
# plus what that gradient error does to AdamW's first step (update_tol);
# the card's first-update ratio within 1e-5 of 1
TRAIN_RTOL, TRAIN_ATOL, PARAM_RTOL, RATIO_TOL = 1e-4, 1e-6, 1e-6, 1e-5
GRAD_NOISE = 5e-5


def require(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing


class Timer:
    """Median device time of one call, L2 flushed before each launch.
    ``turns`` times several functions in turns (forward, then backward
    order, rep after rep), so that they share the card's state.  After the
    flush the card spins for ``SPIN_CYCLES`` (``torch.cuda._sleep``), so
    that the host has queued the call before the start event runs: the
    events time the card's work, not the host's wrapper."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32,
                                 device="cuda")      # 256 MB > 50 MB L2

    def _once(self, fn) -> float:
        torch = self.torch
        self.flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def turns(self, *fns, reps: int = REPS):
        for fn in fns:
            for _ in range(3):
                fn()
        times = [[] for _ in fns]
        for rep in range(reps):
            order = range(len(fns)) if rep % 2 == 0 else reversed(
                range(len(fns)))
            for i in order:
                times[i].append(self._once(fns[i]))
        return [statistics.median(t) for t in times]

    def ms(self, fn, reps: int = REPS) -> float:
        return self.turns(fn, reps=reps)[0]

    def session(self, fn, kernel: str, reps: int = REPS,
                pad_s: float = PROFILE_PAD_S) -> dict:
        """One ``torch.profiler`` session of ``reps`` calls of ``fn``, each
        after a marker kernel (``torch.cuda._sleep``'s ``spin_kernel``) and
        the L2 flush, one more marker after the last, and ``pad_s`` of host
        time at both ends of the window.  Returns the trace's counts: the
        markers, the launches of ``kernel`` (a part of its name) and their
        device time (us), any other kernel's launches (the flush aside) and
        every device event."""
        from torch.autograd import DeviceType

        torch = self.torch

        def body():
            for _ in range(reps):
                torch.cuda._sleep(MARK_CYCLES)
                self.flush.zero_()
                fn()
            torch.cuda._sleep(MARK_CYCLES)

        events = profile_window(torch, body, pad_s)
        markers, lead_in = marker_counts(events)
        out = dict(markers=markers, lead_in_lost=LEAD_IN - lead_in,
                   launches=0, us=0.0, others=0, events=0)
        for e in events.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            out["events"] += e.count
            if MARKER in e.key:
                continue
            if kernel in e.key:
                out["us"] += e.self_device_time_total
                out["launches"] += e.count
            elif "FillFunctor" not in e.key and "Memset" not in e.key:
                out["others"] += e.count
        return out

    def device_ms(self, fn, kernel: str, reps: int = REPS):
        """The mean device time (ms, CUPTI through ``torch.profiler``) of
        the launches of ``kernel`` (a part of its name) over ``reps`` calls
        of ``fn``, the L2 flushed before each; and per call, the launches
        of ``kernel`` and of any other kernel (the flush aside).  Read from
        a complete trace only: one that holds all ``reps + 1`` markers of
        its session.  The profiler has dropped a session's device events
        on the H100 (a whole smoke's check once saw no launch of a kernel
        that every other run saw once a call), so a session with a marker
        missing is logged and profiled again, up to ``PROFILE_SESSIONS``
        times; what a complete trace shows is held as it stands."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        for attempt in range(1, PROFILE_SESSIONS + 1):
            got = self.session(fn, kernel, reps)
            if got["markers"] == reps + 1:
                break
            log(f"profiler session {attempt} of {kernel}: a trace with "
                f"{got['markers']} of {reps + 1} markers and "
                f"{got['events']} device events lost device events "
                f"({got['lead_in_lost']} of the lead-in's {LEAD_IN})")
        require(got["markers"] == reps + 1,
                f"the profiler lost device events in each of "
                f"{PROFILE_SESSIONS} sessions of {kernel}: {got}")
        require(got["launches"] > 0,
                f"the profiler saw no launch of {kernel} in a complete "
                f"trace: {got}")
        return (got["us"] / got["launches"] / 1e3, got["launches"] / reps,
                got["others"] / reps)


MARKER = "spin_kernel"       # torch.cuda._sleep's kernel, a session's marker


def profile_window(torch, body, pad_s: float = PROFILE_PAD_S):
    """The events (``prof.events()``) of one ``torch.profiler`` session
    around ``body()``, which launches its own markers
    (``torch.cuda._sleep(MARK_CYCLES)``).  The window opens with the
    ``LEAD_IN`` one-cycle markers, waited for, and closes on a
    synchronise, with ``pad_s`` of host time after the lead-in and at the
    end: a window that closes on the card's last work is the case in which
    the profiler has lost a session's device events
    (``tools/profiler_probe.py``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(pad_s)
        body()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    return prof.events()


def marker_counts(events):
    """(the session's markers, the lead-in's markers) in a trace, told
    apart by device time (``MARK_MIN_US``)."""
    from torch.autograd import DeviceType

    long = short = 0
    for e in events:
        if e.device_type == DeviceType.CUDA and MARKER in e.name:
            if e.time_range.elapsed_us() >= MARK_MIN_US:
                long += 1
            else:
                short += 1
    LEAD_IN_LOST.append(LEAD_IN - short)
    return long, short


def bound(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S):
    """The least time (ms) for the work at the card's peaks, and which of
    the two bounds it; ``flop_rate`` is the peak for the operations' type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- kernels


def flash_case(torch, gen, name, B, Hq, Hkv, T, S, D, spans, peak=None,
               window=0):
    """One flash_attention case through the public wrapper against the
    plain version: row b's queries ``spans[b] = (pad, valid)`` sit at
    positions 0.. after ``pad`` padded slots (q_pos -1, given as int64 for
    the wrapper to convert), its keys are the same slots (k_pos past T
    empty).  With ``peak``, each query is scaled so that its largest
    visible logit is about ``peak`` (where rounding the softmax weights
    shows most); with ``window``, a sliding window of that many keys.
    Within ATTN_TOL; rows that see no key exactly 0."""
    from repro_torch.kernels.flash_attention import ops as fl_ops

    dev = gen.device
    q_pos = torch.full((B, T), -1, dtype=torch.int64, device=dev)
    for b, (pad, valid) in enumerate(spans):
        q_pos[b, pad:pad + valid] = torch.arange(valid, device=dev)
    k_pos = torch.full((B, S), -1, dtype=torch.int32, device=dev)
    k_pos[:, :min(T, S)] = q_pos[:, :min(T, S)].to(torch.int32)
    bf = dict(dtype=torch.bfloat16, device=dev)
    q = torch.randn((B, Hq, T, D), generator=gen, **bf)
    k = torch.randn((B, Hkv, S, D), generator=gen, **bf)
    v = torch.randn((B, Hkv, S, D), generator=gen, **bf)
    vis = ((k_pos[:, None, :] >= 0)
           & (k_pos[:, None, :] <= q_pos[:, :, None]))          # (B, T, S)
    if window > 0:
        vis &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    if peak is not None:
        kr = k.float().repeat_interleave(Hq // Hkv, dim=1)
        logits = torch.einsum("bhtd,bhsd->bhts", q.float(), kr) / math.sqrt(D)
        top = logits.masked_fill(~vis[:, None], -1e30).amax(-1)
        factor = torch.where(top > 0, peak / top.clamp(min=1e-6),
                             torch.ones_like(top))
        q = (q.float() * factor[..., None]).to(torch.bfloat16)
        del kr, logits
    got = fl_ops.flash_attention(q, k, v, q_pos, k_pos, window=window)
    want = fl_ops.flash_attention_plain(q, k, v, q_pos.to(torch.int32), k_pos,
                                        window=window)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    dead = ~vis.any(-1)                                          # (B, T)
    log(f"kernel flash_attention {name} (B={B}, Hq={Hq}, Hkv={Hkv}, T={T}, "
        f"S={S}, D={D}, window={window}): max_abs_err={err}, "
        f"{int(dead.sum())} query rows see no key")
    require(bool(torch.isfinite(got).all()) and err <= ATTN_TOL,
            f"flash_attention {name}: max_abs_err {err} > {ATTN_TOL}")
    require(bool((got.transpose(1, 2)[dead] == 0).all())
            and bool((want.transpose(1, 2)[dead] == 0).all()),
            f"flash_attention {name}: rows that see no key must be exactly 0")
    return err


def decode_case(torch, gen, name, Hq, Hkv, T, S, D, spans, q_lens, *,
                window=0, block_sizes=(32,)):
    """One decode case through both public wrappers against the plain
    version.  Row b's live span is ``spans[b] = (starts, lengths)`` (lengths
    may pass S), its keys at positions 0.. from starts; its first
    ``q_lens[b]`` queries sit at the span's last positions (the draft-block
    contract), the rest at -1; positions and bounds go in as int64 for the
    wrappers to convert.  The dense cache holds NaN at every slot outside
    its row's span, and so do the paged pools (a shuffled table, each block
    size of ``block_sizes``; spare blocks NaN too): a kernel that reads one
    shows it.  Within ATTN_TOL of the plain version on the clean cache;
    queries that see no key exactly 0.  Returns the larger error and the
    dense kernel's arguments in its form."""
    from repro_torch.kernels.decode_attention import ops as dec_ops

    dev = gen.device
    B = len(spans)
    starts = torch.tensor([a for a, _ in spans], device=dev)
    lengths = torch.tensor([z for _, z in spans], device=dev)
    j = torch.arange(S, device=dev)[None, :]
    live = (j >= starts[:, None]) & (j < lengths[:, None])
    k_pos = torch.where(live, j - starts[:, None], torch.full_like(j, -1)
                        ).to(torch.int32)
    q_pos = torch.full((B, T), -1, dtype=torch.int64, device=dev)
    for b, n in enumerate(q_lens):
        span = int(live[b].sum())
        q_pos[b, :n] = span - n + torch.arange(n, device=dev)
    q_pos = q_pos.clamp(min=-1)
    bf = dict(dtype=torch.bfloat16, device=dev)
    q = torch.randn((B, Hq, T, D), generator=gen, **bf)
    k = torch.randn((B, Hkv, S, D), generator=gen, **bf)
    v = torch.randn((B, Hkv, S, D), generator=gen, **bf)
    lv = live[:, None, :, None]
    nan = torch.tensor(float("nan"), **bf)
    k_bad, v_bad = torch.where(lv, k, nan), torch.where(lv, v, nan)
    k_ok, v_ok = torch.where(lv, k, 0.0), torch.where(lv, v, 0.0)
    kargs = (q, k_bad, v_bad, q_pos.to(torch.int32), k_pos,
             lengths.clamp(max=S).to(torch.int32),
             starts.clamp(0, S).to(torch.int32))
    want = dec_ops.decode_attention_plain(q, k_ok, v_ok, *kargs[3:],
                                          window=window)
    vis = (live[:, None, :] & (k_pos[:, None, :] >= 0)
           & (k_pos[:, None, :] <= q_pos[:, :, None]))
    if window > 0:
        vis &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    dead = ~vis.any(-1)                                          # (B, T)
    gots = {"dense": dec_ops.decode_attention(q, k_bad, v_bad, q_pos, k_pos,
                                              lengths, starts, window=window)}
    for bs in block_sizes:
        nb = -(-S // bs)
        NB = B * nb + 2
        table = torch.randperm(NB, generator=gen, device=dev)[:B * nb].to(
            torch.int32).reshape(B, nb)
        pools = []
        for x in (k_bad, v_bad):
            pad = torch.full((B, Hkv, nb * bs, D), float("nan"), **bf)
            pad[:, :, :S] = x
            pool = torch.full((NB, Hkv, bs, D), float("nan"), **bf)
            pool[table.reshape(-1).long()] = pad.view(
                B, Hkv, nb, bs, D).transpose(1, 2).reshape(B * nb, Hkv, bs, D)
            pools.append(pool)
        gots[f"paged bs={bs}"] = dec_ops.paged_decode_attention(
            q, pools[0], pools[1], table, q_pos, k_pos, lengths, starts,
            window=window)
    torch.cuda.synchronize()
    err = 0.0
    for what, got in gots.items():
        e = float((got - want).abs().max())
        err = max(err, e)
        log(f"kernel decode {name} {what} (B={B}, Hq={Hq}, Hkv={Hkv}, T={T}, "
            f"S={S}, D={D}, window={window}): max_abs_err={e}, "
            f"{int(dead.sum())} queries see no key")
        require(bool(torch.isfinite(got).all()) and e <= ATTN_TOL,
                f"decode {name} {what}: max_abs_err {e} > {ATTN_TOL} or "
                "non-finite (a slot outside the live span was read)")
        require(bool((got.transpose(1, 2)[dead] == 0).all()),
                f"decode {name} {what}: queries that see no key must be "
                "exactly 0")
    return err, kargs


def kernel_checks(torch, timer):
    """Each kernel against its plain version at the slice's shapes."""
    from repro_torch.kernels.cache_gather import ops as roll_ops
    from repro_torch.kernels.cache_slot_write import ops as sw_ops
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fl_ops
    from repro_torch.kernels.spec_verify import ops as sv_ops
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    B, Hq, Hkv, D = PROMPTS * GROUP, 16, 8, 128
    W = P + N
    bf = dict(dtype=torch.bfloat16, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    records = {}
    # per-row verified prefix and prompt length, as the one-pass epoch has
    n = torch.randint(0, N + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    p_len = torch.randint(6, 10, (B,), generator=gen, device=dev, dtype=torch.int32)

    def randn(*shape):
        return torch.randn(shape, generator=gen, **bf)

    def record(name, src, replaces, err, fn, plain, library, nbytes, flops,
               kernel, two_step=None, flop_rate=BF16_FLOP_PER_S):
        """``kernel``: a part of the CUDA kernel's name, for its device
        time; ``library``: one PyTorch call computing the same function (or
        None); ``two_step``: (label, fn) of a comparison that is not one
        library call, timed and reported beside it."""
        fns = [fn, plain] + [f for f in (library,) if f is not None]
        ms, plain_ms, *lib = timer.turns(*fns)
        library_ms = lib[0] if lib else None
        dev_ms, per_call, others = timer.device_ms(fn, kernel)
        b_ms, b_by = bound(nbytes, flops, flop_rate)
        rec = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": None, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": library_ms,
               "device_ms": dev_ms, "kernels_per_call": per_call,
               "other_kernels_per_call": others}
        extra = ""
        if two_step is not None:
            rec["two_step"], rec["two_step_ms"] = two_step[0], timer.ms(
                two_step[1])
            extra = f" two_step_ms={rec['two_step_ms']} ({two_step[0]})"
        records[name] = rec
        log(f"kernel {name}: max_abs_err={err} ms={ms} device_ms={dev_ms} "
            f"plain_ms={plain_ms} library_ms={library_ms}{extra} "
            f"bound_ms={b_ms} ({b_by}); kernels a call: {per_call} of "
            f"{kernel}, {others} other")
        return rec

    def one_launch(name):
        rec = records[name]
        require(rec["kernels_per_call"] == 1 and
                rec["other_kernels_per_call"] == 0,
                f"{name}: {rec['kernels_per_call']} launches of its kernel "
                f"and {rec['other_kernels_per_call']} others a call, want "
                "one launch and nothing else")

    # --- decode_attention: a resumed decode step of epoch 1 (S = W + N) ----
    # Rows 0-2 are done (q_pos -1, as the decode loop feeds rows past EOS);
    # row 3 has no live slot (lengths == starts) but a valid query; row 4's
    # length runs past the cache and is clamped.  Positions and bounds go in
    # as int64, the query position as (B,), for the wrapper to convert.
    S = W + N
    step = N // 2
    starts = (W - (p_len + n)).long()
    lengths = torch.full((B,), W + 1 + step, dtype=torch.int64, device=dev)
    j = torch.arange(S, device=dev)[None, :]
    k_pos = torch.where((j >= starts[:, None]) & (j < lengths[:, None]),
                        j - starts[:, None], torch.full_like(j, -1)
                        ).to(torch.int32)
    q_pos = lengths - 1 - starts
    q_pos[:3] = -1
    lengths[3] = starts[3]
    lengths[4] = S + 5
    q, k, v = randn(B, Hq, 1, D), randn(B, Hkv, S, D), randn(B, Hkv, S, D)
    kargs = (q, k, v, q_pos.view(B, 1).to(torch.int32), k_pos,
             lengths.clamp(max=S).to(torch.int32),
             starts.clamp(0, S).to(torch.int32))       # the kernel's form
    got = dec_ops.decode_attention(q, k, v, q_pos, k_pos, lengths, starts)
    want = dec_ops.decode_attention_plain(*kargs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(err <= ATTN_TOL, f"decode_attention: max_abs_err {err} > {ATTN_TOL}")
    require(bool((got[:4] == 0).all()) and bool((want[:4] == 0).all()),
            "decode_attention: done rows and the row with no live slot "
            "must come out exactly 0")
    # the bound counts what this step's data needs: q and the visible K/V
    # of rows with a live query, the k_pos of their live span, the output
    qp32, len32, st32 = kargs[3], kargs[5], kargs[6]
    row_live = (qp32[:, 0] >= 0) & (len32 > st32)
    span = (j >= st32[:, None]) & (j < len32[:, None]) & row_live[:, None]
    seen = span & (k_pos >= 0) & (k_pos <= qp32)
    n_span, n_seen = int(span.sum()), int(seen.sum())
    mask4 = seen[:, None, None, :].expand(B, Hq, 1, S)
    record("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
           "src/repro/kernels/decode_attention/kernel.py:193", err,
           lambda: dec_ops.decode_attention_cuda(*kargs),
           lambda: dec_ops.decode_attention_plain(*kargs),
           lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask4,
                                                  enable_gqa=True),
           nbytes=int(row_live.sum()) * Hq * D * 2 + n_seen * Hkv * D * 2 * 2
           + n_span * 4 + 3 * B * 4 + B * Hq * D * 4,
           flops=4 * n_seen * Hq * D, kernel="dense_decode_kernel")
    one_launch("decode_attention")

    # --- the decode kernels' other regimes, dense and paged (block size 32,
    # and 64 where named): draft blocks of T = 4 and 8 at G = 2 (G * T = 8
    # and 16, queries past q_len at -1), a window of 16, the reduced
    # configs' D = 64 with 4 / 2 heads, live spans of one slot, of the whole
    # cache, off tile edges and past S
    cases = [
        ("T=4", Hq, Hkv, 4, S, D, [(100, 420), (0, S), (37, 291), (250, 250)],
         [4, 2, 4, 3], 0, (32,)),
        ("T=8", Hq, Hkv, 8, S, D, [(3, 500), (64, 65), (0, S), (200, 330)],
         [8, 1, 5, 0], 0, (32, 64)),
        ("window 16", Hq, Hkv, 1, S, D,
         [(10, 400), (0, S), (320, 449), (31, 33)], [1, 1, 1, 1], 16, (32,)),
        ("D=64", 4, 2, 1, 96, 64, [(0, 96), (7, 40), (95, 96), (33, 65)],
         [1, 1, 1, 1], 0, (32, 64)),
        ("spans", Hq, Hkv, 1, S, D,
         [(0, 1), (0, S), (31, 33), (33, 95), (S - 1, S), (17, S + 24),
          (64, 128), (5, 5)], [1] * 8, 0, (32, 64)),
    ]
    # the draft engine's verify blocks (T = k + 1) at G = 2: G * T = 18,
    # 32 and 128, two, two and eight query chunks of 16; row 2 is done
    # (q_len 0), row 3 has no live slot
    cases += [
        (f"draft T={t}", Hq, Hkv, t, S, D,
         [(100, 420), (0, S), (37, 291), (250, 250)], [t, t // 2 + 1, 0, t],
         0, (32, 64)) for t in DRAFT_TS]
    errs = [decode_case(torch, gen, name, hq, hkv, t, s_, d, spans, q_lens,
                        window=w, block_sizes=bss)[0]
            for name, hq, hkv, t, s_, d, spans, q_lens, w, bss in cases]
    # the slot engine's decode step: 8 slots of S = 576, timed
    p8 = torch.randint(6, 10, (SLOTS,), generator=gen, device=dev)
    n8 = torch.randint(0, N + 1, (SLOTS,), generator=gen, device=dev)
    spans8 = [(int(W - a - c), W + 1 + step) for a, c in zip(p8, n8)]
    err8, a8 = decode_case(torch, gen, "slot engine", Hq, Hkv, 1, S, D, spans8,
                           [1] * SLOTS)
    ms8 = timer.ms(lambda: dec_ops.decode_attention_cuda(*a8))
    dev8 = timer.device_ms(lambda: dec_ops.decode_attention_cuda(*a8),
                           "dense_decode_kernel")[0]
    log(f"kernel decode_attention at the slot engine's shape (B={SLOTS}, "
        f"S={S}): ms={ms8} device_ms={dev8}")
    records["decode_attention"].update(
        regimes_max_abs_err=max(errs + [err8]), slots_ms=ms8,
        slots_device_ms=dev8)

    # --- flash_attention: first the one-tile rehearsal (a wrong wgmma
    # descriptor, swizzle or fragment mapping shows here first), then the
    # verify prefill of epoch 1 (T = W, S = W + N), then the other regimes
    errs = [flash_case(torch, gen, "one tile", 1, Hq, Hkv, 64, 64, D,
                       [(0, 64)])]
    # --- the verify prefill of epoch 1: left-padded prompt and right-padded
    # draft; the padded query rows carry q_pos -1 and must come out exactly
    # 0; q_pos goes in as int64
    T = W
    col = torch.arange(T, device=dev)[None, :]
    pad = P - p_len[:, None]
    valid = ((col >= pad) & (col < P)) | ((col >= P) & (col < P + n[:, None]))
    q_pos_f = torch.where(valid, torch.cumsum(valid.long(), 1) - 1,
                          torch.full_like(col, -1))
    k_pos_f = torch.full((B, S), -1, **i32)
    k_pos_f[:, :T] = q_pos_f
    qf, kf, vf = randn(B, Hq, T, D), randn(B, Hkv, S, D), randn(B, Hkv, S, D)
    fargs = (qf, kf, vf, q_pos_f.to(torch.int32), k_pos_f)   # kernel's form
    got = fl_ops.flash_attention(qf, kf, vf, q_pos_f, k_pos_f)
    want = fl_ops.flash_attention_plain(*fargs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(err <= ATTN_TOL, f"flash_attention: max_abs_err {err} > {ATTN_TOL}")
    require(bool((got.transpose(1, 2)[~valid] == 0).all()),
            "flash_attention: padded query rows must come out exactly 0")
    log(f"kernel flash_attention epoch-1 verify (B={B}, Hq={Hq}, Hkv={Hkv}, "
        f"T={T}, S={S}, D={D}): max_abs_err={err}")
    errs += [err,
             # the reduced configs' and the serve path's widths
             flash_case(torch, gen, "D=64", 4, 4, 2, 40, 96, 64,
                        [(0, 40), (7, 33), (3, 20), (0, 1)]),
             # the slot engine's admissions: ragged T and S, rows of padding
             flash_case(torch, gen, "ragged", 4, Hq, Hkv, 70, 130, D,
                        [(5, 65), (0, 0), (9, 40), (0, 0)]),
             # the largest logit of each row about 20
             flash_case(torch, gen, "peaked", 4, Hq, Hkv, T, S, D,
                        [(3, 300), (0, W), (10, 120), (0, 64)], peak=20.0)]
    err = max(errs)
    vis = ((k_pos_f[:, None, :] >= 0)
           & (k_pos_f[:, None, :] <= q_pos_f[:, :, None]))     # (B, T, S)
    pairs = int(vis.sum())
    kv_seen = int(vis.any(dim=1).sum())
    fmask = vis[:, None].expand(B, Hq, T, S)
    # the K/V tiles the kernel loads (its tile list, once per KV head) beside
    # the K/V the function needs
    kv_loaded = int(fl_ops.live_key_tiles(q_pos_f, k_pos_f).sum()) * Hkv \
        * fl_ops.BK * D * 2 * 2
    log(f"kernel flash_attention epoch-1 verify: K/V bytes loaded "
        f"{kv_loaded}, needed {kv_seen * Hkv * D * 2 * 2}")
    # bytes: q of the valid rows only (a padded row's q is never needed),
    # the K/V some query sees, both position arrays, the whole fp32 output
    # (padded rows are written as zeros)
    record("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention/kernel.py:69", err,
           lambda: fl_ops.flash_attention_cuda(*fargs),
           lambda: fl_ops.flash_attention_plain(*fargs),
           lambda: F.scaled_dot_product_attention(qf, kf, vf, attn_mask=fmask,
                                                  enable_gqa=True),
           nbytes=int(valid.sum()) * Hq * D * 2 + kv_seen * Hkv * D * 2 * 2
           + B * (T + S) * 4 + B * Hq * T * D * 4,
           flops=4 * D * Hq * pairs, kernel="flash_kernel")

    # --- spec_verify: the accept test of epoch 1 (B, N) --------------------
    f32 = dict(dtype=torch.float32, device=dev)
    lp_prev = -torch.rand((B, N), generator=gen, **f32) * 8.0
    lp_curr = lp_prev + 0.01 * torch.randn((B, N), generator=gen, **f32)
    u = torch.rand((B, N), generator=gen, **f32)
    # lengths of none, one token, off the float4 and warp edges, all
    vlen = torch.full((B,), N, dtype=torch.int64, device=dev)
    vlen[:5] = torch.tensor([0, 1, 37, 129, N - 1])
    sargs = (lp_curr, lp_prev, u, vlen.to(torch.int32), math.log(LENIENCE))
    sargs64 = sargs[:3] + (vlen,) + sargs[4:]
    spec_verify_check(torch, sv_ops, sargs, cover=False)
    # the scalar loads (N % 4 != 0, rows not 16-byte aligned) and a draft
    # longer than the 256 tokens a warp covers at once (a rejection in the
    # second chunk, and the early exit after the first); row r accepts
    # every token before sure[r] (lp_curr 1 above lp_prev) and about two
    # in three after it, so that every case of the mask occurs
    for n_tok, lens, sure in (
            (37, [0, 1, 3, 4, 5, 17, 36, 37], [0, 5, 0, 2, 5, 10, 30, 37]),
            (300, [0, 1, 37, 129, 255, 256, 257, 299, 300],
             [0, 0, 40, 100, 250, 256, 256, 280, 300])):
        rows = len(lens)
        prev = -torch.rand((rows, n_tok), generator=gen, **f32) * 8.0
        accept = (torch.arange(n_tok, device=dev)[None, :]
                  < torch.tensor(sure, device=dev)[:, None])
        curr = prev + torch.where(accept, 1.0, torch.randn(
            (rows, n_tok), generator=gen, **f32))
        spec_verify_check(torch, sv_ops, (
            curr, prev, torch.rand((rows, n_tok), generator=gen, **f32),
            torch.tensor(lens, dtype=torch.int32, device=dev),
            math.log(LENIENCE)))
    record("spec_verify", "src/repro_torch/csrc/spec_verify.cu",
           "src/repro/kernels/spec_verify/kernel.py:44", 0.0,
           lambda: sv_ops.spec_verify_cuda(*sargs),
           lambda: sv_ops.spec_verify_plain(*sargs), None,
           nbytes=3 * B * N * 4 + 2 * B * 4, flops=5 * B * N,
           kernel="spec_verify_kernel")
    one_launch("spec_verify")
    # int64 lengths (the callers hold int32) take no conversion either
    _, per_call, others = timer.device_ms(
        lambda: sv_ops.spec_verify(*sargs64), "spec_verify_kernel")
    require(per_call == 1 and others == 0,
            f"spec_verify with int64 valid_len: {per_call} launches of its "
            f"kernel and {others} others a call, want one and nothing else")
    log(f"kernel spec_verify with int64 valid_len: kernels a call: "
        f"{per_call}, {others} other")

    # --- cache_roll: the compaction of one epoch-1 buffer (28*16*8 rows) ---
    R = 28 * B * Hkv
    buf = randn(R, S, D)
    shift64 = (N - n).long().repeat_interleave(Hkv).repeat(28)
    shift = shift64.to(torch.int32)                            # kernel's form
    got = roll_ops.cache_roll(buf, shift64)
    want = roll_ops.cache_roll_plain(buf, shift)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "cache_roll differs from its plain version")
    del got, want
    src_idx = torch.remainder(torch.arange(S, device=dev)[None, :]
                              - shift.long()[:, None], S)
    gidx = src_idx[:, :, None].expand(R, S, D)
    record("cache_roll", "src/repro_torch/csrc/cache_roll.cu",
           "src/repro/kernels/cache_gather/kernel.py:38", 0.0,
           lambda: roll_ops.cache_roll_cuda(buf, shift),
           lambda: roll_ops.cache_roll_plain(buf, shift),
           lambda: torch.gather(buf, 1, gidx),
           nbytes=2 * buf.numel() * 2 + R * 4, flops=0.0,
           kernel="cache_roll_kernel")
    del buf, gidx
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # --- paged_decode_attention: the same resumed step over a paged cache --
    # pools (B*nb, Hkv, 32, D) behind a shuffled table (B, nb), nb*32 = S;
    # the same q, positions and bounds as decode_attention above.  Every
    # slot outside a row's [starts, lengths) holds NaN, in the blocks that
    # hold live slots too: a kernel that reads one fails the check.
    bs = 32
    nb = S // bs
    NB = B * nb
    table = torch.randperm(NB, generator=gen, device=dev).to(torch.int32
                                                              ).reshape(B, nb)
    k_pool, v_pool = randn(NB, Hkv, bs, D), randn(NB, Hkv, bs, D)
    blk = torch.arange(nb, device=dev)[None, :]
    dead = (((blk + 1) * bs <= st32[:, None]) | (blk * bs >= len32[:, None])
            | (len32 <= st32)[:, None])
    dead_slot = ((j < st32[:, None]) | (j >= len32[:, None])).view(B, nb, bs)
    rb, ib, sb = torch.nonzero(dead_slot, as_tuple=True)
    k_pool[table[rb, ib].long(), :, sb] = float("nan")
    v_pool[table[rb, ib].long(), :, sb] = float("nan")
    pargs = (q, k_pool, v_pool, table, qp32, k_pos, len32, st32)
    got = dec_ops.paged_decode_attention(q, k_pool, v_pool, table, q_pos,
                                         k_pos, lengths, starts)
    want = dec_ops.paged_decode_attention_plain(*pargs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(bool(torch.isfinite(got).all()) and err <= ATTN_TOL,
            f"paged_decode_attention: max_abs_err {err} > {ATTN_TOL} or "
            "non-finite (a dead block was read)")
    require(bool((got[:4] == 0).all()) and bool((want[:4] == 0).all()),
            "paged_decode_attention: done rows and the row with no live "
            "slot must come out exactly 0")
    n_live_blocks = int((~dead & row_live[:, None]).sum())

    def two_step():
        kg = roll_ops.paged_gather_cuda(k_pool.view(NB, Hkv * bs, D), table)
        vg = roll_ops.paged_gather_cuda(v_pool.view(NB, Hkv * bs, D), table)
        return dec_ops.decode_attention_cuda(
            q, kg.view(B, nb, Hkv, bs, D).transpose(1, 2).reshape(B, Hkv, S, D),
            vg.view(B, nb, Hkv, bs, D).transpose(1, 2).reshape(B, Hkv, S, D),
            qp32, k_pos, len32, st32)

    record("paged_decode_attention",
           "src/repro_torch/csrc/paged_decode_attention.cu",
           "src/repro/kernels/decode_attention/kernel.py:120", err,
           lambda: dec_ops.paged_decode_attention_cuda(*pargs),
           lambda: dec_ops.paged_decode_attention_plain(*pargs), None,
           nbytes=int(row_live.sum()) * Hq * D * 2 + n_seen * Hkv * D * 2 * 2
           + n_span * 4 + n_live_blocks * 4 + 3 * B * 4 + B * Hq * D * 4,
           flops=4 * n_seen * Hq * D, kernel="paged_decode_kernel",
           two_step=("paged_gather kernels, a transpose copy, the dense "
                     "decode_attention kernel", two_step))
    one_launch("paged_decode_attention")
    del k_pool, v_pool

    # --- cache_slot_write: one admission of 3 requests into the 8-slot ----
    # persistent cache of the slot engine (28 layers x 8 slots x 8 heads,
    # S = P + 2N), the group padded to 8 rows by repeating its row 0, as
    # write_cache_slots flattens it
    L, Bs = 28, SLOTS
    Rd = L * Bs * Hkv
    dst, src = randn(Rd, S, D), randn(Rd, S, D)
    slot_ids = torch.tensor([5, 2, 7] + [5] * (Bs - 3), device=dev)
    r0 = torch.arange(L, device=dev)[:, None, None]
    h = torch.arange(Hkv, device=dev)[None, None, :]
    rows = ((r0 * Bs + slot_ids[None, :, None]) * Hkv + h).reshape(-1)
    src_for_dst = sw_ops._invert_rows(rows, Rd, Rd)
    got, want = dst.clone(), dst.clone()
    sw_ops.cache_slot_write(got, src, rows)
    sw_ops.cache_slot_write_plain(want, src, src_for_dst)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "cache_slot_write differs from its plain "
            "version")
    untouched = src_for_dst < 0
    require(torch.equal(got[untouched], dst[untouched]),
            "cache_slot_write touched a row nobody admitted")
    del got, want
    uniq = torch.nonzero(~untouched).reshape(-1)
    src_sel = src[src_for_dst[uniq].long()]
    row_bytes = S * D * 2
    record("cache_slot_write", "src/repro_torch/csrc/cache_slot_write.cu",
           "src/repro/kernels/cache_slot_write/kernel.py:30", 0.0,
           lambda: sw_ops.cache_slot_write_cuda(dst, src, src_for_dst),
           lambda: sw_ops.cache_slot_write_plain(dst, src, src_for_dst),
           lambda: dst.index_copy_(0, uniq, src_sel),
           nbytes=2 * int(uniq.numel()) * row_bytes + Rd * 4, flops=0.0,
           kernel="slot_write_kernel")
    del dst, src, src_sel
    torch.cuda.empty_cache()

    # --- paged_gather: one pool of the paged compaction (28 layers, 288 ----
    # blocks each, heads folded into the block rows) through the identity
    # stripes of the 16 rows, shuffled
    NBt = 28 * NB
    pool = randn(NBt, Hkv * bs, D)
    gtable = torch.randperm(NBt, generator=gen, device=dev).to(torch.int32
                                                              ).reshape(-1, nb)
    got = roll_ops.paged_gather(pool, gtable)
    want = roll_ops.paged_gather_plain(pool, gtable)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "paged_gather differs from its plain "
            "version")
    del got, want
    flat = gtable.reshape(-1).long()
    record("paged_gather", "src/repro_torch/csrc/paged_gather.cu",
           "src/repro/kernels/cache_gather/kernel.py:63", 0.0,
           lambda: roll_ops.paged_gather_cuda(pool, gtable),
           lambda: roll_ops.paged_gather_plain(pool, gtable),
           lambda: pool.index_select(0, flat),
           nbytes=2 * pool.numel() * 2 + gtable.numel() * 4, flops=0.0,
           kernel="paged_gather_kernel")
    del pool
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the epoch-0 shapes of the two attentions, for the record
    S0 = W
    k0, v0 = randn(B, Hkv, S0, D), randn(B, Hkv, S0, D)
    st0 = (P - p_len).contiguous()
    ln0 = torch.full((B,), P + 1 + step, **i32)
    j0 = torch.arange(S0, **i32)[None, :]
    kp0 = torch.where((j0 >= st0[:, None]) & (j0 < ln0[:, None]),
                      j0 - st0[:, None], torch.full_like(j0, -1))
    qp0 = (ln0 - 1 - st0)[:, None].contiguous()
    qp0[:2] = -1                                             # done rows
    a0 = (q, k0, v0, qp0, kp0, ln0, st0)
    got0 = dec_ops.decode_attention(*a0)
    err0 = float((got0 - dec_ops.decode_attention_plain(*a0)).abs().max())
    require(bool((got0[:2] == 0).all()), "epoch-0 decode: done rows not 0")
    qp_pref = torch.where(col[:, :P] >= pad, col[:, :P] - pad,
                          torch.full_like(col[:, :P], -1)).to(torch.int32)
    kp_pref = torch.full((B, S0), -1, **i32)
    kp_pref[:, :P] = qp_pref
    fa0 = (randn(B, Hq, P, D), k0, v0, qp_pref, kp_pref)
    errf0 = float((fl_ops.flash_attention(*fa0)
                   - fl_ops.flash_attention_plain(*fa0)).abs().max())
    require(err0 <= ATTN_TOL and errf0 <= ATTN_TOL,
            f"epoch-0 shapes: decode err {err0}, flash err {errf0} > {ATTN_TOL}")
    log(f"kernel decode_attention at S={S0}: max_abs_err={err0} "
        f"ms={timer.ms(lambda: dec_ops.decode_attention_cuda(*a0))} "
        "device_ms=" + str(timer.device_ms(
            lambda: dec_ops.decode_attention_cuda(*a0),
            "dense_decode_kernel")[0]))
    vis0 = ((kp_pref[:, None, :] >= 0)
            & (kp_pref[:, None, :] <= qp_pref[:, :, None]))
    mask0 = vis0[:, None].expand(B, Hq, P, S0)
    ms0, lib0 = timer.turns(
        lambda: fl_ops.flash_attention_cuda(*fa0),
        lambda: F.scaled_dot_product_attention(fa0[0], k0, v0,
                                               attn_mask=mask0,
                                               enable_gqa=True))
    log(f"kernel flash_attention at (T, S)=({P}, {S0}): max_abs_err={errf0} "
        f"ms={ms0} library_ms={lib0} (SDPA)")
    del k0, v0, fa0
    for T in DRAFT_TIMED_TS:
        draft_block_timing(torch, timer, gen, records, n, p_len, T)
    decode = wkv_check(torch, timer, gen, p_len, n, record)
    records["wkv"].update(decode)
    steps = mamba_check(torch, timer, gen, p_len, n, record)
    records["mamba_scan"].update(steps)
    return records


def flash_long_case(torch, timer, gen, name, Hq, Hkv, S, D, window,
                    n_rows=1024):
    """flash_attention over one row of S contiguous positions (B = 1, T =
    S), causal, with a sliding ``window`` (0: none), through the public
    wrapper.  The plain version materialises (T, S) scores, so it runs on
    a subset of the query rows (each query's output depends only on its
    own q and the keys): the first and last query tiles, the tiles around
    the window's edge and ``n_rows`` seeded others; within ATTN_TOL there.
    Then the kernel is timed on its own.  Returns (err, ms, bound ms,
    bound_by)."""
    from repro_torch.kernels.flash_attention import ops as fl_ops

    dev = gen.device
    bf = dict(dtype=torch.bfloat16, device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
    q = torch.randn((1, Hq, S, D), generator=gen, **bf)
    k = torch.randn((1, Hkv, S, D), generator=gen, **bf)
    v = torch.randn((1, Hkv, S, D), generator=gen, **bf)
    got = fl_ops.flash_attention(q, k, v, pos.long(), pos, window=window)
    edge = window if window else S // 2
    rows = torch.unique(torch.cat([
        torch.arange(64, device=dev), torch.arange(edge - 64, edge + 64,
                                                   device=dev),
        torch.arange(S - 64, S, device=dev),
        torch.randint(0, S, (n_rows,), generator=gen, device=dev)]))
    want = fl_ops.flash_attention_plain(q[:, :, rows], k, v, pos[:, rows],
                                        pos, window=window)
    torch.cuda.synchronize()
    err = float((got[:, :, rows] - want).abs().max())
    require(bool(torch.isfinite(got).all()) and err <= ATTN_TOL,
            f"flash_attention {name}: max_abs_err {err} > {ATTN_TOL}")
    del want
    ms = timer.ms(lambda: fl_ops.flash_attention_cuda(q, k, v, pos, pos,
                                                      window=window), reps=5)
    t = torch.arange(S, dtype=torch.float64)
    seen = torch.clamp(t + 1, max=window) if window else t + 1
    pairs = float(seen.sum())
    b_ms, b_by = bound(S * Hq * D * 2 + S * Hkv * D * 2 * 2 + 2 * S * 4
                       + S * Hq * D * 4, 4 * D * Hq * pairs)
    log(f"kernel flash_attention {name} (B=1, Hq={Hq}, Hkv={Hkv}, T=S={S}, "
        f"D={D}, window={window}): max_abs_err={err} over {rows.numel()} "
        f"query rows, ms={ms} bound_ms={b_ms} ({b_by})")
    return err, ms, b_ms, b_by


# (S, window) of the long flash cases: mixtral-8x22b's window of 4,096
# past the unwindowed bound and at its max_seq_len (the windowed bound),
# and the unwindowed bound itself
LONG_CASES = ((40_960, 4_096), (65_536, 4_096), (32_768, 0))


def decode_bound(torch, kargs, hkv: int):
    """The least time of a decode call with no window on ``kargs`` (the
    dense kernel's arguments): q of the live queries, the K/V slots some
    query of the row sees, the live span's k_pos, the positions and
    bounds, the float32 output; 2 (Dk + Dv) operations per visible (query
    head, key) pair.  Returns (ms, what bounds it, bytes, operations)."""
    q, _, v, q_pos, k_pos, lengths, starts = kargs
    B, Hq, T, Dk = q.shape
    Dv = v.shape[-1]
    j = torch.arange(k_pos.shape[1], device=q.device)
    span = (j >= starts[:, None]) & (j < lengths[:, None])          # (B, S)
    vis = (span[:, None, :] & (k_pos[:, None, :] >= 0)
           & (k_pos[:, None, :] <= q_pos[:, :, None])
           & (q_pos[:, :, None] >= 0))                              # (B, T, S)
    nbytes = (int((q_pos >= 0).sum()) * Hq * Dk * 2
              + int(vis.any(1).sum()) * hkv * (Dk + Dv) * 2
              + int(span.sum()) * 4 + (B * T + 2 * B) * 4
              + B * Hq * T * Dv * 4)
    flops = 2 * (Dk + Dv) * Hq * int(vis.sum())
    return (*bound(nbytes, flops), nbytes, flops)


def arch_kernel_checks(torch, timer, records):
    """The attention kernels at the head layouts of deepseek-7b (G = 1),
    jamba-v0.1-52b (G = 4), mixtral-8x22b (G = 6), qwen1.5-110b (G = 8) and
    granite-34b (G = 48),
    each against its plain version: the decode kernels, dense and paged,
    at T = 1 (a window of 16 at G = 6) and granite's draft blocks (T = 3
    and 9: G * T = 144 and 432, 9 and 27 query chunks) and a deepseek one
    (T = 9, G * T = 9); flash_attention at G = 1 (one query head a block),
    4, 6, 8 and 48, a window of 16 at the verify shape, and over S = T =
    40,960 and 65,536 (past the 32,768 keys of an unwindowed call, up to
    mixtral's max_seq_len) with mixtral's window of 4,096 and over 32,768
    without one.  Adds each kernel's largest error over these
    cases to its record, and the timed cases' times."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dec_ops

    heads = {arch: (get_config(arch).num_heads, get_config(arch).num_kv_heads)
             for arch in ARCH_LAYERS
             if get_config(arch).attention_kind == "gqa"}  # (Hq, Hkv), D = 128
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    D, S, W = 128, P + 2 * N, P + N
    spans = [(100, 420), (0, S), (37, 291), (250, 250)]
    errs, timed = [], {}
    for arch, (hq, hkv) in heads.items():
        g = hq // hkv
        cases = [(f"G={g} {arch}", 1, [1, 1, 0, 1], 0)]
        if arch == "mixtral-8x22b":
            cases.append((f"G={g} {arch} window 16", 1, [1, 1, 1, 1], 16))
        if arch == "granite-34b":
            cases += [(f"G={g} {arch} draft T={t}", t, [t, t // 2 + 1, 0, t],
                       0) for t in (3, 9)]
        if arch == "deepseek-7b":
            cases.append((f"G={g} {arch} draft T=9", 9, [9, 4, 0, 9], 0))
        for name, t, q_lens, window in cases:
            err, kargs = decode_case(torch, gen, name, hq, hkv, t, S, D,
                                     spans, q_lens, window=window,
                                     block_sizes=(32, 64))
            errs.append(err)
            if arch == "granite-34b" and window == 0:
                ms, plain_ms = timer.turns(
                    lambda: dec_ops.decode_attention_cuda(*kargs),
                    lambda: dec_ops.decode_attention_plain(*kargs))
                b_ms, b_by, _, _ = decode_bound(torch, kargs, hkv)
                timed[f"G={g} T={t}"] = {"ms": ms, "plain_ms": plain_ms,
                                         "bound_ms": b_ms, "bound_by": b_by}
    log(f"kernel decode_attention at granite-34b's G = 48 (B=4, S={S}): "
        f"{json.dumps(timed)}")
    for name in ("decode_attention", "paged_decode_attention"):
        records[name]["archs_max_abs_err"] = max(errs)
    records["decode_attention"]["granite_ms"] = timed
    ferrs = [flash_case(torch, gen, f"G={hq // hkv} {arch}", 4, hq, hkv, W,
                        S, D, [(3, 300), (0, W), (10, 120), (0, 64)])
             for arch, (hq, hkv) in heads.items()]
    hq, hkv = heads["mixtral-8x22b"]
    ferrs.append(flash_case(torch, gen, "mixtral-8x22b window 16", 4, hq, hkv,
                            W, S, D, [(3, 300), (0, W), (10, 120), (0, 64)],
                            window=16))
    long = {}
    for s_long, window in LONG_CASES:
        err, ms, b_ms, b_by = flash_long_case(
            torch, timer, gen, f"S={s_long} window {window}", 6, 1, s_long,
            D, window)
        ferrs.append(err)
        long[f"S={s_long} window {window}"] = {"ms": ms, "bound_ms": b_ms,
                                               "bound_by": b_by}
    records["flash_attention"]["archs_max_abs_err"] = max(ferrs)
    records["flash_attention"]["long_s"] = long
    torch.cuda.empty_cache()


# the modality frontends' flash cases: pixtral-12b's heads unwindowed over
# S = T = 65,536 and its max_seq_len 131,072 (causal, the plain version on
# sampled query rows, REPS cut to what the time limit allows), and
# whisper-tiny's non-causal calls: the encoder over its 1,500 frames, the
# decoder's cross-attention at the prefill (T = P, left pads) and at a
# decode step (T = 1)
FRONTEND_LONG = ((65_536, 5), (131_072, 3))     # (S, reps)
FRONTEND_ROWS = 256                             # sampled query rows


def visible_pairs(torch, q_pos, k_pos, causal: bool) -> float:
    """The (query, key) pairs a call computes on these positions: every
    live key for every query row when non-causal (rows of padding too),
    else the live keys at or below the query's position."""
    live = k_pos >= 0
    if not causal:
        return float((live.sum(1) * q_pos.shape[1]).sum())
    big = torch.iinfo(torch.int64).max
    srt = torch.sort(torch.where(live, k_pos.long(),
                                 torch.full_like(k_pos, big, dtype=torch.int64)),
                     dim=1).values
    return float(torch.searchsorted(srt, q_pos.long().contiguous(),
                                    right=True).sum())


def flash_frontend_case(torch, timer, name, q, k, v, q_pos, k_pos,
                        causal, sdpa, rows=None, reps=REPS):
    """flash_attention on (q, k, v, q_pos, k_pos) through the public wrapper
    against the plain version (on the query ``rows`` only when given, 64
    rows at a time: each query's output depends on its own q and the keys),
    within ATTN_TOL; then the kernel entry and ``sdpa`` (one PyTorch call
    computing the same function) timed in turns, the kernel's device time,
    and its bound: q, k, v, the positions and the float32 output once; 2
    (Dk + Dv) operations per (query head, key) pair the call computes.
    Returns the case's record."""
    from repro_torch.kernels.flash_attention import ops as fl_ops

    B, Hq, T, D = q.shape
    got = fl_ops.flash_attention(q, k, v, q_pos.long(), k_pos,
                                 causal=causal)
    idx = (torch.arange(T, device=q.device) if rows is None else rows)
    err = 0.0
    for lo in range(0, idx.numel(), 64):
        r = idx[lo:lo + 64]
        want = fl_ops.flash_attention_plain(q[:, :, r], k, v, q_pos[:, r],
                                            k_pos, causal=causal)
        err = max(err, float((got[:, :, r] - want).abs().max()))
        del want
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()) and err <= ATTN_TOL,
            f"flash_attention {name}: max_abs_err {err} > {ATTN_TOL}")
    del got

    def kernel():
        return fl_ops.flash_attention_cuda(q, k, v, q_pos, k_pos,
                                           causal=causal)

    ms, sdpa_ms = timer.turns(kernel, sdpa, reps=reps)
    dev_ms, per_call, _ = timer.device_ms(kernel, "flash_kernel", reps=reps)
    require(per_call == 1, f"flash_attention {name}: {per_call} launches a "
            "call")
    pairs = visible_pairs(torch, q_pos, k_pos, causal)
    Dv = v.shape[-1]
    nbytes = (q.numel() * 2 + (k.numel() + v.numel()) * 2
              + (q_pos.numel() + k_pos.numel()) * 4 + B * Hq * T * Dv * 4)
    flops = 2 * (D + Dv) * Hq * pairs
    b_ms, b_by = bound(nbytes, flops)
    rec = {"B": B, "Hq": Hq, "Hkv": k.shape[1], "T": T, "S": k.shape[2],
           "D": D, "Dv": Dv, "causal": causal, "max_abs_err": err,
           "rows_checked": int(idx.numel()), "ms": ms, "device_ms": dev_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "operations": flops, "library_ms": sdpa_ms,
           "library": "scaled_dot_product_attention"}
    log(f"kernel flash_attention {name}: " + json.dumps(rec))
    return rec


def frontend_kernel_checks(torch, timer, records):
    """flash_attention at the frontends' shapes (``FRONTEND_LONG``, and
    whisper-tiny's non-causal encoder, cross-prefill and cross-decode
    calls), each against its plain version and timed beside SDPA; adds
    them to the flash record under ``frontends``."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fl_ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    bf = dict(dtype=torch.bfloat16, device=dev)
    out = {}
    px = get_config("pixtral-12b")
    Hq, Hkv, D = px.num_heads, px.num_kv_heads, px.head_dim
    for S, reps in FRONTEND_LONG:
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
        q = torch.randn((1, Hq, S, D), generator=gen, **bf)
        k = torch.randn((1, Hkv, S, D), generator=gen, **bf)
        v = torch.randn((1, Hkv, S, D), generator=gen, **bf)
        rows = torch.unique(torch.cat([
            torch.arange(64, device=dev),
            torch.arange(S // 2 - 64, S // 2 + 64, device=dev),
            torch.arange(S - 64, S, device=dev),
            torch.randint(0, S, (FRONTEND_ROWS,), generator=gen,
                          device=dev)]))
        # SDPA's flash path takes equal head counts: K/V repeated outside
        # the timed call
        kr = k.repeat_interleave(Hq // Hkv, dim=1)
        vr = v.repeat_interleave(Hq // Hkv, dim=1)
        rec = flash_frontend_case(
            torch, timer, f"pixtral-12b S=T={S}", q, k, v, pos, pos,
            True, lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                         is_causal=True),
            rows=rows, reps=reps)
        # what the per-block scan of all S key positions costs: the same
        # call with every key dead lists no tile, so it only flags the
        # tiles and writes the zero output
        dead = torch.full_like(pos, -1)
        rec["no_live_key_ms"] = timer.ms(
            lambda: fl_ops.flash_attention_cuda(q, k, v, pos, dead),
            reps=reps)
        log(f"kernel flash_attention pixtral-12b S=T={S} with no live key "
            f"(the tile scan and the zero output): {rec['no_live_key_ms']} "
            "ms")
        out[f"pixtral-12b S=T={S}"] = rec
        del q, k, v, kr, vr
        torch.cuda.empty_cache()
    wh = get_config("whisper-tiny")
    Bw, Hw, Dw, Fw = PROMPTS * GROUP, wh.num_heads, wh.resolved_head_dim, \
        wh.encoder_frames
    enc_pos = torch.arange(Fw, dtype=torch.int32, device=dev)[None].expand(
        Bw, Fw).contiguous()
    kv = [torch.randn((Bw, Hw, Fw, Dw), generator=gen, **bf)
          for _ in range(2)]
    qe = torch.randn((Bw, Hw, Fw, Dw), generator=gen, **bf)
    out["whisper-tiny encoder"] = flash_frontend_case(
        torch, timer, "whisper-tiny encoder", qe, *kv, enc_pos, enc_pos,
        False, lambda: F.scaled_dot_product_attention(qe, *kv))
    pads = torch.randint(0, P // 2, (Bw,), generator=gen, device=dev)
    col = torch.arange(P, device=dev)[None]
    q_pos = torch.where(col >= pads[:, None], col - pads[:, None],
                        torch.full_like(col, -1)).to(torch.int32)
    qp = torch.randn((Bw, Hw, P, Dw), generator=gen, **bf)
    out["whisper-tiny cross prefill"] = flash_frontend_case(
        torch, timer, "whisper-tiny cross prefill", qp, *kv, q_pos,
        enc_pos, False, lambda: F.scaled_dot_product_attention(qp, *kv))
    q1 = torch.randn((Bw, Hw, 1, Dw), generator=gen, **bf)
    pos1 = (P - pads[:, None]).to(torch.int32)
    pos1[:2] = -1                                    # done rows
    out["whisper-tiny cross decode"] = flash_frontend_case(
        torch, timer, "whisper-tiny cross decode", q1, *kv, pos1,
        enc_pos, False, lambda: F.scaled_dot_product_attention(q1, *kv))
    records["flash_attention"]["frontends"] = out
    records["flash_attention"]["archs_max_abs_err"] = max(
        records["flash_attention"]["archs_max_abs_err"],
        *(c["max_abs_err"] for c in out.values()))
    del kv, qe, qp, q1
    torch.cuda.empty_cache()


def mla_kernel_checks(torch, timer, records):
    """The two attention kernels at deepseek-v3-671b's MLA shapes (G = 1,
    128 heads, Dk = 192, Dv = 128), each through the public wrapper
    against its plain version within ATTN_TOL, then the kernel entry, the
    plain version and SDPA (one PyTorch call computing the same function,
    over the same K and V with a boolean mask) timed in turns, the
    kernel's device time with one launch a call and nothing else, and its
    bound from the call's data (bytes and operations both recorded):
    ``decode_attention`` at a decode step of the archs traffic (B = 16, S
    = P + 2N; two done rows, a row with no live slot, NaN at every slot
    outside a live span) at each T of ``MLA_DECODE_TS``;
    ``flash_attention`` at the archs verify shape (B = 16, T = S = P +
    ARCHS_N, left pads) and at max_seq_len (B = 1, T = S = 8,192, the
    plain version on sampled query rows).  Adds them to the two kernels'
    records under ``mla``."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dec_ops

    cfg = get_config("deepseek-v3-671b")
    H, dk, dv = (cfg.num_heads, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                 cfg.v_head_dim)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    bf = dict(dtype=torch.bfloat16, device=dev)
    Bm, S = PROMPTS * GROUP, P + 2 * N

    def randn(*shape):
        return torch.randn(shape, generator=gen, **bf)

    decode = {}
    for T in MLA_DECODE_TS:
        starts = torch.randint(0, P, (Bm,), generator=gen, device=dev)
        lengths = torch.randint(S // 2, S + 1, (Bm,), generator=gen,
                                device=dev)
        lengths[2] = starts[2]                       # no live slot
        j = torch.arange(S, device=dev)[None]
        live = (j >= starts[:, None]) & (j < lengths[:, None])
        k_pos = torch.where(live, j - starts[:, None],
                            torch.full_like(j, -1)).to(torch.int32)
        q_pos = ((lengths - starts)[:, None] - T
                 + torch.arange(T, device=dev)[None]).to(torch.int32)
        q_pos[:2] = -1                               # done rows
        q_pos[2] = torch.arange(T, device=dev)       # a query, no key
        q, k, v = randn(Bm, H, T, dk), randn(Bm, H, S, dk), randn(Bm, H, S, dv)
        lv = live[:, None, :, None]
        nan = torch.tensor(float("nan"), **bf)
        k_ok, v_ok = torch.where(lv, k, 0.0), torch.where(lv, v, 0.0)
        kargs = (q, torch.where(lv, k, nan), torch.where(lv, v, nan), q_pos,
                 k_pos, lengths.to(torch.int32), starts.to(torch.int32))
        got = dec_ops.decode_attention(*kargs)
        want = dec_ops.decode_attention_plain(q, k_ok, v_ok, *kargs[3:])
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        vis = (live[:, None, :] & (k_pos[:, None, :] >= 0)
               & (k_pos[:, None, :] <= q_pos[:, :, None]))   # (B, T, S)
        dead = ~vis.any(-1)
        require(tuple(got.shape) == (Bm, H, T, dv)
                and bool(torch.isfinite(got).all()) and err <= ATTN_TOL,
                f"decode_attention MLA T={T}: max_abs_err {err} > {ATTN_TOL} "
                "or non-finite (a slot outside the live span was read)")
        require(bool((got.transpose(1, 2)[dead] == 0).all()),
                f"decode_attention MLA T={T}: queries that see no key must "
                "be exactly 0")
        mask = vis[:, None]

        def kernel(a=kargs):
            return dec_ops.decode_attention_cuda(*a)

        ms, plain_ms, sdpa_ms = timer.turns(
            kernel,
            lambda: dec_ops.decode_attention_plain(q, k_ok, v_ok, *kargs[3:]),
            lambda: F.scaled_dot_product_attention(q, k_ok, v_ok,
                                                   attn_mask=mask))
        dev_ms, per_call, others = timer.device_ms(kernel,
                                                   "dense_decode_kernel")
        require(per_call == 1 and others == 0,
                f"decode_attention MLA T={T}: {per_call} launches and "
                f"{others} other kernels a call")
        b_ms, b_by, nbytes, flops = decode_bound(torch, kargs, H)
        rec = {"B": Bm, "H": H, "T": T, "S": S, "Dk": dk, "Dv": dv,
               "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes, "operations": flops, "library_ms": sdpa_ms,
               "library": "scaled_dot_product_attention"}
        log(f"kernel decode_attention MLA T={T}: " + json.dumps(rec))
        decode[f"T={T}"] = rec
        del q, k, v, k_ok, v_ok, kargs, got, want
    flash = {}
    T = P + ARCHS_N
    pads = torch.randint(0, P // 2, (Bm,), generator=gen, device=dev)
    col = torch.arange(T, device=dev)[None]
    pos = torch.where(col >= pads[:, None], col - pads[:, None],
                      torch.full_like(col, -1)).to(torch.int32)
    q, k, v = randn(Bm, H, T, dk), randn(Bm, H, T, dk), randn(Bm, H, T, dv)
    vis = ((pos[:, None, :] >= 0)
           & (pos[:, None, :] <= pos[:, :, None]))[:, None]   # (B, 1, T, S)
    flash[f"verify T=S={T}"] = flash_frontend_case(
        torch, timer, f"MLA verify T=S={T}", q, k, v, pos, pos, True,
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=vis))
    del q, k, v
    S_long = cfg.max_seq_len
    pos = torch.arange(S_long, dtype=torch.int32, device=dev)[None]
    q, k, v = (randn(1, H, S_long, dk), randn(1, H, S_long, dk),
               randn(1, H, S_long, dv))
    rows = torch.unique(torch.cat([
        torch.arange(64, device=dev),
        torch.arange(S_long // 2 - 64, S_long // 2 + 64, device=dev),
        torch.arange(S_long - 64, S_long, device=dev),
        torch.randint(0, S_long, (FRONTEND_ROWS,), generator=gen,
                      device=dev)]))
    flash[f"T=S={S_long}"] = flash_frontend_case(
        torch, timer, f"MLA T=S={S_long}", q, k, v, pos, pos, True,
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        rows=rows, reps=MLA_LONG_REPS)
    del q, k, v
    records["decode_attention"]["mla"] = decode
    records["flash_attention"]["mla"] = flash
    for name, cases in (("decode_attention", decode),
                        ("flash_attention", flash)):
        records[name]["archs_max_abs_err"] = max(
            records[name]["archs_max_abs_err"],
            *(c["max_abs_err"] for c in cases.values()))
    torch.cuda.empty_cache()


def draft_block_timing(torch, timer, gen, records, n, p_len, T):
    """Both decode kernels at a draft-verify block of T = K + 1 of the
    ``draft`` path's epoch 1 (B = 16, G = 2; T = 9 is two query chunks,
    S = P + 2N + K), each row's block at its own write slot with its own
    draft length (rows 0 and 1 done), against the plain version within
    ``ATTN_TOL``, then timed like T = 1: kernel, plain version and SDPA in
    turns, and its bound from this step's data; at ``DRAFT_PROFILED_T``
    also its ``device_ms`` and one launch a call and nothing else.  The
    paged kernel reads 32-slot pools behind a shuffled table, NaN at every
    slot outside a live span.  Adds the T's entry to each kernel record's
    ``draft_blocks``."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dec_ops

    dev = gen.device
    B, Hq, Hkv, D = PROMPTS * GROUP, 16, 8, 128
    W, K = P + N, T - 1
    S = W + N + K
    step = N // 2
    bf = dict(dtype=torch.bfloat16, device=dev)
    starts = (W - (p_len + n)).to(torch.int32)
    write = torch.full((B,), W + step, dtype=torch.int32, device=dev)
    lengths = write + 1 + K                        # kv_length of draft_step
    eff = torch.randint(0, K + 1, (B,), generator=gen, device=dev)
    t = torch.arange(T, device=dev)[None, :]
    q_pos = torch.where(t <= eff[:, None], (write - starts)[:, None] + t,
                        torch.full_like(t, -1)).to(torch.int32)
    q_pos[:2] = -1                                   # done rows
    j = torch.arange(S, device=dev)[None, :]
    span = (j >= starts[:, None]) & (j < lengths[:, None])
    k_pos = torch.where(span & (j < (write + 1 + eff)[:, None]),
                        j - starts[:, None], torch.full_like(j, -1)
                        ).to(torch.int32)
    q = torch.randn((B, Hq, T, D), generator=gen, **bf)
    k = torch.randn((B, Hkv, S, D), generator=gen, **bf)
    v = torch.randn((B, Hkv, S, D), generator=gen, **bf)
    kargs = (q, k, v, q_pos, k_pos, lengths, starts)
    got = dec_ops.decode_attention(*kargs)
    want = dec_ops.decode_attention_plain(*kargs)
    # the paged pools: NaN at every slot outside a row's live span
    bs = 32
    nb = -(-S // bs)
    NB = B * nb
    table = torch.randperm(NB, generator=gen, device=dev).to(torch.int32
                                                              ).reshape(B, nb)
    pools = []
    for x in (k, v):
        pad = torch.full((B, Hkv, nb * bs, D), float("nan"), **bf)
        pad[:, :, :S] = torch.where(span[:, None, :, None], x,
                                    torch.tensor(float("nan"), **bf))
        pool = torch.empty((NB, Hkv, bs, D), **bf)
        pool[table.reshape(-1).long()] = pad.view(
            B, Hkv, nb, bs, D).transpose(1, 2).reshape(NB, Hkv, bs, D)
        pools.append(pool)
    k_pos_p = F.pad(k_pos, (0, nb * bs - S), value=-1)
    pargs = (q, pools[0], pools[1], table, q_pos, k_pos_p, lengths, starts)
    got_p = dec_ops.paged_decode_attention(q, pools[0], pools[1], table,
                                           q_pos, k_pos, lengths, starts)
    torch.cuda.synchronize()
    vis = (span[:, None, :] & (k_pos[:, None, :] >= 0)
           & (k_pos[:, None, :] <= q_pos[:, :, None]))      # (B, T, S)
    dead = ~vis.any(-1)
    errs = {}
    for what, out in (("decode_attention", got),
                      ("paged_decode_attention", got_p)):
        e = float((out - want).abs().max())
        errs[what] = e
        require(bool(torch.isfinite(out).all()) and e <= ATTN_TOL,
                f"{what} draft block T={T}: max_abs_err {e} > {ATTN_TOL} or "
                "non-finite")
        require(bool((out.transpose(1, 2)[dead] == 0).all()),
                f"{what} draft block T={T}: queries that see no key must be "
                "exactly 0")
    mask = vis[:, None].expand(B, Hq, T, S)
    pairs = int(vis.sum())
    n_seen = int(vis.any(1).sum())
    row_span = span & (q_pos >= 0).any(1)[:, None]
    nbytes = (int((q_pos >= 0).sum()) * Hq * D * 2 + n_seen * Hkv * D * 2 * 2
              + int(row_span.sum()) * 4 + B * T * 4 + 2 * B * 4
              + B * Hq * T * D * 4)
    b_ms, b_by = bound(nbytes, 4 * D * Hq * pairs)
    ms, plain_ms, sdpa_ms = timer.turns(
        lambda: dec_ops.decode_attention_cuda(*kargs),
        lambda: dec_ops.decode_attention_plain(*kargs),
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                               enable_gqa=True))
    pms, pplain_ms = timer.turns(
        lambda: dec_ops.paged_decode_attention_cuda(*pargs),
        lambda: dec_ops.paged_decode_attention_plain(*pargs))
    for what, kern, fn, t_ms, t_plain in (
            ("decode_attention", "dense_decode_kernel",
             lambda: dec_ops.decode_attention_cuda(*kargs), ms, plain_ms),
            ("paged_decode_attention", "paged_decode_kernel",
             lambda: dec_ops.paged_decode_attention_cuda(*pargs), pms,
             pplain_ms)):
        rec = {"T": T, "B": B, "S": S, "max_abs_err": errs[what], "ms": t_ms,
               "plain_ms": t_plain, "sdpa_ms": sdpa_ms, "bound_ms": b_ms,
               "bound_by": b_by, "query_chunks": dec_ops.query_chunks(2 * T)}
        if T == DRAFT_PROFILED_T:
            # the profiler's sessions are kept to one a kernel here
            dev_ms, per_call, others = timer.device_ms(fn, kern)
            require(per_call == 1 and others == 0,
                    f"{what} draft block T={T}: {per_call} launches of its "
                    f"kernel and {others} others a call, want one and "
                    "nothing else")
            rec["device_ms"] = dev_ms
        records[what].setdefault("draft_blocks", {})[T] = rec
        log(f"kernel {what} draft block: " + json.dumps(rec))


def spec_verify_check(torch, sv_ops, args, cover=True):
    """``spec_verify`` on the card, with ``args``' int32 lengths and the
    same as int64, exactly equal to its plain version.  With ``cover`` the
    rows must hold a rejection inside the length, a full accept and a
    rejection that only the length hides, so that each branch of the
    kernel's mask is held (inputs made to hold them; random draws need
    not)."""
    lp_curr, lp_prev, u, vlen, ll = args
    want = sv_ops.spec_verify_plain(*args)
    for what, vl in (("int32", vlen), ("int64", vlen.long())):
        got = sv_ops.spec_verify(lp_curr, lp_prev, u, vl, ll)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"spec_verify {tuple(lp_curr.shape)} "
                f"with {what} valid_len differs: {got} vs {want}")
    B, N = lp_curr.shape
    unmasked = sv_ops.spec_verify_plain(
        lp_curr, lp_prev, u, torch.full_like(vlen, N), ll)
    vl = vlen.long()
    kinds = {"rejected inside": bool(((want > 0) & (want < vl)).any()),
             "all accepted": bool(((want == vl) & (vl > 0)).any()),
             "hidden by the length": bool(((unmasked >= vl) & (unmasked < N)
                                           & (vl > 0)).any())}
    log(f"kernel spec_verify {tuple(lp_curr.shape)}: lengths "
        f"{vl.tolist()}, first rejections {want.tolist()}")
    require(all(kinds.values()) or not cover,
            f"spec_verify {tuple(lp_curr.shape)}: rows lack a case: {kinds}")


WKV_H, WKV_HD = 40, 64     # rwkv6-3b's heads


def wkv_inputs(torch, gen, T, valid, H=WKV_H, hd=WKV_HD):
    """r, k, v, w (B, T, H, hd), u (H, hd) and s0 (B, H, hd, hd) in float32
    on ``gen``'s device, B = ``valid.shape[0]``: w from the model's range
    exp(-exp(-6 + noise)), the pad contract (k = 0, w = 1) where ``valid``
    (B, T) is False, a nonzero state."""
    B = valid.shape[0]
    f32 = dict(dtype=torch.float32, device=gen.device)
    shape = (B, T, H, hd)
    r, k, v = (torch.randn(shape, generator=gen, **f32) for _ in range(3))
    logw = -6.0 + 0.5 * torch.randn(shape, generator=gen, **f32)
    w = torch.exp(-torch.exp(logw))
    vm = valid[:, :, None, None]
    k = torch.where(vm, k, torch.zeros_like(k))
    w = torch.where(vm, w, torch.ones_like(w))
    u = 0.1 * torch.randn((H, hd), generator=gen, **f32)
    s0 = torch.randn((B, H, hd, hd), generator=gen, **f32)
    return r, k, v, w, u, s0


def score_valid(torch, p_len, n):
    """(B, P + N) mask of the epoch-1 score: each row's left-padded prompt
    of ``p_len`` tokens, then its ``n`` draft tokens."""
    col = torch.arange(P + N, device=p_len.device)[None, :]
    return (((col >= P - p_len[:, None]) & (col < P))
            | ((col >= P) & (col < P + n[:, None])))


def wkv_check(torch, timer, gen, p_len, n, record):
    """The RWKV6 recurrence at the rwkv path's shapes (B = 16, H = 40,
    hd = 64) in its three regimes: the epoch-1 verify score (T = P + N, the
    prompt's left pads and the draft's right pads as k = 0, w = 1), the
    epoch-0 prefill (T = P, the prompt's left pads) and a decode step
    (T = 1, one done row), and at the reduced config's hd = 32 (T = 37);
    each from a nonzero state, w drawn from the model's range
    exp(-exp(-6 + noise)); y and the final state (new and written over s0,
    as the cache is) against the plain version.  Each of the three is
    timed and held to one launch a call and no other kernel."""
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

    dev = gen.device
    B = PROMPTS * GROUP

    def check(T, args):
        r, k, v, w, u, s0 = args
        y, s = wkv_ops.wkv(r, k, v, w, u, s0)
        s_in_place = s0.clone()
        y2, _ = wkv_ops.wkv(r, k, v, w, u, s_in_place, s_out=s_in_place)
        want_y, want_s = wkv_ops.wkv_plain(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        err = 0.0
        for got, want, what in ((y, want_y, "y"), (s, want_s, "state"),
                                (y2, want_y, "y (in place)"),
                                (s_in_place, want_s, "state (in place)")):
            e = float((got - want).abs().max())
            scale = float(want.abs().max())
            require(bool(torch.isfinite(got).all()) and e <= WKV_TOL * scale,
                    f"wkv T={T}: {what} max_abs_err {e} > {WKV_TOL} x "
                    f"{scale}")
            err = max(err, e)
        # bytes: r/k/v/w read and y written once, the state read and
        # written; operations the function needs: 5 float32 flops per state
        # element per step (2 for sum_i r_i S_ij, 3 for w_i S_ij + k_i v_j),
        # on the CUDA cores; the u-term, (sum_i r_i u_i k_i) v_j, is O(hd)
        # a step
        nbytes = 5 * r.numel() * 4 + 2 * s0.numel() * 4 + u.numel() * 4
        flops = 5 * r.numel() * r.shape[-1]
        s_out = torch.empty_like(s0)
        return (err, lambda: wkv_ops.wkv_cuda(r, k, v, w, u, s0, s_out),
                lambda: wkv_ops.wkv_plain(r, k, v, w, u, s0), nbytes, flops)

    def one_launch(T, per_call, others):
        require(per_call == 1 and others == 0,
                f"wkv T={T}: {per_call} launches of its kernel and {others} "
                "others a call, want one launch and nothing else")

    # the head dim of the reduced config (the small reference's)
    check(37, wkv_inputs(torch, gen, 37, torch.ones((2, 37), dtype=torch.bool,
                                                    device=dev), H=4, hd=32))
    # rwkv6-3b's head dim with a last ring stage partly filled (T = 70 is
    # not a multiple of the stage's 16 steps), left pads as in a prefill
    check(70, wkv_inputs(torch, gen, 70, torch.arange(70, device=dev)[None, :]
                         >= torch.tensor([[0], [3], [17], [69]], device=dev),
                         H=8))

    err, fn, plain, nbytes, flops = check(
        P + N, wkv_inputs(torch, gen, P + N, score_valid(torch, p_len, n)))
    rec = record("wkv", "src/repro_torch/csrc/wkv.cu",
                 "src/repro/kernels/rwkv6_wkv/kernel.py:53", err, fn, plain,
                 None, nbytes=nbytes, flops=flops, kernel="wkv_",
                 flop_rate=FP32_FLOP_PER_S)
    one_launch(P + N, rec["kernels_per_call"], rec["other_kernels_per_call"])
    del fn, plain
    col = torch.arange(P, device=dev)[None, :]
    valid = {P: col >= P - p_len[:, None],
             1: torch.arange(B, device=dev)[:, None] > 0}    # row 0 done
    extra = {}
    for T, what in ((P, "prefill"), (1, "decode")):
        err_t, fn_t, plain_t, nbytes_t, flops_t = check(
            T, wkv_inputs(torch, gen, T, valid[T]))
        ms_t, plain_ms_t = timer.turns(fn_t, plain_t)
        dev_ms_t, per_call, others = timer.device_ms(fn_t, "wkv_")
        one_launch(T, per_call, others)
        b_t, by_t = bound(nbytes_t, flops_t, FP32_FLOP_PER_S)
        log(f"kernel wkv at T={T}: max_abs_err={err_t} ms={ms_t} "
            f"device_ms={dev_ms_t} plain_ms={plain_ms_t} bound_ms={b_t} "
            f"({by_t}); kernels a call: {per_call} of wkv_, {others} other")
        extra.update({f"{what}_ms": ms_t, f"{what}_device_ms": dev_ms_t,
                      f"{what}_plain_ms": plain_ms_t, f"{what}_bound_ms": b_t,
                      f"{what}_max_abs_err": err_t})
    return extra


MAMBA_DI, MAMBA_DS = 8192, 16     # jamba-v0.1-52b's d_inner and d_state


def mamba_inputs(torch, gen, T, valid, di=MAMBA_DI, ds=MAMBA_DS):
    """dt, u (B, T, di), Bc, Cc (B, T, ds), A (di, ds), D (di,) and a
    nonzero state s (B, di, ds), float32 on ``gen``'s device, B =
    ``valid.shape[0]``: dt a softplus of a normal and 0 where ``valid``
    (B, T) is False (the pad contract), A = -exp(A_log) from the init's
    log(1..ds) jittered, D from a normal."""
    B = valid.shape[0]
    f32 = dict(dtype=torch.float32, device=gen.device)
    dt = torch.nn.functional.softplus(
        torch.randn((B, T, di), generator=gen, **f32) - 1.0)
    dt = torch.where(valid[:, :, None], dt, torch.zeros_like(dt))
    u = torch.randn((B, T, di), generator=gen, **f32)
    Bc, Cc = (torch.randn((B, T, ds), generator=gen, **f32)
              for _ in range(2))
    A = -(torch.arange(1, ds + 1, **f32)[None, :]
          * torch.exp(0.1 * torch.randn((di, ds), generator=gen, **f32)))
    D = torch.randn((di,), generator=gen, **f32)
    s = 0.5 * torch.randn((B, di, ds), generator=gen, **f32)
    return dt, u, Bc, Cc, A, D, s


def mamba_check(torch, timer, gen, p_len, n, record):
    """The selective scan at jamba-v0.1-52b's widths (B = 16, di = 8,192,
    ds = 16) in its three regimes: the verify score (T = P + N, the
    prompt's left pads and the draft's right pads as dt = 0), the prefill
    (T = P, left pads) and a decode step (T = 1, one done row), each from
    a nonzero state, against the plain version: y, and the final state
    written over the input in place; T = P + N also as one call against
    P + N chained T = 1 calls through the state in place.  Each of the
    three is timed and held to one launch a call and no other kernel.
    Returns the record's extra keys."""
    from repro_torch.kernels.mamba_scan import ops as ms_ops

    dev = gen.device
    B = PROMPTS * GROUP

    def check(T, args, chained=False):
        dt, u, Bc, Cc, A, D, s0 = args
        s = s0.clone()
        y = ms_ops.mamba_scan(dt, u, Bc, Cc, A, D, s)
        want_y, want_s = ms_ops.mamba_scan_plain(dt, u, Bc, Cc, A, D, s0)
        outs = [(y, want_y, "y"), (s, want_s, "state (in place)")]
        if chained:
            sc = s0.clone()
            steps = torch.cat([ms_ops.mamba_scan(
                dt[:, t:t + 1].contiguous(), u[:, t:t + 1].contiguous(),
                Bc[:, t:t + 1].contiguous(), Cc[:, t:t + 1].contiguous(), A,
                D, sc) for t in range(T)], dim=1)
            outs += [(steps, want_y, f"y of {T} chained T=1 calls"),
                     (sc, want_s, f"state after {T} chained T=1 calls")]
        torch.cuda.synchronize()
        err = 0.0
        for got, want, what in outs:
            e = float((got - want).abs().max())
            scale = float(want.abs().max())
            require(bool(torch.isfinite(got).all()) and e <= MAMBA_TOL * scale,
                    f"mamba_scan T={T}: {what} max_abs_err {e} > "
                    f"{MAMBA_TOL} x {scale}")
            err = max(err, e)
        log(f"kernel mamba_scan T={T}: max_abs_err={err} (scale "
            f"{float(want_y.abs().max())}, tol {MAMBA_TOL} of it)")
        # bytes: dt, u read and y written, B and C read, the state read and
        # written, A and D read; operations the function needs: an
        # exponential and 6 flops per state element a step (dt A, then
        # exp, (dt u) B, the fused s update and the C sum), on the CUDA
        # cores, the exponential counted as one
        nbytes = (3 * dt.numel() + 2 * Bc.numel() + 2 * s0.numel()
                  + A.numel() + D.numel()) * 4
        flops = 7 * dt.numel() * A.shape[-1]
        s_t = s0.clone()
        return (err, lambda: ms_ops.mamba_scan_cuda(dt, u, Bc, Cc, A, D, s_t),
                lambda: ms_ops.mamba_scan_plain(dt, u, Bc, Cc, A, D, s0),
                nbytes, flops)

    def one_launch(T, per_call, others):
        require(per_call == 1 and others == 0,
                f"mamba_scan T={T}: {per_call} launches of its kernel and "
                f"{others} others a call, want one launch and nothing else")

    # a width off the block's 128 channels and a last time tile part-filled
    check(37, mamba_inputs(torch, gen, 37, torch.ones(
        (2, 37), dtype=torch.bool, device=dev), di=200))
    err, fn, plain, nbytes, flops = check(
        P + N, mamba_inputs(torch, gen, P + N, score_valid(torch, p_len, n)),
        chained=True)
    rec = record("mamba_scan", "src/repro_torch/csrc/mamba_scan.cu",
                 "src/repro/models/mamba.py:101-128 (jax.lax.scan in XLA; "
                 "no Pallas kernel)", err, fn, plain, None, nbytes=nbytes,
                 flops=flops, kernel="mamba_scan_kernel",
                 flop_rate=FP32_FLOP_PER_S)
    one_launch(P + N, rec["kernels_per_call"], rec["other_kernels_per_call"])
    del fn, plain
    col = torch.arange(P, device=dev)[None, :]
    valid = {P: col >= P - p_len[:, None],
             1: torch.arange(B, device=dev)[:, None] > 0}    # row 0 done
    extra = {}
    for T, what in ((P, "prefill"), (1, "decode")):
        err_t, fn_t, plain_t, nbytes_t, flops_t = check(
            T, mamba_inputs(torch, gen, T, valid[T]))
        ms_t, plain_ms_t = timer.turns(fn_t, plain_t)
        dev_ms_t, per_call, others = timer.device_ms(fn_t, "mamba_scan_kernel")
        one_launch(T, per_call, others)
        b_t, by_t = bound(nbytes_t, flops_t, FP32_FLOP_PER_S)
        log(f"kernel mamba_scan at T={T}: max_abs_err={err_t} ms={ms_t} "
            f"device_ms={dev_ms_t} plain_ms={plain_ms_t} bound_ms={b_t} "
            f"({by_t}); kernels a call: {per_call} of mamba_scan_kernel, "
            f"{others} other")
        extra.update({f"{what}_ms": ms_t, f"{what}_device_ms": dev_ms_t,
                      f"{what}_plain_ms": plain_ms_t, f"{what}_bound_ms": b_t,
                      f"{what}_max_abs_err": err_t})
    torch.cuda.empty_cache()
    return extra


# ---------------------------------------------------------------- small ref


def small_reference(torch, arch: str, tol: float, tol_f32=None,
                    title=None, **overrides):
    """The port on the card against the port on the CPU, teacher-forced, at
    a reduced config in bfloat16: forward, prefill and decode steps (and,
    for an attention trunk, the compaction roll), within ``tol``.  Both are
    also held against the CPU's float32 run of the same weights: the card's
    bfloat16 may lie at most ``BF16_GAP`` times as far from it as the CPU's
    does.  With ``tol_f32`` the card runs the float32 model too, held
    against the CPU's within it (only for trunks whose kernels take
    float32).  A MoE trunk is teacher-forced in its routing too: the CPU's
    bfloat16 run records every router call's expert choice (``RouteLog``)
    and the other runs replay it, so a bf16 rounding that tips a near-tied
    top-k choice another way on the card (or in float32) does not part
    the runs; every row is compared, and the count of tokens whose own
    choice the replay overrode is logged.  A frontend is conditioned as
    its path is: pixtral-12b's stub patches in front of the prompt (the
    decode steps over the whole cache, no ``kv_start``; no compaction),
    whisper-tiny's stub frames through ``encode`` on each side (its output
    compared too), its memory at every call."""
    from repro_torch.configs import get_config
    from repro_torch.engine.generate import (positions_from_mask,
                                             prefix_positions)
    from repro_torch.models import model as M
    from repro_torch.models.attention import cache_leaves
    from repro_torch.models.moe import RouteLog

    title = title or arch
    cfg = get_config(arch).reduced(dtype="bfloat16", param_dtype="bfloat16",
                                   **overrides)
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    cpu_model = M.init_lm(cfg, seed=SEED, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    g = torch.Generator().manual_seed(SEED)
    B, Pp, steps = 4, 16, 6
    prompt = torch.randint(3, cfg.vocab_size, (B, Pp), generator=g,
                           dtype=torch.int32)
    mask = torch.ones(B, Pp, dtype=torch.bool)
    for b in range(B):
        mask[b, :b * 3] = False
    nxt = torch.randint(3, cfg.vocab_size, (B, steps), generator=g,
                        dtype=torch.int32)
    shift = torch.tensor([0, 3, 5, 1], dtype=torch.int32)
    Pv = cfg.num_prefix_embeddings
    stub = (torch.randn((B, Pv or cfg.encoder_frames, cfg.d_model),
                        generator=g)
            if Pv or cfg.encoder_layers else None)

    def run(model, dev, cfg, replay=None):
        """[(output on the host, its batch axis)] and the router's log."""
        with RouteLog(replay) as routes:
            pos = positions_from_mask(mask.to(dev))
            outs, step_kw, kw = [], {}, {}
            if cfg.encoder_layers:
                enc, enc_pos = M.encode(model, cfg, stub.to(dev))
                outs.append((enc, 0))
                step_kw = kw = {"encoder_out": enc,
                                "encoder_positions": enc_pos}
            if Pv:
                pos = prefix_positions(pos, Pv)
                kw = {"prefix_embeds": stub.to(dev)}
            outs.append((M.forward(model, cfg, prompt.to(dev), pos, **kw)[0],
                         0))
            caches = M.init_cache(cfg, B, Pv + Pp + 2 * steps, device=dev)
            logits, caches = M.prefill(model, cfg, prompt.to(dev), pos,
                                       caches, **kw)
            outs.append((logits, 0))
            p_len = mask.sum(1).to(torch.int32).to(dev)
            W = Pv + Pp
            for s in range(steps):
                logits, caches = M.decode_step(
                    model, cfg, nxt[:, s:s + 1].to(dev),
                    (p_len + Pv + s)[:, None], caches, W + s,
                    kv_length=W + 1 + s,
                    kv_start=None if Pv else Pp - p_len, **step_kw)
                outs.append((logits, 0))
            if M.supports_cache_realign(cfg) and not Pv:
                width = Pp + steps
                caches = M.realign_decode_cache(
                    cfg, caches, shift.to(dev),
                    p_len + steps - shift.to(dev), width)
                sc = caches[0]["self"]          # k, or MLA's latent ckv
                outs.append((sc[cache_leaves(sc)[0]].float(), 1))
        return [(o.float().cpu(), ax) for o, ax in outs], routes

    want, r_cpu = run(cpu_model, torch.device("cpu"), cfg)
    got, r_card = run(gpu_model, torch.device("cuda"), cfg, r_cpu.calls)
    ref32, r_32 = run(cpu_model.float(), torch.device("cpu"), cfg32,
                      r_cpu.calls)
    require(bool(r_cpu.calls) == bool(cfg.num_experts),
            f"{title}: {len(r_cpu.calls)} router calls logged for "
            f"{cfg.num_experts} experts")

    def max_err(xs, ys):
        return max(float((a - b).abs().max())
                   for (a, _), (b, _) in zip(xs, ys))

    def finite(xs):
        return all(bool(torch.isfinite(a).all()) for a, _ in xs)

    err, cpu_gap, card_gap = (max_err(got, want), max_err(want, ref32),
                              max_err(got, ref32))
    routed = (f"; {len(r_cpu.calls)} router calls replayed, tokens "
              f"rerouted: card {r_card.rerouted}, float32 {r_32.rerouted} "
              f"of {sum(len(c) for c in r_cpu.calls)}"
              if r_cpu.calls else "")
    log(f"small reference (reduced {title}, bf16, card vs CPU): "
        f"max_abs_err={err} tol={tol}; from the CPU's float32: CPU bf16 "
        f"{cpu_gap}, card bf16 {card_gap} (at most {BF16_GAP}x the CPU's)"
        f"{routed}")
    require(finite(got) and err <= tol,
            f"{title}: card vs CPU max_abs_err {err} > {tol} or non-finite")
    require(card_gap <= BF16_GAP * cpu_gap,
            f"{title}: the card's bf16 lies {card_gap} from float32, more "
            f"than {BF16_GAP} x the CPU's {cpu_gap}")
    if tol_f32 is not None:
        got32, _ = run(gpu_model.float(), torch.device("cuda"), cfg32,
                       r_cpu.calls)
        err32 = max_err(got32, ref32)
        log(f"small reference (reduced {title}, float32, card vs CPU): "
            f"max_abs_err={err32} tol={tol_f32}")
        require(finite(got32) and err32 <= tol_f32,
                f"{title}: float32 card vs CPU max_abs_err {err32} > "
                f"{tol_f32} or non-finite")


# ---------------------------------------------------------------- main paths


def cut_depth(model, cfg, layers: int):
    """``model`` cut to its first ``layers`` layers at full width, sharing
    its tensors (no copy), with the config to run it by."""
    cut_cfg = cfg.replace(num_layers=layers)
    cut = copy.copy(model)
    cut._modules = dict(model._modules)     # not the model's own dict
    cut.layers = type(model.layers)(list(model.layers)[:layers])
    cut.cfg = cut_cfg
    return cut, cut_cfg


def setup_model(torch, arch: str = "qwen3-1.7b", dtype=None, layers=None,
                n_new: int = N):
    """A full-width model with random weights from ``SEED`` (in ``dtype``
    for parameters and activations, if given, else the config's), built at
    ``layers`` layers if given (never whole first: mixtral-8x22b's 140.6e9
    parameters do not fit) else at full depth, the prompt batch and the
    generation config (``n_new`` tokens) the rollout paths share."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokenizer import EOS_ID, PAD_ID
    from repro_torch.engine.generate import GenerateConfig
    from repro_torch.models import model as M

    cfg = get_config(arch)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype, param_dtype=dtype)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    t0 = time.perf_counter()
    model = M.init_lm(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"model {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{M.count_params(model)} params in {cfg.param_dtype}, init "
        f"{time.perf_counter() - t0:.2f} s")
    gen = GenerateConfig(max_new_tokens=n_new, temperature=1.0, top_p=1.0,
                         eos_id=EOS_ID, pad_id=PAD_ID)
    return model, cfg, prompt_batch(), gen


def prompt_batch():
    """The smoke's batch: PROMPTS prompts of at most P tokens, GROUP rows
    each."""
    from repro_torch.data.dataset import PromptDataset
    from repro_torch.rewards.mathgen import MathTaskConfig, generate_problems

    problems = generate_problems(MathTaskConfig(num_problems=PROMPTS,
                                                seed=SEED))
    return next(PromptDataset(problems, max_prompt_len=P).epochs(
        PROMPTS, GROUP, 1, shuffle=False))


class Launches(dict):
    """A path's launch counts by kernel, read at the end of the window its
    ``reset_launches`` opened, with the two decode kernels' launches split
    by query block T from the same window (``by_t``) and ``mamba_scan``'s
    by sequence length T (``mamba_by_t``)."""

    def blocks(self, name):
        """Launches of decode kernel ``name`` at T > 1."""
        return sum(c for T, c in self.by_t[name].items() if T > 1)


def read_launches():
    """The counts since the last ``reset_launches``, as ``Launches``."""
    from repro_torch.kernels import (DECODE_LAUNCHES_BY_T, LAUNCHES,
                                     MAMBA_LAUNCHES_BY_T)

    out = Launches(LAUNCHES)
    out.by_t = {name: dict(sorted(by_t.items()))
                for name, by_t in DECODE_LAUNCHES_BY_T.items()}
    out.mamba_by_t = dict(sorted(MAMBA_LAUNCHES_BY_T.items()))
    return out


def rollout_path(torch, label, model, cfg, batch, gen, spec,
                 model_kwargs=None, reset=True):
    """Two rollout epochs (epoch 0 vanilla, epoch 1 speculative: the
    one-pass branch for an attention trunk, else the two-pass one, as for
    a vision prefix) with the launch counts set to 0 just before and read
    just after; checks the outputs and returns (launches, the two
    RolloutBatches).  ``model_kwargs``: the modality extras of every row,
    passed to both epochs; ``reset=False`` keeps the counts (and the peak)
    its caller opened before computing them.  With the draft engine on,
    each epoch line also
    carries its macro-steps, the draft metrics and the decode kernels'
    launches by T."""
    import numpy as np

    from repro_torch.core import RolloutCache, rollout
    from repro_torch.core.spec_rollout import use_one_pass
    from repro_torch.engine.sampling import make_key, split_key
    from repro_torch.kernels import (DECODE_LAUNCHES_BY_T, LAUNCHES,
                                     reset_launches)
    from repro_torch.rewards.verifier import batch_rewards

    N = gen.max_new_tokens
    drafting = spec.draft.enabled
    model_kwargs = model_kwargs or {}

    cache = RolloutCache(history=spec.cache_history, group_size=GROUP)
    key = make_key(SEED)
    if reset:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
    rbs, walls = [], []
    for epoch in (0, 1):
        key, sub = split_key(key)
        before = dict(LAUNCHES)
        by_t = copy.deepcopy(DECODE_LAUNCHES_BY_T)
        te = time.perf_counter()
        with StepSpy() as steps:
            rb = rollout(model, cfg, gen, spec, batch.tokens, batch.mask,
                         batch.cache_keys, cache, sub, epoch, **model_kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - te
        walls.append(wall)
        rewards = batch_rewards(rb.response, rb.length, batch.answers)
        m = rb.metrics
        line = {
            "path": label, "epoch": epoch, "wall_s": wall,
            "n_generated": m["n_generated"], "n_reused": m["n_reused"],
            "accept_rate": m["accept_rate"], "one_pass": m["one_pass"],
            "prefill_passes": m["prefill_passes"],
            "verify_time": m["verify_time"],
            "compact_time": m["compact_time"],
            "decode_time": m["decode_time"],
            "reward_mean": float(rewards.mean())}
        if spec.backfill == "slots":
            line.update(engine_steps=m["engine_steps"],
                        slot_occupancy=m["slot_occupancy"],
                        admissions=m["admissions"])
        if drafting:
            line.update(
                macro_steps=steps.calls,
                draft_accept_rate=m["draft_accept_rate"],
                draft_mean_len=m["draft_mean_len"],
                tokens_per_forward=m["tokens_per_forward"],
                decode_forwards=m["decode_forwards"],
                decode_launches_by_t={
                    name: {T: c - by_t[name].get(T, 0)
                           for T, c in sorted(DECODE_LAUNCHES_BY_T[name].items())
                           if c - by_t[name].get(T, 0)}
                    for name in DECODE_LAUNCHES_BY_T})
        line.update(launches={k: LAUNCHES[k] - before[k] for k in LAUNCHES},
                    n=rb.n.tolist())
        log("epoch " + json.dumps(line))
        rbs.append(rb)
    launches = read_launches()
    launches.wall_s = walls
    log(f"{label} path launches: {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    rb0, rb1 = rbs
    B = PROMPTS * GROUP
    for rb in rbs:
        require(rb.response.shape == (B, N)
                and rb.behaviour_logprobs.shape == (B, N),
                f"{label}: output shapes")
        lp = rb.behaviour_logprobs
        require(np.all(np.isfinite(lp)), f"{label}: non-finite logprobs")
        require(np.all(lp[rb.response_mask] <= 0.0)
                and np.all(lp[~rb.response_mask] == 0.0),
                f"{label}: logprob layout")
        require(np.array_equal(rb.response_mask.sum(1), rb.length),
                f"{label}: response mask vs length")
        require(np.all((rb.response >= 0) & (rb.response < cfg.vocab_size)),
                f"{label}: token ids out of range")
    require(rb0.metrics["one_pass"] == 0.0 and rb0.metrics["n_generated"] > 0,
            f"{label}: epoch 0 was not a vanilla rollout: {rb0.metrics}")
    one_pass = use_one_pass(cfg, spec, model_kwargs)
    want = (1.0, 1.0) if one_pass else (0.0, 2.0)
    require((rb1.metrics["one_pass"], rb1.metrics["prefill_passes"]) == want,
            f"{label}: epoch 1 did not take the "
            f"{'one' if one_pass else 'two'}-pass branch: {rb1.metrics}")
    n = rb1.n
    require(np.any((n > 0) & (n < N)), f"{label}: no partial acceptance: "
            f"n={n}")
    require(int(n.sum()) == rb1.metrics["n_reused"], f"{label}: n vs n_reused")
    for b in range(B):
        nb = int(n[b])
        require(np.array_equal(rb1.response[b, :nb], rb0.response[b, :nb]),
                f"{label}: row {b}: response does not start with its "
                f"draft[:{nb}]")
    # the accepted draft tokens' log-probs under the verify pass against
    # those the epoch-0 decode drew them with (same weights: only rounding
    # separates them, and it drives the rejections)
    reused = np.arange(N)[None, :] < n[:, None]
    gap = np.abs(rb1.behaviour_logprobs - rb0.behaviour_logprobs)[reused]
    log(f"{label}: reused prefix log-prob gap over {gap.size} tokens: "
        f"mean {float(gap.mean())} max {float(gap.max())}")
    return launches, rbs


def main_path(torch, model, cfg, batch, gen):
    """The fixed decode batch's path; then its time breakdown."""
    from repro_torch.core import SpecConfig

    spec = SpecConfig(variant="spec", one_pass="auto", lenience=LENIENCE)
    launches, _ = rollout_path(torch, "rollout", model, cfg, batch, gen, spec)
    for name in ("decode_attention", "flash_attention", "spec_verify",
                 "cache_roll"):
        require(launches[name] > 0, f"kernel {name} was not launched on the "
                "rollout path")
    generate_breakdown(torch, model, cfg, gen, batch)
    return launches


def slots_path(torch, model, cfg, batch, gen):
    """Straggler backfill: the batch drained through the slot engine."""
    from repro_torch.core import SpecConfig

    spec = SpecConfig(variant="spec", one_pass="auto", lenience=LENIENCE,
                      backfill="slots", backfill_slots=SLOTS)
    launches, rbs = rollout_path(torch, "slots", model, cfg, batch, gen, spec)
    B = PROMPTS * GROUP
    for rb in rbs:
        require(rb.metrics["admissions"] == B and
                rb.metrics["backfill_slots"] == SLOTS,
                f"slots: {rb.metrics['admissions']} admissions of {B} rows "
                f"on {rb.metrics['backfill_slots']} slots")
    for name in ("decode_attention", "flash_attention", "spec_verify",
                 "cache_roll", "cache_slot_write"):
        require(launches[name] > 0, f"kernel {name} was not launched on the "
                "slots path")
    return launches, rbs


class EngineSpy:
    """Keeps every engine ``rollout(backfill="slots")`` builds (the
    adapter's ``make_slot_engine`` wrapped for the duration of a ``with``),
    so the paged path can read the engines' allocators and stats."""

    def __init__(self):
        from repro_torch.serving import rl_adapter
        self.module, self.engines = rl_adapter, []

    def __enter__(self):
        self.make = self.module.make_slot_engine

        def spy(*args, **kw):
            self.engines.append(self.make(*args, **kw))
            return self.engines[-1]

        self.module.make_slot_engine = spy
        return self

    def __exit__(self, *exc):
        self.module.make_slot_engine = self.make


def first_difference(a, b):
    """(row, column) of the first element where two (B, N) arrays differ."""
    import numpy as np
    rows, cols = np.nonzero(np.asarray(a) != np.asarray(b))
    if rows.size == 0:
        return None
    i = int(np.argmin(rows * np.asarray(a).shape[1] + cols))
    return int(rows[i]), int(cols[i])


def paged_slots_path(torch, model, cfg, batch, gen, slots_rbs):
    """The ``slots`` path's two epochs over the paged layout: the batch
    drained through the ``PagedSlotEngine`` (epoch 0 vanilla admission with
    copy-on-write GRPO prompt sharing, epoch 1 speculative-prefix admission,
    which never shares).  Its rows must equal the ``slots`` path's."""
    import numpy as np

    from repro_torch.core import SpecConfig
    from repro_torch.serving import PagedSlotEngine

    spec = SpecConfig(variant="spec", one_pass="auto", lenience=LENIENCE,
                      backfill="slots", backfill_slots=SLOTS)
    paged = cfg.replace(cache_layout="paged")
    with EngineSpy() as spy:
        launches, rbs = rollout_path(torch, "paged_slots", model, paged,
                                     batch, gen, spec)
    for name in ("paged_decode_attention", "cache_slot_write",
                 "flash_attention", "spec_verify", "cache_roll"):
        require(launches[name] > 0, f"kernel {name} was not launched on the "
                "paged_slots path")
    require(launches["decode_attention"] == 0, "the paged_slots path "
            f"launched the dense decode kernel {launches['decode_attention']}"
            " times")
    B = PROMPTS * GROUP
    require(len(spy.engines) == 2
            and all(type(e) is PagedSlotEngine for e in spy.engines),
            f"paged_slots: engines {[type(e).__name__ for e in spy.engines]}")
    for epoch, (eng, rb, want) in enumerate(zip(spy.engines, rbs,
                                                slots_rbs)):
        st, a = eng.stats(), eng.allocator
        a.check()
        followers = st["paged_shared_prompt_bytes_saved"] // (
            eng._pb * eng._block_bytes)
        line = {"path": "paged_slots", "epoch": epoch,
                "block_bytes": eng._block_bytes, "blocks_per_row": eng.nb,
                "prompt_blocks": eng._pb, "pool_blocks": a.num_blocks,
                "peak_blocks": a.peak_blocks_in_use,
                "dense_blocks": SLOTS * eng.nb,
                "peak_bytes": st["paged_peak_bytes_in_use"],
                "shared_prompt_bytes_saved":
                    st["paged_shared_prompt_bytes_saved"],
                "leaders": int(st["admitted"] - followers),
                "followers": int(followers), "cow_forks": a.cow_forks,
                "blocks_in_use_after": a.blocks_in_use,
                "admit_time": st["admit_time"],
                "decode_time": st["decode_time"],
                "max_logprob_gap_vs_slots": float(np.abs(
                    rb.behaviour_logprobs - want.behaviour_logprobs).max())}
        log("paged_slots " + json.dumps(line))
        # the whole pool is back: rows freed, registry entries collected
        require(a.blocks_in_use == 0 and not eng._groups,
                f"paged_slots epoch {epoch}: {a.blocks_in_use} blocks in "
                f"use and {len(eng._groups)} registrations after the drain")
        require(a.cow_forks == 0 and a.alloc_failures == 0,
                f"paged_slots epoch {epoch}: {a.cow_forks} forks, "
                f"{a.alloc_failures} allocation failures (P = {P} fills "
                "whole blocks)")
        if epoch == 0:
            saved = (B - PROMPTS) * eng._pb * eng._block_bytes
            require(line["leaders"] == PROMPTS and followers == B - PROMPTS
                    and st["paged_shared_prompt_bytes_saved"] == saved,
                    f"paged_slots epoch 0: {line['leaders']} leaders, "
                    f"{followers} followers, "
                    f"{st['paged_shared_prompt_bytes_saved']} bytes saved "
                    f"(want {PROMPTS}, {B - PROMPTS}, {saved})")
        else:
            require(st["paged_shared_prompt_bytes_saved"] == 0
                    and a.peak_blocks_in_use == SLOTS * eng.nb,
                    f"paged_slots epoch 1: {line}")
        diff = (first_difference(rb.response, want.response)
                or first_difference(rb.length[:, None], want.length[:, None])
                or first_difference(rb.n[:, None], want.n[:, None]))
        require(diff is None, f"paged_slots epoch {epoch}: row {diff and diff[0]}"
                f" differs from the slots path's at column {diff and diff[1]}")
    return launches


class StepSpy:
    """Counts ``draft_step`` calls (the drafted loops' macro-steps) for the
    duration of a ``with``: the fixed-batch loop's name and the module's
    (the slot engine imports it at call time)."""

    def __enter__(self):
        from repro_torch.drafting import engine, step
        self.modules, self.calls = (engine, step), 0
        self.real = step.draft_step

        def spy(*args, **kw):
            self.calls += 1
            return self.real(*args, **kw)

        for mod in self.modules:
            mod.draft_step = spy
        return self

    def __exit__(self, *exc):
        for mod in self.modules:
            mod.draft_step = self.real


def draft_path(torch, model, cfg, batch, gen):
    """The ``rollout`` path's traffic with the draft engine: epoch 0
    through ``drafted_generate``, epoch 1 the one-pass branch continued by
    ``drafted_resume`` (contexts prompt ⊕ draft[:n], the sibling corpus)."""
    from repro_torch.core import SpecConfig
    from repro_torch.drafting import DraftConfig

    spec = SpecConfig(variant="spec", one_pass="auto", lenience=LENIENCE,
                      draft=DraftConfig(kind="ngram", draft_k=DRAFT_K))
    launches, rbs = rollout_path(torch, "draft", model, cfg, batch, gen, spec)
    for name in ("decode_attention", "flash_attention", "spec_verify",
                 "cache_roll"):
        require(launches[name] > 0, f"kernel {name} was not launched on the "
                "draft path")
    for rb in rbs:
        require(rb.metrics["decode_forwards"] > 0,
                f"draft: the drafted loop did not run: {rb.metrics}")
    return launches


def draft_slots_path(torch, model, cfg, batch, gen):
    """The drafted paged slot engine: ``rollout(backfill="slots")`` over
    ``cache_layout="paged"`` with the draft engine (``DRAFT_SLOTS_N``
    tokens a row), so ``paged_decode_attention`` takes the draft blocks."""
    spec, shape = draft_slots_spec()
    paged, gen = shape(cfg, gen)
    launches, rbs = rollout_path(torch, "draft_slots", model, paged, batch,
                                 gen, spec)
    for name in ("paged_decode_attention", "cache_slot_write",
                 "flash_attention", "spec_verify", "cache_roll"):
        require(launches[name] > 0, f"kernel {name} was not launched on the "
                "draft_slots path")
    require(launches["decode_attention"] == 0, "the draft_slots path "
            f"launched the dense decode kernel {launches['decode_attention']}"
            " times")
    for rb in rbs:
        require(rb.metrics["decode_forwards"] > 0
                and rb.metrics["admissions"] == PROMPTS * GROUP,
                f"draft_slots: {rb.metrics}")
    return launches, rbs


def draft_slots_spec():
    """The ``draft_slots`` path's spec, config and generation settings."""
    from dataclasses import replace

    from repro_torch.core import SpecConfig
    from repro_torch.drafting import DraftConfig

    spec = SpecConfig(variant="spec", one_pass="auto", lenience=LENIENCE,
                      backfill="slots", backfill_slots=SLOTS,
                      draft=DraftConfig(kind="ngram", draft_k=DRAFT_K))
    return spec, lambda cfg, gen: (cfg.replace(cache_layout="paged"),
                                   replace(gen, max_new_tokens=DRAFT_SLOTS_N))


OBS_DIR = OUT_DIR / "observatory"


def observatory_path(torch, model, cfg, batch, gen, off_launches, off_rbs):
    """The ``draft_slots`` traffic again, on the same model, inputs and
    keys, with the §11/§14 observatory on: a ledger, a tracer and a
    decision log configured process-global.  The tokens, log-probs and
    ``n`` must equal the observatory-off run's bit for bit, and every
    kernel's launches too; the ledger must conserve every row and split
    each epoch as its metrics do (``REUSED_PREFIX`` = n_reused; FRESH,
    DRAFT_BONUS and DRAFT_ACCEPTED = n_generated; PROMPT and
    SHARED_PROMPT_BLOCK = the prompts); the recompile sentinel must see
    no new call signature (the obs-off run was the same request set); the
    three export files are written under ``chiprun_out/observatory/`` and
    parsed back, and ``launch.analysis attrib`` on the ``events.jsonl``
    must rebuild the in-process attribution.  Returns the launches."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.core import RolloutCache, rollout
    from repro_torch.engine.sampling import make_key, split_key
    from repro_torch.kernels import reset_launches
    from repro_torch.launch import analysis
    from repro_torch.obs import export
    from repro_torch.obs.alerts import compile_counts
    from repro_torch.obs.attrib import build_report, measured_token_cost
    from repro_torch.obs.ledger import CATEGORY_NAMES, DecisionLog, TokenLedger

    spec, shape = draft_slots_spec()
    cfg, gen = shape(cfg, gen)
    B = PROMPTS * GROUP
    led, tracer = TokenLedger(), obs.Tracer(enabled=True)
    decisions, reg = DecisionLog(), obs.MetricsRegistry()
    baseline = compile_counts()
    require(any(baseline.values()), "observatory: the sentinel counted no "
            f"call in the runs before it: {baseline}")
    obs.configure(tracer=tracer, registry=reg, ledger=led,
                  decisions=decisions)
    try:
        cache = RolloutCache(history=spec.cache_history, group_size=GROUP)
        key = make_key(SEED)
        reset_launches()
        rbs, walls, finalized = [], [], 0
        with EngineSpy() as spy:
            for epoch in (0, 1):
                key, sub = split_key(key)
                te = time.perf_counter()
                rb = rollout(model, cfg, gen, spec, batch.tokens, batch.mask,
                             batch.cache_keys, cache, sub, epoch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - te)
                rbs.append(rb)
                # every row is begun again at its admission, so the live
                # rows are this epoch's
                c = led.counts_dict()
                m = rb.metrics
                log("observatory ledger " + json.dumps({
                    "epoch": epoch, "counts": c,
                    "finalized": led.finalized - finalized,
                    "violations": led.violations,
                    "n_reused": m["n_reused"],
                    "n_generated": m["n_generated"]}))
                done = led.finalized - finalized
                require(led.violations == 0 and done == B,
                        f"observatory epoch {epoch}: {done} rows finalized "
                        f"of {B}, {led.violations} violations")
                finalized = led.finalized
                require(c["reused_prefix"] == m["n_reused"]
                        and c["fresh"] + c["draft_bonus"]
                        + c["draft_accepted"] == m["n_generated"]
                        and c["prompt"] + c["shared_prompt_block"]
                        == int(batch.mask.sum()) and c["unset"] == 0,
                        f"observatory epoch {epoch}: ledger {c} against "
                        f"n_reused {m['n_reused']}, n_generated "
                        f"{m['n_generated']}")
                if epoch == 0:
                    require(c["shared_prompt_block"] > 0,
                            f"observatory epoch 0: no shared prompt: {c}")
        launches = read_launches()
        engines = list(spy.engines)
    finally:
        obs.reset()
    grew = {k: (baseline.get(k, 0), v) for k, v in compile_counts().items()
            if v != baseline.get(k, 0)}
    require(not grew, f"observatory: new call signatures on the replayed "
            f"request set: {grew}")
    for epoch, (rb, want) in enumerate(zip(rbs, off_rbs)):
        for name in ("response", "behaviour_logprobs", "length", "n"):
            got, ref = getattr(rb, name), getattr(want, name)
            where = first_difference(np.reshape(got, (len(got), -1)),
                                     np.reshape(ref, (len(ref), -1)))
            require(np.array_equal(got, ref),
                    f"observatory epoch {epoch}: {name} differs from the "
                    f"observatory-off run at {where}")
    require(dict(launches) == dict(off_launches)
            and launches.by_t == off_launches.by_t,
            f"observatory: launches {launches} {launches.by_t} against the "
            f"observatory-off run's {off_launches} {off_launches.by_t}")
    require(len(decisions) > 0, "observatory: no decision record")
    log("observatory wall " + json.dumps({
        "on_s": walls, "off_s": off_launches.wall_s,
        "on_over_off": sum(walls) / sum(off_launches.wall_s)}))

    # the engines' registries (serve.* histograms, ledger gauges) joined
    # to the process-global one, priced as the analysis CLI prices them
    merged = obs.MetricsRegistry.merged([e.metrics_registry()
                                         for e in engines])
    merged.merge(reg)
    flat = merged.as_dict()
    t_tok = measured_token_cost(flat)
    require(t_tok is not None and t_tok > 0, "observatory: no serve.token_ms")
    report = build_report(led, t_tok)
    log("observatory attribution " + json.dumps({
        "counts": report.counts, "saved_s": report.saved_s,
        "t_token_s": t_tok,
        "serve.draft_chunk_ms_mean": flat.get("serve.draft_chunk_ms_mean"),
        "serve.decode_step_ms_mean": flat.get("serve.decode_step_ms_mean"),
        "decision_records": len(decisions)}))
    OBS_DIR.mkdir(parents=True, exist_ok=True)
    report.to_registry(merged)
    export.write_chrome_trace(OBS_DIR / "trace.json", tracer,
                              counters=report.counter_events(sum(walls)))
    export.write_jsonl(OBS_DIR / "events.jsonl", tracer, merged)
    export.write_prometheus(OBS_DIR / "metrics.prom", merged)
    trace = json.loads((OBS_DIR / "trace.json").read_text())
    lanes = {e["args"]["name"] for e in trace["traceEvents"]
             if e["name"] == "thread_name"}
    events = [json.loads(ln) for ln in
              (OBS_DIR / "events.jsonl").read_text().splitlines()]
    prom = {}
    for ln in (OBS_DIR / "metrics.prom").read_text().splitlines():
        if not ln.startswith("#"):
            name, value = ln.rsplit(" ", 1)
            prom[name] = float(value)
    require({"engine", "attrib"} <= lanes
            and any(t.startswith("req/") for t in lanes),
            f"observatory: trace lanes {sorted(lanes)[:8]}")
    require(events[-1]["type"] == "metrics" and len(events) > B,
            f"observatory: {len(events)} events.jsonl records")
    require(prom.get("repro_ledger_tokens_reused_prefix")
            == report.counts["reused_prefix"],
            "observatory: metrics.prom's ledger gauge")
    out = OBS_DIR / "attrib.json"
    analysis.main(["attrib", str(OBS_DIR / "events.jsonl"), "--json",
                   str(out)])
    offline = json.loads(out.read_text())
    require(offline == report.as_dict(), "observatory: launch.analysis "
            f"attrib {offline} against the in-process {report.as_dict()}")
    log("observatory exports " + json.dumps({
        "trace_events": len(trace["traceEvents"]),
        "jsonl_records": len(events), "prom_series": len(prom),
        "lanes": len(lanes), "bytes": {p.name: p.stat().st_size
                                       for p in OBS_DIR.iterdir()}}))
    log(f"observatory: {sum(v for k, v in report.counts.items())} tokens "
        f"in {len(CATEGORY_NAMES)} categories, replay added 0 signatures "
        f"to {sum(baseline.values())}")
    return launches


TRAIN_STAGES = ("reward", "collect", "old_logprob", "ref", "adv",
                "update_actor")


class TrainObservatory:
    """The §11/§14 observatory around the ``train`` path's two
    ``train_step``s: a ledger, a tracer, a decision log and a registry
    configured process-global, and ``AlertManager(default_rules())`` for
    the trainer.  ``check_step`` holds each step to one span per stage and
    an enclosing ``train_step`` on the trainer lane, each stage span
    within 1 ms of its stage timer, and the ledger growing by the
    rollout's ``n_reused`` (``REUSED_PREFIX``) and ``n_generated``
    (``FRESH``) with every row finalized; ``close`` holds the registry's
    ``device.peak_bytes_in_use`` to ``max_memory_allocated()`` read in the
    same window and prints the attribution."""

    def __init__(self, torch, batch):
        from repro_torch import obs
        from repro_torch.obs.alerts import AlertManager, default_rules
        from repro_torch.obs.ledger import DecisionLog, TokenLedger

        self.torch, self.batch, self.obs = torch, batch, obs
        self.ledger, self.tracer = TokenLedger(), obs.Tracer(enabled=True)
        self.registry = obs.MetricsRegistry()
        obs.configure(tracer=self.tracer, registry=self.registry,
                      ledger=self.ledger, decisions=DecisionLog())
        self.alerts = AlertManager(default_rules(), tracer=self.tracer)
        self.prev = {"reused_prefix": 0.0, "fresh": 0.0, "prompt": 0.0}
        self.first = 0

    def trainer_kw(self):
        return {"tracer": self.tracer, "alerts": self.alerts}

    def start_step(self):
        self.first = len(self.tracer.spans)

    def check_step(self, epoch, m):
        B = PROMPTS * GROUP
        spans = [sp for sp in list(self.tracer.spans)[self.first:]
                 if sp.track == "trainer"]
        names = [sp.name for sp in spans]
        gaps = {sp.name: abs(sp.dur - m[f"{sp.name}_time"])
                for sp in spans if sp.name != "train_step"}
        step = [sp for sp in spans if sp.name == "train_step"]
        grew = {k: m[f"ledger_tokens_{k}"] - v for k, v in self.prev.items()}
        log("observatory train " + json.dumps({
            "step": epoch, "spans": names,
            "max_span_gap_s": max(gaps.values(), default=None),
            "ledger": {k: m[k] for k in m if k.startswith("ledger_")},
            "alerts": {k: m[k] for k in m if k.startswith("alerts_")},
            "n_reused": m["n_reused"], "n_generated": m["n_generated"],
            "train_step_s": step[0].dur if step else None}))
        require(sorted(names) == sorted(TRAIN_STAGES + ("train_step",)),
                f"observatory train {epoch}: trainer lane {names}")
        require(max(gaps.values()) <= 1e-3, f"observatory train {epoch}: "
                f"span vs stage timer gaps {gaps}")
        require(all(step[0].t0 <= sp.t0 and sp.t1 <= step[0].t1
                    for sp in spans), f"observatory train {epoch}: a stage "
                "span outside train_step")
        require(m["ledger_violations"] == 0.0
                and m["ledger_finalized"] == B * (epoch + 1)
                and grew["reused_prefix"] == m["n_reused"]
                and grew["fresh"] == m["n_generated"]
                and grew["prompt"] == int(self.batch.mask.sum()),
                f"observatory train {epoch}: ledger grew {grew}, finalized "
                f"{m['ledger_finalized']}, against n_reused {m['n_reused']} "
                f"n_generated {m['n_generated']}")
        self.prev = {k: m[f"ledger_tokens_{k}"] for k in self.prev}

    def close(self):
        from repro_torch.obs.alerts import record_device_memory
        from repro_torch.obs.attrib import build_report, measured_token_cost

        mem = self.obs.MetricsRegistry()
        record_device_memory(mem)
        peak = self.torch.cuda.max_memory_allocated()
        got = mem.as_dict().get("device.peak_bytes_in_use")
        require(got == peak, f"observatory train: device.peak_bytes_in_use "
                f"{got} against max_memory_allocated {peak}")
        led = self.ledger
        require(led.finalized == len(led.rows()) == 2 * PROMPTS * GROUP,
                f"observatory train: {led.finalized} finalized of "
                f"{len(led.rows())} rows")
        flat = self.registry.as_dict()
        report = build_report(led, measured_token_cost(flat))
        log("observatory train attribution " + json.dumps({
            "counts": report.counts, "saved_s": report.saved_s,
            "t_token_s": report.t_token_s, "device.peak_bytes_in_use": got,
            "train.train_step_s_count": flat["train.train_step_s_count"]}))


def greedy_witness(torch, model, cfg, batch, gen):
    """Greedy drafted decoding against greedy vanilla decoding at full size
    (B = 16, ``WITNESS_N`` tokens, no eos).  On the CPU in float32 the two
    streams are equal (tests/test_torch_drafting.py); in bf16 on the card
    the block forward rounds otherwise than the T = 1 step, so a row may
    part where two logits nearly tie.  The phase measures that rounding:
    it teacher-forces the vanilla stream through T = 1 decode steps and
    through blocks of each T in ``WITNESS_TS`` (explicit live bounds, so
    the blocks take the decode kernels, as a draft block does), the gap
    being the largest |block logit - step logit|; it may not pass
    ``WITNESS_GAP_MAX``, so a block route that drifted cannot widen its
    own bar.  Every row must equal the vanilla one up to its first
    difference (``first_difference``); there, the vanilla and the drafted
    token must both lie within the gap of the step's largest logit (so
    the step's top-2 margin does too).  The same holds at every
    teacher-forced position where a block's argmax is not the step's.
    Any other divergence fails."""
    from dataclasses import replace

    import numpy as np

    from repro_torch.drafting import DraftConfig, drafted_generate
    from repro_torch.engine.generate import generate, positions_from_mask
    from repro_torch.engine.sampling import make_key
    from repro_torch.models import model as M

    dev = model.device
    g = replace(gen, max_new_tokens=WITNESS_N, temperature=0.0, eos_id=-1)
    t0 = time.perf_counter()
    van = generate(model, cfg, g, batch.tokens, batch.mask, make_key(SEED))
    torch.cuda.synchronize()
    t_van = time.perf_counter() - t0
    t0 = time.perf_counter()
    with StepSpy() as steps:
        dr = drafted_generate(model, cfg, g, batch.tokens, batch.mask,
                              make_key(SEED),
                              DraftConfig(kind="ngram", draft_k=DRAFT_K))
    torch.cuda.synchronize()
    t_dr = time.perf_counter() - t0
    vt, dt = van["tokens"].cpu().numpy(), dr["tokens"].cpu().numpy()

    # teacher-forced logits of the vanilla stream: column c holds the
    # logits that chose token c (c = 0: the prefill's last)
    prompt = torch.as_tensor(batch.tokens, dtype=torch.int32, device=dev)
    mask = torch.as_tensor(batch.mask, dtype=torch.bool, device=dev)
    B, Pw = prompt.shape
    p_len = mask.sum(1, dtype=torch.int32)
    stream = van["tokens"].to(torch.int32)

    def forced(T):
        caches = M.init_cache(cfg, B, Pw + WITNESS_N + T, device=dev)
        logits, caches = M.prefill(model, cfg, prompt,
                                   positions_from_mask(mask), caches)
        out = [logits[:, -1:].float()]
        del logits
        for s0 in range(0, WITNESS_N - 1, T):
            w = min(T, WITNESS_N - 1 - s0)
            blk = stream[:, s0:s0 + w]
            pos = (p_len[:, None] + s0
                   + torch.arange(w, dtype=torch.int32, device=dev)[None, :])
            start = torch.full((B,), Pw + s0, dtype=torch.int32, device=dev)
            lg, caches = M.decode_step(model, cfg, blk, pos, caches, start,
                                       kv_length=start + w,
                                       kv_start=start - pos[:, 0])
            out.append(lg.float())
        return torch.cat(out, dim=1)                     # (B, N, V)

    step_logits = forced(1)
    top2 = step_logits.topk(2, dim=-1)
    gaps, flips, flip_behind = {}, {}, {}
    for T in WITNESS_TS:
        blk = forced(T)
        gaps[T] = float((blk - step_logits).abs().max())
        # where the block's argmax is not the step's: how far the block's
        # choice lies behind the step's largest logit
        arg = blk.argmax(-1)
        del blk
        flip = arg != top2.indices[..., 0]
        behind = top2.values[..., 0] - step_logits.gather(
            -1, arg[..., None])[..., 0]
        flips[T] = int(flip.sum())
        flip_behind[T] = float(behind[flip].max()) if flips[T] else 0.0
    gap = max(gaps.values())
    require(gap <= WITNESS_GAP_MAX,
            f"greedy witness: block-vs-step logit gap {gaps} passes "
            f"{WITNESS_GAP_MAX}")
    require(max(flip_behind.values()) <= gap,
            f"greedy witness: a block's argmax lies {flip_behind} behind the "
            f"step's largest logit, more than the gap {gap}")
    margin = (top2.values[..., 0] - top2.values[..., 1]).cpu().numpy()
    rows = []
    for b in range(B):
        diff = first_difference(vt[b:b + 1], dt[b:b + 1])
        if diff is None:
            rows.append(None)
            continue
        c = diff[1]
        lc = step_logits[b, c]
        top = float(lc.max())
        behind = {"vanilla": top - float(lc[int(vt[b, c])]),
                  "drafted": top - float(lc[int(dt[b, c])])}
        rows.append({"row": b, "col": c, "margin": float(margin[b, c]),
                     "behind_largest": behind})
        require(max(behind.values()) <= gap,
                f"greedy witness: row {b} parts from the vanilla stream at "
                f"column {c}, where the tokens' step logits lie {behind} "
                f"behind the largest: more than the block-vs-step gap {gap}")
    equal = sum(r is None for r in rows)
    line = {"B": B, "N": WITNESS_N, "vanilla_s": t_van, "drafted_s": t_dr,
            "macro_steps": steps.calls,
            "tokens_per_forward": dr["stats"].tokens_per_forward,
            "draft_accept_rate": dr["stats"].accept_rate,
            "draft_mean_len": dr["stats"].mean_draft_len,
            "gap_by_t": gaps, "gap": gap, "gap_max": WITNESS_GAP_MAX,
            "forced_flips_by_t": flips, "flip_behind_by_t": flip_behind,
            "margin_median": float(np.median(margin)),
            "rows_equal": equal, "parted": [r for r in rows if r]}
    log("greedy witness " + json.dumps(line))
    require(dr["stats"].accepted > 0, "greedy witness: no draft was accepted "
            "(a random model's greedy stream loops, so the n-gram source "
            "should find it)")
    del step_logits, top2


FAULT_N = 64                    # the faults path's tokens per request
FAULT_CHUNK = 8


def faults_path(torch, model, cfg, batch, gen):
    """The §10 layer on the ``PagedSlotEngine``, used directly: 16 requests
    (the batch's 4 groups x 4 siblings), N = 64, 8 slots, three runs — a
    clean one; one under a ``FaultPlan`` with a NaN on a follower and a
    stall that trips its deadline on another (untargeted rows identical to
    the clean run, targeted rows finished after their retries); one killed
    at a chunk boundary, saved with ``save_server_state``, loaded into a
    fresh engine and drained (all 16 responses identical to the clean
    run's, the bf16 pools reloaded bit for bit)."""
    from dataclasses import replace

    import numpy as np

    from repro_torch.checkpoint.io import load_server_state, save_server_state
    from repro_torch.engine.sampling import make_key, request_keys
    from repro_torch.kernels import reset_launches
    from repro_torch.serving import (EngineKilled, FaultEvent, FaultPlan,
                                     PagedSlotEngine, Request)
    from repro_torch.serving.request import (FINISH_BUDGET, FINISH_EOS,
                                             FINISH_FULL_REUSE)

    paged = cfg.replace(cache_layout="paged")
    g = replace(gen, max_new_tokens=FAULT_N)
    B = PROMPTS * GROUP
    keys = request_keys(make_key(SEED + 2), B)
    nan_row, stall_row = 1, 6           # followers of groups 0 and 1
    deadline = 4 * FAULT_N              # a clean row stays FAULT_N + 8 steps

    def engine(faults=None):
        return PagedSlotEngine(model, paged, g, num_slots=SLOTS,
                               prompt_width=P, chunk_steps=FAULT_CHUNK,
                               faults=faults, deadline_steps=deadline)

    def requests():
        return [Request(request_id=i,
                        prompt=batch.tokens[i, P - int(batch.mask[i].sum()):],
                        key=keys[i], max_new_tokens=FAULT_N,
                        group_id=batch.cache_keys[i] // GROUP, max_retries=2)
                for i in range(B)]

    def serve(eng, label):
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        log("faults " + json.dumps({
            "run": label, "wall_s": wall, "engine_steps": st["engine_steps"],
            "generated_tokens": st["generated_tokens"],
            **{k: st[k] for k in st if k.startswith("fault_") and st[k]},
            "retried_requests": st["retried_requests"],
            "paged_peak_blocks": st["paged_peak_blocks_in_use"],
            "paged_cow_forks": st["paged_cow_forks"]}))
        return out, st

    def same(a, b):
        return (a.finish_reason == b.finish_reason and a.length == b.length
                and np.array_equal(a.tokens, b.tokens)
                and np.array_equal(a.logprobs, b.logprobs))

    reset_launches()
    clean_eng = engine()
    for r in requests():
        clean_eng.submit(r)
    clean, _ = serve(clean_eng, "clean")
    require(sorted(clean) == list(range(B)) and all(
        clean[i].finish_reason in (FINISH_EOS, FINISH_BUDGET) for i in clean),
        "faults: the clean run did not finish every request")

    plan = FaultPlan([FaultEvent("nan", at_step=0, request_id=nan_row),
                      FaultEvent("stall", at_step=0, request_id=stall_row,
                                 count=10 ** 6)])
    eng = engine(plan)
    for r in requests():
        eng.submit(r)
    hit, st = serve(eng, "nan+stall")
    success = (FINISH_EOS, FINISH_BUDGET, FINISH_FULL_REUSE)
    for i in range(B):
        if i in (nan_row, stall_row):
            require(hit[i].finish_reason in success and hit[i].retries >= 1,
                    f"faults: targeted row {i} ended {hit[i].finish_reason} "
                    f"after {hit[i].retries} retries")
        else:
            require(same(hit[i], clean[i]) and hit[i].retries == 0,
                    f"faults: untargeted row {i} differs from the clean run")
    require((st["fault_nan_events"], st["fault_quarantines"],
             st["fault_impl_fallbacks"]) == (1, 1, 0)
            and st["fault_timeouts"] >= 1,
            f"faults: counters {st}")
    log("faults: targeted rows equal to the clean run: " + json.dumps(
        {i: same(hit[i], clean[i]) for i in (nan_row, stall_row)}))

    killed = engine(FaultPlan([FaultEvent("kill", at_step=2 * FAULT_CHUNK)]))
    for r in requests():
        killed.submit(r)
    try:
        killed.run()
        raise AssertionError("faults: the kill did not fire")
    except EngineKilled:
        pass
    require(killed.scheduler.num_active > 0 and killed.scheduler.queue,
            "faults: the kill did not land mid-batch")
    OUT_DIR.mkdir(exist_ok=True)
    path = str(OUT_DIR / "faults_snapshot")
    t0 = time.perf_counter()
    save_server_state(path, killed, metadata={"requests": B})
    t_save = time.perf_counter() - t0
    size = sum(Path(path + ext).stat().st_size for ext in (".npz", ".json"))
    resumed = engine()
    t0 = time.perf_counter()
    load_server_state(path, resumed)
    t_load = time.perf_counter() - t0
    for ext in (".npz", ".json"):
        Path(path + ext).unlink()
    words = {2: torch.int16, 4: torch.int32}
    for a, b in zip(killed.caches, resumed.caches):
        for name in ("k", "v"):
            x, y = a["self"][name], b["self"][name]
            require(y.dtype == x.dtype and str(x.dtype).endswith(cfg.dtype)
                    and torch.equal(x.view(words[x.element_size()]),
                                    y.view(words[y.element_size()])),
                    f"faults: the snapshot's {name} pool ({x.dtype}) did "
                    "not reload bit for bit")
    log(f"faults: snapshot at step {killed.steps}: {size} bytes, save "
        f"{t_save:.2f} s, load {t_load:.2f} s")
    resumed_out, _ = serve(resumed, "resumed")
    for i in range(B):
        require(same(resumed_out[i], clean[i]),
                f"faults: resumed row {i} differs from the clean run")
    launches = read_launches()
    log(f"faults path launches: {launches}")
    for name in ("paged_decode_attention", "cache_slot_write",
                 "flash_attention"):
        require(launches[name] > 0, f"kernel {name} was not launched on the "
                "faults path")
    require(launches["decode_attention"] == 0, "the faults path launched "
            "the dense decode kernel")
    return launches


def paged_path(torch, model, cfg, batch, gen):
    """The fixed-batch rollout over the paged KV layout."""
    from repro_torch.core import SpecConfig

    spec = SpecConfig(variant="spec", one_pass="auto", lenience=LENIENCE)
    paged = cfg.replace(cache_layout="paged")
    launches, _ = rollout_path(torch, "paged", model, paged, batch, gen, spec)
    for name in ("paged_decode_attention", "paged_gather", "cache_slot_write",
                 "flash_attention", "spec_verify", "cache_roll"):
        require(launches[name] > 0, f"kernel {name} was not launched on the "
                "paged path")
    require(launches["decode_attention"] == 0, "the paged path launched the "
            f"dense decode kernel {launches['decode_attention']} times")
    return launches


def rwkv_path(torch):
    """Two epochs of full-width rwkv6-3b at ``RWKV_LAYERS`` layers: epoch 0
    vanilla, epoch 1 the two-pass speculative branch (verify score,
    left-align, re-prefill and decode), every T of the recurrence through
    ``wkv``; then its time breakdown.  No attention or cache kernel may
    run.  Then the witnesses in float32, outside the counts: the same two
    epochs, and the consistency of score and decode at ``RWKV_LAYERS``
    layers and at one layer.
    Returns the launches and the ``wkv`` launches by T."""
    from repro_torch.core import SpecConfig
    from repro_torch.kernels import WKV_LAUNCHES_BY_T
    from repro_torch.models import model as M

    model, cfg, batch, gen = setup_model(torch, "rwkv6-3b",
                                         layers=RWKV_LAYERS)
    spec = SpecConfig(variant="spec", one_pass="auto", lenience=LENIENCE)
    launches, rbs = rollout_path(torch, "rwkv", model, cfg, batch, gen, spec)
    by_t = dict(sorted(WKV_LAUNCHES_BY_T.items()))
    log(f"rwkv wkv launches by T: {json.dumps(by_t)}")
    require(sum(by_t.values()) == launches["wkv"],
            f"rwkv path: wkv launches by T {by_t} do not sum to "
            f"{launches['wkv']}")
    require(rbs[1].metrics["n_reused"] > 0, "rwkv: nothing was reused")
    require(launches["wkv"] > 0 and launches["spec_verify"] == 1,
            f"rwkv path: wkv {launches['wkv']} launches, spec_verify "
            f"{launches['spec_verify']} (want > 0 and 1)")
    for name in ("decode_attention", "flash_attention", "cache_roll",
                 "cache_slot_write", "paged_gather", "paged_decode_attention"):
        require(launches[name] == 0, f"rwkv path launched {name} "
                f"{launches[name]} times")
    generate_breakdown(torch, model, cfg, gen, batch)
    del model
    torch.cuda.empty_cache()
    model, cfg32, batch, gen = setup_model(torch, "rwkv6-3b", "float32",
                                           layers=RWKV_LAYERS)
    rollout_path(torch, "rwkv-float32", model, cfg32, batch, gen, spec)
    recurrent_consistency(torch, model, cfg32)
    del model
    torch.cuda.empty_cache()
    one = cfg32.replace(num_layers=1)
    recurrent_consistency(torch, M.init_lm(one, seed=SEED, device="cuda"),
                          one, max_gap=CONSISTENCY_TOL)
    return launches, by_t


def jamba_consistency(torch):
    """``recurrent_consistency`` on jamba-v0.1-52b cut to one layer (Mamba
    + MoE) at full width, in float32 with ``moe_impl="dense"`` (no
    capacity, so no drop parts the score from the decode steps), within
    ``CONSISTENCY_TOL``."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    one = get_config("jamba-v0.1-52b").replace(
        num_layers=1, dtype="float32", param_dtype="float32",
        moe_impl="dense")
    model = M.init_lm(one, seed=SEED, device="cuda")
    recurrent_consistency(torch, model, one, max_gap=CONSISTENCY_TOL)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def recurrent_consistency(torch, model, cfg, max_gap=None):
    """The score of prompt + continuation (the verify's log-probs) against
    the prefill + decode steps' log-probs of the same tokens, as the
    rollout's two epochs draw them; then both again with the plain
    recurrence in place of the kernel (``wkv`` for an RWKV trunk,
    ``mamba_scan`` for a Mamba one), and the score with the embeddings
    nudged by 1e-7.  With ``max_gap``: the kernel's largest gap within it;
    else its mean gap within ``CHAOS_FACTOR`` of the larger of the plain
    recurrence's and the nudge's."""
    from repro_torch.engine.generate import positions_from_mask, score
    from repro_torch.engine.sampling import logprobs_of
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.models import mamba as MB
    from repro_torch.models import model as M
    from repro_torch.models import rwkv as R

    B, C = PROMPTS * GROUP, CONSISTENCY_STEPS
    g = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(3, cfg.vocab_size, (B, P + C), generator=g,
                           dtype=torch.int32).cuda()
    mask = torch.ones(B, P + C, dtype=torch.bool)
    for b in range(B):
        mask[b, :3 * b] = False
    mask = mask.cuda()

    @torch.no_grad()
    def both():
        lp_score = score(model, cfg, tokens, mask)["logprobs"][:, P:]
        pos = positions_from_mask(mask)
        caches = M.init_cache(cfg, B, P + C, device="cuda")
        logits, caches = M.prefill(model, cfg, tokens[:, :P], pos[:, :P],
                                   caches)
        lps = [logprobs_of(logits[:, -1], tokens[:, P])]
        for s in range(C - 1):
            t = P + s
            logits, caches = M.decode_step(model, cfg, tokens[:, t:t + 1],
                                           pos[:, t:t + 1], caches, t)
            lps.append(logprobs_of(logits[:, 0], tokens[:, t + 1]))
        return lp_score, torch.stack(lps, 1)

    def plain_wkv(r, k, v, w, u, s0, s_out=None):
        y, s = wkv_ops.wkv_plain(r, k, v, w, u, s0)
        s_out = torch.empty_like(s0) if s_out is None else s_out
        return y, s_out.copy_(s)

    def plain_mamba(dt, u, Bc, Cc, A, D, s):
        y, s_final = ms_ops.mamba_scan_plain(dt, u, Bc, Cc, A, D, s)
        s.copy_(s_final)
        return y

    label, mod, name, plain = (("jamba", MB, "mamba_scan", plain_mamba)
                               if cfg.block_kind == "mamba" else
                               ("rwkv", R, "wkv", plain_wkv))

    def gap(a, b):
        d = (a - b).abs()
        return float(d.mean()), float(d.max())

    lp_score, lp_dec = both()
    kernel = getattr(mod, name)
    setattr(mod, name, plain)
    try:
        plain_score, plain_dec = both()
    finally:
        setattr(mod, name, kernel)
    embed = model.embed.detach().clone()
    nudge = torch.randn(embed.shape, generator=torch.Generator(
        device="cuda").manual_seed(SEED + 1), device="cuda")
    with torch.no_grad():
        model.embed.mul_(1.0 + 1e-7 * nudge)
        nudged = score(model, cfg, tokens, mask)["logprobs"][:, P:]
        model.embed.copy_(embed)
    gaps = {"kernel": gap(lp_score, lp_dec), "plain": gap(plain_score,
                                                          plain_dec),
            "score_kernel_vs_plain": gap(lp_score, plain_score),
            "score_nudged": gap(lp_score, nudged)}
    log(f"{label} consistency {cfg.param_dtype} L={cfg.num_layers} B={B} "
        f"P={P} steps={C} (mean, max |log-prob| gap): " + json.dumps(gaps))
    require(all(bool(torch.isfinite(x).all()) for x in
                (lp_score, lp_dec, plain_score, plain_dec, nudged)),
            f"{label} consistency: non-finite log-probs")
    if max_gap is not None:
        require(gaps["kernel"][1] <= max_gap,
                f"{label} consistency L={cfg.num_layers}: score vs decode "
                f"{gaps['kernel'][1]} > {max_gap}")
    else:
        floor = max(gaps["plain"][0], gaps["score_nudged"][0])
        require(gaps["kernel"][0] <= CHAOS_FACTOR * floor,
                f"{label} consistency L={cfg.num_layers}: score vs decode "
                f"{gaps['kernel'][0]} > {CHAOS_FACTOR} x {floor}")


def mixed_rewards(B: int, seed: int = SEED):
    """0/1 per row from a seeded generator, every group of GROUP mixed (a
    random model earns 0 everywhere from the verifier, and GRPO's
    advantages, hence its gradient, are then 0)."""
    import numpy as np

    r = np.random.default_rng(seed).integers(0, 2, B).astype(np.float32)
    r[0::GROUP], r[1::GROUP] = 1.0, 0.0
    return r


class GradSpy:
    """Reads each update's gradients as AdamW receives them (``_grad_step``
    drops ``.grad`` once AdamW has stepped): wraps
    ``repro_torch.optim.adamw.update`` while active.  For each of
    ``models`` (label to module; ``None`` entries ignored) it records the
    names of the parameters whose gradient is zero everywhere (``zero``)
    and, with ``keep``, the gradients themselves (``grads``: the witness's
    two-layer models only, never a full-size one)."""

    def __init__(self, torch, models, keep=False):
        self.torch, self.keep = torch, keep
        self.models = {k: m for k, m in models.items() if m is not None}
        self.zero, self.grads = {}, {}

    def __enter__(self):
        from repro_torch.optim import adamw

        label_of = {id(next(m.parameters())): k
                    for k, m in self.models.items()}
        update = adamw.update

        def spy(cfg, params, grads, state, **kw):
            label = label_of[id(params[0])]
            names = [n for n, _ in self.models[label].named_parameters()]
            nonzero = self.torch.stack([g.any() for g in grads]).tolist()
            self.zero[label] = [n for n, ok in zip(names, nonzero) if not ok]
            if self.keep:
                self.grads[label] = list(grads)
            return update(cfg, params, grads, state, **kw)

        self.adamw, self.saved, adamw.update = adamw, update, spy
        return self

    def __exit__(self, *exc):
        self.adamw.update = self.saved


class StageSpy:
    """Counts the kernel launches and the peak memory of each trainer stage:
    wraps the collector's ``collect`` and the trainer module's
    ``_old_logprobs`` (the actor's scoring, then the reference's),
    ``_values``, ``_update_critic`` and ``_update_actor`` while it is
    active, and keeps each stage's return value.  Its ``grads`` (a
    ``GradSpy`` of the actor and the critic) lists, per model, the
    parameters whose latest gradient is zero everywhere."""

    NAMES = ("_old_logprobs", "_values", "_update_critic", "_update_actor")

    def __init__(self, torch, tr, T, keep=False):
        self.torch, self.tr, self.T = torch, tr, T
        self.stages, self.returns = {}, {}
        self.grads = GradSpy(torch, {"actor": tr.model, "critic": tr.critic},
                             keep=keep)

    def _wrap(self, fn, name_of):
        from repro_torch.kernels import LAUNCHES

        torch = self.torch

        def run(*args, **kw):
            name = name_of(args)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = dict(LAUNCHES)
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.stages[name] = {
                "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                             if LAUNCHES[k] != before[k]},
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            self.returns[name] = out
            return out
        return run

    def __enter__(self):
        T, tr = self.T, self.tr
        self.saved = {n: getattr(T, n) for n in self.NAMES}

        def stage_of(n):
            if n == "_old_logprobs":
                return lambda a: "old_logprob" if a[0] is tr.model else "ref"
            return lambda a: n.strip("_")
        for n in self.NAMES:
            setattr(T, n, self._wrap(self.saved[n], stage_of(n)))
        tr.collector.collect = self._wrap(tr.collector.collect,
                                          lambda a: "collect")
        self.grads.__enter__()
        return self

    def __exit__(self, *exc):
        self.grads.__exit__(*exc)
        for n, fn in self.saved.items():
            setattr(self.T, n, fn)
        del self.tr.collector.collect

    def take(self):
        out, self.stages = self.stages, {}
        return out


def check_scoring(label, stages, layers, scorings=("old_logprob", "ref"),
                  updates=("update_actor",), kernel="flash_attention"):
    """The no-grad forwards (the actor's and the reference's scoring, the
    critic's values) launch ``kernel`` (the trunk's T > 1 kernel) once a
    layer and nothing else; the updates launch nothing."""
    for name in scorings:
        got = stages[name]["launches"]
        require(got == {kernel: layers},
                f"{label}: {name} launched {got}, want {kernel} {layers} "
                "times")
    for name in updates:
        require(stages[name]["launches"] == {},
                f"{label}: {name} launched kernels: "
                f"{stages[name]['launches']}")


def make_trainer(cfg, model, algo, trainer_kw=None, **rl_kw):
    """A ``Trainer`` of ``algo`` on ``model`` at the slice's traffic: the
    smoke's prompts, spec with LENIENCE, key ``make_key(SEED)``
    (``trainer_kw``: further ``Trainer`` arguments)."""
    from repro_torch.core import SpecConfig
    from repro_torch.data.dataset import PromptDataset
    from repro_torch.engine.sampling import make_key
    from repro_torch.rewards.mathgen import MathTaskConfig, generate_problems
    from repro_torch.rl import trainer as T

    problems = generate_problems(MathTaskConfig(num_problems=PROMPTS,
                                                seed=SEED))
    rl = T.RLConfig(**{**dict(algo=algo, group_size=GROUP,
                              prompts_per_batch=PROMPTS, max_new_tokens=N),
                       **rl_kw})
    spec = SpecConfig(variant="spec", one_pass="auto", lenience=LENIENCE)
    return T.Trainer(cfg, rl, spec, PromptDataset(problems, max_prompt_len=P),
                     make_key(SEED), model=model, **(trainer_kw or {}))


def stage_line(m, st, keys):
    """A trainer line's fields: the step log's ``keys`` that it has, then
    launches and peak GiB by stage."""
    return {**{k: m[k] for k in keys if k in m},
            "launches": {k: v["launches"] for k, v in st.items()},
            "peak_gib": {k: v["peak_gib"] for k, v in st.items()},
            "step_peak_gib": max(v["peak_gib"] for v in st.values())}


def train_path(torch, model, cfg, batch):
    """The GRPO train step on the full-depth model: two ``train_step``
    calls with the real verifier and the §11/§14 observatory on
    (``TrainObservatory``), then ``optimize`` on the epoch-1 rollout with
    seeded mixed rewards at the default lr and at 1e-3.  Returns the
    launches and the epoch-1 rollout."""
    from repro_torch import obs

    try:
        return _train_path(torch, model, cfg, batch,
                           TrainObservatory(torch, batch))
    finally:
        obs.reset()


def _train_path(torch, model, cfg, batch, watch):
    import numpy as np
    from dataclasses import replace

    from repro_torch.kernels import reset_launches
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.rl import trainer as T

    reset_launches()
    tr = make_trainer(cfg, model, "grpo", trainer_kw=watch.trainer_kw())
    rl = tr.rl
    layers = cfg.num_layers
    with StageSpy(torch, tr, T) as spy:
        for epoch in (0, 1):
            watch.start_step()
            m = tr.train_step(batch)
            watch.check_step(epoch, m)
            st = spy.take()
            log("train " + json.dumps({"step": epoch, **stage_line(m, st, (
                "collect_time", "old_logprob_time", "ref_time", "adv_time",
                "update_actor_time", "loss", "grad_norm", "reward_mean",
                "n_generated", "n_reused", "one_pass", "ratio_mean",
                "approx_kl", "clip_frac", "kl_ref"))}))
            require(np.isfinite(m["loss"]), f"train step {epoch}: loss "
                    f"{m['loss']}")
            check_scoring(f"train step {epoch}", st, layers)
            want = ({"decode_attention", "flash_attention"} if epoch == 0
                    else {"decode_attention", "flash_attention",
                          "spec_verify", "cache_roll"})
            got = set(st["collect"]["launches"])
            require(want <= got, f"train step {epoch}: the rollout "
                    f"launched {sorted(got)}, want {sorted(want)}")
            require(m["one_pass"] == float(epoch), f"train step {epoch}: "
                    f"one_pass {m['one_pass']}")
        watch.close()
        rb1 = tr.last_rb
        rewards = mixed_rewards(rb1.prompt.shape[0])
        for lr in (rl.optim.lr, 1e-3):
            tr.rl = replace(tr.rl, optim=AdamWConfig(lr=lr))
            before = [p.detach().to("cpu", copy=True)
                      for p in model.parameters()]
            m = tr.optimize(rb1, rewards, {})
            st = spy.take()
            changed = sum(int((p.detach().to("cpu") != b).sum())
                          for p, b in zip(model.parameters(), before))
            total = sum(b.numel() for b in before)
            del before
            no_grad = spy.grads.zero["actor"]
            log("train optimize " + json.dumps({
                "lr": lr, "rewards": rewards.tolist(),
                **{k: m[k] for k in (
                    "loss", "grad_norm", "ratio_mean", "approx_kl",
                    "clip_frac", "kl_ref", "entropy", "old_logprob_time",
                    "ref_time", "update_actor_time")},
                "changed_fraction": changed / total,
                "launches": {k: v["launches"] for k, v in st.items()},
                "peak_gib": {k: v["peak_gib"] for k, v in st.items()}}))
            require(np.isfinite(m["loss"]) and m["grad_norm"] > 0,
                    f"train optimize: loss {m['loss']}, grad_norm "
                    f"{m['grad_norm']}")
            require(not no_grad, f"train optimize: no gradient in "
                    f"{no_grad[:5]} ({len(no_grad)} parameters)")
            check_scoring("train optimize", st, layers)
    launches = read_launches()
    log(f"train path launches: {launches}")
    return launches, rb1


PPO_KEYS = ("collect_time", "old_logprob_time", "values_time", "adv_time",
            "update_critic_time", "update_actor_time", "critic_loss",
            "grad_norm", "lr", "loss", "reward_mean", "n_generated",
            "n_reused", "one_pass", "ratio_mean", "approx_kl", "clip_frac",
            "entropy")


def ppo_path(torch, model, cfg, batch, rb1):
    """PPO on the model cut to ``CUT_LAYERS``, with its own full-width
    critic of the same depth: one ``train_step`` (epoch 0 vanilla, the
    verifier's rewards), then ``optimize`` on the GRPO path's epoch-1
    rollout with seeded mixed rewards, so that GAE sees nonzero returns.  Each values pass launches
    flash_attention once a layer and nothing else, the two updates launch
    nothing, every critic parameter gets a nonzero gradient in the
    mixed-reward update.  Step-log ``grad_norm`` and ``lr`` are the
    critic's (as in JAX's); the actor's grad norm is ``_update_actor``'s
    own.  Returns the launches."""
    import numpy as np

    from repro_torch.kernels import reset_launches
    from repro_torch.models import model as M
    from repro_torch.rl import trainer as T

    reset_launches()
    t0 = time.perf_counter()
    tr = make_trainer(cfg, model, "ppo")
    torch.cuda.synchronize()
    n_critic = M.count_params(tr.critic)
    want = (M.count_params(model) - model.lm_head.kernel.numel()
            + cfg.d_model + 1)
    log(f"train ppo: critic {cfg.num_layers} layers, {n_critic} params in "
        f"{cfg.param_dtype} (want {want}), trainer built in "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    require(n_critic == want and tr.ref_model is None,
            f"train ppo: critic of {n_critic} params, want {want}; "
            f"reference model {tr.ref_model is not None}")
    layers = cfg.num_layers
    scorings, updates = ("old_logprob", "values"), ("update_critic",
                                                     "update_actor")
    with StageSpy(torch, tr, T) as spy:
        m = tr.train_step(batch)
        st = spy.take()
        actor = spy.returns["update_actor"]
        log("train ppo " + json.dumps({
            "step": 0, **stage_line(m, st, PPO_KEYS),
            "actor_grad_norm": float(actor["grad_norm"])}))
        require(np.isfinite(m["loss"]) and np.isfinite(m["critic_loss"]),
                f"train ppo: loss {m['loss']}, critic_loss "
                f"{m['critic_loss']}")
        check_scoring("train ppo", st, layers, scorings, updates)
        require(m["one_pass"] == 0.0, f"train ppo: one_pass {m['one_pass']}")

        rewards = mixed_rewards(rb1.prompt.shape[0])
        before = [p.detach().to("cpu", copy=True)
                  for p in tr.critic.parameters()]
        m = tr.optimize(rb1, rewards, {})
        st = spy.take()
        changed = sum(int((p.detach().to("cpu") != b).sum())
                      for p, b in zip(tr.critic.parameters(), before))
        total = sum(b.numel() for b in before)
        del before
        actor = spy.returns["update_actor"]
        log("train ppo optimize " + json.dumps({
            "rewards": rewards.tolist(), **stage_line(m, st, PPO_KEYS),
            "actor_grad_norm": float(actor["grad_norm"]),
            "critic_grad_norm": m["grad_norm"],
            "critic_changed_fraction": changed / total}))
        require(np.isfinite(m["loss"]) and np.isfinite(m["critic_loss"])
                and m["grad_norm"] > 0 and float(actor["grad_norm"]) > 0,
                f"train ppo optimize: loss {m['loss']}, critic_loss "
                f"{m['critic_loss']}, critic grad_norm {m['grad_norm']}, "
                f"actor grad_norm {float(actor['grad_norm'])}")
        for who, no_grad in spy.grads.zero.items():
            require(not no_grad, f"train ppo optimize: no gradient in "
                    f"{no_grad[:5]} ({len(no_grad)} {who} parameters)")
        check_scoring("train ppo optimize", st, layers, scorings, updates)
    launches = read_launches()
    log(f"ppo path launches: {launches}")
    return launches


def dapo_path(torch, model, cfg, batch):
    """DAPO on the model cut to ``CUT_LAYERS``: one ``train_step`` with one
    resample round, ``batch_rewards`` replaced for this step only: the first
    round gives groups 0 and 2 all-zero rewards and groups 1 and 3 mixed
    ones, the resample mixed ones.  Exactly the 8 rows of groups 0 and 2
    are rolled again (through the SPEC-RL cache the first round has just
    filled: the one-pass branch) and merged back; the rows of groups 1 and
    3 stay the first round's.  Returns the launches."""
    import numpy as np

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.rl import trainer as T

    B = batch.tokens.shape[0]
    degenerate = [0, 2]
    redo = np.concatenate([np.arange(g * GROUP, (g + 1) * GROUP)
                           for g in degenerate])
    kept = np.setdiff1d(np.arange(B), redo)
    calls = []

    def stub_rewards(responses, lengths, answers):
        r = mixed_rewards(len(answers))
        if not calls:
            r[redo] = 0.0
        calls.append(len(answers))
        return r

    reset_launches()
    tr = make_trainer(cfg, model, "dapo", max_resample_rounds=1)
    require(tr.ref_model is None and tr.critic is None,
            "train dapo: a reference model or a critic was built")
    rounds = []
    once = tr.collector.rollout_once

    def spy_once(mdl, sub_batch, epoch):
        torch.cuda.synchronize()
        before, t0 = dict(LAUNCHES), time.perf_counter()
        rb = once(mdl, sub_batch, epoch)
        torch.cuda.synchronize()
        rounds.append({
            "rb": rb, "keys": list(sub_batch.cache_keys),
            "wall_s": time.perf_counter() - t0,
            "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                         if LAUNCHES[k] != before[k]}})
        return rb

    tr.collector.rollout_once = spy_once
    real_rewards = T.batch_rewards
    T.batch_rewards = stub_rewards
    try:
        with StageSpy(torch, tr, T) as spy:
            m = tr.train_step(batch)
            st = spy.take()
    finally:
        T.batch_rewards = real_rewards
        del tr.collector.rollout_once
    first, again = (rounds + [None, None])[:2]
    log("train dapo " + json.dumps({
        "step": 0, **stage_line(m, st, (
            "collect_time", "reward_time", "old_logprob_time", "adv_time",
            "update_actor_time", "loss", "grad_norm", "reward_mean",
            "n_generated", "n_reused", "gen_steps", "ratio_mean",
            "approx_kl", "clip_frac")),
        "rounds": [{"rows": len(r["keys"]), "wall_s": r["wall_s"],
                    **{k: r["rb"].metrics[k] for k in (
                        "n_generated", "n_reused", "one_pass",
                        "verify_time", "compact_time", "decode_time")
                       if k in r["rb"].metrics},
                    "launches": r["launches"]} for r in rounds]}))
    require(len(rounds) == 2 and calls == [B, len(redo)],
            f"train dapo: {len(rounds)} rollout rounds, rewards for "
            f"{calls} rows; want 2 rounds, {B} then {len(redo)} rows")
    require(again["keys"] == [batch.cache_keys[i] for i in redo],
            f"train dapo: the resample rolled {again['keys']}")
    got, a, b = tr.last_rb, again["rb"], first["rb"]
    for name in ("response", "response_mask", "behaviour_logprobs",
                 "length"):
        require(np.array_equal(getattr(got, name)[redo], getattr(a, name))
                and np.array_equal(getattr(got, name)[kept],
                                   getattr(b, name)[kept]),
                f"train dapo: merged {name} is not the resample's rows "
                f"{redo.tolist()} and the first round's rows "
                f"{kept.tolist()}")
    require(m["n_generated"] == b.metrics["n_generated"]
            + a.metrics["n_generated"] and m["gen_steps"] == 2,
            f"train dapo: n_generated {m['n_generated']}, gen_steps "
            f"{m['gen_steps']}")
    require(a.metrics["one_pass"] == 1.0
            and again["launches"].get("spec_verify") == 1
            and again["launches"].get("cache_roll", 0) > 0,
            f"train dapo: the resample took one_pass "
            f"{a.metrics['one_pass']}, launched {again['launches']}")
    require(np.isfinite(m["loss"]) and m["grad_norm"] > 0,
            f"train dapo: loss {m['loss']}, grad_norm {m['grad_norm']}")
    check_scoring("train dapo", st, cfg.num_layers, ("old_logprob",))
    launches = read_launches()
    log(f"dapo path launches: {launches}")
    return launches


# the async path (§12): ASYNC_SCHEDULE lets three collections land under
# version 0 before the first consumer step, so the three steps consume
# trajectories 0, 1 and 2 versions old: exact, IS-corrected (within the
# window ASYNC_K) and re-verified (past it)
ASYNC_SCHEDULE, ASYNC_K, ASYNC_CAPACITY, ASYNC_STEPS = "pppccc", 1, 4, 3
ASYNC_KEYS = ("collect_time", "old_logprob_time", "ref_time", "adv_time",
              "update_actor_time", "loss", "grad_norm", "reward_mean",
              "n_generated", "n_reused", "one_pass", "is_weight_mean",
              "reverified", "traj_version", "policy_version")


def same_weights(torch, label, got, want):
    """Every tensor of ``got`` (name → tensor) equal to ``want``'s bit for
    bit, and none sharing storage with it."""
    require(set(got) == set(want), f"{label}: parameter names differ")
    shared = [n for n in want if got[n].data_ptr() == want[n].data_ptr()]
    require(not shared, f"{label}: {len(shared)} tensors share storage "
            f"with the trainer's, e.g. {shared[:3]}")
    off = [n for n in want if not torch.equal(got[n].to(want[n].device),
                                              want[n])]
    require(not off, f"{label}: {len(off)} tensors differ from the "
            f"trainer's, e.g. {off[:3]}")


def async_path(torch, model, cfg, batch):
    """The async rollout ↔ train seam on the model cut to ``ASYNC_LAYERS``: a
    fresh GRPO ``make_trainer`` under ``AsyncTrainer`` (``ASYNC_SCHEDULE``, window
    ``ASYNC_K``) for ``ASYNC_STEPS`` consumer steps.  The rollout service
    samples with its own copy of the weights: at the bootstrap install and
    at each publish the served (or published) weights must equal the
    trainer's bit for bit and share no storage with them.  One line per
    producer tick and per consumer step (staleness, branch, work, stage
    split, peak GiB by stage), then the loop's counters.  Returns the
    launches."""
    import numpy as np

    from repro_torch.kernels import reset_launches
    from repro_torch.rl import trainer as T
    from repro_torch.rl.async_loop import AsyncConfig, AsyncTrainer

    tr = make_trainer(cfg, model, "grpo")
    trained = dict(tr.model.named_parameters())
    with StageSpy(torch, tr, T) as spy:
        at = AsyncTrainer(tr, AsyncConfig(
            staleness_window=ASYNC_K, buffer_capacity=ASYNC_CAPACITY,
            schedule=ASYNC_SCHEDULE))
        same_weights(torch, "async bootstrap install",
                     dict(at.service.model.named_parameters()), trained)
        served = sum(p.numel() * p.element_size()
                     for p in at.service.model.parameters())
        log(f"async: the served copy holds {served} bytes")
        publish, tick, consume = (at.sync.publish, at.producer_tick,
                                  at.consumer_step)
        at._reverify = spy._wrap(at._reverify, lambda a: "reverify")
        published = []

        def spy_publish(mdl, version):
            ok = publish(mdl, version)
            require(ok, f"async: publish of version {version} failed")
            same_weights(torch, f"async publish v{version}",
                         at.sync.poll()[1], trained)
            published.append(version)
            return ok

        def spy_tick():
            t0 = time.perf_counter()
            ok = tick()
            st = spy.take()
            traj = at.buffer._q[-1] if ok else None
            log("async produce " + json.dumps({
                "tick": at.service.ticks - 1, "produced": ok,
                "wall_s": time.perf_counter() - t0,
                **({} if traj is None else {
                    "version": traj.version,
                    **{k: traj.rb.metrics[k] for k in (
                        "n_generated", "n_reused", "one_pass",
                        "collect_time") if k in traj.rb.metrics}}),
                "launches": {k: v["launches"] for k, v in st.items()},
                "peak_gib": {k: v["peak_gib"] for k, v in st.items()}}))
            return ok

        steps = []

        def spy_consume():
            m = consume()
            if m is None:
                return m
            st = spy.take()
            branch = ("reverify" if m.get("reverified") else
                      "is" if m["staleness"] > 0 else "exact")
            steps.append((branch, m, st))
            log("async step " + json.dumps({
                "step": len(steps) - 1, "staleness": m["staleness"],
                "branch": branch, **stage_line(m, st, ASYNC_KEYS)}))
            return m

        at.sync.publish = spy_publish
        at.producer_tick, at.consumer_step = spy_tick, spy_consume
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out = at.run(ASYNC_STEPS)
        launches = read_launches()
    log("async counters " + json.dumps(at.counters()))
    log(f"async path launches: {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require([b for b, _, _ in steps] == ["exact", "is", "reverify"]
            and [m["staleness"] for m in out] == [0.0, 1.0, 2.0],
            f"async: steps {[(b, m['staleness']) for b, m, _ in steps]}, "
            "want one exact, one IS-corrected and one re-verified")
    require((at.exact_steps, at.is_steps, at.reverified) == (1, 1, 1),
            f"async: counters {at.counters()}")
    require(all(np.isfinite(m["loss"]) for m in out),
            f"async: losses {[m['loss'] for m in out]}")
    require("is_weight_mean" in out[1] and "is_weight_mean" not in out[0],
            "async: the IS step carries no is_weight_mean")
    require(out[2]["one_pass"] == 1.0 and "reverify" in steps[2][2],
            f"async: the re-verify took one_pass {out[2]['one_pass']}")
    require(published == [1, 2, 3], f"async: published {published}")
    for name in ("decode_attention", "flash_attention", "spec_verify",
                 "cache_roll"):
        require(launches[name] > 0, f"kernel {name} was not launched on the "
                "async path")
    check_scoring("async", {k: v for _, _, st in steps for k, v in
                            st.items()}, cfg.num_layers)
    return launches


# the watchdog path (§10) cuts the depth to WATCHDOG_LAYERS at full width:
# a full-size snapshot is 2,031,739,904 x (2 + 4 + 4) B, about 20.3 GB of
# bf16 weights and float32 moments to write and read back (worked out from
# the code, not measured); at 4 layers it is about 8.2 GB (the
# vocabulary's tables are most of it)
WATCHDOG_LAYERS = 4


def watchdog_path(torch, cfg, batch):
    """The trainer watchdog on the qwen3-1.7b model cut to
    ``WATCHDOG_LAYERS`` layers (full width, weights from ``SEED``): one
    healthy GRPO step under ``TrainWatchdog(snapshot_every=1)`` (it
    snapshots), every parameter poisoned with NaN in place, ``after_step``
    with a NaN loss; the restore must bring back every parameter and
    moment bit for bit into the same tensors, leave ``step_idx`` where it
    was, and the next ``train_step`` must have a finite loss.  The
    snapshot lives in a temporary directory under ``chiprun_out/``,
    removed after.  Returns the launches."""
    import tempfile

    import numpy as np

    from repro_torch.kernels import reset_launches
    from repro_torch.models import model as M
    from repro_torch.rl.watchdog import TrainWatchdog, WatchdogConfig

    cut = cfg.replace(num_layers=WATCHDOG_LAYERS)
    model = M.init_lm(cut, seed=SEED, device="cuda")
    reset_launches()
    OUT_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR, prefix="watchdog_") as d:
        wd = TrainWatchdog(WatchdogConfig(checkpoint_dir=d,
                                          snapshot_every=1))
        tr = make_trainer(cut, model, "grpo")
        tr.watchdog = wd
        saves, loads = [], []
        snapshot, restore = wd.snapshot, wd.restore

        def timed(fn, out):
            def run(trainer):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fn(trainer)
                torch.cuda.synchronize()
                out.append(time.perf_counter() - t0)
                return r
            return run

        wd.snapshot, wd.restore = timed(snapshot, saves), timed(restore,
                                                                 loads)
        m0 = tr.train_step(batch)
        require(np.isfinite(m0["loss"]) and wd.snapshots == 1,
                f"watchdog: healthy step loss {m0['loss']}, "
                f"{wd.snapshots} snapshots")
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for f in os.listdir(d))
        good = [p.detach().clone() for p in model.parameters()]
        moments = [t.clone() for t in tr.opt_state["mu"]
                   + tr.opt_state["nu"]]
        ptrs = [p.data_ptr() for p in model.parameters()]
        step_idx = tr.step_idx
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(float("nan"))
            for t in tr.opt_state["mu"] + tr.opt_state["nu"]:
                t.fill_(float("nan"))
        verdict = {"loss": float("nan"), "reward_mean": 0.0}
        wd.after_step(tr, verdict)
        require(verdict.get("watchdog_restored") == 1.0
                and wd.nonfinite_steps == 1,
                f"watchdog: no restore after a NaN loss: {verdict}")
        require(tr.model is model
                and [p.data_ptr() for p in model.parameters()] == ptrs,
                "watchdog: the restore did not write into the live model")
        off = sum(not torch.equal(a, b) for a, b in zip(
            model.parameters(), good))
        off_m = sum(not torch.equal(a, b) for a, b in zip(
            tr.opt_state["mu"] + tr.opt_state["nu"], moments))
        require(off == 0 and off_m == 0,
                f"watchdog: {off} parameters and {off_m} moments differ "
                "from the snapshot after the restore")
        require(tr.step_idx == step_idx, f"watchdog: step_idx rolled back "
                f"to {tr.step_idx} from {step_idx}")
        del good, moments
        m1 = tr.train_step(batch)
        require(np.isfinite(m1["loss"]), f"watchdog: the step after the "
                f"restore has loss {m1['loss']}")
        log("watchdog " + json.dumps({
            "layers": WATCHDOG_LAYERS, "params": M.count_params(model),
            "snapshot_bytes": nbytes, "save_s": saves, "load_s": loads,
            "loss_before": m0["loss"], "loss_after": m1["loss"],
            "step_idx": tr.step_idx,
            **{k: v for k, v in m1.items() if k.startswith("watchdog_")}}))
    launches = read_launches()
    log(f"watchdog path launches: {launches}")
    for name in ("decode_attention", "flash_attention"):
        require(launches[name] > 0, f"kernel {name} was not launched on the "
                "watchdog path")
    return launches


def update_tol(p0, g, lr, scale, eps=1e-8, noise=GRAD_NOISE, gmax=None):
    """Tolerance of a parameter after AdamW's first step from a gradient
    ``g`` known within δ = noise · max|g·scale| (GRAD_NOISE unless a
    caller bounds the gradient otherwise): 1e-6 of the update's operands
    (|p| + lr; p - lr·... cancels where p ≈ lr) plus at most 2δ·eps / (m + eps)² of g / (|g| +
    eps), m = |g·scale| - δ, and at most 2 (a sign); the same rule as
    tests/test_torch_train.py's.  ``gmax``: max|g| of the whole tensor,
    when ``g`` is a block of it."""
    gs = g.abs() * scale
    delta = noise * (float(gs.max()) if gmax is None else gmax * scale)
    m = (gs - delta).clamp_min(0.0)
    return (PARAM_RTOL * (p0.abs() + lr)
            + lr * (2 * delta * eps / (m + eps) ** 2).clamp_max(2.0))


def compare_update(gpu_params, cpu_params, grads, prior, grad_norm):
    """One AdamW step on the card against the same step on the CPU, with
    ``grads`` a ``GradSpy`` that kept both ("card", "cpu"): (the largest
    gradient error over a tensor's largest gradient, the parameter
    elements outside ``update_tol``, the worst error over its
    tolerance).  The float64 arithmetic runs on the card (the CPU's
    tensors copied there): the same numbers, without the CPU's minutes
    over the vocabulary's tables."""
    scale = min(1.0, 1.0 / (grad_norm + 1e-9))
    worst, n_bad, grad_err = 0.0, 0, 0.0
    for pg, pc, gg, gc, p0 in zip(gpu_params, cpu_params, grads.grads["card"],
                                  grads.grads["cpu"], prior):
        dev = pg.device
        g_cpu = gc.detach().to(dev).double()
        g_err = float((gg.detach().double() - g_cpu).abs().max())
        grad_err = max(grad_err, g_err / float(g_cpu.abs().max()))
        d = (pg.detach().double() - pc.detach().to(dev).double()).abs()
        tol = update_tol(p0.to(dev).double(), g_cpu, WITNESS_LR, scale)
        n_bad += int((d > tol).sum())
        worst = max(worst, float((d / tol).max()))
    return grad_err, n_bad, worst


def train_witness(torch, rb):
    """The updates' numbers in float32: two layers at qwen3-1.7b's widths,
    seeded weights, the first WITNESS_ROWS rows of the epoch-1 rollout cut
    to WITNESS_COLS response columns, seeded mixed rewards.  The actor: the
    CPU runs the whole ``Trainer.optimize``; the card runs the actor update
    on the same weights with the CPU's old-policy and reference log-probs
    (its own scoring would run the flash_attention kernel, which takes
    bfloat16 only).  The critic: the CPU's values (the old values) and the
    GAE returns of the same rewards, then ``_update_critic`` on the CPU and
    on the card from the same critic.  Losses, grad norms, every gradient
    and every updated parameter agree within the CPU parity test's
    tolerances, the card's ratio is within RATIO_TOL of 1, and neither
    update launches a kernel on the card.  The card's bfloat16 values (the
    values pass of the ``ppo`` path, through flash_attention) lie within
    SMALL_TOL of the CPU's bfloat16 ones, and at most BF16_GAP times as far
    from the float32 values as the CPU's."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import SpecConfig
    from repro_torch.core.spec_rollout import RolloutBatch
    from repro_torch.data.dataset import PromptDataset
    from repro_torch.engine.sampling import make_key
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.rewards.mathgen import MathTaskConfig, generate_problems
    from repro_torch.rl import trainer as T
    from repro_torch.rl.advantages import group_relative_advantages

    cfg = get_config("qwen3-1.7b").replace(
        num_layers=WITNESS_LAYERS, dtype="float32", param_dtype="float32")
    r, c = WITNESS_ROWS, WITNESS_COLS
    sub = RolloutBatch(
        prompt=rb.prompt[:r], prompt_mask=rb.prompt_mask[:r],
        response=rb.response[:r, :c], response_mask=rb.response_mask[:r, :c],
        behaviour_logprobs=rb.behaviour_logprobs[:r, :c],
        length=np.minimum(rb.length[:r], c), metrics={})
    rewards = mixed_rewards(r)
    problems = generate_problems(MathTaskConfig(num_problems=PROMPTS,
                                                seed=SEED))
    rl = T.RLConfig(group_size=GROUP, prompts_per_batch=r // GROUP,
                    max_new_tokens=c, optim=AdamWConfig(lr=WITNESS_LR))
    t0 = time.perf_counter()
    cpu_model = M.init_lm(cfg, seed=SEED, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    cpu_tr = T.Trainer(cfg, rl, SpecConfig(lenience=LENIENCE),
                       PromptDataset(problems, max_prompt_len=P),
                       make_key(SEED, "cpu"), model=cpu_model)
    prior = [p.detach().clone() for p in cpu_model.parameters()]
    scored = []
    score = T._old_logprobs
    T._old_logprobs = lambda *a, **kw: scored.append(score(*a, **kw)) or \
        scored[-1]
    grads = GradSpy(torch, {"cpu": cpu_model, "card": gpu_model}, keep=True)
    try:
        with grads:
            want = cpu_tr.optimize(sub, rewards, {})
    finally:
        T._old_logprobs = score
    cpu_s = time.perf_counter() - t0
    (lp_old, _), (ref_lp, _) = scored

    dev = torch.device("cuda")
    Pw = sub.prompt.shape[1]
    full_tokens = torch.as_tensor(np.concatenate([sub.prompt, sub.response],
                                                 1), device=dev)
    full_mask = torch.as_tensor(np.concatenate(
        [sub.prompt_mask, sub.response_mask], 1), device=dev)
    resp_mask = torch.as_tensor(sub.response_mask, device=dev)
    adv = group_relative_advantages(
        torch.as_tensor(rewards, device=dev), GROUP)[:, None] \
        * resp_mask.float()
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    with grads:
        info = T._update_actor(
            gpu_model, adamw.init(T.trainable(gpu_model)), cfg,
            rl.policy_cfg(), rl.optim, full_tokens, full_mask, Pw,
            lp_old.to(dev), adv, resp_mask, ref_lp.to(dev), rl.temperature,
            rl.top_p)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    got = {k: float(v) for k, v in info.items()}
    launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                if LAUNCHES[k] != before[k]}
    grad_err, n_bad, worst = compare_update(
        gpu_model.parameters(), cpu_model.parameters(), grads, prior,
        want["grad_norm"])
    del cpu_tr, cpu_model, gpu_model, prior, grads
    critic = critic_witness(torch, cfg, sub, rewards, full_tokens, full_mask,
                            resp_mask)
    log("train witness " + json.dumps({
        "layers": WITNESS_LAYERS, "rows": r, "response_cols": c,
        "lr": WITNESS_LR, "cpu": {k: want[k] for k in (
            "loss", "grad_norm", "ratio_mean", "approx_kl", "clip_frac",
            "kl_ref")},
        "card": {k: got[k] for k in (
            "loss", "grad_norm", "ratio_mean", "approx_kl", "clip_frac",
            "kl_ref")},
        "grad_err_of_max": grad_err, "params_off": n_bad,
        "worst_param_err_over_tol": worst,
        "card_update_launches": launched, "cpu_optimize_s": cpu_s,
        "card_update_s": gpu_s, "critic": critic}))
    require(abs(got["loss"] - want["loss"])
            <= TRAIN_ATOL + TRAIN_RTOL * abs(want["loss"]),
            f"train witness: loss {got['loss']} vs CPU {want['loss']}")
    require(abs(got["grad_norm"] - want["grad_norm"])
            <= TRAIN_RTOL * want["grad_norm"] and want["grad_norm"] > 0,
            f"train witness: grad_norm {got['grad_norm']} vs CPU "
            f"{want['grad_norm']}")
    require(abs(got["ratio_mean"] - 1.0) <= RATIO_TOL,
            f"train witness: the card's ratio_mean {got['ratio_mean']}")
    require(grad_err <= GRAD_NOISE, f"train witness: gradients off by "
            f"{grad_err} of a tensor's largest > {GRAD_NOISE}")
    require(n_bad == 0, f"train witness: {n_bad} parameter elements off "
            f"(worst {worst} x the tolerance)")
    require(not launched, f"train witness: the update launched {launched}")
    cw, cc = critic["cpu"], critic["card"]
    require(abs(cc["critic_loss"] - cw["critic_loss"])
            <= TRAIN_ATOL + TRAIN_RTOL * abs(cw["critic_loss"]),
            f"train witness: critic_loss {cc['critic_loss']} vs CPU "
            f"{cw['critic_loss']}")
    require(abs(cc["grad_norm"] - cw["grad_norm"])
            <= TRAIN_RTOL * cw["grad_norm"] and cw["grad_norm"] > 0,
            f"train witness: critic grad_norm {cc['grad_norm']} vs CPU "
            f"{cw['grad_norm']}")
    require(critic["grad_err_of_max"] <= GRAD_NOISE,
            f"train witness: critic gradients off by "
            f"{critic['grad_err_of_max']} of a tensor's largest")
    require(critic["params_off"] == 0, f"train witness: "
            f"{critic['params_off']} critic parameter elements off (worst "
            f"{critic['worst_param_err_over_tol']} x the tolerance)")
    require(not critic["card_update_launches"], f"train witness: the "
            f"critic update launched {critic['card_update_launches']}")
    tol = SMALL_TOL["qwen3-1.7b"]
    require(critic["bf16_values_card_vs_cpu"] <= tol
            and critic["bf16_values_card_gap"]
            <= BF16_GAP * critic["bf16_values_cpu_gap"],
            f"train witness: the card's bf16 values lie "
            f"{critic['bf16_values_card_vs_cpu']} from the CPU's (tol "
            f"{tol}) and {critic['bf16_values_card_gap']} from float32 "
            f"(the CPU's {critic['bf16_values_cpu_gap']}, at most "
            f"{BF16_GAP}x)")
    require(critic["bf16_values_launches"]
            == {"flash_attention": WITNESS_LAYERS},
            f"train witness: the bf16 values pass launched "
            f"{critic['bf16_values_launches']}")


def critic_witness(torch, cfg, sub, rewards, full_tokens, full_mask,
                   resp_mask):
    """The critic's half of the float32 witness (see ``train_witness``):
    returns its numbers; the caller holds them to the tolerances."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.rl import trainer as T
    from repro_torch.rl.advantages import (gae_advantages,
                                           terminal_reward_to_tokens)
    from repro_torch.rl.critic import init_critic

    cpu = torch.device("cpu")
    Pw = sub.prompt.shape[1]
    ocfg = AdamWConfig(lr=WITNESS_LR)
    ft, fm, rm = (x.to(cpu) for x in (full_tokens, full_mask, resp_mask))
    t0 = time.perf_counter()
    cpu_critic = init_critic(cfg, seed=SEED + 1, device="cpu")
    gpu_critic = copy.deepcopy(cpu_critic).to("cuda")
    old_values = T._values(cpu_critic, cfg, ft, fm, Pw)
    rew_tok = terminal_reward_to_tokens(torch.as_tensor(rewards),
                                        torch.as_tensor(sub.length),
                                        sub.response.shape[1])
    _, returns = gae_advantages(rew_tok, old_values, rm)
    prior = [p.detach().clone() for p in cpu_critic.parameters()]
    grads = GradSpy(torch, {"cpu": cpu_critic, "card": gpu_critic},
                    keep=True)
    with grads:
        want = T._update_critic(
            cpu_critic, adamw.init(T.trainable(cpu_critic)), cfg, ocfg, ft,
            fm, Pw, returns, old_values, rm)
    cpu_s = time.perf_counter() - t0
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    with grads:
        got = T._update_critic(
            gpu_critic, adamw.init(T.trainable(gpu_critic)), cfg, ocfg,
            full_tokens, full_mask, Pw, returns.to(full_tokens.device),
            old_values.to(full_tokens.device), resp_mask)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                if LAUNCHES[k] != before[k]}
    grad_err, n_bad, worst = compare_update(
        gpu_critic.parameters(), cpu_critic.parameters(), grads, prior,
        float(want["grad_norm"]))
    del grads

    # the values pass in bfloat16, as the ppo path runs it, from the
    # critic before its update
    cfg16 = cfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    with torch.no_grad():
        for p, p0 in zip(cpu_critic.parameters(), prior):
            p.copy_(p0)
    cpu16 = copy.deepcopy(cpu_critic).to(dtype=torch.bfloat16)
    gpu16 = copy.deepcopy(cpu16).to("cuda")
    v_cpu16 = T._values(cpu16, cfg16, ft, fm, Pw)
    before = dict(LAUNCHES)
    v_card16 = T._values(gpu16, cfg16, full_tokens, full_mask, Pw).to(cpu)
    v_launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                  if LAUNCHES[k] != before[k]}

    def gap(a, b):
        return float((a - b)[rm].abs().max())

    return {"cpu": {k: float(v) for k, v in want.items()},
            "card": {k: float(v) for k, v in got.items()},
            "grad_err_of_max": grad_err, "params_off": n_bad,
            "worst_param_err_over_tol": worst,
            "card_update_launches": launched, "cpu_update_s": cpu_s,
            "card_update_s": gpu_s,
            "old_values_abs_max": float(old_values[rm].abs().max()),
            "bf16_values_card_vs_cpu": gap(v_card16, v_cpu16),
            "bf16_values_card_gap": gap(v_card16, old_values),
            "bf16_values_cpu_gap": gap(v_cpu16, old_values),
            "bf16_values_launches": v_launched}


def archs_path(torch, arch: str):
    """Two rollout epochs of ``arch`` at full width and ``ARCH_LAYERS``
    layers (``rollout_path``: epoch 0 vanilla, epoch 1 the one-pass
    branch, or for a trunk with Mamba layers (jamba) the two-pass one),
    the path's kernels launched: the decode, flash and verify kernels,
    then ``cache_roll`` for an attention trunk, or ``mamba_scan`` (its
    launches by T summing to its count) and no ``cache_roll`` for jamba;
    an ``archs`` line with the parameter count, peak GiB, each epoch's
    wall time and counts, and for a MoE trunk the ``moe_drop_frac`` of
    one no-grad ``forward`` over epoch 1's verify input (prompt and epoch
    0's response); with an MTP head (deepseek-v3-671b) that forward also
    returns ``mtp_logits``, which must be finite and shaped like the
    logits.  The model is freed before returning its launches."""
    import numpy as np

    from repro_torch.core import SpecConfig
    from repro_torch.engine.generate import positions_from_mask
    from repro_torch.models import model as M

    model, cfg, batch, gen = setup_model(torch, arch,
                                         layers=ARCH_LAYERS[arch],
                                         n_new=ARCHS_N)
    spec = SpecConfig(variant="spec", one_pass="auto", lenience=LENIENCE)
    launches, (rb0, rb1) = rollout_path(torch, f"archs {arch}", model, cfg,
                                        batch, gen, spec)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    compacts = M.supports_cache_realign(cfg)
    for name in ("decode_attention", "flash_attention", "spec_verify",
                 "cache_roll" if compacts else "mamba_scan"):
        require(launches[name] > 0, f"archs {arch}: kernel {name} was not "
                "launched")
    if not compacts:
        require(launches["cache_roll"] == 0, f"archs {arch}: the two-pass "
                f"branch launched cache_roll {launches['cache_roll']} times")
        log(f"archs {arch} mamba_scan launches by T: "
            f"{json.dumps(launches.mamba_by_t)}")
    line = {"arch": arch, "layers": cfg.num_layers,
            "params": M.count_params(model), "peak_gib": peak,
            "wall_s": launches.wall_s,
            "n_generated": [rb.metrics["n_generated"] for rb in (rb0, rb1)],
            "n_reused": [rb.metrics["n_reused"] for rb in (rb0, rb1)],
            "one_pass": [rb.metrics["one_pass"] for rb in (rb0, rb1)],
            "launches": dict(launches)}
    if cfg.num_experts or cfg.mtp:
        dev = model.device
        tokens = torch.from_numpy(np.concatenate(
            [batch.tokens, rb0.response], 1)).to(dev)
        mask = torch.from_numpy(np.concatenate(
            [batch.mask, rb0.response_mask], 1)).to(dev)
        with torch.no_grad():
            logits, aux = M.forward(model, cfg, tokens,
                                    positions_from_mask(mask),
                                    return_mtp=cfg.mtp)
    if cfg.mtp:
        mtp = aux.pop("mtp_logits")
        line["mtp_logits"] = {"shape": list(mtp.shape),
                              "finite": bool(torch.isfinite(mtp).all()),
                              "max_abs": float(mtp.abs().max())}
        require(mtp.shape == logits.shape and line["mtp_logits"]["finite"],
                f"archs {arch}: mtp_logits {line['mtp_logits']} against "
                f"logits {tuple(logits.shape)}")
        del mtp, logits
    if cfg.num_experts:
        line.update({k: float(aux[k]) for k in ("moe_drop_frac",
                                                "moe_lb_loss", "moe_z_loss")
                     if k in aux},
                    moe_expert_frac=aux["moe_expert_frac"].tolist(),
                    moe_impl=cfg.moe_impl)
        drop = line.get("moe_drop_frac", 0.0)      # "dense" drops nothing
        require(0.0 <= drop < 1.0, f"archs {arch}: moe_drop_frac {drop}")
    log("archs " + json.dumps(line))
    del model, rb0, rb1
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def arch_train_path(torch, arch: str):
    """One GRPO ``train_step`` of ``arch`` (mixtral-8x22b, jamba-v0.1-52b
    or deepseek-v3-671b) at full width and ``TRAIN_LAYERS[arch]`` layers
    (epoch 0, the verifier's rewards: a random model's are 0, so the
    router losses drive the update of a MoE layer): the scorings launch
    the trunk's T > 1 kernel once a layer (flash_attention for mixtral and
    deepseek-v3's MLA layer, mamba_scan for jamba's Mamba layer) and
    nothing else, the update launches no kernel (jamba's scan takes
    ``ssm_scan``), the loss (and a MoE layer's ``moe_lb_loss``) is finite
    and every MoE, Mamba and attention parameter of layer 0 has a
    gradient; a ``<arch> train`` line with the stage split, peak GiB by
    stage and the parameters whose gradient is zero everywhere: only
    deepseek-v3's MTP head, expected (no trainer path reads
    ``mtp_logits``, in either package), may be among them."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launches
    from repro_torch.models import model as M
    from repro_torch.rl import trainer as T

    cfg = get_config(arch).replace(num_layers=TRAIN_LAYERS[arch])
    label = f"{arch.split('-')[0]} train"
    # one layer: jamba's layer 0 is Mamba + MoE, mixtral's attention + MoE,
    # deepseek-v3's MLA + a dense FFN
    kernel = "mamba_scan" if cfg.block_kind == "mamba" else "flash_attention"
    moe = any(is_moe for _, is_moe in cfg.layer_plan())
    torch.cuda.reset_peak_memory_stats()
    model = M.init_lm(cfg, seed=SEED, device="cuda")
    params = M.count_params(model)
    reset_launches()
    tr = make_trainer(cfg, model, "grpo")
    with StageSpy(torch, tr, T) as spy:
        m = tr.train_step(prompt_batch())
        st = spy.take()
    launches = read_launches()
    zero = spy.grads.zero["actor"]
    expected = [n for n in zero if n.startswith("mtp.")]
    log(f"{label} " + json.dumps({
        "layers": cfg.num_layers, "params": params, **stage_line(m, st, (
            "collect_time", "old_logprob_time", "ref_time", "adv_time",
            "update_actor_time", "loss", "moe_lb_loss", "grad_norm",
            "reward_mean", "n_generated", "one_pass", "kl_ref")),
        "zero_grad_params": [n for n in zero if n not in expected],
        "zero_grad_params_expected": expected,
        "mamba_scan_launches_by_t": launches.mamba_by_t}))
    require(np.isfinite(m["loss"])
            and (not moe or np.isfinite(m["moe_lb_loss"]))
            and m["grad_norm"] > 0, f"{label}: loss {m['loss']}, "
            f"moe_lb_loss {m.get('moe_lb_loss')}, grad_norm {m['grad_norm']}")
    check_scoring(label, st, cfg.num_layers, kernel=kernel)
    rollout_kernels = ({"mamba_scan"} if kernel == "mamba_scan" else
                       {"decode_attention", "flash_attention"})
    require(rollout_kernels <= set(st["collect"]["launches"]),
            f"{label}: the rollout launched {st['collect']['launches']}")
    require(not any(n.startswith(("layers.0.moe", "layers.0.mamba",
                                  "layers.0.attn")) for n in zero),
            f"{label}: no gradient in {zero}")
    del tr, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def frontend_extras(torch, model, cfg, batch: int):
    """The frontend's stub conditioning on the card, from a generator
    seeded with ``SEED``, one draw a prompt shared by its group's rows:
    pixtral-12b's patch embeddings (B, 256, 5120), or whisper-tiny's frames
    (B, 1,500, 384) through ``encode`` once."""
    from repro_torch.models import model as M

    g = torch.Generator(device=model.device)
    g.manual_seed(SEED)
    width = cfg.num_prefix_embeddings or cfg.encoder_frames
    stub = torch.randn((batch // GROUP, width, cfg.d_model), generator=g,
                       device=model.device).repeat_interleave(GROUP, dim=0)
    if cfg.num_prefix_embeddings:
        return {"prefix_embeds": stub.to(torch.bfloat16)}
    enc, pos = M.encode(model, cfg, stub)
    return {"encoder_out": enc, "encoder_positions": pos}


def frontend_archs_path(torch, arch: str):
    """Two rollout epochs of a frontend at full width and
    ``FRONTEND_LAYERS`` layers with its stub conditioning (the ``archs``
    traffic): pixtral-12b's epoch 1 the two-pass branch (verify score over
    prefix ⊕ prompt ⊕ draft, re-prefill of prompt ⊕ accepted prefix behind
    the prefix; ``cache_roll`` 0), whisper-tiny's the one-pass branch
    (``cache_roll`` launched; the encoder run once, its memory read by the
    cross-attention at every call, ``flash_attention`` non-causal at T = 1
    too).  The flash, decode and verify kernels launch; an ``archs`` line
    with parameters, peak GiB, each epoch's wall time, counts and launches.
    The model is freed before returning its launches."""
    from repro_torch.core import SpecConfig
    from repro_torch.kernels import reset_launches
    from repro_torch.models import model as M

    gc.collect()
    torch.cuda.empty_cache()
    model, cfg, batch, gen = setup_model(torch, arch,
                                         layers=FRONTEND_LAYERS[arch],
                                         n_new=ARCHS_N)
    B = batch.tokens.shape[0]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()            # the encoder's launches are the path's
    t0 = time.perf_counter()
    kw = frontend_extras(torch, model, cfg, B)
    torch.cuda.synchronize()
    extras_s = time.perf_counter() - t0
    spec = SpecConfig(variant="spec", one_pass="auto", lenience=LENIENCE)
    launches, (rb0, rb1) = rollout_path(torch, f"archs {arch}", model, cfg,
                                        batch, gen, spec, model_kwargs=kw,
                                        reset=False)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("decode_attention", "flash_attention", "spec_verify"):
        require(launches[name] > 0, f"archs {arch}: kernel {name} was not "
                "launched")
    if cfg.num_prefix_embeddings:
        require(launches["cache_roll"] == 0, f"archs {arch}: the two-pass "
                f"branch launched cache_roll {launches['cache_roll']} times")
    else:
        require(launches["cache_roll"] > 0, f"archs {arch}: the one-pass "
                "branch launched no cache_roll")
    line = {"arch": arch, "layers": cfg.num_layers,
            "encoder_layers": cfg.encoder_layers,
            "params": M.count_params(model), "peak_gib": peak,
            "extras": {k: list(v.shape) for k, v in kw.items()},
            "extras_s": extras_s, "wall_s": launches.wall_s,
            "n_generated": [rb.metrics["n_generated"] for rb in (rb0, rb1)],
            "n_reused": [rb.metrics["n_reused"] for rb in (rb0, rb1)],
            "one_pass": [rb.metrics["one_pass"] for rb in (rb0, rb1)],
            "prefill_passes": [rb.metrics["prefill_passes"]
                               for rb in (rb0, rb1)],
            "launches": dict(launches)}
    log("archs " + json.dumps(line))
    del model, kw, rb0, rb1
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_frontends_path(torch):
    """``launch.serve --engine fixed`` of the two frontends (the launcher's
    reduced configs in bfloat16 on the card, stub conditioning from
    ``--seed``), in process: exit 0 and every request served; the flash and
    decode kernels launched."""
    import contextlib
    import io

    from repro_torch.kernels import reset_launches
    from repro_torch.launch import serve

    reset_launches()
    t0 = time.perf_counter()
    for arch in FRONTEND_LAYERS:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = serve.main(["--arch", arch, "--engine", "fixed",
                             "--requests", "8"])
        text = out.getvalue()
        for line in text.splitlines():
            log(f"  serve {arch}: " + line)
        require(rc == 0 and "served 8 requests" in text,
                f"launch.serve --arch {arch} --engine fixed: rc={rc}")
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"serve frontends path: in {time.perf_counter() - t0:.2f} s, "
        f"launches: {launches}")
    for name in ("decode_attention", "flash_attention"):
        require(launches[name] > 0, f"kernel {name} was not launched on the "
                "serve frontends path")
    return launches


def serve_path(torch):
    """One run of the port's serve launcher on the card, with its §11/§14
    flags: the ledger, a trace directory, a decision log and the
    compile-stability replay, which must end the output."""
    import contextlib
    import io

    from repro_torch import obs
    from repro_torch.kernels import reset_launches
    from repro_torch.launch import serve

    reset_launches()
    t0 = time.perf_counter()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = serve.main(["--spec-prefix", "--arrival-every", "2",
                             "--ledger", "--trace-dir",
                             str(OBS_DIR / "serve_trace"), "--decision-log",
                             str(OBS_DIR / "serve_decisions"),
                             "--assert-compile-stable"])
    finally:
        obs.reset()
    torch.cuda.synchronize()
    launches = read_launches()
    text = out.getvalue()
    for line in text.splitlines():
        log("  serve: " + line)
    log(f"serve path: rc={rc} in {time.perf_counter() - t0:.2f} s, "
        f"launches: {launches}")
    require(rc == 0, f"launch.serve exited {rc}")
    require(text.rstrip().endswith("0 new on identical replay"),
            "launch.serve did not end with the compile-stability line")
    require(all((OBS_DIR / "serve_trace" / f).is_file() for f in (
        "trace.json", "events.jsonl", "metrics.prom")),
        "launch.serve --trace-dir wrote no export files")
    for name in ("decode_attention", "flash_attention", "spec_verify",
                 "cache_roll", "cache_slot_write"):
        require(launches[name] > 0, f"kernel {name} was not launched on the "
                "serve path")
    return launches


# ------------------------------------------------------------------ mesh


class SampleRecorder:
    """Records every ``sample`` call of the decode paths (``generate``'s
    loop, the slot engine's admissions and chunks, the paged engine's
    followers) for the duration of a ``with``: each row's key words and
    its ``MESH_TOP_K`` best sampler scores (adjusted log-prob plus the
    Gumbel noise) with their tokens.  The port's ``sample`` draws; the
    recorder draws the same noise again from the same key batch (a
    counter hash of the key's words: the same bits), and checks that its
    best token is the one sampled.  It also records every accept test of
    the one-pass verify (``core/verify.py``): each row's verify key words,
    ``lp_curr``, ``lp_prev``, ``u``, ``valid_len`` and the log-lenience,
    as ``spec_verify`` takes them."""

    MODULES = ("repro_torch.engine.generate",
               "repro_torch.serving.engine_loop",
               "repro_torch.serving.paged_engine")

    def __enter__(self):
        import importlib

        import numpy as np

        from repro_torch.core import verify
        from repro_torch.engine import sampling

        self.mods = [importlib.import_module(m) for m in self.MODULES]
        self.real = sampling.sample
        self.verify = verify
        self.real_uniforms = verify._accept_uniforms
        self.real_verify = verify.spec_verify
        self.calls = []
        self.verifies = []
        words = []

        def uniforms(key, B, N):
            words.append(key.words.cpu().numpy())
            return self.real_uniforms(key, B, N)

        def accept_test(lp_curr, lp_prev, u, valid_len, log_lenience):
            self.verifies.append((words.pop(), *(
                x.float().cpu().numpy() for x in (lp_curr, lp_prev, u)),
                valid_len.cpu().numpy(), float(log_lenience)))
            return self.real_verify(lp_curr, lp_prev, u, valid_len,
                                    log_lenience)

        verify._accept_uniforms = uniforms
        verify.spec_verify = accept_test

        def spy(key, logits, temperature=1.0, top_p=1.0):
            # a key batch records its rows' words; a scalar key (the
            # trainer's stream: on the mesh a data rank's rows of it,
            # from ``lo``) records None and its first row
            words = getattr(key, "words", None)
            lo = getattr(key, "lo", 0)
            tok, lp = self.real(key, logits, temperature, top_p)
            scores = key.gumbel(logits.shape) + sampling.adjust_logits(
                logits.float(), temperature, top_p)
            top = scores.topk(MESH_TOP_K, dim=-1)
            idx = top.indices.cpu().numpy()
            vals = top.values.float().cpu().numpy()
            sampled = tok.cpu().numpy()
            for r in np.nonzero(idx[:, 0] != sampled)[0]:
                # a tie at the top (a done row's logits are all equal, and
                # its noise has 24 bits): the sampled token must hold the
                # best score too; it goes first
                at = np.nonzero(idx[r] == sampled[r])[0]
                require(at.size and vals[r, at[0]] == vals[r, 0],
                        f"mesh: the recorder's redraw ranks token "
                        f"{sampled[r]} below {idx[r, 0]}")
                idx[r, [0, at[0]]] = idx[r, [at[0], 0]]
            self.calls.append((None if words is None else
                               words.cpu().numpy(), idx, vals, lo))
            return tok, lp

        for m in self.mods:
            m.sample = spy
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.sample = self.real
        self.verify._accept_uniforms = self.real_uniforms
        self.verify.spec_verify = self.real_verify



def records_by_row(calls, chains):
    """{(epoch, row, j): (tokens, scores)} of the recorded calls whose key
    words are row ``row``'s j-th sample key of ``epoch`` (``chains``); the
    first record of each (a padded admission group repeats its first
    row; the ranks of a model group record the same rows)."""
    out = {}
    for words, idx, vals, _ in calls:
        if words is None:
            continue
        for r in range(words.shape[0]):
            at = chains.get(tuple(int(w) for w in words[r]))
            if at is not None and at not in out:
                out[at] = (idx[r], vals[r])
    return out


def records_by_call(calls):
    """{(0, row, j): (tokens, scores)} of a scalar key's recorded calls (a
    trainer's rollout): its j-th call draws every row's j-th sample (on
    the mesh, of the rows from its ``lo``)."""
    out = {}
    for j, (words, idx, vals, lo) in enumerate(calls):
        if words is None:
            for r in range(idx.shape[0]):
                out.setdefault((0, lo + r, j), (idx[r], vals[r]))
    return out


def accept_tests_by_row(verifies, epoch_words):
    """{row: (lp_curr, lp_prev, u, valid_len, log_lenience)} of the
    recorded accept tests of epoch 1, whose row b verifies with its epoch
    key's second split (``rollout`` and ``rollout_via_slots`` split it so);
    the first record of each row."""
    from repro_torch.engine.sampling import KeyBatch, split_key

    _, vkey = split_key(KeyBatch.from_words(epoch_words[1], "cuda"))
    rows = {tuple(w): b for b, w in enumerate(vkey.words.cpu().tolist())}
    out = {}
    for words, lp_curr, lp_prev, u, valid_len, log_len in verifies:
        for r in range(words.shape[0]):
            b = rows.get(tuple(int(w) for w in words[r]))
            if b is not None and b not in out:
                out[b] = (lp_curr[r], lp_prev[r], u[r], int(valid_len[r]),
                          log_len)
    return out


def sample_chains(torch, epoch_words):
    """{key words: (epoch, row, j)}: the key each row's j-th sample draws
    with, for j up to ``ARCHS_N``.  A row's decode stream is its epoch key
    split once (the vanilla epoch 0) or twice (epoch 1: the verify's
    stream, then the decode's), as ``rollout`` and ``rollout_via_slots``
    split it, then split again before every sample; the streams follow
    the keys alone, never the tokens, so the fixed batch and the slot
    engine, the reference and the mesh draw row b's j-th token with the
    same key."""
    from repro_torch.engine.sampling import KeyBatch, split_key

    out = {}
    for epoch, words in enumerate(epoch_words):
        key = KeyBatch.from_words(words, "cuda")
        if epoch:
            key, _ = split_key(key)
        _, key = split_key(key)
        for j in range(ARCHS_N + 1):
            key, sub = split_key(key)
            for b, w in enumerate(sub.words.cpu().tolist()):
                out[tuple(w)] = (epoch, b, j)
    return out


def mesh_rollouts(torch, model, cfg, batch, gen, keys, *, mesh=None,
                  drafts=None, modes=MESH_MODES):
    """Each of ``modes``' two epochs (epoch 0 vanilla, epoch 1 the
    one-pass branch) with per-row keys (``keys``: each epoch's (B, 2)
    words), recorded (``SampleRecorder``).  ``drafts``: the reference's
    epoch-0 batches, by mode: epoch 1 then verifies the reference's rows,
    so that both sides verify the same drafts.  Returns {mode: (rb0, rb1,
    recorder)}."""
    from repro_torch.core import RolloutCache, SpecConfig, rollout
    from repro_torch.engine.sampling import KeyBatch

    out = {}
    for layout, backfill in modes:
        mode = f"{layout}/{backfill}"
        c = cfg.replace(cache_layout=layout)
        spec = SpecConfig(variant="spec", one_pass="auto", lenience=LENIENCE,
                          backfill=backfill, backfill_slots=SLOTS)
        rbs = []
        with SampleRecorder() as rec:
            for epoch in (0, 1):
                cache = RolloutCache(history=spec.cache_history,
                                     group_size=GROUP)
                if epoch:
                    src = drafts[mode] if drafts is not None else rbs[0]
                    cache.batch_put(batch.cache_keys, src.response,
                                    src.behaviour_logprobs, src.length, 0,
                                    gen.eos_id)
                rbs.append(rollout(model, c, gen, spec, batch.tokens,
                                   batch.mask, batch.cache_keys, cache,
                                   KeyBatch.from_words(keys[epoch], "cuda"),
                                   epoch, mesh=mesh))
        out[mode] = (rbs[0], rbs[1], rec)
    return out


def mesh_keys():
    """Each epoch's per-row key words of the mesh phases: two splits of
    ``make_key(SEED)``, each drawn into a key a row."""
    from repro_torch.engine.sampling import make_key, request_keys, split_key

    key = make_key(SEED)
    keys = []
    for _ in (0, 1):
        key, sub = split_key(key)
        keys.append(request_keys(sub, PROMPTS * GROUP).words.cpu().numpy())
    return keys


def _rb_host(rb):
    return {"response": rb.response, "length": rb.length, "n": rb.n,
            "lp": rb.behaviour_logprobs,
            "metrics": {k: v for k, v in rb.metrics.items()
                        if not k.endswith("_time")}}


def mesh_trainer(torch, cfg, model, algo, mesh=None):
    """A trainer of ``algo`` on ``model`` (cut over ``mesh`` when given)
    at the mesh phase's traffic (ARCHS_N new tokens) and MESH_LR."""
    from repro_torch.optim.adamw import AdamWConfig

    return make_trainer(cfg, model, algo,
                        trainer_kw=None if mesh is None else {"mesh": mesh},
                        max_new_tokens=ARCHS_N,
                        optim=AdamWConfig(lr=MESH_LR),
                        critic_optim=AdamWConfig(lr=MESH_LR))


def _host_named(module, tensors=None):
    """A module's parameters (or ``tensors`` laid out like them) as CPU
    copies, by name."""
    names = [n for n, _ in module.named_parameters()]
    if tensors is None:
        tensors = [p for _, p in module.named_parameters()]
    return {n: t.detach().to("cpu", copy=True) for n, t in zip(names,
                                                                tensors)}


def _load_named(torch, module, named):
    with torch.no_grad():
        for n, p in module.named_parameters():
            p.copy_(named[n])


def mesh_optimize(torch, tr, rb):
    """``tr.optimize`` of ``rb`` with seeded mixed rewards under a
    ``StageSpy`` that keeps the gradients: (the step log, its stages'
    launches and peak GiB, the gradients by model, the old log-probs in
    numpy)."""
    from repro_torch.rl import trainer as T

    with StageSpy(torch, tr, T, keep=True) as spy:
        m = tr.optimize(rb, mixed_rewards(rb.prompt.shape[0]), {})
        torch.cuda.synchronize()
    st = spy.take()
    lp_old = spy.returns["old_logprob"][0].float().cpu().numpy()
    return m, st, spy.grads.grads, lp_old


def mesh_train_reference(torch, model, cfg, batch, rb0, tmp):
    """The trainer's single-process reference of the ``mesh`` phase: each
    of MESH_TRAIN_ALGOS' ``optimize`` on ``rb0`` from the same weights
    (the prior weights, the updated ones and the gradients written to
    ``tmp/<algo>.pt`` in bfloat16 for the ranks to read in place), then
    one ``train_step`` of a fresh GRPO trainer with its sampler recorded.
    The model's weights are put back after each."""
    prior = _host_named(model)
    out = {}
    for algo in ("grpo", "ppo"):
        tr = mesh_trainer(torch, cfg, model, algo)
        blob = {"actor": {"prior": prior}}
        if tr.critic is not None:
            blob["critic"] = {"prior": _host_named(tr.critic)}
        t0 = time.perf_counter()
        m, st, grads, lp_old = mesh_optimize(torch, tr, rb0)
        t_opt = time.perf_counter() - t0
        for label, mod in (("actor", tr.model), ("critic", tr.critic)):
            if mod is None:
                continue
            g = _host_named(mod, grads[label])
            blob[label].update(updated=_host_named(mod), grads=g,
                               norm=math.sqrt(sum(
                                   float(x.double().square().sum())
                                   for x in g.values())))
        torch.save(blob, os.path.join(tmp, f"{algo}.pt"))
        out[algo] = {"metrics": {k: float(v) for k, v in m.items()},
                     "lp_old": lp_old, "optimize_s": t_opt,
                     "launches": {k: v["launches"] for k, v in st.items()}}
        check_scoring(f"mesh reference {algo}", st, cfg.num_layers,
                      scorings=(("old_logprob", "ref") if algo == "grpo"
                                else ("old_logprob", "values")),
                      updates=(("update_actor",) if algo == "grpo" else
                               ("update_actor", "update_critic")))
        _load_named(torch, model, prior)
        del tr, blob, grads
        gc.collect()
        torch.cuda.empty_cache()
    tr = mesh_trainer(torch, cfg, model, "grpo")
    with SampleRecorder() as rec:
        m = tr.train_step(batch)
    out["train_step"] = {"rb": _rb_host(tr.last_rb), "calls": rec.calls,
                         "metrics": {k: float(v) for k, v in m.items()}}
    _load_named(torch, model, prior)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def compare_shards(torch, label, model, grads, ref, scale, r, m,
                   prior=None):
    """A rank's updated shards of ``model`` (and its ``grads``) against the
    matching slices of the reference's (``ref``: a ``.pt`` blob's model
    entry, read in place; ``prior``: this rank's own shards before the
    update, by name, else the blob's ``prior`` slices): (the gradient gap,
    the largest gradient error over its tensor's largest, which must stay
    within MESH_GRAD_GAP; the elements outside ``update_tol`` with
    MESH_GRAD_GAP as its noise plus MESH_BF16_ULP of |p|; the worst error
    over its tolerance).  Large tensors go a piece at a time (``pieces``)."""
    from repro_torch.distributed.mesh import _slice, param_specs, pieces

    specs = param_specs(model)
    dev = next(model.parameters()).device

    def mine(name, what):
        if what == "prior" and prior is not None:
            return prior[name]
        return _slice(ref[what][name], specs.get(name, ()), m, r)

    def on(t):
        return t.to(dev).float()

    names = [n for n, _ in model.named_parameters()]
    gap = 0.0
    tops = {}
    for n, g in zip(names, grads):
        top = err = 0.0
        for a, b in pieces(g, mine(n, "grads")):
            b = on(b)
            top = max(top, float(b.abs().max()))
            err = max(err, float((a.float() - b).abs().max()))
        tops[n] = top
        if top > 0:
            gap = max(gap, err / top)
    require(gap <= MESH_GRAD_GAP, f"mesh {label}: gradients off by {gap} of "
            f"a tensor's largest > MESH_GRAD_GAP {MESH_GRAD_GAP}")
    n_bad, worst = 0, 0.0
    for n, p in model.named_parameters():
        for got, want, p0, g in pieces(p.detach(), mine(n, "updated"),
                                           mine(n, "prior"),
                                           mine(n, "grads")):
            want, got = on(want), got.float()
            tol = update_tol(on(p0), on(g), MESH_LR, scale,
                             noise=MESH_GRAD_GAP, gmax=tops[n]) \
                + MESH_BF16_ULP * torch.maximum(want.abs(), got.abs())
            d = (got - want).abs()
            n_bad += int((d > tol).sum())
            worst = max(worst, float((d / tol).max()))
    require(n_bad == 0, f"mesh {label}: {n_bad} updated elements outside "
            f"the tolerance (worst {worst} x; gradient gap {gap})")
    return gap, n_bad, worst


def _digest(torch, t, chunk: int = 1 << 24) -> int:
    """A position-weighted sum of a tensor's raw bits, on its device, a
    chunk at a time: equal tensors have equal digests, and one changed
    element changes it."""
    x = t.detach().contiguous().view(-1)
    x = x.view(torch.int16 if x.element_size() == 2 else torch.int32)
    total = 0
    for lo in range(0, x.numel(), chunk):
        part = x[lo:lo + chunk].long()
        w = torch.arange(lo + 1, lo + 1 + part.numel(), device=x.device,
                         dtype=torch.long) % 65521 + 1
        total += int((part * w).sum())
    return total


def log_rank(msg: str) -> None:
    """A progress line from the mesh's first rank."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_rank() == 0:
        log(f"mesh rank 0: {msg}")


def mesh_rank_train(torch, mesh, model, cfg, batch, data, tmp):
    """The trainer on this rank (after the rollouts): each algorithm's
    ``optimize`` of the reference's epoch-0 rows, held against the
    reference's update; one ``train_step`` (recorded); two async steps;
    a watchdog snapshot and restore.  Returns what it saw."""
    import numpy as np

    from repro_torch.distributed import mesh as MS
    from repro_torch.distributed.mesh import model_rank, model_size
    from repro_torch.rl.async_loop import AsyncConfig, AsyncTrainer
    from repro_torch.rl.watchdog import TrainWatchdog, WatchdogConfig

    r, m_size = model_rank(mesh), model_size(mesh)
    prior = _host_named(model)
    sums = []
    finish = MS.finish_grads

    def timed_finish(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        finish(*a, **kw)
        torch.cuda.synchronize()
        sums.append(time.perf_counter() - t0)
    MS.finish_grads = timed_finish
    out = {}
    try:
        for algo in ("grpo", "ppo"):
            log_rank(f"{algo} optimize")
            sums.clear()
            tr = mesh_trainer(torch, cfg, model, algo, mesh)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m, st, grads, lp_old = mesh_optimize(torch, tr, data["rb0"])
            t_opt = time.perf_counter() - t0
            ref = torch.load(os.path.join(tmp, f"{algo}.pt"), mmap=True,
                             weights_only=True)
            cmp = {}
            for label, mod in (("actor", tr.model), ("critic", tr.critic)):
                if mod is None:
                    continue
                scale = min(1.0, 1.0 / (ref[label]["norm"] + 1e-9))
                cmp[label] = compare_shards(
                    torch, f"{algo} {label}", mod, grads[label], ref[label],
                    scale, r, m_size)
            del ref
            out[algo] = {
                "metrics": {k: float(v) for k, v in m.items()},
                "lp_old": lp_old, "optimize_s": t_opt,
                "grad_sum_s": list(sums), "compare": cmp,
                "launches": {k: v["launches"] for k, v in st.items()},
                "peak_gib": {k: v["peak_gib"] for k, v in st.items()}}
            _load_named(torch, model, prior)
            del tr, grads
            gc.collect()
            torch.cuda.empty_cache()
        log_rank("train_step")
        tr = mesh_trainer(torch, cfg, model, "grpo", mesh)
        with SampleRecorder() as rec:
            t0 = time.perf_counter()
            m = tr.train_step(batch)
            t_step = time.perf_counter() - t0
        out["train_step"] = {"rb": _rb_host(tr.last_rb), "calls": rec.calls,
                             "metrics": {k: float(v) for k, v in m.items()},
                             "step_s": t_step}
        # the async loop over the mesh trainer: "ppcc" at K = 1
        log_rank("async")
        at = AsyncTrainer(tr, AsyncConfig(staleness_window=1,
                                          buffer_capacity=4,
                                          schedule="ppcc"))
        t0 = time.perf_counter()
        ms = at.run(2)
        t_async = time.perf_counter() - t0
        # the published snapshot, then the service's model once it has
        # polled it, hold the trainer's shards bit for bit, in their own
        # storage
        version, published = at.sync.poll()
        at.service._maybe_sync()
        served = at.service.model
        mine = dict(tr.model.named_parameters())
        same = version == at.version and at.service.version == version \
            and all(torch.equal(published[n], p) for n, p in mine.items()) \
            and all(torch.equal(a, b) for a, b in zip(
                served.parameters(), tr.model.parameters()))
        shared = any(a.data_ptr() == b.data_ptr() for a, b in zip(
            list(served.parameters()) + list(published.values()),
            list(tr.model.parameters()) * 2))
        out["async"] = {"counters": at.counters(), "async_s": t_async,
                        "staleness": [x["staleness"] for x in ms],
                        "is_weight_mean": [x.get("is_weight_mean", 0.0)
                                           for x in ms],
                        "loss": [x["loss"] for x in ms],
                        "served_equal": same, "shared_storage": shared}
        del at, served
        gc.collect()
        # the watchdog: a snapshot of the whole trees (rank 0 writes), the
        # weights and moments poisoned, the restore cutting them back
        wd = TrainWatchdog(WatchdogConfig(checkpoint_dir=data["wd_dir"]))
        state = list(tr.model.parameters()) + tr.opt_state["mu"] \
            + tr.opt_state["nu"]
        keep = [_digest(torch, t) for t in state]
        log_rank(f"watchdog snapshot of {sum(t.numel() for t in state)} "
                 "local elements")
        t0 = time.perf_counter()
        wd.snapshot(tr)
        t_snap = time.perf_counter() - t0
        with torch.no_grad():
            for t in state:
                t.fill_(float("nan"))
        t0 = time.perf_counter()
        ok = wd.restore(tr)
        t_restore = time.perf_counter() - t0
        exact = ok and [_digest(torch, t) for t in state] == keep
        out["watchdog"] = {"snapshot_s": t_snap, "restore_s": t_restore,
                           "exact": exact}
        del tr, keep
        _load_named(torch, model, prior)
    finally:
        MS.finish_grads = finish
    require(np.isfinite(out["train_step"]["metrics"]["loss"]),
            "mesh train_step: the loss is not finite")
    return out


def mesh_rank(rank, path):
    """One rank of the ``mesh`` phase: the model cut over its model group,
    every mode's two epochs over the mesh, the teacher-forced scores of
    the reference's rows, then the trainer (``mesh_rank_train``); returns
    what it saw, with its launches."""
    import pickle

    import torch

    from repro_torch.distributed.mesh import MeshConfig, shard_params
    from repro_torch.engine.generate import score
    from repro_torch.kernels import _build, reset_launches

    with open(path, "rb") as f:
        data = pickle.load(f)
    t0 = time.perf_counter()
    _build.library()                  # the parent built it: loaded here
    mesh = MeshConfig(*MESH_SHAPE, require=True).build("cuda")
    model, cfg, batch, gen = setup_model(torch, layers=MESH_LAYERS,
                                         n_new=ARCHS_N)
    model = shard_params(mesh, cfg, model)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    runs = mesh_rollouts(torch, model, cfg, batch, gen, data["keys"],
                         mesh=mesh, drafts=data["drafts"])
    forced = [score(model, cfg, toks, mask, mesh=mesh)["logprobs"].cpu()
              .numpy() for toks, mask in data["forced"]]
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    train = mesh_rank_train(torch, mesh, model, cfg, batch, data,
                            os.path.dirname(path))
    t_train = time.perf_counter() - t0
    launches = read_launches()
    return {"rank": rank, "backend": torch.distributed.get_backend(),
            "setup_s": t_setup, "run_s": t_run, "train_s": t_train,
            "train": train, "peak_gib": peak,
            "launches": dict(launches), "by_t": launches.by_t,
            "mamba_by_t": launches.mamba_by_t,
            "runs": {mode: ([_rb_host(rb0), _rb_host(rb1)], rec.calls,
                            rec.verifies)
                     for mode, (rb0, rb1, rec) in runs.items()},
            "forced": forced}


def mesh_path(torch):
    """The §8 mesh on the card: the single-process reference first (the
    model at full width, ``MESH_LAYERS`` layers, in bfloat16; its rows,
    its sampler records and its teacher-forced scores kept in numpy, the
    model then freed), then four ``gloo`` ranks on ``cuda:0`` as a (2, 2)
    mesh (``run_ranks``; NCCL will not put two ranks on one card), each
    running every mode's two epochs and the teacher-forced scores on its
    shards.  Checks: the mesh's scores of the reference's rows within
    ``MESH_LP_TOL`` of the reference's; every row equal to the reference's
    up to its first parting, and at a parting either the accept test's
    position (``n`` differs: the same uniform and draft log-prob on both
    sides, the two thresholds straddling the uniform, and the current
    log-probs of the draft within the tolerance: ``accept_parting``) or a
    sampled token where both tokens lie among both sides'
    best sampler scores, each score shifted by at most ``MESH_LP_TOL``
    (before every parting, every shared token's shift too), the
    reference's margin between them no more than their shifts' difference;
    epoch 1 one-pass with ``n_reused > 0``; every rank's rows equal bit for
    bit; and the seven attention-path kernels launched on the ranks (their
    sum is the path's count).  Times mean nothing about NCCL or several
    cards."""
    import pickle
    import tempfile

    import numpy as np

    from repro_torch.distributed.mesh import run_ranks
    from repro_torch.engine.generate import score
    from repro_torch.kernels import LAUNCHES

    t0 = time.perf_counter()
    model, cfg, batch, gen = setup_model(torch, layers=MESH_LAYERS,
                                         n_new=ARCHS_N)
    keys = mesh_keys()
    before = dict(LAUNCHES)
    ref = mesh_rollouts(torch, model, cfg, batch, gen, keys)
    dense = ref["dense/none"]
    # [prompt | response] of each epoch, for the teacher-forced scores
    forced = [(np.concatenate([batch.tokens, rb.response], 1),
               np.concatenate([batch.mask, rb.response_mask], 1))
              for rb in dense[:2]]
    ref_forced = [score(model, cfg, toks, mask)["logprobs"].cpu().numpy()
                  for toks, mask in forced]
    require(dict(LAUNCHES) != before, "mesh: the reference launched nothing")
    chains = sample_chains(torch, keys)
    ref_rec = {mode: records_by_row(rec.calls, chains)
               for mode, (_, _, rec) in ref.items()}
    ref_acc = {mode: accept_tests_by_row(rec.verifies, keys)
               for mode, (_, _, rec) in ref.items()}
    ref_rbs = {mode: [_rb_host(rb0), _rb_host(rb1)]
               for mode, (rb0, rb1, _) in ref.items()}
    t_ref = time.perf_counter() - t0
    drafts = {mode: rb0 for mode, (rb0, _, _) in ref.items()}
    rb0 = dense[0]
    del ref, dense
    # the reference's update blobs and the watchdog's snapshot (several GB)
    # go to disk under chiprun_out/, removed after
    OUT_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        t0 = time.perf_counter()
        ref_train = mesh_train_reference(torch, model, cfg, batch, rb0, tmp)
        t_ref_train = time.perf_counter() - t0
        del model
        gc.collect()
        torch.cuda.empty_cache()
        log(f"mesh: reference ({MESH_LAYERS} layers, {len(MESH_MODES)} "
            f"modes) in {t_ref:.1f} s, its trainer in {t_ref_train:.1f} s; "
            f"{len(MESH_MODES)} modes x 2 epochs and the trainer on a "
            f"{MESH_SHAPE} gloo mesh of {MESH_WORLD} ranks on cuda:0")
        path = os.path.join(tmp, "mesh.pkl")
        with open(path, "wb") as f:
            pickle.dump({"keys": keys, "drafts": drafts, "forced": forced,
                         "rb0": rb0, "wd_dir": os.path.join(tmp, "wd")}, f)
        t0 = time.perf_counter()
        ranks = run_ranks(mesh_rank, MESH_WORLD, (path,), device="cuda",
                          timeout=MESH_TIMEOUT_S)
        t_ranks = time.perf_counter() - t0

    # the mesh's teacher-forced scores of the reference's rows
    gaps = []
    for (toks, mask), want, got in zip(forced, ref_forced,
                                       ranks[0]["forced"]):
        valid = mask & np.concatenate([np.zeros_like(mask[:, :1]),
                                       mask[:, :-1]], 1)
        gaps.append(float(np.abs(got - want)[valid].max()))
    lp_gap = max(gaps)
    require(lp_gap <= MESH_LP_TOL, f"mesh: teacher-forced log-prob gap "
            f"{gaps} passes MESH_LP_TOL {MESH_LP_TOL}")
    for r in ranks[1:]:
        for a, b in zip(r["forced"], ranks[0]["forced"]):
            require(np.array_equal(a, b), f"mesh: rank {r['rank']}'s scores "
                    "differ from rank 0's")

    summary = {}
    for mode, want in ref_rbs.items():
        got = ranks[0]["runs"][mode][0]
        for r in ranks[1:]:
            for e in (0, 1):
                for k in ("response", "length", "n", "lp"):
                    require(np.array_equal(r["runs"][mode][0][e][k],
                                           got[e][k]),
                            f"mesh {mode} epoch {e}: rank {r['rank']}'s "
                            f"{k} differs from rank 0's")
        mesh_rec = records_by_row(
            [c for r in ranks for c in r["runs"][mode][1]], chains)
        mesh_acc = accept_tests_by_row(
            [v for r in ranks for v in r["runs"][mode][2]], keys)
        summary[mode] = mesh_partings(mode, want, got, ref_rec[mode],
                                      mesh_rec, ref_acc[mode], mesh_acc)
        require(got[1]["metrics"]["one_pass"] == 1.0
                and got[1]["metrics"]["n_reused"] > 0,
                f"mesh {mode}: epoch 1 was not one-pass with reuse: "
                f"{got[1]['metrics']}")

    train = mesh_train_checks(cfg, ranks, ref_train, rb0)

    launches = Launches({k: sum(r["launches"][k] for r in ranks)
                         for k in ranks[0]["launches"]})
    launches.by_t = {name: {} for name in ranks[0]["by_t"]}
    for r in ranks:
        for name, by_t in r["by_t"].items():
            for T, c in by_t.items():
                launches.by_t[name][T] = launches.by_t[name].get(T, 0) + c
    launches.mamba_by_t = {}
    for name in ("decode_attention", "flash_attention", "spec_verify",
                 "cache_roll", "cache_slot_write", "paged_decode_attention",
                 "paged_gather"):
        require(launches[name] > 0, f"mesh: kernel {name} was not launched "
                "on the ranks")
        require(all(r["launches"][name] > 0 for r in ranks),
                f"mesh: a rank launched no {name}")
    line = {"shape": list(MESH_SHAPE), "backend": ranks[0]["backend"],
            "layers": MESH_LAYERS, "N": ARCHS_N,
            "reference_s": t_ref, "ranks_s": t_ranks,
            "rank_setup_s": [r["setup_s"] for r in ranks],
            "rank_run_s": [r["run_s"] for r in ranks],
            "rank_peak_gib": [r["peak_gib"] for r in ranks],
            "forced_lp_gap_by_epoch": gaps, "lp_tol": MESH_LP_TOL,
            "launches_by_rank": [r["launches"] for r in ranks],
            "modes": summary}
    log("mesh " + json.dumps(line))
    log("mesh train " + json.dumps({
        "reference_s": t_ref_train,
        "rank_train_s": [r["train_s"] for r in ranks], **train}))
    return launches


def _untimed(m):
    return {k: v for k, v in m.items() if not k.endswith("_time")}


def mesh_train_checks(cfg, ranks, ref, rb0):
    """The trainer's checks of the ``mesh`` phase (``mesh_rank_train``
    held the gradients and update shards on each rank): the old log-probs
    within MESH_LP_TOL of the reference's; the step log's loss,
    grad_norm, kl_ref and critic_loss within MESH_METRIC_RTOL (plus
    MESH_METRIC_ATOL) of the reference's; no kernel in any update, the
    scorings one flash_attention a layer; every rank's step log the same;
    the ``train_step``'s rows equal to the reference's up to partings
    that its recorded sampler scores explain (``mesh_partings``); the
    async steps one exact and one importance-corrected, the served
    weights the trainer's with no shared storage; the watchdog's restore
    exact.
    Returns the ``mesh train`` line's fields."""
    import numpy as np

    out = {}
    valid = np.asarray(rb0.response_mask, bool)
    for algo in ("grpo", "ppo"):
        gap = max(float(np.abs(r["train"][algo]["lp_old"]
                               - ref[algo]["lp_old"])[valid].max())
                  for r in ranks)
        require(gap <= MESH_LP_TOL, f"mesh {algo}: old log-probs {gap} from "
                f"the reference's (MESH_LP_TOL {MESH_LP_TOL})")
        for r in ranks:
            check_scoring(f"mesh rank {r['rank']} {algo}",
                          {k: {"launches": v}
                           for k, v in r["train"][algo]["launches"].items()},
                          cfg.num_layers,
                          scorings=(("old_logprob", "ref") if algo == "grpo"
                                    else ("old_logprob", "values")),
                          updates=(("update_actor",) if algo == "grpo" else
                                   ("update_actor", "update_critic")))
            require(_untimed(r["train"][algo]["metrics"])
                    == _untimed(ranks[0]["train"][algo]["metrics"]),
                    f"mesh {algo}: rank {r['rank']}'s step log differs")
        mine, theirs = ranks[0]["train"][algo], ref[algo]
        keys = ("loss", "grad_norm", "kl_ref", "critic_loss", "approx_kl",
                "clip_frac", "ratio_mean")
        require(all(np.isfinite(mine["metrics"][k]) for k in keys
                    if k in mine["metrics"]), f"mesh {algo}: not finite")
        for k in ("loss", "grad_norm", "kl_ref", "critic_loss"):
            if k in theirs["metrics"]:
                a, b = mine["metrics"][k], theirs["metrics"][k]
                require(abs(a - b) <= MESH_METRIC_RTOL * abs(b)
                        + MESH_METRIC_ATOL, f"mesh {algo}: {k} {a} against "
                        f"the reference's {b} (rtol {MESH_METRIC_RTOL}, "
                        f"atol {MESH_METRIC_ATOL})")
        out[algo] = {
            "mesh": {k: mine["metrics"][k] for k in keys
                     if k in mine["metrics"]},
            "reference": {k: theirs["metrics"][k] for k in keys
                          if k in theirs["metrics"]},
            "old_lp_gap": gap,
            "grad_gap": {lab: max(r["train"][algo]["compare"][lab][0]
                                  for r in ranks)
                         for lab in mine["compare"]},
            "worst_param_err_over_tol": {
                lab: max(r["train"][algo]["compare"][lab][2] for r in ranks)
                for lab in mine["compare"]},
            "reference_optimize_s": theirs["optimize_s"],
            "rank_optimize_s": [r["train"][algo]["optimize_s"]
                                for r in ranks],
            "rank_grad_sum_s": [r["train"][algo]["grad_sum_s"]
                                for r in ranks],
            "rank_update_s": [r["train"][algo]["metrics"].get(
                "update_actor_time") for r in ranks],
            "rank_peak_gib": [max(r["train"][algo]["peak_gib"].values())
                              for r in ranks],
            "launches": mine["launches"]}
    # the train step: rows against the reference's, partings explained
    got = ranks[0]["train"]["train_step"]
    for r in ranks[1:]:
        for k in ("response", "length"):
            require(np.array_equal(r["train"]["train_step"]["rb"][k],
                                   got["rb"][k]),
                    f"mesh train_step: rank {r['rank']}'s {k} differs")
    mesh_rec = {}
    for r in ranks:
        for k, v in records_by_call(r["train"]["train_step"]["calls"]
                                    ).items():
            mesh_rec.setdefault(k, v)
    parts = mesh_partings("train_step", [ref["train_step"]["rb"]],
                          [got["rb"]], records_by_call(
                              ref["train_step"]["calls"]), mesh_rec, {}, {})
    out["train_step"] = {"rows": parts, "step_s": [
        r["train"]["train_step"]["step_s"] for r in ranks],
        "loss": got["metrics"]["loss"],
        "reference_loss": ref["train_step"]["metrics"]["loss"]}
    a = ranks[0]["train"]["async"]
    c = a["counters"]
    require(c["async_exact_steps"] == 1 and c["async_is_steps"] == 1
            and a["staleness"] == [0.0, 1.0],
            f"mesh async: {c}, staleness {a['staleness']}")
    for r in ranks:
        ra = r["train"]["async"]
        require(ra["served_equal"] and not ra["shared_storage"],
                f"mesh async: rank {r['rank']}'s served weights "
                f"{'differ' if not ra['served_equal'] else 'share storage'}")
        require(r["train"]["watchdog"]["exact"],
                f"mesh watchdog: rank {r['rank']}'s restore is not exact")
    out["async"] = {k: a[k] for k in ("staleness", "is_weight_mean", "loss",
                                      "async_s")}
    out["watchdog"] = {k: [r["train"]["watchdog"][k] for r in ranks]
                       for k in ("snapshot_s", "restore_s")}
    return out


def mesh_partings(mode, want, got, ref_rec, mesh_rec, ref_acc, mesh_acc,
                  router_margin=None):
    """Each epoch's rows of one mode, mesh against reference: equal up to
    their first parting, every parting explained (``mesh_path``); the
    sampler-score shifts before the partings within ``MESH_LP_TOL``.
    ``ref_acc`` / ``mesh_acc``: each side's epoch-1 accept tests by row
    (``accept_tests_by_row``).  ``router_margin(e, b, col)`` (a MoE trunk):
    the reference's router margin behind row b's column col of epoch e
    (``mesh_moe_path``); where a check fails, a margin within
    ROUTER_TIE_MARGIN explains it instead, and the case is listed under
    ``router_ties``.  Returns the mode's line."""
    import numpy as np

    out = {}
    for e in range(len(want)):
        w, g = want[e], got[e]
        rows_equal, n_parts, draw_parts, shift = 0, [], [], 0.0
        ties = []

        def tie(b, col, msg, epoch=e, **what):
            """Fail with ``msg`` unless the router nearly tied there."""
            mg = None if router_margin is None else router_margin(epoch, b,
                                                                  col)
            require(mg is not None and mg <= ROUTER_TIE_MARGIN,
                    msg + ("" if mg is None else f"; router margin there "
                           f"{mg} > ROUTER_TIE_MARGIN {ROUTER_TIE_MARGIN}"))
            ties.append({"row": b, "col": col, "router_margin": mg, **what})

        for b in range(len(w["length"])):
            diff = first_difference(w["response"][b:b + 1],
                                    g["response"][b:b + 1])
            if diff is None and w["length"][b] == g["length"][b]:
                rows_equal += 1
            n_b = int(w["n"][b])
            if int(g["n"][b]) != n_b:
                m = min(n_b, int(g["n"][b]))
                require(diff is None or diff[1] >= m,
                        f"mesh {mode} epoch {e} row {b}: parts at {diff} "
                        f"before its shorter accepted prefix {m}")
                n_parts.append(accept_parting(
                    f"mesh {mode} epoch {e} row {b}", ref_acc.get(b),
                    mesh_acc.get(b), n_b, int(g["n"][b]),
                    None if router_margin is None else
                    (lambda col, b=b: router_margin(0, b, col)))
                    | {"row": b})
                continue
            c = (diff[1] if diff is not None else
                 min(int(w["length"][b]), int(g["length"][b])))
            # the sampled tokens before the parting: same prefix, same key
            first = n_b if e else 0
            for j in range(c - first):
                rr, mr = ref_rec.get((e, b, j)), mesh_rec.get((e, b, j))
                require(rr is not None and mr is not None,
                        f"mesh {mode} epoch {e} row {b}: no record of sample "
                        f"{j}")
                common = set(rr[0].tolist()) & set(mr[0].tolist())
                for t in common:
                    d = abs(float(mr[1][list(mr[0]).index(t)])
                            - float(rr[1][list(rr[0]).index(t)]))
                    if d > MESH_LP_TOL:
                        tie(b, first + j, f"mesh {mode} epoch {e} row {b}: "
                            f"sampler score of token {t} at column "
                            f"{first + j} shifted {d} (MESH_LP_TOL "
                            f"{MESH_LP_TOL})", shift=d)
                        break
                    shift = max(shift, d)
            if diff is None:
                continue
            j = c - first
            require(j >= 0, f"mesh {mode} epoch {e} row {b}: parts inside "
                    f"its accepted prefix ({c} < {n_b})")
            rr, mr = ref_rec.get((e, b, j)), mesh_rec.get((e, b, j))
            require(rr is not None and mr is not None,
                    f"mesh {mode} epoch {e} row {b}: no record of the "
                    f"parting sample {j}")
            a, t = int(rr[0][0]), int(mr[0][0])
            require(a == int(w["response"][b, c])
                    and t == int(g["response"][b, c]),
                    f"mesh {mode} epoch {e} row {b}: the records' tokens "
                    f"({a}, {t}) are not the rows' at column {c}")
            in_both = (t in rr[0].tolist() and a in mr[0].tolist())
            if not in_both:
                tie(b, c, f"mesh {mode} epoch {e} row {b} column {c}: token "
                    f"{a} (reference) or {t} (mesh) is not among both "
                    f"sides' {MESH_TOP_K} best sampler scores: {rr}, {mr}",
                    tokens=[a, t])
                continue

            def s(rec, tok):
                return float(rec[1][list(rec[0]).index(tok)])
            d_a, d_t = s(mr, a) - s(rr, a), s(mr, t) - s(rr, t)
            margin = s(rr, a) - s(rr, t)
            if not (max(abs(d_a), abs(d_t)) <= MESH_LP_TOL
                    and margin <= d_t - d_a + 1e-6):
                tie(b, c, f"mesh {mode} epoch {e} row {b} column {c}: tokens "
                    f"{a} / {t}, score shifts {d_a} / {d_t}, reference "
                    f"margin {margin} (MESH_LP_TOL {MESH_LP_TOL})",
                    tokens=[a, t], shifts=[d_a, d_t])
                continue
            draw_parts.append({"row": b, "col": c, "margin": margin,
                               "shifts": [d_a, d_t]})
        require(shift <= MESH_LP_TOL, f"mesh {mode} epoch {e}: a sampler "
                f"score shifted {shift} before its row parted "
                f"(MESH_LP_TOL {MESH_LP_TOL})")
        out[e] = {"rows_equal": rows_equal, "n_parted": n_parts,
                  "draw_parted": draw_parts, "shift_before": shift,
                  "n_generated": g["metrics"]["n_generated"],
                  "n_reused": g["metrics"]["n_reused"],
                  "ref_n_reused": w["metrics"]["n_reused"]}
        if router_margin is not None:
            out[e]["router_ties"] = ties
    return out


def accept_parting(what, ref, mesh, n_ref, n_mesh, router_margin=None):
    """The accept test parted a row at m = min(n): both sides verified the
    reference's epoch-0 row with the same key, so they must hold the same
    uniform u and draft log-prob at m, the side that accepted at m a
    threshold min(1, l * p_curr / p_prev) of at least u and the other
    one below it (the two thresholds straddle u), and the two current
    log-probs of the row's draft tokens (m among them) within
    ``MESH_LP_TOL``.  ``router_margin(col)`` (a MoE trunk): the
    reference's router margin behind draft column col; a draft token
    whose log-prob gap passes the tolerance, or thresholds that do not
    straddle u, are explained where it lies within ROUTER_TIE_MARGIN
    (listed under ``router_ties``).  Returns the parting's line."""
    import numpy as np

    require(ref is not None and mesh is not None,
            f"{what}: no record of its accept test on both sides")
    (lc_r, lp_r, u_r, vl_r, ll), (lc_m, lp_m, u_m, vl_m, ll_m) = ref, mesh
    m = min(n_ref, n_mesh)
    require(vl_r == vl_m and m < vl_r and ll == ll_m
            and np.array_equal(u_r, u_m) and np.array_equal(lp_r, lp_m),
            f"{what}: the two accept tests did not take the same draft "
            f"(valid {vl_r} / {vl_m}, parting at {m}), lenience ({ll} / "
            f"{ll_m}) or uniforms")

    def alpha(lc):
        return float(np.exp(np.minimum(
            np.float32(0), lc[m] - lp_r[m] + np.float32(ll))))
    a_r, a_m = alpha(lc_r), alpha(lc_m)
    a_acc, a_rej = (a_r, a_m) if n_ref > n_mesh else (a_m, a_r)
    u = float(u_r[m])
    gaps = np.abs(lc_r[:vl_r] - lc_m[:vl_r])
    ties = {}
    if router_margin is not None:
        for col in np.nonzero(gaps > MESH_LP_TOL)[0].tolist() + (
                [] if a_rej < u <= a_acc else [m]):
            ties[int(col)] = router_margin(int(col))
    tied = {c for c, mg in ties.items() if mg <= ROUTER_TIE_MARGIN}
    gap = float(max([0.0] + [float(x) for c, x in enumerate(gaps)
                             if c not in tied]))
    require((a_rej < u <= a_acc or m in tied) and gap <= MESH_LP_TOL,
            f"{what}: accept test at {m}: u {u}, thresholds {a_acc} "
            f"(accepting side) / {a_rej} (rejecting side), log-prob gap "
            f"{gap} over the draft (MESH_LP_TOL {MESH_LP_TOL}); router "
            f"margins there {ties}")
    out = {"n": [n_ref, n_mesh], "u": u, "alpha": [a_r, a_m],
           "lp_curr": [float(lc_r[m]), float(lc_m[m])],
           "lp_prev": float(lp_r[m]), "lp_gap": gap}
    if router_margin is not None:
        out["router_ties"] = {c: ties[c] for c in sorted(tied)}
    return out


def forced_routes(torch, model, cfg, forced, mesh=None, replay=None):
    """Teacher-forced log-probs and ``moe_aux`` of each ``forced`` (tokens,
    mask) under a ``RouteLog``: recording its routing (``replay`` None),
    or replaying the reference's calls (``replay``: one list a forced
    input), each data rank its own rows.  Returns a record a forced input:
    the whole log-probs and aux (each data rank runs its rows), the calls,
    each call's router margins and (replayed) rerouted tokens by row, and
    ``rerouted``."""
    from repro_torch.distributed.mesh import DataRows
    from repro_torch.engine.generate import moe_aux, score
    from repro_torch.models.moe import RouteLog

    out = []
    for i, (toks, mask) in enumerate(forced):
        rows = DataRows(mesh, len(toks))
        with RouteLog(None if replay is None else replay[i],
                      rows=(rows.lo, rows.hi, rows.batch)) as rl:
            lp = score(model, cfg, toks, mask, mesh=mesh)["logprobs"]
            aux = moe_aux(model, cfg, toks, mask, mesh=mesh)
        n = rows.hi - rows.lo
        out.append({
            "lp": lp.float().cpu().numpy(),
            "aux": {k: v.float().cpu().numpy() for k, v in aux.items()},
            "calls": rl.calls, "rows": (rows.lo, rows.hi),
            "margins": [x.view(n, -1).numpy() for x in rl.margins],
            "moved": [x.view(n, -1).numpy() for x in rl.moved],
            "rerouted": rl.rerouted})
    return out


def drop_reference(torch, tr) -> None:
    """GRPO without its KL term: no reference model, ``kl_coef`` 0 (the
    ``mesh moe`` trainer, whose reference would not fit the card)."""
    from dataclasses import replace

    tr.ref_model = None
    tr.pcfg = replace(tr.pcfg, kl_coef=0.0)
    gc.collect()
    torch.cuda.empty_cache()


def mesh_moe_train_reference(torch, model, cfg, rb0, tmp, kl):
    """The ``mesh moe`` trainer's single-process reference: one GRPO
    ``optimize`` of ``rb0`` (without the KL term unless ``kl``) with its
    routing recorded; the updated weights and the gradients written to
    ``tmp/grpo.pt`` in bfloat16 (the ranks hold their own prior shards)."""
    from repro_torch.models.moe import RouteLog

    tr = mesh_trainer(torch, cfg, model, "grpo")
    if not kl:
        drop_reference(torch, tr)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with RouteLog() as routes:
        m, st, grads, lp_old = mesh_optimize(torch, tr, rb0)
    t_opt = time.perf_counter() - t0
    g = _host_named(tr.model, grads["actor"])
    torch.save({"actor": {"updated": _host_named(tr.model), "grads": g,
                          "norm": math.sqrt(sum(
                              float(x.double().square().sum())
                              for x in g.values()))}},
               os.path.join(tmp, "grpo.pt"))
    check_scoring("mesh moe reference grpo", st, cfg.num_layers,
                  scorings=("old_logprob", "ref") if kl else
                  ("old_logprob",))
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "lp_old": lp_old, "optimize_s": t_opt, "calls": routes.calls,
           "launches": {k: v["launches"] for k, v in st.items()},
           "peak_gib": max(v["peak_gib"] for v in st.values())}
    del tr, grads, g
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_moe_rank_train(torch, mesh, model, cfg, data, tmp):
    """The ``mesh moe`` trainer on this rank: the reference's GRPO
    ``optimize`` of its epoch-0 rows under its replayed routing, held
    against its update (``compare_shards``, the moments freed first)."""
    from repro_torch.distributed.mesh import DataRows, model_rank, model_size
    from repro_torch.models.moe import RouteLog

    tr = mesh_trainer(torch, cfg, model, "grpo", mesh)
    if not data["kl"]:
        drop_reference(torch, tr)
    prior = _host_named(tr.model)
    rows = DataRows(mesh, PROMPTS * GROUP)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with RouteLog(data["train_calls"], rows=(rows.lo, rows.hi,
                                             rows.batch)) as routes:
        m, st, grads, lp_old = mesh_optimize(torch, tr, data["rb0"])
    t_opt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tr.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()
    ref = torch.load(os.path.join(tmp, "grpo.pt"), mmap=True,
                     weights_only=True)
    scale = min(1.0, 1.0 / (ref["actor"]["norm"] + 1e-9))
    cmp = compare_shards(torch, "moe grpo actor", tr.model, grads["actor"],
                         ref["actor"], scale, model_rank(mesh),
                         model_size(mesh), prior=prior)
    del ref, tr, grads, prior
    gc.collect()
    torch.cuda.empty_cache()
    return {"metrics": {k: float(v) for k, v in m.items()},
            "lp_old": lp_old, "optimize_s": t_opt, "compare": cmp,
            "rerouted": routes.rerouted, "peak_gib": peak,
            "launches": {k: v["launches"] for k, v in st.items()},
            "stage_peak_gib": {k: v["peak_gib"] for k, v in st.items()}}


def mesh_moe_rank(rank, path):
    """One rank of the ``mesh moe`` phase: mixtral cut over its model
    group, each mode's two epochs, the teacher-forced scores and
    ``moe_aux`` of the reference's rows under its routing, then the
    trainer (``mesh_moe_rank_train``); returns what it saw."""
    import pickle

    import torch

    from repro_torch.distributed.mesh import MeshConfig, shard_params
    from repro_torch.kernels import _build, reset_launches

    with open(path, "rb") as f:
        data = pickle.load(f)
    t0 = time.perf_counter()
    _build.library()
    mesh = MeshConfig(*MESH_SHAPE, require=True).build("cuda")
    model, cfg, batch, gen = setup_model(torch, MESH_MOE_ARCH,
                                         layers=MESH_MOE_LAYERS,
                                         n_new=ARCHS_N)
    model = shard_params(mesh, cfg, model)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    log_rank("moe rollouts")
    runs = mesh_rollouts(torch, model, cfg, batch, gen, data["keys"],
                         mesh=mesh, drafts=data["drafts"],
                         modes=MESH_MOE_MODES)
    forced = forced_routes(torch, model, cfg, data["forced"], mesh=mesh,
                           replay=data["calls"])
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log_rank("moe trainer")
    t0 = time.perf_counter()
    train = mesh_moe_rank_train(torch, mesh, model, cfg, data,
                                os.path.dirname(path))
    t_train = time.perf_counter() - t0
    launches = read_launches()
    for f in forced:
        del f["calls"]
    return {"rank": rank, "setup_s": t_setup, "run_s": t_run,
            "train_s": t_train, "train": train, "peak_gib": peak,
            "launches": dict(launches), "by_t": launches.by_t,
            "runs": {mode: ([_rb_host(rb0), _rb_host(rb1)], rec.calls,
                            rec.verifies)
                     for mode, (rb0, rb1, rec) in runs.items()},
            "forced": forced}


def mesh_moe_path(torch, kl: bool = False):
    """The MoE family on the §8 mesh on the card: the single-process
    reference first (mixtral-8x22b at full width, MESH_MOE_LAYERS layer,
    bfloat16: each MESH_MOE_MODES mode's two epochs with its sampler
    records, the teacher-forced scores and ``moe_aux`` of each mode's rows
    with their routing recorded, and one GRPO ``optimize`` of the dense
    epoch-0 rows, without its KL term unless ``kl``), the model then
    freed; then four ``gloo`` ranks on ``cuda:0`` as a (2, 2) mesh doing
    the same on their shards.  Checks: the teacher-forced log-probs under
    the reference's replayed routing within MESH_LP_TOL, ``moe_drop_frac``
    within 1e-6 of the reference's, every token the replay rerouted at a
    recorded router margin within ROUTER_TIE_MARGIN; every row equal to
    the reference's up to partings that the sampler scores or a router
    near tie explain (``mesh_partings``), every rank's rows the same,
    epoch 1 one-pass with reuse; the update's gradients and shards
    (``compare_shards``), its step log (loss, grad_norm, moe_lb_loss)
    within MESH_METRIC_RTOL plus MESH_METRIC_ATOL, no kernel in the
    update; the seven attention-path kernels launched on every rank."""
    import pickle
    import tempfile

    import numpy as np

    from repro_torch.distributed.mesh import run_ranks
    from repro_torch.kernels import LAUNCHES

    t0 = time.perf_counter()
    model, cfg, batch, gen = setup_model(torch, MESH_MOE_ARCH,
                                         layers=MESH_MOE_LAYERS,
                                         n_new=ARCHS_N)
    keys = mesh_keys()
    before = dict(LAUNCHES)
    ref = mesh_rollouts(torch, model, cfg, batch, gen, keys,
                        modes=MESH_MOE_MODES)
    modes = list(ref)
    # [prompt | response] of each mode's epochs: mode-major, then epoch
    forced = [(np.concatenate([batch.tokens, rb.response], 1),
               np.concatenate([batch.mask, rb.response_mask], 1))
              for mode in modes for rb in ref[mode][:2]]
    ref_forced = forced_routes(torch, model, cfg, forced)
    require(dict(LAUNCHES) != before, "mesh moe: the reference launched "
            "nothing")
    chains = sample_chains(torch, keys)
    ref_rec = {mode: records_by_row(rec.calls, chains)
               for mode, (_, _, rec) in ref.items()}
    ref_acc = {mode: accept_tests_by_row(rec.verifies, keys)
               for mode, (_, _, rec) in ref.items()}
    ref_rbs = {mode: [_rb_host(rb0), _rb_host(rb1)]
               for mode, (rb0, rb1, _) in ref.items()}
    t_ref = time.perf_counter() - t0
    drafts = {mode: rb0 for mode, (rb0, _, _) in ref.items()}
    rb0 = ref["dense/none"][0]
    del ref
    OUT_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        t0 = time.perf_counter()
        ref_train = mesh_moe_train_reference(torch, model, cfg, rb0, tmp, kl)
        t_ref_train = time.perf_counter() - t0
        del model
        gc.collect()
        torch.cuda.empty_cache()
        log(f"mesh moe: reference ({MESH_MOE_ARCH}, {MESH_MOE_LAYERS} "
            f"layer, {len(modes)} modes) in {t_ref:.1f} s, its trainer in "
            f"{t_ref_train:.1f} s; the same on a {MESH_SHAPE} gloo mesh of "
            f"{MESH_WORLD} ranks on cuda:0")
        path = os.path.join(tmp, "mesh_moe.pkl")
        with open(path, "wb") as f:
            pickle.dump({"keys": keys, "drafts": drafts, "forced": forced,
                         "calls": [r["calls"] for r in ref_forced],
                         "train_calls": ref_train.pop("calls"), "rb0": rb0,
                         "kl": kl}, f)
        t0 = time.perf_counter()
        # four ranks' 17.4 GB leave the card a few GB: the ranks' allocator
        # maps its segments as they grow rather than caching fixed blocks
        alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            ranks = run_ranks(mesh_moe_rank, MESH_WORLD, (path,),
                              device="cuda", timeout=MESH_MOE_TIMEOUT_S)
        finally:
            if alloc is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        t_ranks = time.perf_counter() - t0

    # the teacher-forced scores and aux under the replayed routing; the
    # rerouted tokens by row, from the data ranks of model rank 0
    firsts = [r for r in ranks if r["rank"] % MESH_SHAPE[1] == 0]
    gaps, drops, rerouted, moved_margin = [], [], 0, 0.0
    margins = {}
    for i, ((toks, mask), want) in enumerate(zip(forced, ref_forced)):
        got = ranks[0]["forced"][i]
        valid = mask & np.concatenate([np.zeros_like(mask[:, :1]),
                                       mask[:, :-1]], 1)
        gaps.append(float(np.abs(got["lp"] - want["lp"])[valid].max()))
        for r in ranks[1:]:
            require(np.array_equal(r["forced"][i]["lp"], got["lp"]),
                    f"mesh moe: rank {r['rank']}'s scores differ from rank "
                    "0's")
        for r in ranks:
            d = abs(float(r["forced"][i]["aux"]["moe_drop_frac"])
                    - float(want["aux"]["moe_drop_frac"]))
            drops.append(d)
        # the reference's margins (B, L) of each layer; the replay's
        # rerouted tokens by row, each rank's own rows
        ref_m = np.min(np.stack(want["margins"][:cfg.num_layers]), 0)
        margins[i] = ref_m
        for r in firsts:
            lo, hi = r["forced"][i]["rows"]
            # the score's calls (the aux forward's repeat them)
            for mv in r["forced"][i]["moved"][:cfg.num_layers]:
                mv = mv.reshape(hi - lo, -1)[:, :ref_m.shape[1]].astype(bool)
                mv &= mask[lo:hi]
                rerouted += int(mv.sum())
                if mv.any():
                    moved_margin = max(moved_margin,
                                       float(ref_m[lo:hi][mv].max()))
    lp_gap = max(gaps)
    require(lp_gap <= MESH_LP_TOL, f"mesh moe: teacher-forced log-prob gap "
            f"{gaps} passes MESH_LP_TOL {MESH_LP_TOL}")
    require(max(drops) <= 1e-6, f"mesh moe: moe_drop_frac off by "
            f"{max(drops)} of the reference's")
    require(moved_margin <= ROUTER_TIE_MARGIN, f"mesh moe: a rerouted "
            f"token's router margin {moved_margin} passes ROUTER_TIE_MARGIN "
            f"{ROUTER_TIE_MARGIN}")

    summary = {}
    for k, mode in enumerate(modes):
        want = ref_rbs[mode]
        got = ranks[0]["runs"][mode][0]
        for r in ranks[1:]:
            for e in (0, 1):
                for key in ("response", "length", "n", "lp"):
                    require(np.array_equal(r["runs"][mode][0][e][key],
                                           got[e][key]),
                            f"mesh moe {mode} epoch {e}: rank {r['rank']}'s "
                            f"{key} differs from rank 0's")
        mesh_rec = records_by_row(
            [c for r in ranks for c in r["runs"][mode][1]], chains)
        mesh_acc = accept_tests_by_row(
            [v for r in ranks for v in r["runs"][mode][2]], keys)

        def router_margin(e, b, col, k=k):
            return float(margins[2 * k + e][b, P + col - 1])
        summary[mode] = mesh_partings(f"moe {mode}", want, got,
                                      ref_rec[mode], mesh_rec, ref_acc[mode],
                                      mesh_acc, router_margin)
        require(got[1]["metrics"]["one_pass"] == 1.0
                and got[1]["metrics"]["n_reused"] > 0,
                f"mesh moe {mode}: epoch 1 was not one-pass with reuse: "
                f"{got[1]['metrics']}")
    ties = sum(len(v.get("router_ties", [])) + sum(
        len(p.get("router_ties", {})) for p in v["n_parted"])
        for s_ in summary.values() for v in s_.values())

    train = mesh_moe_train_checks(cfg, ranks, ref_train, rb0)

    launches = Launches({k: sum(r["launches"][k] for r in ranks)
                         for k in ranks[0]["launches"]})
    launches.by_t = {name: {} for name in ranks[0]["by_t"]}
    for r in ranks:
        for name, by_t in r["by_t"].items():
            for T, c in by_t.items():
                launches.by_t[name][T] = launches.by_t[name].get(T, 0) + c
    launches.mamba_by_t = {}
    line = {"arch": MESH_MOE_ARCH, "shape": list(MESH_SHAPE),
            "layers": MESH_MOE_LAYERS, "N": ARCHS_N,
            "reference_s": t_ref, "ranks_s": t_ranks,
            "rank_setup_s": [r["setup_s"] for r in ranks],
            "rank_run_s": [r["run_s"] for r in ranks],
            "rank_peak_gib": [r["peak_gib"] for r in ranks],
            "forced_lp_gap": gaps, "lp_tol": MESH_LP_TOL,
            "drop_frac": float(ref_forced[0]["aux"]["moe_drop_frac"]),
            "drop_frac_gap": max(drops), "rerouted": rerouted,
            "rerouted_max_margin": moved_margin,
            "router_tie_margin": ROUTER_TIE_MARGIN,
            "router_tie_cases": ties,
            "launches_by_rank": [r["launches"] for r in ranks],
            "modes": summary}
    log("mesh moe " + json.dumps(line))
    log("mesh moe train " + json.dumps({
        "reference_s": t_ref_train,
        "rank_train_s": [r["train_s"] for r in ranks], **train}))
    for name in ("decode_attention", "flash_attention", "spec_verify",
                 "cache_roll", "cache_slot_write", "paged_decode_attention",
                 "paged_gather"):
        require(all(r["launches"][name] > 0 for r in ranks),
                f"mesh moe: a rank launched no {name}")
    return launches


def mesh_moe_train_checks(cfg, ranks, ref, rb0):
    """The ``mesh moe`` trainer's checks (``mesh_moe_rank_train`` held the
    gradients and shards on each rank): old log-probs within MESH_LP_TOL
    of the reference's, every rank's step log the same, its loss,
    grad_norm and moe_lb_loss within MESH_METRIC_RTOL of the reference's
    plus MESH_METRIC_ATOL, no kernel in the update and the scoring one
    flash_attention a layer.  Returns the ``mesh moe train`` line's
    fields."""
    import numpy as np

    valid = np.asarray(rb0.response_mask, bool)
    gap = max(float(np.abs(r["train"]["lp_old"] - ref["lp_old"])[valid]
                    .max()) for r in ranks)
    require(gap <= MESH_LP_TOL, f"mesh moe grpo: old log-probs {gap} from "
            f"the reference's (MESH_LP_TOL {MESH_LP_TOL})")
    scorings = tuple(k for k in ("old_logprob", "ref")
                     if k in ranks[0]["train"]["launches"])
    for r in ranks:
        check_scoring(f"mesh moe rank {r['rank']} grpo",
                      {k: {"launches": v}
                       for k, v in r["train"]["launches"].items()},
                      cfg.num_layers, scorings=scorings)
        require(_untimed(r["train"]["metrics"])
                == _untimed(ranks[0]["train"]["metrics"]),
                f"mesh moe grpo: rank {r['rank']}'s step log differs")
    mine, theirs = ranks[0]["train"]["metrics"], ref["metrics"]
    keys = ("loss", "grad_norm", "moe_lb_loss", "kl_ref", "approx_kl",
            "clip_frac", "ratio_mean")
    require(all(np.isfinite(mine[k]) for k in keys if k in mine),
            "mesh moe grpo: not finite")
    for k in ("loss", "grad_norm", "moe_lb_loss", "kl_ref"):
        if k in theirs:
            a, b = mine[k], theirs[k]
            require(abs(a - b) <= MESH_METRIC_RTOL * abs(b)
                    + MESH_METRIC_ATOL, f"mesh moe grpo: {k} {a} against "
                    f"the reference's {b} (rtol {MESH_METRIC_RTOL}, atol "
                    f"{MESH_METRIC_ATOL})")
    return {"mesh": {k: mine[k] for k in keys if k in mine},
            "reference": {k: theirs[k] for k in keys if k in theirs},
            "kl": "kl_ref" in theirs, "old_lp_gap": gap,
            "grad_gap": max(r["train"]["compare"][0] for r in ranks),
            "worst_param_err_over_tol": max(r["train"]["compare"][2]
                                            for r in ranks),
            "rerouted": [r["train"]["rerouted"] for r in ranks],
            "reference_optimize_s": ref["optimize_s"],
            "reference_peak_gib": ref["peak_gib"],
            "rank_optimize_s": [r["train"]["optimize_s"] for r in ranks],
            "rank_update_peak_gib": [r["train"]["peak_gib"] for r in ranks],
            "rank_update_s": [r["train"]["metrics"].get("update_actor_time")
                              for r in ranks],
            "launches": ranks[0]["train"]["launches"]}


BREAKDOWN_STEPS = 16
_PROFILE_ROWS = ["what\tside\tname\tcalls\tself_ms"]


def time_breakdown(torch, what: str, run):
    """Where the time of ``run()`` goes: host wall time without the
    profiler, then device busy time, CUDA kernel launches and the top
    kernels and host ops from ``torch.profiler`` over the same call.  The
    profiled call follows ``Timer.device_ms``'s rule: ``profile_window``'s
    padded window, a marker kernel before the call and one after it, and
    a trace read only when it holds both (else profiled again, up to
    ``PROFILE_SESSIONS`` times, then a failure with the counts).  The
    markers stay out of every figure: device busy time, launches, the top
    kernels and the ``.tsv``."""
    from torch.autograd import DeviceType

    def timed():
        run()
        torch.cuda.synchronize()

    def marked():
        torch.cuda._sleep(MARK_CYCLES)
        run()
        torch.cuda._sleep(MARK_CYCLES)

    timed()
    t0 = time.perf_counter()
    timed()
    wall_ms = (time.perf_counter() - t0) * 1e3
    for sessions in range(1, PROFILE_SESSIONS + 1):
        trace = profile_window(torch, marked)
        markers, lead_in = marker_counts(trace)
        events = trace.key_averages()
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        if markers == 2:
            break
        log(f"profiler session {sessions} of breakdown {what!r}: a trace "
            f"with {markers} of 2 markers and "
            f"{sum(e.count for e in device)} device events lost device "
            f"events ({LEAD_IN - lead_in} of the lead-in's {LEAD_IN})")
    require(markers == 2,
            f"the profiler lost device events in each of {PROFILE_SESSIONS} "
            f"sessions of breakdown {what!r}: {markers} of 2 markers")
    kernels = sorted((e for e in device if MARKER not in e.key),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    launches = sum(e.count for e in host              # and ...KernelExC
                   if e.key.startswith("cudaLaunchKernel")) - LEAD_IN - 2
    log("breakdown " + json.dumps({
        "what": what, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "cuda_launches": launches, "profiler_sessions": sessions,
        "lead_in_lost": LEAD_IN - lead_in,
        "top_kernels": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                        for e in kernels[:8]],
        "top_host_ops": [[e.key[:60], e.count, e.self_cpu_time_total / 1e3]
                         for e in host[:8]]}))
    _PROFILE_ROWS.extend(
        [f"{what}\tdevice\t{e.key}\t{e.count}\t{e.self_device_time_total / 1e3}"
         for e in kernels[:40]]
        + [f"{what}\thost\t{e.key}\t{e.count}\t{e.self_cpu_time_total / 1e3}"
           for e in host[:40]])
    (OUT_DIR / "chip_smoke_profile.tsv").write_text(
        "\n".join(_PROFILE_ROWS) + "\n")


def generate_breakdown(torch, model, cfg, gen, batch):
    """A vanilla generate at the slice's batch: prefill + 16 decode steps,
    named by the cache layout (an RWKV trunk's: ``rwkv``)."""
    from dataclasses import replace

    from repro_torch.engine.generate import generate
    from repro_torch.engine.sampling import make_key

    g = replace(gen, eos_id=-1, max_new_tokens=BREAKDOWN_STEPS)
    layout = "rwkv" if cfg.block_kind == "rwkv" else cfg.cache_layout
    time_breakdown(
        torch, f"generate {layout} B={batch.tokens.shape[0]} "
        f"P={batch.tokens.shape[1]} steps={BREAKDOWN_STEPS}",
        lambda: generate(model, cfg, g, batch.tokens, batch.mask,
                         make_key(SEED + 1)))


def engine_breakdown(torch, model, cfg, gen, batch):
    """The slot engine serving SLOTS requests of 16 tokens on SLOTS slots:
    one admission (prefill) + 16 decode steps."""
    from dataclasses import replace

    from repro_torch.engine.sampling import make_key, request_keys
    from repro_torch.serving import Request, SlotEngine

    g = replace(gen, eos_id=-1, max_new_tokens=BREAKDOWN_STEPS)
    keys = request_keys(make_key(SEED + 1), SLOTS)

    def run():
        eng = SlotEngine(model, cfg, g, num_slots=SLOTS, prompt_width=P)
        for i in range(SLOTS):
            row = batch.tokens[i, P - int(batch.mask[i].sum()):]
            eng.submit(Request(request_id=i, prompt=row, key=keys[i],
                               max_new_tokens=BREAKDOWN_STEPS))
        eng.run()

    time_breakdown(torch, f"slot engine B={SLOTS} P={P} "
                   f"steps={BREAKDOWN_STEPS}", run)


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on the "
              "card", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_build.log").write_text(_build.build_log())
    for line in _build.build_log().splitlines():
        if ("registers" in line or "spill" in line or "error" in line
                or "Compiling entry" in line):
            log("  ptxas: " + line.strip())

    from repro_torch.engine.sampling import make_key

    high_seed = make_key(2 ** 64 - 1).uniform((4,)).tolist()
    log(f"make_key(2**64 - 1) on the card draws {high_seed}")

    def run(label, fn, *args, **kw):
        t0 = time.perf_counter()
        log(f"phase {label} starts {t0 - t_start:.1f} s into the smoke")
        out = fn(*args, **kw)
        log(f"phase {label} took {time.perf_counter() - t0:.1f} s")
        return out

    timer = Timer(torch)
    records = run("kernels", kernel_checks, torch, timer)
    run("arch kernels", arch_kernel_checks, torch, timer, records)
    run("frontend kernels", frontend_kernel_checks, torch, timer, records)
    run("mla kernels", mla_kernel_checks, torch, timer, records)
    del timer
    torch.cuda.empty_cache()
    run("small qwen", small_reference, torch, "qwen3-1.7b",
        SMALL_TOL["qwen3-1.7b"], num_kv_heads=2)
    run("small rwkv", small_reference, torch, "rwkv6-3b",
        SMALL_TOL["rwkv6-3b"], tol_f32=SMALL_TOL_F32)
    for arch in ARCH_LAYERS:
        run(f"small {arch}", small_reference, torch, arch, SMALL_TOL[arch],
            **SMALL_OVERRIDES.get(arch, {}))
    run("small deepseek-v3-671b paged", small_reference, torch,
        "deepseek-v3-671b", SMALL_TOL["deepseek-v3-671b"],
        title="deepseek-v3-671b paged", cache_layout="paged",
        **SMALL_OVERRIDES["deepseek-v3-671b"])
    run("small mixtral-8x22b dispatch", small_reference, torch,
        "mixtral-8x22b", SMALL_TOL["mixtral-8x22b"],
        title="mixtral-8x22b dispatch, window 8", moe_impl="dispatch",
        sliding_window=8)
    for arch in FRONTEND_LAYERS:
        run(f"small {arch}", small_reference, torch, arch, SMALL_TOL[arch])
    paths = {"mesh": run("mesh", mesh_path, torch)}
    gc.collect()
    torch.cuda.empty_cache()
    paths["mesh moe"] = run("mesh moe", mesh_moe_path, torch)
    gc.collect()
    torch.cuda.empty_cache()
    model, cfg, batch, gen = setup_model(torch)
    cut_model, cut_cfg = cut_depth(model, cfg, CUT_LAYERS)
    log(f"paths {', '.join(CUT_PATHS)} run the model cut to {CUT_LAYERS} "
        f"of its {cfg.num_layers} layers")
    paths["rollout"] = run("rollout", main_path, torch, model, cfg, batch,
                           gen)
    paths["slots"], slots_rbs = run("slots", slots_path, torch, cut_model,
                                    cut_cfg, batch, gen)
    run("slot engine breakdown", engine_breakdown, torch, cut_model, cut_cfg,
        gen, batch)
    paths["paged"] = run("paged", paged_path, torch, cut_model, cut_cfg,
                         batch, gen)
    run("paged breakdown", generate_breakdown, torch, cut_model,
        cut_cfg.replace(cache_layout="paged"), gen, batch)
    paths["paged_slots"] = run("paged_slots", paged_slots_path, torch,
                               cut_model, cut_cfg, batch, gen, slots_rbs)
    paths["draft"] = run("draft", draft_path, torch, cut_model, cut_cfg,
                         batch, gen)
    run("greedy witness", greedy_witness, torch, model, cfg, batch, gen)
    gc.collect()
    torch.cuda.empty_cache()
    paths["draft_slots"], off_rbs = run("draft_slots", draft_slots_path,
                                        torch, cut_model, cut_cfg, batch, gen)
    paths["observatory"] = run("observatory", observatory_path, torch,
                               cut_model, cut_cfg, batch, gen,
                               paths["draft_slots"], off_rbs)
    paths["faults"] = run("faults", faults_path, torch, cut_model, cut_cfg,
                          batch, gen)
    del cut_model
    paths["train"], rb1 = run("train", train_path, torch,
                              *cut_depth(model, cfg, CUT_LAYERS), batch)
    gc.collect()                # the GRPO trainer's reference and moments
    torch.cuda.empty_cache()
    paths["ppo"] = run("ppo", ppo_path, torch,
                       *cut_depth(model, cfg, CUT_LAYERS), batch, rb1)
    gc.collect()                # the PPO trainer's critic and moments
    torch.cuda.empty_cache()
    paths["dapo"] = run("dapo", dapo_path, torch,
                        *cut_depth(model, cfg, CUT_LAYERS), batch)
    gc.collect()                # the DAPO trainer
    torch.cuda.empty_cache()
    paths["async"] = run("async", async_path, torch,
                         *cut_depth(model, cfg, ASYNC_LAYERS), batch)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    paths["watchdog"] = run("watchdog", watchdog_path, torch, cfg, batch)
    gc.collect()
    torch.cuda.empty_cache()
    run("train witness", train_witness, torch, rb1)
    torch.cuda.empty_cache()
    paths["serve"] = run("serve", serve_path, torch)
    paths["rwkv"], records["wkv"]["launches_by_t"] = run("rwkv", rwkv_path,
                                                         torch)
    gc.collect()
    torch.cuda.empty_cache()
    for arch in ARCH_LAYERS:
        paths[f"archs {arch}"] = run(f"archs {arch}", archs_path, torch, arch)
    for arch in TRAIN_LAYERS:
        label = f"{arch.split('-')[0]} train"
        paths[label] = run(label, arch_train_path, torch, arch)
    run("jamba consistency", jamba_consistency, torch)
    for arch in FRONTEND_LAYERS:
        paths[f"archs {arch}"] = run(f"archs {arch}", frontend_archs_path,
                                     torch, arch)
    paths["serve frontends"] = run("serve frontends", serve_frontends_path,
                                   torch)
    # the decode kernels by path and T, each read with the path's launches:
    # draft blocks (T > 1) on the two draft paths, dense and paged, and
    # nowhere else (no prefill, verify or score moved off flash_attention)
    log("decode launches by path and T: " + json.dumps(
        {p: paths[p].by_t for p in paths}))
    for p, launches in paths.items():
        require(sum(launches.mamba_by_t.values()) == launches["mamba_scan"],
                f"{p}: mamba_scan launches by T {launches.mamba_by_t} do not "
                f"sum to {launches['mamba_scan']}")
        for name, by_t in launches.by_t.items():
            require(sum(by_t.values()) == launches[name],
                    f"{p}: {name} launches by T {by_t} do not sum to "
                    f"{launches[name]}")
            require(p in ("draft", "draft_slots", "observatory")
                    or not launches.blocks(name),
                    f"{p}: {name} launched at T > 1 {by_t}")
    require(paths["draft"].blocks("decode_attention") > 0,
            "draft: no dense decode launch at T > 1")
    require(paths["draft_slots"].blocks("paged_decode_attention") > 0,
            "draft_slots: no paged decode launch at T > 1")
    for name in ("decode_attention", "paged_decode_attention"):
        records[name]["launches_by_path_and_t"] = {
            p: paths[p].by_t[name] for p in paths}
    records["mamba_scan"]["launches_by_path_and_t"] = {
        p: paths[p].mamba_by_t for p in paths if paths[p].mamba_by_t}
    for name, rec in records.items():
        rec["launches_by_path"] = {p: paths[p][name] for p in paths}
        rec["launches"] = sum(rec["launches_by_path"].values())
        require(rec["launches"] > 0, f"kernel {name} was launched on no path")
    log(f"profiler lead-in: {len(LEAD_IN_LOST)} sessions, records lost of "
        f"the lead-in's {LEAD_IN} by session {LEAD_IN_LOST}")
    log(f"chip smoke: all checks passed in {time.perf_counter() - t_start:.1f} s "
        f"(make_key(2**64 - 1) on the card drew {high_seed})")
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
