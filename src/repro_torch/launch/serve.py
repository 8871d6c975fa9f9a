"""Serving launcher of the port (``repro/launch/serve.py``'s flags for the
slot server): a continuous-batching slot server with a request arrival
stream, speculative-prefix admission and latency/throughput stats
(DESIGN.md §6), or one-shot fixed-batch generation (``--engine fixed``).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \\
        --spec-prefix
    PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \\
        --arch qwen3-1.7b --requests 64 --slots 8 --spec-prefix
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \\
        --cache-layout paged --kv-block-size 8 --deadline-steps 64 \\
        --max-queue 16 --overflow shed-oldest --state-path /tmp/serve_state
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \\
        --spec-prefix --draft 4 --ledger --decision-log /tmp/d \\
        --trace-dir /tmp/t --assert-compile-stable

Runs on the card unless ``--device cpu``.  As in JAX the model config is
always the architecture's ``.reduced(...)`` smoke variant, with random
weights from ``--seed``; on the card it runs in bfloat16 (the port's
kernels take bfloat16), on the CPU in float32 as JAX's.  ``--cache-layout
paged`` serves through the ``PagedSlotEngine`` (or the paged fixed batch
with ``--engine fixed``).  An encoder-decoder (``--arch whisper-tiny``)
or a vision prefix (``--arch pixtral-12b``) serves on the fixed batch
only, with stub conditioning drawn from ``--seed`` as JAX's
``_model_extras`` draws it: frames encoded once a batch, or patch
embeddings in front of each prompt.  §10 hardening: ``--deadline-steps``,
``--max-queue``, ``--overflow``; with ``--state-path``, SIGTERM / Ctrl-C
stops the serve at the next chunk boundary and snapshots the exact server
state there
(``checkpoint/io.save_server_state``; resume with ``load_server_state``
into an engine built the same way).  ``--draft K`` serves through the §9
draft engine (n-gram drafts of up to K tokens a forward; with
``--spec-prefix`` the first pass's output is each request's corpus) and
prints a ``draft:`` stats line.

The §11/§14 observatory, as in JAX, on the main (speculative) serve only:
``--trace-dir DIR`` writes ``trace.json`` (Chrome trace), ``events.jsonl``
and ``metrics.prom`` there (``--trace-sample-rate`` thins the request
lanes); ``--ledger`` prints the savings-attribution table;
``--decision-log DIR`` shards the draft decisions under DIR; ``--metrics
PORT`` serves the engine's Prometheus text on ``localhost:PORT/metrics``
while it runs; ``--assert-compile-stable`` replays the same request set on
a fresh engine and fails if the recompile sentinel sees a new call
signature, else ends with ``0 new on identical replay``.

The §8 mesh, one process a rank under ``torchrun``::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --device cpu --smoke \
        --mesh-data 2 --mesh-model 2

``--mesh-data D --mesh-model M`` lays the ranks out as a (D, M) mesh
(``distributed/mesh.py``): the model is cut over each model group of M
ranks and, with D > 1, the slots over D shards, one scheduler each
(``MeshSlotServer``); ``--engine fixed`` decodes each data shard's rows.
The ranks take ``gloo`` unless each has a card of its own (then NCCL).
Without enough ranks the mesh is off, as in JAX, or with
``--require-mesh`` the launcher raises.  Rank 0 prints.  The sinks are
per process on the mesh (the model ranks of a shard hold the same):
``--ledger``'s report sums every shard's provenance counts and
``--trace-dir`` every shard's spans and events, gathered over the data
group, and rank 0 writes them; with ``--decision-log`` each data shard's
first model rank writes its shard's records, rotating as one process
does, into files of its own (``decisions-s<shard>-NNNNN``, which
``load_dataset`` reads together); ``--metrics`` on rank 0 serves every
shard's registry merged, as the shards last published it
(``serving/mesh_server.py:MetricsBoard``).  ``--state-path``: SIGTERM /
Ctrl-C stops a model group at a chunk boundary its ranks agree on (an
all-reduce of the stop flag at each boundary), every rank snapshots its
shard, and rank 0 writes the whole server's state.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import random
import shutil
import signal
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.cache import RolloutCache
from repro_torch.data.dataset import PromptDataset
from repro_torch.data.tokenizer import VOCAB_SIZE, decode
from repro_torch.device import sync
from repro_torch.distributed.comm import all_gather_objects, all_reduce_
from repro_torch.distributed.mesh import (MeshConfig, data_group, data_rank,
                                          data_size, init_from_env,
                                          model_group, model_rank, model_size,
                                          shard_params)
from repro_torch.drafting import DraftConfig
from repro_torch.engine.generate import GenerateConfig, generate
from repro_torch.engine.sampling import fold_in, make_key, stack_keys
from repro_torch.models import model as M
from repro_torch.obs import Tracer, configure, get_decision_log
from repro_torch.obs import export as obs_export
from repro_torch.obs.alerts import compile_counts
from repro_torch.obs.attrib import build_report, measured_token_cost
from repro_torch.obs.ledger import DecisionLog, TokenLedger
from repro_torch.rewards.mathgen import MathTaskConfig, generate_problems
from repro_torch.serving import (EngineKilled, FaultEvent, FaultPlan,
                                 Request, make_slot_engine)
from repro_torch.serving.mesh_server import MeshSlotServer, MetricsBoard

# long-tailed per-request budgets (fractions of --max-new-tokens): most
# requests are short, a few run to the full budget — the regime where
# fixed-batch decode idles on its stragglers
TAIL_FRACTIONS = (0.25, 0.25, 0.5, 1.0)
TAIL_WEIGHTS = (0.5, 0.25, 0.15, 0.1)


def build_requests(ds: PromptDataset, rng: random.Random, n_requests: int,
                   max_new_tokens: int, key) -> list:
    batch = ds.sample_batch(rng, n_requests, 1)
    reqs = []
    for i in range(n_requests):
        p_len = int(batch.mask[i].sum())
        budget = max(1, int(max_new_tokens *
                            rng.choices(TAIL_FRACTIONS, TAIL_WEIGHTS)[0]))
        reqs.append(Request(
            request_id=i, prompt=batch.tokens[i, -p_len:].astype(np.int32),
            key=fold_in(key, i), max_new_tokens=budget))
    return reqs


def _model_extras(model, cfg, batch: int, seed: int) -> dict:
    """Stub modality conditioning for an encoder or vision trunk, from a
    generator on the model's device seeded with ``seed``: normal frames
    (B, encoder_frames, d_model) through ``M.encode``, and normal patch
    embeddings (B, num_prefix_embeddings, d_model)."""
    kw = {}
    if not (cfg.encoder_layers or cfg.num_prefix_embeddings):
        return kw
    g = torch.Generator(device=model.device)
    g.manual_seed(seed)
    normal = dict(generator=g, device=model.device)
    if cfg.encoder_layers:
        frames = torch.randn((batch, cfg.encoder_frames, cfg.d_model),
                             **normal)
        enc, pos = M.encode(model, cfg, frames)
        kw = {"encoder_out": enc, "encoder_positions": pos}
    if cfg.num_prefix_embeddings:
        kw["prefix_embeds"] = torch.randn(
            (batch, cfg.num_prefix_embeddings, cfg.d_model), **normal)
    return kw


def serve_fixed(model, cfg, gen, reqs, prompt_width, slots, seed: int = 0,
                mesh=None):
    """Fixed-batch baseline: decode ``slots``-sized batches to the slowest
    row, each row on its own key and budget, with a batch's stub modality
    conditioning (``_model_extras``, from ``seed``); on a ``mesh`` each
    data rank decodes its rows.  Returns (tokens dict, n_generated)."""
    outs, total = {}, 0
    for lo in range(0, len(reqs), slots):
        chunk = reqs[lo:lo + slots]
        B = len(chunk)
        toks = np.zeros((B, prompt_width), np.int32)
        mask = np.zeros((B, prompt_width), bool)
        for j, r in enumerate(chunk):
            toks[j, prompt_width - len(r.prompt):] = r.prompt
            mask[j, prompt_width - len(r.prompt):] = True
        keys = stack_keys([r.key for r in chunk])
        budget = np.asarray([r.max_new_tokens for r in chunk], np.int32)
        out = generate(model, cfg, gen, toks, mask, keys, row_budget=budget,
                       mesh=mesh, **_model_extras(model, cfg, B, seed))
        sync(model.device)
        length = out["length"].cpu().numpy()
        tokens = out["tokens"].cpu().numpy()
        for j, r in enumerate(chunk):
            outs[r.request_id] = tokens[j, :int(length[j])]
        total += int(out["n_generated"])
    return outs, total


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", choices=sorted(ARCH_IDS), default="qwen3-0.6b")
    p.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="tiny reduced run (default); --no-smoke serves the "
                        "full request/token budget")
    p.add_argument("--engine", choices=["auto", "slots", "fixed"],
                   default="auto")
    p.add_argument("--slots", type=int, default=4,
                   help="decode-batch slots (also the fixed-batch size)")
    p.add_argument("--requests", type=int, default=None)
    p.add_argument("--max-new-tokens", type=int, default=None)
    p.add_argument("--prompt-len", type=int, default=10)
    p.add_argument("--arrival-every", type=int, default=0,
                   help="stagger arrivals: one request every K engine steps "
                        "(0 = all queued up front)")
    p.add_argument("--spec-prefix", action="store_true",
                   help="serve every request twice: the first pass's output "
                        "becomes the second pass's speculative prefix")
    p.add_argument("--draft", type=int, default=0, metavar="K",
                   help="continuation draft engine (§9): draft up to K "
                        "tokens per decode forward from n-gram matches over "
                        "each request's own stream (and, with --spec-prefix, "
                        "its first-pass trajectory as corpus); 0 = off")
    p.add_argument("--mesh-data", type=int, default=1,
                   help="data shards: one slot scheduler per shard (§8)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="model-parallel axis size per shard")
    p.add_argument("--require-mesh", action="store_true",
                   help="fail instead of serving on one rank when fewer "
                        "ranks run than the mesh needs")
    p.add_argument("--deadline-steps", type=int, default=0,
                   help="§10 per-request decode-step deadline (0 = none): "
                        "expired requests are reclaimed and retried once")
    p.add_argument("--max-queue", type=int, default=0,
                   help="§10 bounded admission queue (0 = unbounded)")
    p.add_argument("--overflow", choices=["reject", "shed-oldest"],
                   default="reject",
                   help="backpressure policy when the queue is full")
    p.add_argument("--ledger", action="store_true",
                   help="§14 token-provenance ledger: account every emitted "
                        "token to its mechanism (reused prefix / accepted "
                        "draft / bonus / fresh / retry / shared block) and "
                        "print the savings-attribution report after the run")
    p.add_argument("--decision-log", default="", metavar="DIR",
                   help="§14 decision-record logging: one (features, "
                        "outcomes) record per draft decision, sharded as "
                        "JSONL + NPZ under DIR (obs.ledger.load_dataset "
                        "reloads them as a training-ready bundle)")
    p.add_argument("--assert-compile-stable", action="store_true",
                   help="§14 recompile sentinel: replay the identical "
                        "request set on a fresh engine after the run and "
                        "fail if any enrolled device program sees a new "
                        "call signature")
    p.add_argument("--trace-dir", default="",
                   help="§11 observatory: write trace.json (Chrome trace), "
                        "events.jsonl and metrics.prom here after the run")
    p.add_argument("--trace-sample-rate", type=float, default=1.0,
                   help="fraction of requests given their own trace lane "
                        "(deterministic per-request hash)")
    p.add_argument("--metrics", type=int, default=0, metavar="PORT",
                   help="serve Prometheus text exposition on "
                        "http://localhost:PORT/metrics during the run "
                        "(0 = off)")
    p.add_argument("--state-path", default="",
                   help="on SIGTERM/Ctrl-C, snapshot the exact server state "
                        "here (checkpoint/io.save_server_state) for "
                        "kill-and-resume; empty = drain without snapshot")
    p.add_argument("--cache-layout", choices=["dense", "paged"],
                   default="dense",
                   help="§13 KV cache layout: 'paged' serves over a block "
                        "pool with CoW GRPO prompt sharing (token-identical "
                        "to dense)")
    p.add_argument("--kv-block-size", type=int, default=0,
                   help="paged KV block size in tokens (0 = config default)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    joined = not torch.distributed.is_initialized()
    device = init_from_env(args.device)
    joined = joined and torch.distributed.is_initialized()
    try:
        mesh = MeshConfig(data=args.mesh_data, model=args.mesh_model,
                          require=args.require_mesh).build(device)
        with contextlib.ExitStack() as stack:
            if mesh is not None and torch.distributed.get_rank() != 0:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            return _serve(args, device, mesh)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


class AgreedStop(FaultPlan):
    """The stop of a server on the mesh: a kill (SIGTERM / Ctrl-C, on any
    rank of a model group) fires at the first chunk boundary after it
    where the group's ranks, which run in lockstep, all see it (an
    all-reduce of the flag over the group)."""

    def __init__(self, group, device):
        super().__init__()
        self.group, self.device = group, device

    def due(self, step: int, kind: str):
        out = super().due(step, kind)
        if kind != "kill" or self.group is None:
            return out
        flag = torch.tensor([float(bool(out))], device=self.device)
        if float(all_reduce_(flag, self.group)) > 0:
            return out or [FaultEvent("kill", at_step=step)]
        return []


def _shard_engine(engine):
    """The engine this rank runs (a ``MeshSlotServer``'s shard, else the
    engine itself)."""
    return getattr(engine, "engine", engine)


def _gather(mesh, obj) -> list:
    """Every data shard's ``obj`` (the shards' own sinks), in shard order;
    ``[obj]`` without a data axis."""
    if mesh is None or data_size(mesh) <= 1:
        return [obj]
    return all_gather_objects(obj, data_group(mesh))


def _merged_tracer(tracer: Tracer, mesh) -> Tracer:
    """A tracer holding every shard's spans and events."""
    parts = _gather(mesh, (list(tracer.spans), list(tracer.events)))
    if len(parts) == 1:
        return tracer
    out = Tracer(enabled=True, capacity=tracer.capacity,
                 sample_rate=tracer.sample_rate)
    for spans, events in parts:
        out.spans.extend(spans)
        out.events.extend(events)
    return out


def _serve(args, device, mesh) -> int:
    n_requests = args.requests or (8 if args.smoke else 64)
    max_new = args.max_new_tokens or (12 if args.smoke else 64)

    dtype = "bfloat16" if device.type == "cuda" else "float32"
    cfg = get_config(args.arch).reduced(vocab_size=max(VOCAB_SIZE, 64),
                                        dtype=dtype, param_dtype=dtype)
    if cfg.vocab_size < VOCAB_SIZE:
        cfg = cfg.replace(vocab_size=VOCAB_SIZE)
    if args.cache_layout != cfg.cache_layout:
        cfg = cfg.replace(cache_layout=args.cache_layout)
    if args.kv_block_size > 0:
        cfg = cfg.replace(kv_block_size=args.kv_block_size)
    model = M.init_lm(cfg, seed=args.seed, device=device)
    # every rank draws the same weights from the seed and keeps its slice
    model = shard_params(mesh, cfg, model)
    if mesh is not None:
        print(f"mesh (data, model) = {tuple(mesh.shape)} over "
              f"{torch.distributed.get_backend()} on {device.type}")
    gen = GenerateConfig(max_new_tokens=max_new)
    draft = (DraftConfig(kind="ngram", draft_k=args.draft) if args.draft > 0
             else None)

    # §11/§14: the tracer and the ledger go to the MAIN serving engine
    # only; the spec-prefix warm pass and the compile-stability replay run
    # without them, so the trace and the attribution are about the
    # speculative serve itself
    tracer = (Tracer(enabled=True, sample_rate=args.trace_sample_rate)
              if args.trace_dir else None)
    ledger = TokenLedger(enabled=True) if args.ledger else None
    lead = mesh is None or dist.get_rank() == 0

    def make_engine(spec_prefix: bool, traced: bool = False):
        return make_slot_engine(model, cfg, gen, mesh=mesh,
                                num_slots=args.slots,
                                prompt_width=args.prompt_len,
                                spec_prefix=spec_prefix, log_lenience=0.0,
                                draft=draft,
                                deadline_steps=args.deadline_steps or None,
                                max_queue=args.max_queue or None,
                                overflow=args.overflow,
                                tracer=tracer if traced else None,
                                ledger=ledger if traced else None)

    rng = random.Random(args.seed)
    problems = generate_problems(MathTaskConfig(num_problems=n_requests))
    ds = PromptDataset(problems, max_prompt_len=args.prompt_len)
    reqs = build_requests(ds, rng, n_requests, max_new,
                          make_key(args.seed + 3, device))

    engine_kind = args.engine
    if engine_kind == "auto":
        engine_kind = "slots" if M.supports_slot_serving(cfg) else "fixed"
    if engine_kind == "slots" and not M.supports_slot_serving(cfg):
        raise SystemExit(f"--engine slots unsupported for arch {cfg.name} "
                         "(recurrent trunk or modality extras)")
    if engine_kind == "fixed" and (args.spec_prefix or args.arrival_every
                                   or args.draft):
        raise SystemExit("--spec-prefix/--arrival-every/--draft need the "
                         "slot engine; drop the flags or use --engine slots")

    t0 = time.time()
    if engine_kind == "fixed":
        outs, n_gen = serve_fixed(model, cfg, gen, reqs, args.prompt_len,
                                  args.slots, seed=args.seed, mesh=mesh)
        dt = time.time() - t0
        print(f"arch={cfg.name} engine=fixed: served {n_requests} requests, "
              f"{n_gen} tokens in {dt:.2f}s ({n_gen / max(dt, 1e-9):.0f} tok/s)")
        for i in range(min(n_requests, 4)):
            print(f"  req{i}: {decode(outs[i])!r}")
        return 0

    drafts = None

    def attach_spec(reqs_):
        vkey = make_key(args.seed + 11, device)
        for i, r in enumerate(reqs_):
            e = drafts.get(r.request_id)
            r.verify_key = fold_in(vkey, i)
            r.draft_tokens, r.draft_logprobs = e.tokens, e.logprobs
            r.draft_eos = e.ends_with_eos
            if draft is not None:
                # the first-pass trajectory doubles as the §9 n-gram corpus
                r.ngram_corpus = [e.tokens]

    if args.spec_prefix:
        # pass 1 (vanilla) builds the draft cache; pass 2 below serves with
        # speculative-prefix admission against the same policy
        warm = make_engine(spec_prefix=False)
        for r in reqs:
            warm.submit(Request(request_id=r.request_id, prompt=r.prompt,
                                key=r.key, max_new_tokens=r.max_new_tokens))
        warm_resp = warm.run()
        drafts = RolloutCache()
        for r in reqs:
            resp = warm_resp[r.request_id]
            drafts.put(r.request_id, resp.tokens, resp.logprobs, resp.length,
                       step=0, eos_id=gen.eos_id)
        attach_spec(reqs)
        t0 = time.time()

    if args.decision_log:
        # configured AFTER the warm pass, so the dataset holds only the
        # speculative serve's decisions; on the mesh each data shard's
        # first model rank writes its shard's records, rotating as the
        # single process does, into files of its own (the shards keep no
        # common clock at which to gather them)
        writer = mesh is None or model_rank(mesh) == 0
        configure(decisions=DecisionLog(
            args.decision_log, enabled=writer,
            part="" if mesh is None else f"s{data_rank(mesh)}-"))

    engine = make_engine(spec_prefix=args.spec_prefix, traced=True)
    if mesh is not None and args.state_path:
        _shard_engine(engine).faults = AgreedStop(
            model_group(mesh) if model_size(mesh) > 1 else None, device)
    metrics_srv = board = None
    if args.metrics:
        registry = _shard_engine(engine).metrics_registry
        if isinstance(engine, MeshSlotServer):
            # the merged registry is a collective, which a scrape cannot
            # run: the shards publish theirs to a directory of rank 0's
            where = [tempfile.mkdtemp(prefix="metrics_") if lead else None]
            dist.broadcast_object_list(where, src=0)
            board = MetricsBoard(engine, mesh, where[0])
            registry = board.registry
        if lead:
            metrics_srv = obs_export.start_metrics_server(registry,
                                                          args.metrics)
            print(f"metrics: http://localhost:{args.metrics}/metrics")

    # §10 graceful shutdown: SIGTERM and Ctrl-C become a kill event in the
    # engine's fault plan, so the serve stops at the next chunk boundary
    # (where host state is consistent; an interrupt inside an admission or
    # a chunk would leave the in-place caches ahead of the host vectors),
    # snapshots the exact server state there, and still prints final stats
    def _stop(signum, frame):
        if engine.faults is None:
            engine.faults = FaultPlan()
        engine.faults.events.append(FaultEvent("kill", at_step=0))

    # on the mesh a rank's stop alone would strand its model group in a
    # collective: without --state-path the signals keep their default
    # action there; with it the stop is agreed (AgreedStop)
    previous = {} if mesh is not None and not args.state_path else {
        sig: signal.signal(sig, _stop) for sig in (signal.SIGINT,
                                                   signal.SIGTERM)}
    interrupted = False
    try:
        if args.arrival_every > 0:
            resps = engine.run(arrivals=[(i * args.arrival_every, r)
                                         for i, r in enumerate(reqs)])
        else:
            for r in reqs:
                engine.submit(r)
            resps = engine.run()
    except EngineKilled:
        interrupted = True
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        if metrics_srv is not None:
            metrics_srv.shutdown()
            metrics_srv.server_close()
    if mesh is not None:
        # a shard that finished before the stop snapshots with the rest
        flag = torch.tensor([float(interrupted)], device=device)
        interrupted = float(all_reduce_(flag, None)) > 0
        if board is not None and lead:          # every shard has stopped
            shutil.rmtree(board.dir, ignore_errors=True)
    if interrupted:
        resps = engine.responses
        if args.state_path:
            from repro_torch.checkpoint.io import (save_pytree,
                                                   save_server_state)
            meta = {"arch": cfg.name, "requests": n_requests}
            if mesh is None:
                save_server_state(args.state_path, engine, metadata=meta)
            else:
                # every rank gathers the snapshot; rank 0 writes it
                state = engine.state_dict()
                if lead:
                    save_pytree(args.state_path, state,
                                metadata={**meta, "kind": "server_state"})
            print(f"\ninterrupted: server state -> {args.state_path} "
                  "(resume via checkpoint/io.load_server_state)")
        else:
            print("\ninterrupted: draining without snapshot "
                  "(--state-path to keep serving state)")
    dt = time.time() - t0
    reg = engine.metrics_registry()
    if args.decision_log:
        dec = get_decision_log()
        dec.flush()
        n_dec = sum(_gather(mesh, dec.records_total))
        print(f"decisions: {n_dec} records -> "
              f"{args.decision_log} (obs.ledger.load_dataset to reload)")
    report = None
    if ledger is not None:
        # §14: provenance counts x measured decode cost -> seconds saved
        # per mechanism; the actual wall clock anchors the counterfactual
        counts = sum(_gather(mesh, ledger.category_counts()))
        n_all = max(1, int(counts.sum()))
        t_tok = measured_token_cost(reg.as_dict()) or dt / n_all
        report = build_report(counts, t_tok, actual_s=dt)
        print(report.summary())
    if args.trace_dir:
        all_spans = _merged_tracer(tracer, mesh)
        counters = None
        if report is not None:
            report.to_registry(reg)    # attribution joins /metrics + prom
            counters = report.counter_events(dt)
        if lead:
            os.makedirs(args.trace_dir, exist_ok=True)
            obs_export.write_chrome_trace(
                os.path.join(args.trace_dir, "trace.json"), all_spans,
                counters=counters)
            obs_export.write_jsonl(
                os.path.join(args.trace_dir, "events.jsonl"), all_spans,
                reg)
            obs_export.write_prometheus(
                os.path.join(args.trace_dir, "metrics.prom"), reg)
        print(f"trace: {args.trace_dir}/trace.json (load at "
              f"ui.perfetto.dev), events.jsonl, metrics.prom")
    s = engine.stats()
    n_gen = int(s["generated_tokens"])
    shards = int(s.get("num_shards", 1))
    print(f"arch={cfg.name} engine=slots(spec={args.spec_prefix}, "
          f"shards={shards}){' [interrupted]' if interrupted else ''}: served "
          f"{len(resps)}/{n_requests} requests, {n_gen} "
          f"generated (+{int(s['reused_tokens'])} reused) tokens in "
          f"{dt:.2f}s "
          f"({(n_gen + int(s['reused_tokens'])) / max(dt, 1e-9):.0f} tok/s)")
    print(f"  occupancy={s['occupancy']:.2f} engine_steps={int(s['engine_steps'])} "
          f"admissions={int(s['admitted'])} "
          f"mean_queue_wait={s['mean_queue_wait'] * 1e3:.1f}ms "
          f"mean_serve={s['mean_serve_time'] * 1e3:.1f}ms")
    recov = {k: int(s[k]) for k in ("timeouts", "retried_requests",
                                    "shed_requests", "fault_quarantines",
                                    "fault_impl_fallbacks") if s.get(k)}
    if recov:
        print(f"  recovery: {recov}")
    if draft is not None:
        print(f"  draft: tok/fwd={s['tokens_per_forward']:.2f} "
              f"accept={s['accept_rate']:.2f} "
              f"mean_len={s['mean_draft_len']:.2f} "
              f"forwards={int(s['decode_forwards'])}")
    for i in range(min(n_requests, 4)):
        r = resps.get(i)
        if r is None:
            continue
        full = np.concatenate([
            np.asarray(reqs[i].draft_tokens[:r.n_accepted], np.int32)
            if r.n_accepted else np.zeros(0, np.int32), r.tokens])
        print(f"  req{i} [{r.finish_reason}]: {decode(full)!r}")

    if args.assert_compile_stable and not interrupted:
        # §14 recompile sentinel: an identical request stream on a fresh
        # engine must meet only call signatures already seen
        baseline = compile_counts()
        if not any(baseline.values()):
            raise SystemExit("compile-stability: no enrolled device program "
                             "counted a call; the sentinel cannot vouch for "
                             "this run")
        reqs2 = build_requests(ds, random.Random(args.seed), n_requests,
                               max_new, make_key(args.seed + 3, device))
        if args.spec_prefix:
            attach_spec(reqs2)
        replay = make_engine(spec_prefix=args.spec_prefix)
        if args.arrival_every > 0:
            replay.run(arrivals=[(i * args.arrival_every, r)
                                 for i, r in enumerate(reqs2)])
        else:
            for r in reqs2:
                replay.submit(r)
            replay.run()
        grew = {k: (baseline.get(k, 0), v)
                for k, v in compile_counts().items()
                if v != baseline.get(k, 0)}
        if grew:
            raise SystemExit("compile instability: new call signatures on "
                             f"identical replay: {grew}")
        print(f"compile-stability: {sum(baseline.values())} compiles total, "
              "0 new on identical replay")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
