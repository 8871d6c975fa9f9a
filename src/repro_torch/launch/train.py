"""Training launcher of the port (``repro/launch/train.py``'s flags): the
GRPO, PPO or DAPO trainer (``--algo``) with the SPEC-RL rollout.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
        --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
        --steps 2 --algo ppo
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \
        --steps 2 --draft 2
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \
        --steps 2 --async --async-schedule ppcc --staleness-window 1
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \
        --steps 3 --watchdog-dir /tmp/wd --watchdog-every 1
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \
        --steps 3 --draft 2 --ledger --alerts --decision-log /tmp/d \
        --trace-dir /tmp/t
    PYTHONPATH=src python -m repro_torch.launch.train --steps 10

Runs on the card unless ``--device cpu``.  ``--smoke`` selects the arch's
reduced config; on the card the model runs in bfloat16 (the port's
attention kernels take bfloat16), on the CPU the reduced config keeps
JAX's float32.  The key is ``make_key(0)`` as JAX's is ``PRNGKey(0)``.
``--draft K`` turns on the §9 draft engine (n-gram drafts of up to K
tokens; ``--draft-fixed`` keeps K instead of the adaptive length), and the
step line then carries ``tok/fwd``, ``draft_acc`` and ``draft_len``.
``--async`` runs the §12 disaggregated loop (``rl/async_loop.py``:
``--staleness-window``, ``--buffer-capacity``, ``--publish-every``,
``--async-schedule``); each step line then carries ``staleness=`` and
``mode=`` and the run ends with the ``async k=v`` counter lines.
``--watchdog-dir`` attaches the §10 trainer watchdog (``--watchdog-every``,
``--watchdog-max-collect-time``).

The §11/§14 observatory, as in JAX: ``--ledger`` accounts every rollout
token to its mechanism and prints the savings-attribution table after the
run; ``--decision-log DIR`` shards the drafted loops' decision records
under DIR; ``--alerts`` evaluates the default alert rules on every step
(an ``alerts:`` line at the end); ``--trace-dir DIR`` writes
``trace.json`` (Chrome trace), ``events.jsonl`` and ``metrics.prom``
there (``--trace-sample-rate`` thins the request lanes); ``--metrics
PORT`` serves the Prometheus text on ``localhost:PORT/metrics`` while the
run lasts.

An encoder-decoder (``--arch whisper-tiny``) is refused before anything
is built: the trainer passes no encoder memory (JAX's neither), and a
cross-attention trunk without it would let each position attend the
tokens after it (ROADMAP Queue 3, "Kept on purpose").

The §8 mesh, one process a rank under ``torchrun``::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --device cpu --smoke --steps 2 \
        --mesh-data 2 --mesh-model 2

``--mesh-data D --mesh-model M`` lays the ranks out as a (D, M) mesh
(``distributed/mesh.py``) and the trainer runs on it (``rl/trainer.py``:
the model cut over each model group, the rows over the data groups).
The ranks take ``gloo`` unless each has a card of its own (then NCCL).
Without enough ranks the mesh is off and the single process trains, as
in JAX, or with ``--require-mesh`` the launcher raises.  Rank 0 prints,
and it alone writes the watchdog's snapshots and the trace directory
(every rank's step log is the same).
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import SpecConfig
from repro_torch.data.dataset import PromptDataset
from repro_torch.data.tokenizer import VOCAB_SIZE
from repro_torch.distributed.mesh import MeshConfig, init_from_env
from repro_torch.drafting import DraftConfig
from repro_torch.engine.sampling import make_key
from repro_torch.models import model as M
from repro_torch.obs import (MetricsRegistry, Tracer, configure,
                             get_decision_log, get_registry, get_tracer)
from repro_torch.obs import export as obs_export
from repro_torch.obs.alerts import AlertManager
from repro_torch.obs.attrib import build_report, measured_token_cost
from repro_torch.obs.ledger import DecisionLog, TokenLedger
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.rewards.mathgen import MathTaskConfig, generate_problems
from repro_torch.rl.async_loop import AsyncConfig, AsyncTrainer
from repro_torch.rl.trainer import ALGOS, RLConfig, Trainer
from repro_torch.rl.watchdog import TrainWatchdog, WatchdogConfig

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", choices=sorted(ARCH_IDS), default="qwen3-1.7b")
    p.add_argument("--algo", choices=ALGOS, default="grpo")
    p.add_argument("--variant", default="spec",
                   choices=["spec", "off", "random", "delayed", "full"])
    p.add_argument("--lenience", type=float, default=math.e ** 0.5)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--smoke", action="store_true",
                   help="reduced config of the same family")
    p.add_argument("--group-size", type=int, default=4)
    p.add_argument("--prompts-per-batch", type=int, default=4)
    p.add_argument("--max-new-tokens", type=int, default=10)
    p.add_argument("--lr", type=float, default=5e-7)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--mesh-data", type=int, default=1,
                   help="data-parallel axis size (1 = off)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="model-parallel axis size (1 = off)")
    p.add_argument("--require-mesh", action="store_true",
                   help="fail instead of falling back when fewer ranks run "
                        "than the mesh needs")
    p.add_argument("--draft", type=int, default=0, metavar="K",
                   help="continuation draft engine (§9): draft up to K "
                        "tokens per decode forward (0 = off)")
    p.add_argument("--draft-fixed", action="store_true",
                   help="draft K tokens every forward (no adaptive length)")
    p.add_argument("--async", dest="async_mode", action="store_true",
                   help="§12 disaggregated mode: a rollout service feeding "
                        "a bounded trajectory buffer, consumed by the "
                        "trainer under a bounded staleness window")
    p.add_argument("--staleness-window", type=int, default=1, metavar="K",
                   help="async: trajectories <= K versions old are "
                        "IS-corrected, older ones re-verified (K=0 is "
                        "token-identical to the synchronous trainer)")
    p.add_argument("--buffer-capacity", type=int, default=8,
                   help="async: trajectory buffer bound (shed-oldest)")
    p.add_argument("--publish-every", type=int, default=1,
                   help="async: publish weights every N optimizer steps")
    p.add_argument("--async-schedule", default="pc",
                   help="async: producer/consumer interleave, e.g. 'ppcc'")
    p.add_argument("--watchdog-dir", default="",
                   help="§10 trainer watchdog: snapshot here on healthy "
                        "steps, restore-last-good on a non-finite loss or "
                        "a stalled rollout")
    p.add_argument("--watchdog-every", type=int, default=10,
                   help="healthy-step snapshot cadence (steps)")
    p.add_argument("--watchdog-max-collect-time", type=float,
                   default=float("inf"),
                   help="rollout stall threshold in seconds")
    p.add_argument("--ledger", action="store_true",
                   help="§14 token-provenance ledger: account every rollout "
                        "token to its mechanism and print the savings-"
                        "attribution report after the run")
    p.add_argument("--decision-log", default="", metavar="DIR",
                   help="§14 decision-record logging: shard draft-decision "
                        "(features, outcomes) records under DIR")
    p.add_argument("--alerts", action="store_true",
                   help="§14 metric alert rules: evaluate the default "
                        "threshold/trend rules on every step's metrics; "
                        "events trace on the 'alerts' lane and feed the "
                        "watchdog counters when --watchdog-dir rides along")
    p.add_argument("--trace-dir", default="",
                   help="§11 observatory: write trace.json (Chrome trace), "
                        "events.jsonl and metrics.prom here after the run")
    p.add_argument("--trace-sample-rate", type=float, default=1.0,
                   help="fraction of slot-served requests given their own "
                        "trace lane (deterministic per-request hash)")
    p.add_argument("--metrics", type=int, default=0, metavar="PORT",
                   help="serve Prometheus text exposition on "
                        "http://localhost:PORT/metrics during the run "
                        "(0 = off)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if get_config(args.arch).cross_attention:
        raise SystemExit(f"--arch {args.arch}: a cross-attention trunk needs "
                         "encoder_out, which the trainer does not pass; "
                         "without it each position would attend the tokens "
                         "after it")
    joined = not dist.is_initialized()
    device = init_from_env(args.device)
    joined = joined and dist.is_initialized()
    try:
        mesh = MeshConfig(data=args.mesh_data, model=args.mesh_model,
                          require=args.require_mesh).build(device)
        with contextlib.ExitStack() as stack:
            if mesh is not None and dist.get_rank() != 0:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            return _train(args, device, mesh)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args, device, mesh) -> int:
    lead = mesh is None or dist.get_rank() == 0

    # §11: install the process-global tracer/registry BEFORE the trainer is
    # built, so the rollout, drafting and trainer stage hooks land in it;
    # §14: the ledger and decision log are process-global likewise
    tracer = None
    if args.trace_dir or args.metrics:
        tracer = Tracer(enabled=bool(args.trace_dir),
                        sample_rate=args.trace_sample_rate)
        configure(tracer=tracer, registry=MetricsRegistry())
    ledger = None
    if args.ledger:
        ledger = TokenLedger(enabled=True)
        configure(ledger=ledger)
    if args.decision_log:
        configure(decisions=DecisionLog(args.decision_log, enabled=True))

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced(vocab_size=max(VOCAB_SIZE, 64))
    if cfg.vocab_size < VOCAB_SIZE:
        cfg = cfg.replace(vocab_size=VOCAB_SIZE)
    if device.type == "cuda":
        cfg = cfg.replace(dtype="bfloat16", param_dtype="bfloat16")

    problems = generate_problems(MathTaskConfig(num_problems=16,
                                                max_operand=9))
    ds = PromptDataset(problems, max_prompt_len=10)
    rl = RLConfig(algo=args.algo, group_size=args.group_size,
                  prompts_per_batch=args.prompts_per_batch,
                  max_new_tokens=args.max_new_tokens,
                  optim=AdamWConfig(lr=args.lr))
    draft = (DraftConfig(kind="ngram", draft_k=args.draft,
                         adaptive=not args.draft_fixed) if args.draft > 0
             else DraftConfig())
    spec = SpecConfig(variant=args.variant, lenience=args.lenience,
                      draft=draft)
    watchdog = None
    if args.watchdog_dir:
        watchdog = TrainWatchdog(WatchdogConfig(
            checkpoint_dir=args.watchdog_dir,
            snapshot_every=args.watchdog_every,
            max_collect_time=args.watchdog_max_collect_time))
    alerts = None
    if args.alerts:
        alerts = AlertManager(tracer=tracer if tracer is not None
                              else get_tracer())
    tr = Trainer(cfg, rl, spec, ds, make_key(0, device), device=device,
                 mesh=mesh, watchdog=watchdog, alerts=alerts)
    metrics_srv = None
    if args.metrics and lead:
        metrics_srv = obs_export.start_metrics_server(get_registry,
                                                      args.metrics)
        print(f"metrics: http://localhost:{args.metrics}/metrics")
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    mesh_desc = (f"{args.mesh_data}x{args.mesh_model}" if mesh is not None
                 else "off")
    if mesh is not None:
        print(f"mesh (data, model) = {tuple(mesh.shape)} over "
              f"{dist.get_backend()} on {device.type}")
    print(f"arch={cfg.name} devices={n_dev} device={device.type} "
          f"mesh={mesh_desc} params={M.count_params(cfg_model(cfg)) / 1e6:.1f}M")

    def step_line(m):
        line = (f"step {m['step']:3.0f} reward={m['reward_mean']:.3f} "
                f"gen_tok={m.get('n_generated', 0):6.0f} "
                f"reused={m.get('n_reused', 0):6.0f}")
        if args.draft > 0:
            line += (f" tok/fwd={m.get('tokens_per_forward', 1.0):.2f} "
                     f"draft_acc={m.get('draft_accept_rate', 0.0):.2f} "
                     f"draft_len={m.get('draft_mean_len', 0.0):.2f}")
        return line

    t_run0 = time.time()
    try:
        if args.async_mode:
            run_async(tr, args, step_line)
        else:
            for _ in range(args.steps):
                print(step_line(tr.train_step()), flush=True)
    finally:
        if metrics_srv is not None:
            metrics_srv.shutdown()
            metrics_srv.server_close()
    t_run = time.time() - t_run0
    if args.decision_log:
        dec = get_decision_log()
        dec.flush()
        print(f"decisions: {dec.records_total} records -> "
              f"{args.decision_log} (obs.ledger.load_dataset to reload)")
    if alerts is not None:
        fired = {k: v for k, v in alerts.as_dict().items() if v}
        print(f"alerts: {fired or 'none fired'}")
    report = None
    if ledger is not None:
        regd = get_registry().as_dict()
        n_all = max(1, int(ledger.category_counts().sum()))
        t_tok = measured_token_cost(regd) or t_run / n_all
        report = build_report(ledger, t_tok, actual_s=t_run)
        print(report.summary())
    if args.trace_dir and lead:
        write_trace_dir(args.trace_dir, tracer, get_registry(), report,
                        t_run)
    return 0


def cfg_model(cfg):
    """The whole model of ``cfg`` on the ``meta`` device (its parameter
    count, whatever the mesh cut)."""
    return M.LM(cfg, device="meta")


def run_async(tr: Trainer, args, step_line) -> None:
    """The §12 disaggregated loop: producer ticks and consumer steps in the
    ``--async-schedule`` pattern until ``--steps`` optimizer steps ran."""
    at = AsyncTrainer(tr, AsyncConfig(
        staleness_window=args.staleness_window,
        buffer_capacity=args.buffer_capacity,
        publish_every=args.publish_every, schedule=args.async_schedule))
    print(f"async: K={args.staleness_window} buffer={args.buffer_capacity} "
          f"schedule={args.async_schedule!r}")
    sched, i, done, idle = args.async_schedule, 0, 0, 0
    while done < args.steps and idle < 10000:
        role = sched[i % len(sched)]
        i += 1
        if role == "p":
            at.producer_tick()
            continue
        m = at.consumer_step()
        if m is None:
            idle += 1
            continue
        idle, done = 0, done + 1
        print(step_line(m) + f" staleness={m.get('staleness', 0.0):.0f} "
              f"mode={m.get('async_mode_level', 0.0):.0f}", flush=True)
    for k, v in sorted(at.counters().items()):
        print(f"async {k}={v:.0f}")


def write_trace_dir(trace_dir: str, tracer, reg: MetricsRegistry, report,
                    t_run: float) -> None:
    """Write ``trace.json``, ``events.jsonl`` and ``metrics.prom`` under
    ``trace_dir``; the attribution report, when there is one, joins the
    registry and the trace's counter tracks."""
    os.makedirs(trace_dir, exist_ok=True)
    counters = None
    if report is not None:
        report.to_registry(reg)
        counters = report.counter_events(t_run)
    obs_export.write_chrome_trace(os.path.join(trace_dir, "trace.json"),
                                  tracer, counters=counters)
    obs_export.write_jsonl(os.path.join(trace_dir, "events.jsonl"), tracer,
                           reg)
    obs_export.write_prometheus(os.path.join(trace_dir, "metrics.prom"), reg)
    print(f"trace: {trace_dir}/trace.json (load at ui.perfetto.dev), "
          f"events.jsonl, metrics.prom")


if __name__ == "__main__":
    raise SystemExit(main())
