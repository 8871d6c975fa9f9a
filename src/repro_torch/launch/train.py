"""Training launcher of the port (``repro/launch/train.py``'s flags): the
GRPO, PPO or DAPO trainer (``--algo``) with the SPEC-RL rollout.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
        --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
        --steps 2 --algo ppo
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \
        --steps 2 --draft 2
    PYTHONPATH=src python -m repro_torch.launch.train --steps 10

Runs on the card unless ``--device cpu``.  ``--smoke`` selects the arch's
reduced config; on the card the model runs in bfloat16 (the port's
attention kernels take bfloat16), on the CPU the reduced config keeps
JAX's float32.  The key is ``make_key(0)`` as JAX's is ``PRNGKey(0)``.
``--draft K`` turns on the §9 draft engine (n-gram drafts of up to K
tokens; ``--draft-fixed`` keeps K instead of the adaptive length), and the
step line then carries ``tok/fwd``, ``draft_acc`` and ``draft_len``.

Every flag of a feature the port does not have yet raises and names its
ROADMAP Queue 1 item when it is set away from its default: ``--async``,
``--staleness-window``,
``--buffer-capacity``, ``--publish-every``, ``--async-schedule`` and the
``--watchdog-*`` flags (item 8), ``--ledger``, ``--decision-log``,
``--alerts``, ``--trace-dir``, ``--trace-sample-rate`` and ``--metrics``
(item 9), ``--mesh-data``, ``--mesh-model`` and ``--require-mesh`` (item
11).  At their defaults they are accepted, as in JAX.
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import SpecConfig
from repro_torch.data.dataset import PromptDataset
from repro_torch.data.tokenizer import VOCAB_SIZE
from repro_torch.device import resolve_device
from repro_torch.drafting import DraftConfig
from repro_torch.engine.sampling import make_key
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.rewards.mathgen import MathTaskConfig, generate_problems
from repro_torch.rl.trainer import ALGOS, RLConfig, Trainer

# flag -> (ROADMAP Queue 1 item, its feature) for flags that must stay at
# their default until the item lands
UNPORTED_FLAGS = {
    "async_mode": (8, "async rollout and watchdog"),
    "staleness_window": (8, "async rollout and watchdog"),
    "buffer_capacity": (8, "async rollout and watchdog"),
    "publish_every": (8, "async rollout and watchdog"),
    "async_schedule": (8, "async rollout and watchdog"),
    "watchdog_dir": (8, "async rollout and watchdog"),
    "watchdog_every": (8, "async rollout and watchdog"),
    "watchdog_max_collect_time": (8, "async rollout and watchdog"),
    "ledger": (9, "the observatory hooks"),
    "decision_log": (9, "the observatory hooks"),
    "alerts": (9, "the observatory hooks"),
    "trace_dir": (9, "the observatory hooks"),
    "trace_sample_rate": (9, "the observatory hooks"),
    "metrics": (9, "the observatory hooks"),
    "mesh_data": (11, "the mesh"),
    "mesh_model": (11, "the mesh"),
    "require_mesh": (11, "the mesh"),
}


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
                   help="data-parallel axis size (1 = off; ROADMAP Queue 1 "
                        "item 11, the mesh)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="model-parallel axis size (1 = off; ROADMAP Queue 1 "
                        "item 11, the mesh)")
    p.add_argument("--require-mesh", action="store_true")
    p.add_argument("--draft", type=int, default=0, metavar="K",
                   help="continuation draft engine (§9): draft up to K "
                        "tokens per decode forward (0 = off)")
    p.add_argument("--draft-fixed", action="store_true",
                   help="draft K tokens every forward (no adaptive length)")
    p.add_argument("--async", dest="async_mode", action="store_true",
                   help="disaggregated rollout (ROADMAP Queue 1 item 8, "
                        "async rollout)")
    p.add_argument("--staleness-window", type=int, default=1, metavar="K")
    p.add_argument("--buffer-capacity", type=int, default=8)
    p.add_argument("--publish-every", type=int, default=1)
    p.add_argument("--async-schedule", default="pc")
    p.add_argument("--watchdog-dir", default="",
                   help="trainer watchdog (ROADMAP Queue 1 item 8, the "
                        "watchdog)")
    p.add_argument("--watchdog-every", type=int, default=10)
    p.add_argument("--watchdog-max-collect-time", type=float,
                   default=float("inf"))
    p.add_argument("--ledger", action="store_true",
                   help="token-provenance ledger (ROADMAP Queue 1 item 9, "
                        "the observatory)")
    p.add_argument("--decision-log", default="", metavar="DIR",
                   help="decision records (ROADMAP Queue 1 item 9, the "
                        "observatory)")
    p.add_argument("--alerts", action="store_true",
                   help="metric alerts (ROADMAP Queue 1 item 9, the "
                        "observatory)")
    p.add_argument("--trace-dir", default="",
                   help="Chrome trace and metrics dump (ROADMAP Queue 1 item "
                        "9, the observatory)")
    p.add_argument("--trace-sample-rate", type=float, default=1.0)
    p.add_argument("--metrics", type=int, default=0, metavar="PORT",
                   help="Prometheus exposition (0 = off; ROADMAP Queue 1 item "
                        "9, the observatory)")
    return p


def check_flags(args, parser: argparse.ArgumentParser) -> None:
    """Raise for a flag of an unported feature set away from its default."""
    for name, (item, feature) in UNPORTED_FLAGS.items():
        if getattr(args, name) != parser.get_default(name):
            flag = "--" + ("async" if name == "async_mode"
                           else name.replace("_", "-"))
            raise NotImplementedError(
                f"{flag} arrives with ROADMAP Queue 1 item {item} "
                f"({feature})")


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    check_flags(args, parser)
    device = resolve_device(args.device)

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
    tr = Trainer(cfg, rl, spec, ds, make_key(0, device), device=device)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"arch={cfg.name} devices={n_dev} device={device.type} mesh=off "
          f"params={M.count_params(tr.model) / 1e6:.1f}M")
    for _ in range(args.steps):
        m = tr.train_step()
        line = (f"step {m['step']:3.0f} reward={m['reward_mean']:.3f} "
                f"gen_tok={m.get('n_generated', 0):6.0f} "
                f"reused={m.get('n_reused', 0):6.0f}")
        if args.draft > 0:
            line += (f" tok/fwd={m.get('tokens_per_forward', 1.0):.2f} "
                     f"draft_acc={m.get('draft_accept_rate', 0.0):.2f} "
                     f"draft_len={m.get('draft_mean_len', 0.0):.2f}")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
