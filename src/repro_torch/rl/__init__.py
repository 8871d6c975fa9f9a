"""RL algorithms of the port: losses, advantages, the PPO critic, the
GRPO / PPO / DAPO trainer, the trainer watchdog (§10) and the async
rollout ↔ train loop over a bounded trajectory buffer (§12).

The names below load on first use: ``serving.rollout_service`` imports
``rl.traj_buffer`` and ``rl.async_loop`` imports the service, so an eager
import here would close that loop."""
import importlib

_EXPORTS = {"AsyncConfig": "async_loop", "AsyncTrainer": "async_loop",
            "TrajBuffer": "traj_buffer", "Trajectory": "traj_buffer",
            "TrainWatchdog": "watchdog", "WatchdogConfig": "watchdog"}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)
