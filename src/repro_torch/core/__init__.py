"""SPEC-RL core of the port: rollout cache, verification, rollout."""
from .cache import RolloutCache
from .spec_rollout import RolloutBatch, SpecConfig, rollout

__all__ = ["RolloutBatch", "RolloutCache", "SpecConfig", "rollout"]
