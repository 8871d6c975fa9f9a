"""Checkpoint files of the port: npz + json pytrees, the rollout cache and
the slot server's exact state (``io.py``, port of ``repro/checkpoint``)."""
from .io import (load_pytree, load_rollout_cache, load_server_state,
                 read_latest, save_pytree, save_rollout_cache,
                 save_server_state, write_latest)

__all__ = ["load_pytree", "load_rollout_cache", "load_server_state",
           "read_latest", "save_pytree", "save_rollout_cache",
           "save_server_state", "write_latest"]
