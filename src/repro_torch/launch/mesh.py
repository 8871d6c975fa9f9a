"""Meshes of the launchers (port of ``repro/launch/mesh.py``).

``make_debug_mesh`` lays the ranks of the initialised process group out as
a small (data, model) ``DeviceMesh`` for tests and smoke runs.  The
runtime mesh the rollout and serving stack runs on is configured with
``MeshConfig`` (``distributed/mesh.py``, re-exported here), which falls
back to one rank when too few run, as JAX's falls back to one device.

Not ported: ``make_production_mesh`` (JAX's TPU pods of (16, 16) and
(2, 16, 16) chips) and the TPU v5e constants of the roofline analysis.
"""
from __future__ import annotations

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.mesh import AXES, MeshConfig  # noqa: F401


def make_debug_mesh(model: int = 2, data: int = 2, device: DeviceLike = None):
    """A (data, model) mesh over the ranks of the process group, which
    must number ``data * model`` (JAX's needs as many host devices)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(resolve_device(device).type, (data, model),
                            mesh_dim_names=AXES)
