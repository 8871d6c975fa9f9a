"""The port's partition rules (``repro_torch/distributed/sharding.py`` and
the pure helpers of ``distributed/mesh.py``) against JAX's
(``repro/distributed/{sharding,mesh}.py``), for every config of the port at
model-axis sizes 1, 2, 4, 8 and 16.

Nothing is drawn: JAX's shapes come from ``jax.eval_shape``, the port's
from its modules on the ``meta`` device.  The rules read shapes, never the
depth, so each config is cut to its first ``DEPTH`` layers, which hold
every block signature of every config (deepseek-v3-671b's three dense
layers and its MoE ones, one whole jamba period); JAX traces the whole
deepseek-v3-671b in about a minute.  JAX's mesh-taking helpers read
only a mesh's ``shape`` and ``axis_names``, the port's only a
``DeviceMesh``'s ``shape`` and ``mesh_dim_names``, so each takes a stand-in
with those attributes and no process group is needed.

A port parameter ``layers.<i>.<rest>`` is JAX's ``trunk/#<run>/<rest>``
with its layer stacked on a leading axis (``encoder.trunk.<i>`` likewise),
whose spec carries JAX's leading ``None``; every other name is JAX's path
with dots for slashes.
"""
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed import mesh as JMESH  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.distributed import mesh as MESH  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.blocks import signature_runs  # noqa: E402

MODEL_SIZES = (1, 2, 4, 8, 16)
DEPTH = 8
ARCHS = sorted(ARCH_IDS)

_CACHE = {}


def _stand_ins(data: int, model: int):
    """(JAX's mesh stand-in, the port's)."""
    names = ("data", "model")
    return (SimpleNamespace(axis_names=names,
                            shape={"data": data, "model": model}),
            SimpleNamespace(mesh_dim_names=names, shape=(data, model)))


def _path(path) -> str:
    return JS._path_str(path)


def _archs(arch):
    """(JAX's param shapes, the port's meta LM), built once an arch."""
    if arch not in _CACHE:
        jcfg, cfg = _cut(jax_get_config(arch)), _cut(get_config(arch))
        shapes = jax.eval_shape(
            lambda: JM.init_lm(jax.random.PRNGKey(0), jcfg))
        _CACHE[arch] = (jcfg, shapes, M.LM(cfg, device="meta"))
    return _CACHE[arch]


def _cut(cfg):
    return cfg.replace(num_layers=min(cfg.num_layers, DEPTH))


def _jax_name(name: str, cfg) -> tuple:
    """(JAX path, stacked) of a port parameter name."""
    parts = name.split(".")
    for prefix, run_cfg in (("layers", cfg),
                            ("encoder.trunk", M.encoder_config(cfg))):
        head = prefix.split(".")
        if parts[:len(head)] == head and len(parts) > len(head):
            layer = int(parts[len(head)])
            start = 0
            for run, (_, run_len) in enumerate(signature_runs(run_cfg)):
                if layer < start + run_len:
                    jprefix = "trunk" if prefix == "layers" else \
                        "encoder/trunk"
                    rest = "/".join(parts[len(head) + 1:])
                    return f"{jprefix}/#{run}/{rest}", layer - start
                start += run_len
    return "/".join(parts), None


@pytest.mark.parametrize("m", MODEL_SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, m):
    jcfg, shapes, model = _archs(arch)
    cfg = model.cfg
    flat, _ = jax.tree_util.tree_flatten_with_path(
        JS.params_pspecs(jcfg, shapes, m),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = {_path(p): tuple(spec) for p, spec in flat}
    jshape = {_path(p): tuple(leaf.shape) for p, leaf in
              jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = S.params_pspecs(cfg, model, m)
    seen = set()
    for name, p in model.named_parameters():
        jpath, layer = _jax_name(name, cfg)
        seen.add(jpath)
        spec = want[jpath]
        if layer is not None:                   # JAX's stacked layer axis
            assert spec[:1] in ((), (None,)), (name, spec)
            spec = spec[1:]
            assert jshape[jpath][1:] == tuple(p.shape), name
        else:
            assert jshape[jpath] == tuple(p.shape), name
        assert got[name] == spec, (arch, m, name, got[name], spec)
    assert seen == set(want), sorted(set(want) - seen)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_specs_match_jax(arch, layout):
    jcfg = _cut(jax_get_config(arch)).replace(cache_layout=layout,
                                              kv_block_size=8)
    cfg = _cut(get_config(arch)).replace(cache_layout=layout,
                                         kv_block_size=8)
    B, L = 4, 24
    jcaches = jax.eval_shape(lambda: JM.init_cache(jcfg, B, L))
    caches = M.init_cache(cfg, B, L, device="meta")
    for m in MODEL_SIZES:
        for data in (1, 2, 4):
            jmesh, mesh = _stand_ins(data, m)
            for batch in (True, False):
                want = jax.tree.map(
                    tuple, JMESH.decode_cache_pspecs(jcfg, jcaches, jmesh,
                                                     batch=batch),
                    is_leaf=lambda x: isinstance(x,
                                                 jax.sharding.PartitionSpec))
                got = MESH.decode_cache_pspecs(cfg, caches, mesh, batch=batch)
                assert got == want, (arch, layout, m, data, batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_shard_specs_match_jax(arch):
    jcfg, shapes, model = _archs(arch)
    cfg = model.cfg
    for m in (1, 2, 16):
        specs = S.params_pspecs(cfg, model, m)
        for name, p in model.named_parameters():
            shape = tuple(p.shape)
            for axes, size in ((("data",), 2), (("data",), 16),
                               (("pod", "data"), 32)):
                want = JS.zero_shard_spec(jax.sharding.PartitionSpec(
                    *specs[name]), shape, axes, size)
                got = S.zero_shard_spec(specs[name], shape, axes, size)
                assert got == tuple(want), (name, axes, size)


def test_batch_specs_match_jax():
    for data in (1, 2, 4):
        jmesh, mesh = _stand_ins(data, 2)
        for ndim in (1, 2, 3):
            for batch in (1, 2, 3, 4, 6, 8):
                want = tuple(JMESH.batch_pspec(jmesh, ndim, batch))
                assert MESH.batch_pspec(mesh, ndim, batch) == want
                if data > 1:
                    want = tuple(JS.batch_spec(jmesh, ndim, batch))
                    assert S.batch_spec(mesh, ndim, batch) == want


def test_batch_shardable_matches_jax():
    from repro.distributed import shard_wrap as JSW
    from repro_torch.distributed import shard_wrap as SW
    assert not SW.batch_shardable(None, 4)
    for data in (1, 2, 4):
        for model in (1, 2):
            jmesh, mesh = _stand_ins(data, model)
            for batch in range(1, 9):
                assert SW.batch_shardable(mesh, batch) == \
                    JSW.batch_shardable(jmesh, batch), (data, model, batch)


def test_axis_sizes_of_a_stand_in_mesh():
    _, mesh = _stand_ins(2, 4)
    assert MESH.data_size(mesh) == 2 and MESH.model_size(mesh) == 4
    assert MESH.data_size(None) == 1 and MESH.model_size(None) == 1
    assert np.prod(list(S.axis_sizes(mesh).values())) == 8
