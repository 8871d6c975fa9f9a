"""The port's mixture-of-experts layer (``repro_torch.models.moe``) on the
CPU against ``repro.models.moe``, with JAX's parameters carried across:
each strategy (``dense``, ``dispatch``, ``sort``) at a reduced
mixtral-8x22b width (8 experts, top 2) in float32.

Inputs are numpy arrays from a seed; torch runs on one thread; the JAX
reference runs under ``jax.jit`` (one compile a case in place of one per
operation, a third of the time).  Outputs and
every aux key within rtol 1e-5, atol 1e-6 (float32 products summed in
another order); gradients of (sum of the output + lb + z) against
``jax.grad`` within 1e-5 of each leaf's largest magnitude."""
import functools
import math

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import _load  # noqa: E402

RTOL, ATOL, GRAD_TOL = 1e-5, 1e-6, 1e-5
B, T = 3, 8
BASE = dict(d_model=64, moe_d_ff=48, num_experts=8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_layer(items):
    jcfg = jax_get_config("mixtral-8x22b").reduced(**dict(items))
    return jcfg, jax_moe.make_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)


def _jax_apply(jcfg):
    return jax.jit(lambda p, x: jax_moe.apply_moe(p, jcfg, x))


def _layer(**overrides):
    """JAX's layer (drawn once per config) and the port's copy of it."""
    kw = {**BASE, **overrides}
    jcfg, p = _jax_layer(tuple(sorted(kw.items())))
    cfg = get_config("mixtral-8x22b").reduced(**kw)
    layer = moe.MoE(cfg)
    with torch.no_grad():
        _load(layer, jax.tree.map(np.asarray, p), "moe")
    return jcfg, cfg, p, layer


def _x(cfg, pad=()):
    """(B, T, d) float32 from a seed; row b's first ``pad[b]`` slots are
    exactly 0, as a left-padded slot's hidden state is in the model."""
    x = np.random.default_rng(1).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    for b, n in enumerate(pad):
        x[b, :n] = 0.0
    return x


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


CASES = {
    "dense": dict(moe_impl="dense"),
    "dispatch": dict(moe_impl="dispatch"),
    "dispatch-tight": dict(moe_impl="dispatch", capacity_factor=0.5),
    "dispatch-groups": dict(moe_impl="dispatch", moe_groups=2,
                            capacity_factor=0.75),
    "sort": dict(moe_impl="sort"),
    "sort-tight": dict(moe_impl="sort", capacity_factor=0.5),
    "shared": dict(moe_impl="dispatch", num_shared_experts=1),
}


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_matches_jax(case, padded):
    """Output and every aux key of ``apply_moe``.  ``padded`` zeroes a
    left pad of 3 and 6 slots in rows 1 and 2: every expert ties there,
    and JAX routes those tokens to experts 0 and 1 (checked), where under
    a tight capacity they take rows ahead of the real tokens."""
    jcfg, cfg, p, layer = _layer(**CASES[case])
    x = _x(cfg, (0, 3, 6) if padded else ())
    want, want_aux = _jax_apply(jcfg)(p, jnp.asarray(x))
    got, got_aux = moe.apply_moe(layer, cfg, torch.from_numpy(x))
    _close(got, want, "output")
    assert set(got_aux) == set(want_aux)
    for k in want_aux:
        _close(got_aux[k], want_aux[k], k)
    if "tight" in case or case == "dispatch-groups":
        assert float(want_aux["moe_drop_frac"]) > 0
    if padded:
        _, idx, _ = jax.jit(lambda p, x: jax_moe._router(p, jcfg, x))(
            p, jnp.asarray(x).reshape(-1, cfg.d_model))
        tied = np.asarray(idx).reshape(B, T, 2)[2, :6]
        assert (tied == [0, 1]).all(), tied


def test_dispatch_groups_and_capacity_follow_jax():
    """G from ``moe_groups`` or B, lowered until it divides B * T; the
    capacity ``max(1, ceil(k n / E * capacity_factor))`` capped at k n."""
    cfg = get_config("mixtral-8x22b").reduced(**BASE)
    assert moe.dispatch_groups(cfg, 16, 1) == (16, 1, 1)
    assert moe.dispatch_groups(cfg, 16, 9) == (16, 9, math.ceil(2 * 9 / 8 * 1.25))
    assert moe.dispatch_groups(cfg.replace(moe_groups=5), 3, 8) == (4, 6, 2)
    assert moe.dispatch_groups(cfg.replace(capacity_factor=100.0), 2, 3) \
        == (2, 3, 6)


@pytest.mark.parametrize("case", ["dense", "dispatch-tight", "sort-tight",
                                  "shared"])
def test_moe_gradients_match_jax(case):
    """d(sum(y) + lb + z) by every parameter and by x, against jax.grad,
    on a left-padded batch."""
    jcfg, cfg, p, layer = _layer(**CASES[case])
    x = _x(cfg, (0, 3, 6))

    def jloss(p, x):
        y, aux = jax_moe.apply_moe(p, jcfg, x)
        return jnp.sum(y) + aux["moe_lb_loss"] + aux["moe_z_loss"]

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    params = list(layer.parameters())
    for q in params:
        q.requires_grad_(True)
    y, aux = moe.apply_moe(layer, cfg, xt)
    (y.sum() + aux["moe_lb_loss"] + aux["moe_z_loss"]).backward()
    got = {"router": {"kernel": layer.router.kernel.grad},
           "w_gate": layer.w_gate.grad, "w_up": layer.w_up.grad,
           "w_down": layer.w_down.grad}
    if layer.shared is not None:
        got["shared"] = {n: {"kernel": getattr(layer.shared, n).kernel.grad}
                         for n in ("w_gate", "w_up", "w_down")}
    paths = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert jax.tree.structure(jg) == jax.tree.structure(
        jax.tree.map(lambda t: 0, got))
    for (path, w), g in zip(paths + [((), jgx)],
                            jax.tree.leaves(got) + [xt.grad]):
        w = np.asarray(w, np.float64)
        d = np.abs(g.numpy().astype(np.float64) - w).max()
        assert np.abs(w).max() > 0, jax.tree_util.keystr(path)
        assert d <= GRAD_TOL * np.abs(w).max(), (
            f"{jax.tree_util.keystr(path)}: max diff {d}, largest "
            f"{np.abs(w).max()}")


def test_route_log_records_and_replays():
    """``RouteLog`` keeps each router call's (N, k) choice; replayed into a
    run on other inputs it routes by the record, each choice weighted by
    that run's own probability there (the ``dense`` combine of a
    hand-built mixture), and counts the tokens whose own top k it
    overrode; replayed into the recorded run it changes nothing."""
    _, cfg, _, layer = _layer(moe_impl="dense")
    d, E = cfg.d_model, cfg.num_experts
    x = torch.from_numpy(_x(cfg))
    with moe.RouteLog() as rec:
        y, _ = moe.apply_moe(layer, cfg, x)
    assert len(rec.calls) == 1 and rec.calls[0].shape == (B * T, 2)
    with moe.RouteLog(rec.calls) as same:
        y_same, _ = moe.apply_moe(layer, cfg, x)
    assert torch.equal(y_same, y) and same.rerouted == 0

    x2 = torch.from_numpy(_x(cfg)[::-1].copy())        # other tokens
    with moe.RouteLog(rec.calls) as rep:
        y2, _ = moe.apply_moe(layer, cfg, x2)
    idx = rec.calls[0]
    assert torch.equal(rep.calls[0], idx)
    xf = x2.reshape(-1, d)
    with torch.no_grad():
        probs = torch.softmax(xf @ layer.router.kernel, -1)
        own = probs.topk(2, -1).indices
        w = probs.gather(-1, idx)
        w = w / w.sum(-1, keepdim=True)
        ye = moe._experts(layer, xf.expand(E, -1, -1), cfg.act)  # (E, N, d)
        n = torch.arange(xf.shape[0])
        want = sum(w[:, j, None] * ye[idx[:, j], n] for j in range(2))
    assert rep.rerouted == int((own.sort(-1).values != idx.sort(-1).values
                                ).any(-1).sum()) > 0
    _close(y2.reshape(-1, d), want, "replayed output")

    with pytest.raises(RuntimeError, match="already active"):
        with moe.RouteLog(), moe.RouteLog():
            pass
    with pytest.raises(RuntimeError, match="no recorded twin"):
        with moe.RouteLog(rec.calls):
            moe.apply_moe(layer, cfg, x[:1])
    with pytest.raises(RuntimeError, match="replayed 0 of 1"):
        with moe.RouteLog(rec.calls):
            pass
