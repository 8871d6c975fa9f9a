"""The port's Mamba slice on the CPU against the JAX package: the selective
scan (``kernels/mamba_scan``'s plain version against the reference's
``step`` recurrence), one Mamba layer (``models/mamba.py`` against
``repro.models.mamba.apply_mamba``: full sequence, left pads, a
prefill-with-cache then decode steps, the chunked route, gradients), and
the reduced jamba-v0.1-52b (one full period of 8 layers, d_model 256,
``moe_impl`` ``dense`` and ``dispatch``): ``forward`` logits and aux,
``score``, prefill plus decode steps with the mixed attention + Mamba
caches, a two-epoch ``rollout`` that takes the two-pass branch, and one
GRPO ``optimize``.

Inputs are numpy arrays from a seed; parameters from JAX's inits through
``from_jax_params``; random draws through ``JaxKey``.  JAX's functions run
under ``jax.jit``, torch on one thread.  Tolerances: atol 1e-4 for the scan
and one layer (float32 sums in another order; outputs of order 5); atol
``MODEL_ATOL`` = 5e-4 for the reduced jamba's logits, log-probs and caches:
its eight layers amplify float32 rounding about 600-fold (a 1e-7 relative
nudge of JAX's own embeddings moves its logits by 5.8e-5), so the port's
other summation order lands at about 2e-4; gradients within 1e-4 of each
tensor's largest magnitude (or 1e-4 where that is below 1); the optimize
with ``test_torch_train.py``'s tolerances but a gradient budget of
``GRAD_NOISE`` = 2e-4 (the same amplification: JAX's own gradients move by
1.2e-4 of their largest under that nudge).  Tokens, lengths, ``n`` and the
metrics compared exactly."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.core.spec_rollout as jax_spec_rollout  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import RolloutCache as JaxRolloutCache  # noqa: E402
from repro.core import SpecConfig as JaxSpecConfig  # noqa: E402
from repro.engine.generate import GenerateConfig as JaxGenerateConfig  # noqa: E402
from repro.engine.generate import positions_from_mask as jax_positions  # noqa: E402
from repro.engine.generate import score as jax_score  # noqa: E402
from repro.models import mamba as JMB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RolloutCache, SpecConfig, rollout  # noqa: E402
from repro_torch.data.dataset import PromptDataset  # noqa: E402
from repro_torch.data.tokenizer import EOS_ID, PAD_ID  # noqa: E402
from repro_torch.engine.generate import (GenerateConfig,  # noqa: E402
                                         positions_from_mask, score)
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.mamba_scan.ops import (mamba_scan,  # noqa: E402
                                                mamba_scan_cuda,
                                                mamba_scan_plain)
from repro_torch.models import mamba as MB  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.blocks import check_supported  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.rewards.mathgen import MathTaskConfig, generate_problems  # noqa: E402
from test_torch_rollout import JaxKey  # noqa: E402
from test_torch_train import (LOSS_RTOL, TOL, _capture_jax_grads,  # noqa: E402
                              _capture_port_grads, _check_grads,
                              _check_params, _close, _mixed_rewards,
                              _port_rb, _trainers)

ATOL = 1e-4
MODEL_ATOL = 5e-4
# the optimize's gradient budget, of each tensor's largest magnitude: a
# 1e-7 relative nudge of the embeddings moves JAX's own gradients of the
# reduced jamba by up to 1.2e-4 of it (mixtral's: 1.5e-6), where
# test_torch_train.py's GRAD_NOISE is 5e-5
GRAD_NOISE = 2e-4
ARCH = "jamba-v0.1-52b"
B, P, STEPS = 3, 10, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _near(got, want, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=what)


# ------------------------------------------------------------------ the scan


def _jax_step_scan(dt, u, Bc, Cc, A, D, s0):
    """The reference's recurrence (``step`` at ``repro/models/mamba.py:
    101-107``, a closure there, restated) under ``lax.scan``, then the D
    skip of ``:130``."""
    def step(s, inp):
        dt_t, B_t, C_t, u_t = inp
        dA_t = jnp.exp(dt_t[..., None] * A)
        s = dA_t * s + (dt_t * u_t)[..., None] * B_t[..., None, :]
        return s, jnp.einsum("bds,bs->bd", s, C_t)

    def tm(a):
        return jnp.moveaxis(a, 1, 0)

    s, ys = jax.lax.scan(step, s0, (tm(dt), tm(Bc), tm(Cc), tm(u)))
    return jnp.moveaxis(ys, 0, 1) + u * D, s


def _scan_case(Bn, T, di, ds, seed, pad=0):
    """dt from the model's range (a softplus of a normal), zero on the
    first ``pad`` steps of row 0; A = -exp(log(1..ds)) jittered; a nonzero
    state."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    dt = np.log1p(np.exp(rng.standard_normal((Bn, T, di)))).astype(f32)
    dt[0, :pad] = 0.0
    u = rng.standard_normal((Bn, T, di)).astype(f32)
    Bc, Cc = (rng.standard_normal((Bn, T, ds)).astype(f32) for _ in range(2))
    A = -(np.arange(1, ds + 1, dtype=f32)[None, :]
          * np.exp(0.1 * rng.standard_normal((di, ds)))).astype(f32)
    D = rng.standard_normal(di).astype(f32)
    s0 = (0.5 * rng.standard_normal((Bn, di, ds))).astype(f32)
    return dt, u, Bc, Cc, A, D, s0


@pytest.mark.parametrize("Bn,T,di,ds", [(2, 1, 8, 16), (3, 37, 16, 16),
                                        (1, 64, 8, 4)])
def test_mamba_scan_plain_matches_jax_step(Bn, T, di, ds):
    """y and the final state, T = 1 being the decode step; the wrapper
    (on CPU tensors) writes the final state over its input."""
    case = _scan_case(Bn, T, di, ds, seed=T, pad=min(T - 1, 5))
    jy, js = _jax_step_scan(*map(jnp.asarray, case))
    y, s = mamba_scan_plain(*map(_t, case))
    _near(y, jy, "y")
    _near(s, js, "state")
    state = _t(case[-1]).clone()
    y2 = mamba_scan(*map(_t, case[:-1]), state)
    _near(y2, jy, "y (wrapper)")
    _near(state, js, "state written in place")


def test_mamba_scan_state_handoff_and_pads():
    """[0:T1] then [T1:T] through the state in place equals one shot; a
    step with dt = 0 leaves the state as if the step were absent."""
    dt, u, Bc, Cc, A, D, s0 = map(_t, _scan_case(2, 20, 8, 16, seed=7))
    y_full, s_full = mamba_scan_plain(dt, u, Bc, Cc, A, D, s0)
    state = s0.clone()
    parts = [mamba_scan(dt[:, a:b], u[:, a:b], Bc[:, a:b], Cc[:, a:b], A, D,
                        state) for a, b in ((0, 7), (7, 8), (8, 20))]
    _near(torch.cat(parts, 1), y_full, "handoff y")
    _near(state, s_full, "handoff state")
    dt_pad = dt.clone()
    dt_pad[:, 3] = 0.0
    _, s_a = mamba_scan_plain(dt_pad, u, Bc, Cc, A, D, s0)
    keep = [t for t in range(20) if t != 3]
    _, s_b = mamba_scan_plain(dt[:, keep], u[:, keep], Bc[:, keep],
                              Cc[:, keep], A, D, s0)
    _near(s_a, s_b, "pad state")


def test_mamba_scan_refuses_grad_and_what_the_kernel_cannot_take():
    dt, u, Bc, Cc, A, D, s0 = map(_t, _scan_case(1, 4, 8, 16, seed=1))
    with pytest.raises(RuntimeError, match="mamba_scan: an input requires"):
        mamba_scan(dt.requires_grad_(), u, Bc, Cc, A, D, s0)
    dt = dt.detach()
    with pytest.raises(ValueError, match="state size 4"):
        mamba_scan_cuda(dt, u, Bc[..., :4], Cc[..., :4], A[:, :4], D,
                        s0[..., :4])
    with pytest.raises(ValueError, match="contiguous float32 u"):
        mamba_scan_cuda(dt, u.double(), Bc, Cc, A, D, s0)


# ----------------------------------------------------------------- one layer


@pytest.fixture(scope="module")
def layer():
    """One Mamba layer's parameters in both packages (the reduced jamba's
    widths: d 256, di 512, ds 16, dt rank 16, conv 4) with scan_chunk 4."""
    jcfg = jax_get_config(ARCH).reduced(scan_chunk=4)
    cfg = get_config(ARCH).reduced(scan_chunk=4)
    jp = JMB.make_mamba(jax.random.PRNGKey(1), jcfg, jnp.float32)
    # make_mamba's conv_b and dt_proj bias are 0 and D is 1: give them
    # values, so that their paths are checked
    rng = np.random.default_rng(2)
    jp["conv_b"] = jnp.asarray(rng.standard_normal(cfg.mamba_d_inner),
                               jnp.float32) * 0.1
    jp["dt_proj"]["bias"] = jnp.asarray(
        rng.standard_normal(cfg.mamba_d_inner), jnp.float32) * 0.1
    jp["D"] = jnp.asarray(rng.standard_normal(cfg.mamba_d_inner), jnp.float32)
    mod = MB.Mamba(cfg, dtype=torch.float32)
    with torch.no_grad():
        for name, value in jax.tree.map(np.asarray, jp).items():
            target = getattr(mod, name)
            if isinstance(value, dict):
                for k, v in value.items():
                    getattr(target, k).copy_(_t(v))
            else:
                target.copy_(_t(value))
    fns = dict(
        apply=jax.jit(lambda p, x, pos: JMB.apply_mamba(p, jcfg, x, pos)[0]),
        cached=jax.jit(lambda p, x, pos, c: JMB.apply_mamba(p, jcfg, x, pos,
                                                            cache=c)))
    return jcfg, cfg, jp, mod, fns


def _layer_inputs(cfg, T, seed, pads=(0, 4, 0)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    for b, n in enumerate(pads):
        pos[b] -= n
        pos[b, :n] = -1
    return x, pos


@pytest.mark.parametrize("case", ["full", "left_pads", "chunked"])
def test_mamba_layer_matches_jax(layer, case):
    """The layer with no cache: a full sequence with no pad (T = 6, which
    scan_chunk 4 does not divide: one scan), left pads (row 1 padded 4
    slots: its state and outputs equal those of the same tokens unpadded),
    and T = 12 > scan_chunk = 4, which JAX runs chunked under
    ``jax.checkpoint``."""
    jcfg, cfg, jp, mod, fns = layer
    T, pads = {"full": (6, (0, 0, 0)), "left_pads": (10, (0, 4, 9)),
               "chunked": (12, (0, 3, 0))}[case]
    x, pos = _layer_inputs(cfg, T, seed=T, pads=pads)
    want = fns["apply"](jp, jnp.asarray(x), jnp.asarray(pos))
    with torch.no_grad():
        got = MB.apply_mamba(mod, cfg, _t(x), _t(pos))
    _near(got, want, f"layer output ({case})")
    if case == "left_pads":
        n = pads[1]
        cache = MB.init_mamba_cache(cfg, 1, torch.float32, "cpu")
        with torch.no_grad():
            alone = MB.apply_mamba(mod, cfg, _t(x[1:2, n:]), _t(pos[1:2, n:]),
                                   cache=cache)
            padded = MB.init_mamba_cache(cfg, 1, torch.float32, "cpu")
            MB.apply_mamba(mod, cfg, _t(x[1:2]), _t(pos[1:2]), cache=padded)
        _near(got[1:2, n:], alone, "padded row vs the same tokens unpadded")
        _near(padded["ssm"], cache["ssm"], "state after pads")


def test_mamba_prefill_with_cache_then_steps_match_jax(layer):
    """Prefill (T = 8) from a nonzero cache: JAX reads ``cache["ssm"]`` but
    starts the conv from a zero history (``mamba.py:87-92``), and so does
    the port; then T = 1 steps with a done row (position -1) in the last.
    Outputs and both caches after every call, the port's in place."""
    jcfg, cfg, jp, mod, fns = layer
    x, pos = _layer_inputs(cfg, 8 + STEPS, seed=3, pads=(0, 2, 5))
    rng = np.random.default_rng(4)
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    start = {"conv": rng.standard_normal((B, dc - 1, di)).astype(np.float32),
             "ssm": 0.3 * rng.standard_normal((B, di, ds)).astype(np.float32)}
    jc = jax.tree.map(jnp.asarray, start)
    tc = {k: _t(v).clone() for k, v in start.items()}
    for t0, t1 in [(0, 8)] + [(8 + s, 9 + s) for s in range(STEPS)]:
        xs, ps = x[:, t0:t1], pos[:, t0:t1].copy()
        if t0 == 8 + STEPS - 1:
            ps[0] = -1
        jy, jc = fns["cached"](jp, jnp.asarray(xs), jnp.asarray(ps), jc)
        with torch.no_grad():
            ty = MB.apply_mamba(mod, cfg, _t(xs), _t(ps), cache=tc)
        _near(ty, jy, f"output [{t0}, {t1})")
        for k in ("conv", "ssm"):
            _near(tc[k], jc[k], f"cache {k} after [{t0}, {t1})")


def test_mamba_layer_gradients_match_jax(layer):
    """d(sum(out * w))/d(params, x) through the chunked route (T = 12,
    scan_chunk 4: ``ssm_scan`` under ``torch.utils.checkpoint``, JAX's
    under ``jax.checkpoint``), left pads in row 1."""
    jcfg, cfg, jp, mod, fns = layer
    x, pos = _layer_inputs(cfg, 12, seed=5, pads=(0, 3, 0))
    w = np.random.default_rng(6).standard_normal(
        (B, 12, cfg.d_model)).astype(np.float32)

    def loss(p, xx):
        out, _ = JMB.apply_mamba(p, jcfg, xx, jnp.asarray(pos))
        return jnp.sum(out * jnp.asarray(w))

    jgp, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    xt = _t(x).requires_grad_()
    for prm in mod.parameters():
        prm.requires_grad_(True)
    try:
        out = MB.apply_mamba(mod, cfg, xt, _t(pos))
        (out * _t(w)).sum().backward()
        grads = {n: prm.grad.clone() for n, prm in mod.named_parameters()}
    finally:
        for prm in mod.parameters():
            prm.requires_grad_(False)
            prm.grad = None

    def near_grad(got, want, what):
        want = np.asarray(want)
        _near(got, want, what, atol=ATOL * max(1.0, float(np.abs(want).max())))

    near_grad(xt.grad, jgx, "grad x")
    flat = jax.tree_util.tree_flatten_with_path(jgp)[0]
    assert len(flat) == len(grads)
    for path, g in flat:
        name = ".".join(k.key for k in path)
        near_grad(grads[name], g, f"grad {name}")


# ------------------------------------------------------------ reduced jamba


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    tokens = rng.integers(3, 512, (B, P)).astype(np.int32)
    mask = np.ones((B, P), bool)
    mask[1, :4] = False                       # left padding
    mask[2, :P - 1] = False                   # a one-token prompt
    nxt = rng.integers(3, 512, (B, STEPS)).astype(np.int32)
    return tokens, mask, nxt


def _decode_args(mask, s):
    """Step s's positions (row 0 done in the last step) and live bounds."""
    p_len = mask.sum(1).astype(np.int32)
    pos = (p_len + s)[:, None].astype(np.int32)
    if s == STEPS - 1:
        pos[0] = -1
    return pos, P + 1 + s, (P - p_len).astype(np.int32)


@pytest.fixture(scope="module")
def built(inputs):
    """Per ``moe_impl``, built once and shared by the tests below: (jcfg,
    cfg, params, model, ref), ``ref`` holding JAX's outputs on ``inputs``
    (forward logits and aux with the score in one jitted call; prefill
    logits, each decode step's logits and the final caches)."""
    tokens, mask, nxt = inputs
    cache = {}

    def get(impl):
        if impl in cache:
            return cache[impl]
        jcfg = jax_get_config(ARCH).reduced(moe_impl=impl)
        cfg = get_config(ARCH).reduced(moe_impl=impl)
        params = JM.init_lm(jax.random.PRNGKey(0), jcfg)
        model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
        jt, jm = jnp.asarray(tokens), jnp.asarray(mask)
        ref = {}
        ref["forward"], ref["score"] = jax.jit(lambda p: (
            JM.forward(p, jcfg, jt, jax_positions(jm)),
            jax_score(p, jcfg, jt, jm, return_entropy=True)))(params)
        decode = jax.jit(lambda p, t, pos, c, start, length, kv_start:
                         JM.decode_step(p, jcfg, t, pos, c, start,
                                        kv_length=length, kv_start=kv_start))
        jc = JM.init_cache(jcfg, B, P + STEPS)
        ref["prefill"], jc = jax.jit(lambda p, c: JM.prefill(
            p, jcfg, jt, jax_positions(jm), c))(params, jc)
        ref["decode"] = []
        for s in range(STEPS):
            pos, length, kv_start = _decode_args(mask, s)
            logits, jc = decode(params, jnp.asarray(nxt[:, s:s + 1]),
                                jnp.asarray(pos), jc, jnp.int32(P + s),
                                jnp.asarray(length), jnp.asarray(kv_start))
            ref["decode"].append(logits)
        ref["caches"] = jc
        cache[impl] = jcfg, cfg, params, model, ref
        return cache[impl]
    return get


def test_jamba_config_layers_and_parameters(built):
    """The port's config is JAX's field for field (full and reduced), the
    support gate accepts it, the reduced model keeps one full period
    (Mamba + MoE at 0, 2, 6; Mamba + FFN at 1, 3, 5, 7; attention + MoE at
    4) and JAX's parameter count."""
    jcfg, cfg, params, model, _ = built("dense")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.rope_theta == 10_000.0 and cfg.moe_every == 2
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(
        jax_get_config(ARCH))
    check_supported(get_config(ARCH))
    assert cfg.layer_plan() == tuple(
        ("attn" if i == 4 else "mamba", i % 2 == 0) for i in range(8))
    assert [type(layer).__name__ for layer in model.layers] == [
        "Block" if i == 4 else "MambaBlock" for i in range(8)]
    assert M.count_params(model) == sum(x.size for x in
                                        jax.tree.leaves(params))
    np.testing.assert_array_equal(
        model.layers[2].mamba.A_log.numpy(),
        np.asarray(params["trunk"][2]["mamba"]["A_log"][0]))


def test_init_draws_jax_distributions():
    """``init_lm``'s Mamba leaves: A_log = log(1..ds) on every channel,
    D = 1, conv_b = 0, conv_w ~ N(0, 1/dc), the dt_proj bias 0."""
    cfg = get_config(ARCH).reduced()
    mb = M.init_lm(cfg, seed=0, device="cpu").layers[0].mamba
    ds, dc = cfg.mamba_d_state, cfg.mamba_d_conv
    np.testing.assert_allclose(mb.A_log.numpy(), np.broadcast_to(
        np.log(np.arange(1, ds + 1, dtype=np.float32)), mb.A_log.shape),
        rtol=1e-6)
    assert bool((mb.D == 1).all()) and bool((mb.conv_b == 0).all())
    assert bool((mb.dt_proj.bias == 0).all())
    std = float(mb.conv_w.std())
    assert abs(std - 1.0 / np.sqrt(dc)) < 0.05 / np.sqrt(dc), std


@pytest.mark.parametrize("impl", ["dense", "dispatch"])
def test_jamba_forward_logits_and_aux_match(built, inputs, impl):
    jcfg, cfg, params, model, ref = built(impl)
    tokens, mask, _ = inputs
    want, want_aux = ref["forward"]
    reset_launches()
    got, got_aux = M.forward(model, cfg, _t(tokens),
                             positions_from_mask(_t(mask)))
    assert LAUNCHES["mamba_scan"] == 0          # the CPU runs plain versions
    _near(got, want, "forward logits", MODEL_ATOL)
    assert set(got_aux) == set(want_aux) and "moe_lb_loss" in got_aux
    for k in want_aux:
        np.testing.assert_allclose(got_aux[k].numpy(), np.asarray(want_aux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("impl", ["dense", "dispatch"])
def test_jamba_score_matches(built, inputs, impl):
    jcfg, cfg, params, model, ref = built(impl)
    tokens, mask, _ = inputs
    want = ref["score"]
    got = score(model, cfg, tokens, mask, return_entropy=True)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    for name in ("logprobs", "entropy"):
        _near(got[name], want[name], f"score {name}", MODEL_ATOL)


@pytest.mark.parametrize("impl", ["dense", "dispatch"])
def test_jamba_prefill_decode_and_caches_match(built, inputs, impl):
    """prefill, teacher-forced decode steps with live bounds (a done row
    in the last step), then every buffer of the mixed caches: the
    attention run's k, v and pos, each Mamba run's conv and ssm."""
    jcfg, cfg, params, model, ref = built(impl)
    tokens, mask, nxt = inputs
    tc = M.init_cache(cfg, B, P + STEPS, device="cpu")
    tl, tc = M.prefill(model, cfg, _t(tokens), positions_from_mask(_t(mask)),
                       tc)
    _near(tl, ref["prefill"], "prefill logits", MODEL_ATOL)
    for s in range(STEPS):
        pos, length, kv_start = _decode_args(mask, s)
        tl, tc = M.decode_step(model, cfg, _t(nxt[:, s:s + 1]), _t(pos), tc,
                               P + s, kv_length=length,
                               kv_start=_t(kv_start))
        _near(tl, ref["decode"][s], f"decode step {s} logits", MODEL_ATOL)
    jc = ref["caches"]
    assert [set(run) for run in tc] == [
        {"self"} if i == 4 else {"mamba"} for i in range(8)]
    for i, (trun, jrun) in enumerate(zip(tc, jc)):
        for kind, bufs in trun.items():
            assert set(bufs) == set(jrun[kind])
            for name, buf in bufs.items():
                if name == "pos":
                    np.testing.assert_array_equal(buf.numpy(),
                                                  np.asarray(jrun[kind][name]))
                else:
                    _near(buf, jrun[kind][name], f"run {i} {kind}.{name}",
                          MODEL_ATOL)
    assert not M.supports_cache_realign(cfg)
    assert not M.supports_slot_serving(cfg) and not M.supports_drafting(cfg)


def test_jamba_two_epoch_rollout_matches_jax(built, monkeypatch):
    """Epoch 0 vanilla, epoch 1 the two-pass branch (score, left-align,
    re-prefill and decode) at lenience 0.8, through one RolloutCache each:
    tokens, lengths, masks, ``n`` and the metrics equal to JAX's.  With
    ``dispatch``, jamba's own strategy (``dense`` is held by the tests
    above), for the time a second rollout's compiles would take."""
    jcfg, cfg, params, model, _ = built("dispatch")
    group = 2
    problems = generate_problems(MathTaskConfig(num_problems=3, seed=0))
    batch = next(PromptDataset(problems, max_prompt_len=16).epochs(
        3, group, 1, shuffle=False))
    N = 12
    jgen = JaxGenerateConfig(max_new_tokens=N, eos_id=EOS_ID, pad_id=PAD_ID)
    gen = GenerateConfig(max_new_tokens=N, eos_id=EOS_ID, pad_id=PAD_ID)
    jspec = JaxSpecConfig(variant="spec", lenience=0.8,
                          verify_impl="interpret")
    spec = SpecConfig(variant="spec", lenience=0.8)
    jcache = JaxRolloutCache(group_size=group)
    cache = RolloutCache(group_size=group)
    jax_n = {}
    verify = jax_spec_rollout.verify_drafts

    def spy(*args, **kw):
        out = verify(*args, **kw)
        jax_n["n"] = np.asarray(out["n"])
        return out

    monkeypatch.setattr(jax_spec_rollout, "verify_drafts", spy)
    key = jax.random.PRNGKey(3)
    for epoch in (0, 1):
        key, sub = jax.random.split(key)
        want = jax_spec_rollout.rollout(
            params, jcfg, jgen, jspec, jnp.asarray(batch.tokens),
            jnp.asarray(batch.mask), batch.cache_keys, jcache, sub, epoch)
        got = rollout(model, cfg, gen, spec, batch.tokens, batch.mask,
                      batch.cache_keys, cache, JaxKey(sub), epoch)
        np.testing.assert_array_equal(got.response, want.response)
        np.testing.assert_array_equal(got.length, want.length)
        np.testing.assert_array_equal(got.response_mask, want.response_mask)
        _near(got.behaviour_logprobs, want.behaviour_logprobs, "logprobs",
              MODEL_ATOL)
        assert set(got.metrics) == set(want.metrics)
        for k in ("one_pass", "prefill_passes", "n_generated", "n_reused"):
            assert got.metrics[k] == want.metrics[k], k
    np.testing.assert_array_equal(got.n, jax_n["n"])
    assert got.metrics["one_pass"] == 0.0
    assert got.metrics["prefill_passes"] == 2.0
    assert got.metrics["n_reused"] > 0


def test_jamba_grpo_optimize_matches_jax(monkeypatch):
    """One ``optimize`` of the reduced jamba (``dispatch``) on one collected
    rollout with seeded mixed rewards: the loss with the router losses,
    ``moe_lb_loss``, grad norm, every gradient leaf (the Mamba leaves
    through ``ssm_scan``) and every updated parameter, as
    ``test_torch_archs.py``'s mixtral optimize."""
    lr = 1e-3
    jtr, tr = _trainers(ARCH, lr, moe_impl="dispatch")
    batch = jtr.collector.sample(0)
    _, jrb, _, jtimes = jtr._collect(batch)
    rewards = _mixed_rewards(jrb.prompt.shape[0], 4)
    before = jtr.params
    jgrads = _capture_jax_grads(monkeypatch)
    grads = _capture_port_grads(monkeypatch)
    want = jtr.optimize(jrb, rewards, dict(jtimes))
    got = tr.optimize(_port_rb(jrb), rewards, dict(jtimes))
    assert set(got) == set(want) and "moe_lb_loss" in got
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL,
                               atol=TOL, err_msg="loss")
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=LOSS_RTOL, err_msg="grad_norm")
    _close(got["moe_lb_loss"], want["moe_lb_loss"], "moe_lb_loss")
    _check_grads(tr, grads, jgrads[0], GRAD_NOISE)
    _check_params(tr, jtr, grads, before, lr, want["grad_norm"], GRAD_NOISE)


def test_launchers_take_jamba(capsys):
    """``python -m repro_torch.launch.train --arch jamba-v0.1-52b --smoke``
    trains the reduced jamba on the CPU (epoch 1 takes the two-pass
    branch); the serve launcher refuses the slot engine for it, as JAX's
    ``launch/serve.py`` does a recurrent trunk."""
    from repro_torch.launch import serve, train

    assert train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2", "--max-new-tokens", "6"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke" in out and "step   1" in out
    with pytest.raises(SystemExit, match="--engine slots unsupported"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--engine", "slots", "--requests", "2"])
