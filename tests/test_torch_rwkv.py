"""The port's RWKV6 slice on the CPU against the JAX package: the ``wkv``
recurrence (its plain version against JAX's ``ref`` and Pallas
``interpret`` runs), the time and channel mixes, the reduced rwkv6-3b
model (``forward``, ``prefill``, ``decode_step`` and the caches they fill)
and two epochs of its speculative rollout, which takes the two-pass branch
(a recurrent state cannot be compacted).

Inputs come from numpy seeds; parameters from ``repro.models.model.init_lm``
through ``from_jax_params``; random draws through the ``JaxKey`` helpers of
``test_torch_rollout.py``.  Tolerances: atol = rtol = 1e-4 for ``wkv`` (JAX's
own kernel tolerance: float32 sums over up to 64 steps in another order),
atol 1e-4 for mixes, logits, caches and log-probs (float32 through two
layers summed in another order); tokens, lengths, ``n`` and the metrics
compared exactly.  In bfloat16 the port must round like the reference: its
logits lie within ``BF16_TOL`` of JAX's bfloat16 ones (bfloat16 rounding at
other places than XLA's: 0.035 for qwen3-1.7b and 0.0625 for rwkv6-3b on
the CPU, whose bfloat16 logits lie up to 1.8 from its float32 ones) and no
further from the port's float32 ones than ``BF16_GAP`` times JAX's do."""
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
from repro.kernels.rwkv6_wkv.ops import wkv as jax_wkv  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RolloutCache, SpecConfig, rollout  # noqa: E402
from repro_torch.data.dataset import PromptDataset  # noqa: E402
from repro_torch.data.tokenizer import EOS_ID, PAD_ID  # noqa: E402
from repro_torch.engine.generate import GenerateConfig, positions_from_mask  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ops import wkv, wkv_plain  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.rewards.mathgen import MathTaskConfig, generate_problems  # noqa: E402
from test_torch_rollout import JaxKey  # noqa: E402

ATOL = 1e-4
BF16_TOL = 0.1
BF16_GAP = 1.5
B, P, STEPS = 3, 10, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one CPU thread for the module: the reduced models' small
    ops gain nothing from more, while test processes sharing the cores
    lose much to them (each process's threads would compete for the same
    cores)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what, rtol=0.0, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)


def _wkv_case(Bc, T, H, hd, seed):
    """The inputs of ``tests/kernels/test_rwkv6_wkv.py``'s cases, from
    numpy: w in (0, 1) (a sigmoid of a normal), a nonzero state."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((Bc, T, H, hd), dtype=np.float32)
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((Bc, T, H, hd))))
         ).astype(np.float32)
    u = (0.3 * rng.standard_normal((H, hd))).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((Bc, H, hd, hd))).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("Bc,T,H,hd,bt", [
    (1, 8, 1, 4, 4), (2, 37, 3, 8, 16), (1, 64, 2, 16, 32), (3, 16, 4, 8, 8),
    (2, 1, 3, 32, 1),
])
def test_wkv_plain_matches_jax(Bc, T, H, hd, bt):
    """y and the final state against JAX's lax.scan oracle and its Pallas
    kernel in interpret mode; T = 1 is the decode step."""
    case = _wkv_case(Bc, T, H, hd, seed=Bc * T + hd)
    y, s = wkv(*map(_t, case))
    for impl in ("ref", "interpret"):
        jy, js = jax_wkv(*map(jnp.asarray, case), impl=impl, block_t=bt)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL,
                                   rtol=ATOL, err_msg=f"y vs {impl}")
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=ATOL,
                                   rtol=ATOL, err_msg=f"state vs {impl}")


def test_wkv_state_handoff_in_place_and_pads():
    """[0:T1] then [T1:T] from the carried state, written in place over
    s0 (the decode cache's contract), equals one shot; w = 1, k = 0 at a
    position leaves the state as if the position were absent."""
    r, k, v, w, u, s0 = map(_t, _wkv_case(2, 24, 2, 8, seed=5))
    y_full, s_full = wkv_plain(r, k, v, w, u, s0)
    state = s0.clone()
    y1, out1 = wkv(r[:, :10], k[:, :10], v[:, :10], w[:, :10], u, state,
                   s_out=state)
    y2, out2 = wkv(r[:, 10:], k[:, 10:], v[:, 10:], w[:, 10:], u, state,
                   s_out=state)
    assert out1 is state and out2 is state
    _close(torch.cat([y1, y2], 1), y_full, "handoff y", rtol=ATOL)
    _close(state, s_full, "handoff state", rtol=ATOL)

    k_pad, w_pad = k.clone(), w.clone()
    k_pad[:, 3], w_pad[:, 3] = 0.0, 1.0
    _, s_a = wkv(r, k_pad, v, w_pad, u, s0)
    keep = [t for t in range(24) if t != 3]
    _, s_b = wkv(r[:, keep], k[:, keep], v[:, keep], w[:, keep], u, s0)
    _close(s_a, s_b, "pad state")


@pytest.mark.parametrize("hd", [32, 64])
def test_wkv_step_partition_covers_each_element_once(hd):
    """The T = 1 kernel's partition (its Python twin) against brute force:
    every state element of every (b, h) lies in exactly one thread of one
    block; a block takes one whole (b, h); a thread takes R = hd / 16
    consecutive rows of 4 adjacent columns."""
    Bc, H = 3, 5
    part = wkv_ops.wkv_step_partition(Bc, H, hd).numpy()
    blk, tid, b, h, i, j = part.T
    assert len(part) == Bc * H * hd * hd
    flat = ((b * H + h) * hd + i) * hd + j
    np.testing.assert_array_equal(np.sort(flat), np.arange(Bc * H * hd * hd))
    assert blk.max() + 1 == Bc * H
    for n in range(blk.max() + 1):
        mine = part[blk == n]
        assert len({(x[2], x[3]) for x in mine}) == 1, f"block {n}"
        assert len(mine) == hd * hd, f"block {n}"
    R = hd // 16
    for key in {(x[0], x[1]) for x in part[:: 7 * R]}:
        mine = part[(blk == key[0]) & (tid == key[1])]
        rows, cs = np.unique(mine[:, 4]), np.unique(mine[:, 5])
        assert len(mine) == 4 * R and len(rows) == R and len(cs) == 4
        assert rows[-1] - rows[0] == R - 1 and rows[0] % R == 0
        assert cs[-1] - cs[0] == 3 and cs[0] % 4 == 0


def test_wkv_kernel_refuses_what_it_cannot_take():
    """The kernel entry raises before any launch on inputs outside the
    kernel's contract (meta tensors: the checks need no card): a head dim
    other than 32 or 64, another dtype, a wrong shape, a non-contiguous
    input; and ``wkv`` on a device without a kernel raises too."""
    meta = dict(device="meta", dtype=torch.float32)
    Bc, T, H = 2, 5, 3

    def call(hd=64, dtype=None, r=None, u=None, s_out=None):
        x = torch.empty(Bc, T, H, hd, device="meta",
                        dtype=dtype or torch.float32)
        s0 = torch.empty(Bc, H, hd, hd, **meta)
        wkv_ops.wkv_cuda(x if r is None else r, x, x, x,
                         torch.empty(H, hd, **meta) if u is None else u, s0,
                         s0 if s_out is None else s_out)

    with pytest.raises(ValueError, match="head dim"):
        call(hd=48)
    with pytest.raises(ValueError, match="head dim"):
        call(hd=128)
    with pytest.raises(ValueError, match="float32"):
        call(dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape"):
        call(u=torch.empty(H + 1, 64, **meta))
    with pytest.raises(ValueError, match="s_out"):
        call(s_out=torch.empty(Bc, H, 64, 32, **meta))
    with pytest.raises(ValueError, match="contiguous"):
        call(r=torch.empty(Bc, H, T, 64, **meta).transpose(1, 2))
    x = torch.empty(Bc, T, H, 64, **meta)
    with pytest.raises(ValueError, match="no kernel"):
        wkv(x, x, x, x, torch.empty(H, 64, **meta),
            torch.empty(Bc, H, 64, 64, **meta))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("rwkv6-3b").reduced()
    cfg = get_config("rwkv6-3b").reduced()
    params = JM.init_lm(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return jcfg, cfg, params, model


@pytest.fixture(scope="module")
def inputs(models):
    _, cfg, _, _ = models
    rng = np.random.default_rng(0)
    tokens = rng.integers(3, cfg.vocab_size, (B, P)).astype(np.int32)
    mask = np.ones((B, P), bool)
    mask[1, :4] = False                       # left padding
    mask[2, :P - 1] = False                   # a one-token prompt
    nxt = rng.integers(3, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    return tokens, mask, nxt


def test_config_and_parameters_carry_across(models):
    jcfg, cfg, params, model = models
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert (cfg.rwkv_num_heads, cfg.rwkv_head_dim, cfg.rwkv_lora_rank) == \
        (4, 32, 64)
    assert M.count_params(model) == sum(x.size for x in jax.tree.leaves(params))
    tm = params["trunk"][0]["time_mix"]
    np.testing.assert_array_equal(model.layers[1].time_mix.lora_b.numpy(),
                                  np.asarray(tm["lora_b"][1]))
    np.testing.assert_array_equal(model.layers[1].norm2.bias.numpy(),
                                  np.asarray(params["trunk"][0]["norm2"]
                                             ["bias"][1]))
    full = get_config("rwkv6-3b")
    assert (full.num_layers, full.d_model, full.rwkv_num_heads,
            full.rwkv_head_dim, full.d_ff, full.vocab_size) == \
        (32, 2560, 40, 64, 8960, 65536)


def test_from_jax_params_raises_on_a_shape_mismatch(models):
    jcfg, cfg, params, _ = models
    tree = jax.tree.map(np.asarray, params)
    tree["trunk"][0]["time_mix"]["u"] = tree["trunk"][0]["time_mix"]["u"][:, :-1]
    with pytest.raises(ValueError, match="time_mix.u: shape"):
        from_jax_params(tree, cfg, device="cpu")


def test_time_and_channel_mix_match_jax(models, inputs):
    """One layer's mixes on random activations with left padding: the
    full sequence against JAX's, with and without a cache (nonzero start
    state and shift rows), and against the port's own step-by-step run."""
    jcfg, cfg, params, model = models
    _, mask, _ = inputs
    rng = np.random.default_rng(1)
    d = cfg.d_model
    H, hd = cfg.rwkv_num_heads, cfg.rwkv_head_dim
    x = rng.standard_normal((B, P, d), dtype=np.float32)
    pos = np.asarray(jax_positions(jnp.asarray(mask)))
    cache = {"shift_t": rng.standard_normal((B, d), dtype=np.float32),
             "shift_c": rng.standard_normal((B, d), dtype=np.float32),
             "wkv": 0.1 * rng.standard_normal((B, H, hd, hd),
                                              dtype=np.float32)}
    jp = jax.tree.map(lambda a: jnp.asarray(a)[0], params["trunk"][0])
    tm, cm = model.layers[0].time_mix, model.layers[0].channel_mix

    for with_cache in (False, True):
        jc = jax.tree.map(jnp.asarray, cache) if with_cache else None
        tc = {n: _t(a).clone() for n, a in cache.items()} if with_cache \
            else None
        jt, jtc = JR.apply_rwkv_time_mix(jp["time_mix"], jcfg, jnp.asarray(x),
                                         jnp.asarray(pos), cache=jc)
        jch, jcc = JR.apply_rwkv_channel_mix(jp["channel_mix"], jcfg,
                                             jnp.asarray(x), jnp.asarray(pos),
                                             cache=jc)
        got_t = R.apply_rwkv_time_mix(tm, cfg, _t(x), _t(pos), cache=tc)
        got_c = R.apply_rwkv_channel_mix(cm, cfg, _t(x), _t(pos), cache=tc)
        _close(got_t, jt, f"time mix (cache={with_cache})")
        _close(got_c, jch, f"channel mix (cache={with_cache})")
        if with_cache:
            _close(tc["wkv"], jtc["wkv"], "wkv state")
            _close(tc["shift_t"], jtc["shift_t"], "shift_t")
            _close(tc["shift_c"], jcc["shift_c"], "shift_c")

    step = {n: _t(a).clone() for n, a in cache.items()}
    outs = [(R.apply_rwkv_time_mix(tm, cfg, _t(x[:, t:t + 1]),
                                   _t(pos[:, t:t + 1]), cache=step),
             R.apply_rwkv_channel_mix(cm, cfg, _t(x[:, t:t + 1]),
                                      _t(pos[:, t:t + 1]), cache=step))
            for t in range(P)]
    _close(torch.cat([o[0] for o in outs], 1), got_t, "time mix step by step")
    _close(torch.cat([o[1] for o in outs], 1), got_c,
           "channel mix step by step")
    _close(step["wkv"], tc["wkv"], "state step by step")


def test_forward_prefill_and_decode_steps_match(models, inputs):
    """forward logits; prefill then teacher-forced decode steps with one
    done row (position -1) in the last step: logits and every cache
    buffer."""
    jcfg, cfg, params, model = models
    tokens, mask, nxt = inputs
    jpos = jax_positions(jnp.asarray(mask))
    tpos = positions_from_mask(_t(mask))
    want, _ = JM.forward(params, jcfg, jnp.asarray(tokens), jpos)
    got, _ = M.forward(model, cfg, _t(tokens), tpos)
    _close(got, want, "forward logits")

    S = P + STEPS
    jc = JM.init_cache(jcfg, B, S)
    jl, jc = JM.prefill(params, jcfg, jnp.asarray(tokens), jpos, jc)
    tc = M.init_cache(cfg, B, S, device="cpu")
    tl, tc = M.prefill(model, cfg, _t(tokens), tpos, tc)
    _close(tl, jl, "prefill logits")
    p_len = mask.sum(1).astype(np.int32)
    for s in range(STEPS):
        pos = (p_len + s)[:, None].astype(np.int32)
        if s == STEPS - 1:
            pos[0] = -1                          # a done row
        jl, jc = JM.decode_step(params, jcfg, jnp.asarray(nxt[:, s:s + 1]),
                                jnp.asarray(pos), jc, P + s)
        tl, tc = M.decode_step(model, cfg, _t(nxt[:, s:s + 1]), _t(pos), tc,
                               P + s)
        _close(tl, jl, f"decode step {s} logits")
    assert set(tc[0]) == {"rwkv"}
    for name in ("shift_t", "shift_c", "wkv"):
        _close(tc[0]["rwkv"][name], jc[0]["rwkv"][name], f"cache {name}")


def test_two_epoch_rollout_matches_jax(models, monkeypatch):
    """Epoch 0 vanilla, epoch 1 the two-pass branch (score, left-align,
    re-prefill) at lenience 0.8, through one RolloutCache each."""
    jcfg, cfg, params, model = models
    group = 2
    problems = generate_problems(MathTaskConfig(num_problems=3, seed=0))
    batch = next(PromptDataset(problems, max_prompt_len=16).epochs(
        3, group, 1, shuffle=False))
    N = 16
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
        np.testing.assert_allclose(got.behaviour_logprobs,
                                   want.behaviour_logprobs, atol=ATOL)
        for k in ("one_pass", "prefill_passes", "n_generated", "n_reused"):
            assert got.metrics[k] == want.metrics[k], k
        assert set(got.metrics) == set(want.metrics)
    np.testing.assert_array_equal(got.n, jax_n["n"])
    assert got.metrics["one_pass"] == 0.0
    assert got.metrics["prefill_passes"] == 2.0
    assert got.metrics["n_reused"] > 0
    assert np.any((got.n > 0) & (got.n < N)) and len(set(got.n.tolist())) > 2


@pytest.mark.parametrize("arch", ["rwkv6-3b", "qwen3-1.7b"])
def test_bf16_rounds_like_jax(arch):
    """The reduced model's forward logits in bfloat16 (JAX's float32
    parameters cast, carried over) against JAX's, and both against float32.
    rwkv6-3b's bfloat16 logits lie far further from its float32 ones than
    qwen3-1.7b's in JAX too (1.8 against 0.037 here): the port must follow
    the reference's rounding, not merely stay near float32."""
    rng = np.random.default_rng(7)
    logits = {}
    for dt in ("float32", "bfloat16"):
        jcfg = jax_get_config(arch).reduced(dtype=dt, param_dtype=dt)
        cfg = get_config(arch).reduced(dtype=dt, param_dtype=dt)
        if dt == "float32":
            params32 = JM.init_lm(jax.random.PRNGKey(0), jcfg)
            tokens = rng.integers(3, cfg.vocab_size, (B, P)).astype(np.int32)
            mask = np.ones((B, P), bool)
            mask[1, :4] = False
            params = params32
        else:
            params = jax.tree.map(
                lambda a: a.astype(jnp.bfloat16)
                if a.dtype == jnp.float32 else a, params32)
        jl, _ = JM.forward(params, jcfg, jnp.asarray(tokens),
                           jax_positions(jnp.asarray(mask)))
        model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
        tl, _ = M.forward(model, cfg, _t(tokens), positions_from_mask(
            _t(mask)))
        logits[dt] = (np.asarray(jl.astype(jnp.float32)),
                      tl.float().numpy())
    (j32, t32), (j16, t16) = logits["float32"], logits["bfloat16"]
    _close(t32, j32, "float32 logits")
    jax_gap = float(np.abs(j16 - j32).max())
    port_gap = float(np.abs(t16 - t32).max())
    assert 0.0 < port_gap <= BF16_GAP * jax_gap, (port_gap, jax_gap)
    _close(t16, j16, "bfloat16 logits", atol=BF16_TOL)


def test_init_draws_jax_distributions(models):
    """The port's own ``init_lm`` (what the card runs) against JAX's, leaf
    by leaf: constants equal, random leaves with the same mean and spread
    (within four standard errors of a sample of their size, at least 5%)."""
    _, cfg, _, jax_model = models
    want = dict(jax_model.named_parameters())
    got = dict(M.init_lm(cfg, seed=0, device="cpu").named_parameters())
    assert want.keys() == got.keys()
    for name, w in want.items():
        g, w = got[name].detach().double(), w.detach().double()
        assert g.shape == w.shape, name
        if float(w.std()) == 0.0:
            assert torch.equal(g, w), name
            continue
        se = 4.0 / np.sqrt(w.numel())
        assert abs(float(g.std() / w.std()) - 1.0) <= max(0.05, se), name
        assert abs(float(g.mean() - w.mean())) <= max(0.05, se) * float(
            w.std()), name
