"""MLA and MTP (deepseek-v3-671b) on the CPU against the JAX package.

Held here:

* the plain versions of the two attention kernels at Dk != Dv (the reduced
  config's 48/32 and the published 192/128): ``decode_attention_plain``
  against ``repro.kernels.decode_attention.ref.decode_attention_ref`` and
  ``flash_attention_plain`` against ``repro.models.attention.
  dot_product_attention`` (JAX's Pallas flash kernel assumes one D), each
  returning (B, Hq, T, Dv), within atol 1e-5 (float32, the same sums);
* the kernel wrappers' (Dk, Dv) contract: the dense decode and the flash
  kernels take (64, 64), (128, 128) and (192, 128), the paged decode
  kernel only Dk = Dv, and every other pair raises before a launch;
* one MLA layer (``models/attention.py:apply_mla`` against JAX's) over a
  dense cache and over a paged one (blocks of 4, so writes cross block
  edges): a prefill from left-padded prompts, then decode steps with live
  bounds, outputs and every cache leaf within atol 1e-5;
* ``forward(return_mtp=True)``'s ``mtp_logits`` against JAX's, atol 1e-4;
* the ``SlotEngine`` and the ``PagedSlotEngine`` on the reduced model,
  tokens equal to JAX's engines', log-probs within atol 1e-4;
* one GRPO ``optimize`` against JAX's, as
  ``test_torch_archs.py::test_mixtral_grpo_optimize_matches_jax``, with
  the MTP head's gradients zero in both packages (no trainer path reads
  ``mtp_logits``);
* the train and serve launchers on ``--arch deepseek-v3-671b --smoke``.

``tests/test_torch_archs.py`` holds the rest of the model (forward, score,
prefill/decode/realign, the two-epoch rollout) with the other configs.
The reduced config (``reduced()``, float32) has two layers, the first dense
and the second MoE (4 experts, top 2, one shared), 4 heads, q and kv LoRA
ranks of 64, head dims nope 32, rope 16, v 32 (Dk = 48, Dv = 32).  Inputs
are numpy arrays from a seed; torch runs on one thread.
"""
import copy

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.engine.generate import GenerateConfig as JaxGenerateConfig  # noqa: E402
from repro.engine.generate import positions_from_mask as jax_positions  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import make_slot_engine as jax_make_slot_engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.engine.generate import (GenerateConfig,  # noqa: E402
                                         positions_from_mask)
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import _load, from_jax_params  # noqa: E402
from repro_torch.serving import (PagedSlotEngine, Request,  # noqa: E402
                                 SlotEngine, make_slot_engine)
from test_torch_rollout import JaxKeyBatch, row_keys  # noqa: E402
from test_torch_train import (LOSS_RTOL, TOL, _capture_jax_grads,  # noqa: E402
                              _capture_port_grads, _check_grad_tree,
                              _check_params, _grads_tree, _mixed_rewards,
                              _port_rb, _trainers)

ARCH = "deepseek-v3-671b"
ATOL = 1e-4         # model outputs: float32 through two layers, summed in
                    # another order
LAYER_ATOL = 1e-5   # one layer, or one attention, in float32
B, P, STEPS = 3, 10, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    params = JM.init_lm(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return jcfg, cfg, params, model


def _near(got, want, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("layers", [None, 4, 1])
def test_parameter_count_matches_jax(layers):
    """The port's model on the meta device counts JAX's parameters: at 4
    and 1 layers (the card's ``archs`` and ``train`` cuts) against
    ``jax.eval_shape`` of JAX's ``init_lm``; whole, against the
    671,712,655,360 that ``jax.eval_shape`` gives at 61 layers (74 s of
    tracing on the CPU, so not traced here)."""
    cfg = get_config(ARCH)
    if layers is None:
        want = 671_712_655_360
    else:
        cfg = cfg.replace(num_layers=layers)
        jcfg = jax_get_config(ARCH).replace(num_layers=layers)
        want = sum(x.size for x in jax.tree.leaves(jax.eval_shape(
            lambda k: JM.init_lm(k, jcfg), jax.random.PRNGKey(0))))
    assert M.count_params(M.LM(cfg, device="meta")) == want


def test_reduced_config_is_mla_with_mtp(models):
    jcfg, cfg, params, model = models
    assert cfg.attention_kind == "mla" and cfg.mtp
    assert (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim) \
        == (48, 32)
    assert isinstance(model.layers[0].attn, A.MLA) and model.mtp is not None
    assert M.count_params(model) == sum(
        x.size for x in jax.tree.leaves(params))


# ----------------------------------------------------- the plain versions


@pytest.mark.parametrize("dk,dv", [(48, 32), (192, 128)])
@pytest.mark.parametrize("T", [1, 3])
def test_decode_plain_matches_jax_at_dk_ne_dv(dk, dv, T):
    """Live bounds, a done row (q_pos -1) and G = 2; (B, Hq, T, Dv) out."""
    rng = np.random.default_rng(dk + T)
    Bq, Hq, Hkv, S = 3, 4, 2, 20
    q = rng.normal(size=(Bq, Hq, T, dk)).astype(np.float32)
    k = rng.normal(size=(Bq, Hkv, S, dk)).astype(np.float32)
    v = rng.normal(size=(Bq, Hkv, S, dv)).astype(np.float32)
    starts = np.array([0, 3, 5], np.int32)
    lengths = np.array([S, 15, 12], np.int32)
    j = np.arange(S)[None]
    k_pos = np.where((j >= starts[:, None]) & (j < lengths[:, None]),
                     j - starts[:, None], -1).astype(np.int32)
    q_pos = (lengths - starts - T)[:, None] + np.arange(T)[None]
    q_pos = q_pos.astype(np.int32)
    q_pos[1] = -1                                   # a done row
    want = decode_attention_ref(*map(jnp.asarray, (q, k, v, q_pos, k_pos,
                                                   lengths, starts)))
    got = dec_ops.decode_attention(*map(torch.from_numpy, (
        q, k, v, q_pos, k_pos, lengths, starts)))
    assert tuple(got.shape) == (Bq, Hq, T, dv) == want.shape
    _near(got, want, "decode_attention_plain", LAYER_ATOL)
    assert not got[1].any()


@pytest.mark.parametrize("dk,dv", [(48, 32), (192, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax_at_dk_ne_dv(dk, dv, causal):
    """Left pads (rows that see no key) and G = 2; (B, Hq, T, Dv) out."""
    rng = np.random.default_rng(dk + causal)
    Bq, Hq, Hkv, T = 3, 4, 2, 9
    q = rng.normal(size=(Bq, Hq, T, dk)).astype(np.float32)
    k = rng.normal(size=(Bq, Hkv, T, dk)).astype(np.float32)
    v = rng.normal(size=(Bq, Hkv, T, dv)).astype(np.float32)
    pads = np.array([0, 4, T], np.int32)              # row 2 all padding
    col = np.arange(T)[None]
    pos = np.where(col >= pads[:, None], col - pads[:, None], -1
                   ).astype(np.int32)
    want = JA.dot_product_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                    causal=causal)
    got = flash_ops.flash_attention(*map(torch.from_numpy, (q, k, v, pos,
                                                            pos)),
                                    causal=causal)
    assert tuple(got.shape) == (Bq, Hq, T, dv) == want.shape
    _near(got, want, "flash_attention_plain", LAYER_ATOL)
    assert not got[2].any()


def test_kernel_wrappers_take_only_their_head_dim_pairs():
    """The kernel entries raise before any launch on a (Dk, Dv) pair
    outside their contract (meta tensors: the checks need no card), and
    the contract is the one the CUDA sources are built for."""
    assert dec_ops.HEAD_DIMS == flash_ops.HEAD_DIMS == (
        (64, 64), (128, 128), (192, 128))
    assert dec_ops.PAGED_HEAD_DIMS == ((64, 64), (128, 128))
    meta = dict(device="meta")
    bf = dict(dtype=torch.bfloat16, **meta)
    i32 = dict(dtype=torch.int32, **meta)
    Bq, H, S = 2, 4, 64
    for dk, dv in ((48, 32), (192, 192), (128, 64), (64, 128)):
        q = torch.empty(Bq, H, 1, dk, **bf)
        k = torch.empty(Bq, H, S, dk, **bf)
        v = torch.empty(Bq, H, S, dv, **bf)
        with pytest.raises(ValueError, match="head_dim"):
            dec_ops.decode_attention_cuda(
                q, k, v, torch.empty(Bq, 1, **i32), torch.empty(Bq, S, **i32),
                torch.empty(Bq, **i32), torch.empty(Bq, **i32))
        with pytest.raises(ValueError, match="head_dim"):
            flash_ops.flash_attention_cuda(
                torch.empty(Bq, H, 8, dk, **bf), k, v,
                torch.empty(Bq, 8, **i32), torch.empty(Bq, S, **i32))
    # MLA's pair in float32 (the reduced model's dtype) is refused
    q = torch.empty(Bq, H, 8, 192, dtype=torch.float32, **meta)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_ops.flash_attention_cuda(
            q, torch.empty(Bq, H, S, 192, dtype=torch.float32, **meta),
            torch.empty(Bq, H, S, 128, dtype=torch.float32, **meta),
            torch.empty(Bq, 8, **i32), torch.empty(Bq, S, **i32))
    # the paged kernel takes Dk = Dv only: MLA never reaches it
    pool = torch.empty(6, H, 32, 192, **bf)
    with pytest.raises(ValueError, match="head_dim"):
        dec_ops.paged_decode_attention_cuda(
            torch.empty(Bq, H, 1, 192, **bf), pool, pool,
            torch.empty(Bq, 3, **i32), torch.empty(Bq, 1, **i32),
            torch.empty(Bq, 96, **i32), torch.empty(Bq, **i32),
            torch.empty(Bq, **i32))
    # an input that requires grad is refused on any device
    qg = torch.zeros(Bq, H, 8, 192, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        flash_ops.flash_attention(qg, torch.zeros(Bq, H, S, 192),
                                  torch.zeros(Bq, H, S, 128),
                                  torch.zeros(Bq, 8, dtype=torch.int32),
                                  torch.zeros(Bq, S, dtype=torch.int32))


# --------------------------------------------------------- one MLA layer


def _layer(cfg, jcfg, seed=0):
    jp = JA.make_mla(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    p = A.MLA(cfg, dtype=torch.float32)
    with torch.no_grad():
        _load(p, jax.tree.map(np.asarray, jp), "mla")
    return jp, p


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_mla_layer_prefill_and_decode_match_jax(models, layout):
    """Prefill of left-padded prompts into the latent cache at slot 0, then
    teacher-forced decode steps with live bounds (a done row in the last),
    the last at a slot per row: outputs and every cache leaf (``ckv``,
    ``krope``, ``pos``) equal JAX's within 1e-5.  Paged: blocks of 4, so
    the prefill ends inside a block and the steps cross block edges."""
    jcfg, cfg = models[0], models[1]
    if layout == "paged":
        jcfg = jcfg.replace(cache_layout="paged", kv_block_size=4)
        cfg = cfg.replace(cache_layout="paged", kv_block_size=4)
    jp, p = _layer(cfg, jcfg)
    rng = np.random.default_rng(3)
    S = P + STEPS
    x = rng.normal(size=(B, P + STEPS, cfg.d_model)).astype(np.float32)
    mask = np.ones((B, P), bool)
    mask[1, :4] = False
    mask[2, :P - 1] = False
    pos = np.array(jax_positions(jnp.asarray(mask)))
    jc = JA.init_kv_cache(jcfg, B, S, jnp.float32)
    tc = A.init_kv_cache(cfg, B, S, torch.float32, "cpu")
    assert set(tc) == set(jc)
    jo, jc = JA.apply_mla(jp, jcfg, jnp.asarray(x[:, :P]), jnp.asarray(pos),
                          cache=jc, cache_start=0)
    with torch.no_grad():
        to, tc = A.apply_mla(p, cfg, torch.from_numpy(x[:, :P]),
                             torch.from_numpy(pos), cache=tc, cache_start=0)
    _near(to, jo, "prefill", LAYER_ATOL)
    p_len = mask.sum(1).astype(np.int32)
    for s in range(STEPS):
        qp = (p_len + s)[:, None].astype(np.int32)
        if s == STEPS - 1:
            qp[0] = -1
        start = P + s
        t_start = (torch.full((B,), start, dtype=torch.int32)
                   if s == STEPS - 1 else start)
        kw = dict(kv_length=np.full(B, P + s + 1, np.int32),
                  kv_start=(P - p_len).astype(np.int32))
        xs = x[:, P + s:P + s + 1]
        jo, jc = JA.apply_mla(jp, jcfg, jnp.asarray(xs), jnp.asarray(qp),
                              cache=jc, cache_start=jnp.asarray(start),
                              **{k: jnp.asarray(v) for k, v in kw.items()})
        with torch.no_grad():
            to, tc = A.apply_mla(p, cfg, torch.from_numpy(xs),
                                 torch.from_numpy(qp), cache=tc,
                                 cache_start=t_start,
                                 **{k: torch.from_numpy(v)
                                    for k, v in kw.items()})
        _near(to, jo, f"decode step {s}", LAYER_ATOL)
    for name in tc:
        _near(tc[name], jc[name], f"cache {name}", LAYER_ATOL)


def test_paged_latent_realign_equals_dense(models, monkeypatch):
    """``realign_decode_cache`` over a paged latent cache (blocks of 4,
    a logical width of 14: the gathered view is sliced off its last
    block) equals the dense one bit for bit, and every buffer handed to
    ``cache_roll`` is contiguous, as the kernel requires on the card."""
    import repro_torch.models.model as model_mod
    jcfg, cfg, params, model = models
    pcfg = cfg.replace(cache_layout="paged", kv_block_size=4)
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size, (B, P)
                                           ).astype(np.int32))
    mask = torch.ones(B, P, dtype=torch.bool)
    mask[1, :4] = False
    pos = positions_from_mask(mask)
    S = P + STEPS
    rolled = []
    roll = model_mod.cache_roll

    def spy(buf, shift):
        rolled.append(buf.is_contiguous())
        return roll(buf, shift)

    monkeypatch.setattr(model_mod, "cache_roll", spy)
    shift = torch.tensor([0, 3, 2], dtype=torch.int32)
    valid = mask.sum(1).to(torch.int32) - shift + 1
    out = {}
    for c in (cfg, pcfg):
        caches = M.init_cache(c, B, S, device="cpu")
        _, caches = M.prefill(model, c, tokens, pos, caches)
        caches = M.realign_decode_cache(c, caches, shift, valid, P)
        out[c.cache_layout] = [M._paged_run_gather(run["self"])
                               if "table" in run["self"] else
                               {k: run["self"][k] for k in ("ckv", "krope")}
                               for run in caches]
    assert rolled and all(rolled)
    for d, pg in zip(out["dense"], out["paged"]):
        for name in ("ckv", "krope"):
            assert torch.equal(d[name], pg[name]), name


def test_mla_layer_gradients_match_jax(models):
    """The differentiable route (grad on: ``dot_product_attention`` at Dk
    != Dv) against ``jax.grad`` of JAX's layer, every parameter and x."""
    jcfg, cfg = models[0], models[1]
    jp, p = _layer(cfg, jcfg, seed=1)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(P, dtype=np.int32), (B, 1))

    def jloss(jp, x):
        return jnp.sum(JA.apply_mla(jp, jcfg, x, jnp.asarray(pos))[0] * w)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    for t in p.parameters():
        t.requires_grad_(True)
    out, _ = A.apply_mla(p, cfg, tx, torch.from_numpy(pos))
    (out * torch.from_numpy(w)).sum().backward()
    _near(tx.grad, jgx, "dx", LAYER_ATOL)
    for name, t in p.named_parameters():
        leaf = jg
        for part in name.split("."):
            leaf = leaf[part]
        scale = max(float(np.abs(np.asarray(leaf)).max()), 1.0)
        _near(t.grad, leaf, f"d{name}", LAYER_ATOL * scale)


# ----------------------------------------------------------------- MTP


def test_mtp_logits_match_jax(models):
    """``forward(return_mtp=True)`` on left-padded rows: the main logits
    and ``mtp_logits`` (B, T, V) against JAX's, atol 1e-4; a forward
    without ``return_mtp`` carries no MTP logits."""
    jcfg, cfg, params, model = models
    rng = np.random.default_rng(5)
    tokens = rng.integers(3, cfg.vocab_size, (B, P)).astype(np.int32)
    mask = np.ones((B, P), bool)
    mask[1, :4] = False
    jl, jaux = jax.jit(lambda p, t, m: JM.forward(
        p, jcfg, t, jax_positions(m), return_mtp=True))(
            params, jnp.asarray(tokens), jnp.asarray(mask))
    pos = positions_from_mask(torch.from_numpy(mask))
    tl, taux = M.forward(model, cfg, torch.from_numpy(tokens), pos,
                         return_mtp=True)
    assert tuple(taux["mtp_logits"].shape) == (B, P, cfg.vocab_size)
    _near(tl, jl, "logits")
    _near(taux["mtp_logits"], jaux["mtp_logits"], "mtp_logits")
    _, plain = M.forward(model, cfg, torch.from_numpy(tokens), pos)
    assert "mtp_logits" not in plain


# ------------------------------------------------------ the slot engines


def _requests(vocab, n=6, width=8, max_new=7):
    """``n`` requests, two GRPO groups of siblings and two loners, as (JAX
    requests, port requests) with the same keys."""
    rng = np.random.RandomState(2)
    keys = row_keys(500, n)
    jreqs, treqs = [], []
    prompts = [rng.randint(3, vocab, size=rng.randint(3, width + 1)
                           ).astype(np.int32) for _ in range(4)]
    for i in range(n):
        prompt, gid = (prompts[i // 2], i // 2) if i < 4 else (
            prompts[i - 2], None)
        jreqs.append(JaxRequest(request_id=i, prompt=prompt.copy(),
                                key=np.asarray(keys)[i],
                                max_new_tokens=max_new - i % 3, group_id=gid))
        treqs.append(Request(request_id=i, prompt=prompt.copy(),
                             key=JaxKeyBatch(keys)[i],
                             max_new_tokens=max_new - i % 3, group_id=gid))
    return jreqs, treqs


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_slot_engines_serve_mla_like_jax(models, layout, monkeypatch):
    """More requests than slots through JAX's slot engine and the port's:
    the ``SlotEngine`` over the dense latent cache, the ``PagedSlotEngine``
    over 4-slot latent pools (GRPO siblings share prompt blocks).  Tokens,
    lengths and finish reasons equal, log-probs within 1e-4, and the
    engines' counters equal."""
    monkeypatch.setattr(SlotEngine, "key_type", JaxKeyBatch)
    jcfg, cfg, params, model = models
    if layout == "paged":
        jcfg = jcfg.replace(cache_layout="paged", kv_block_size=4)
        cfg = cfg.replace(cache_layout="paged", kv_block_size=4)
    jreqs, treqs = _requests(cfg.vocab_size)
    kw = dict(num_slots=3, prompt_width=8)
    jeng = jax_make_slot_engine(params, jcfg, JaxGenerateConfig(
        max_new_tokens=7, temperature=0.7), **kw)
    eng = make_slot_engine(model, cfg, GenerateConfig(
        max_new_tokens=7, temperature=0.7), **kw)
    assert type(eng) is (PagedSlotEngine if layout == "paged"
                         else SlotEngine)
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(copy.deepcopy(jr))
        eng.submit(copy.copy(tr))
    want, got = jeng.run(), eng.run()
    assert sorted(got) == sorted(want)
    for i in want:
        g, w = got[i], want[i]
        assert (g.finish_reason, g.length) == (w.finish_reason, w.length), i
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=ATOL)
    st, jst = eng.stats(), jeng.stats()
    keys = ["completed", "admitted", "engine_steps", "generated_tokens"]
    if layout == "paged":
        keys += ["paged_num_blocks", "paged_peak_blocks_in_use",
                 "paged_cow_forks", "paged_shared_prompt_bytes_saved",
                 "paged_peak_bytes_in_use"]
    for k in keys:
        assert st[k] == jst[k], k


# ------------------------------------------------------------ training


def test_deepseek_v3_grpo_optimize_matches_jax(monkeypatch):
    """One ``optimize`` of the reduced deepseek-v3 (MLA on both layers, MoE
    with a shared expert on the second, the MTP head) on one collected
    rollout with seeded mixed rewards: the loss with the router losses,
    grad norm, every trunk, embedding and head gradient and every updated
    parameter, as ``test_one_grpo_optimize_matches_jax``.  The MTP head
    feeds no loss, so its gradients are zero in both packages (and AdamW
    moves its parameters by weight decay alone)."""
    lr = 1e-3
    jtr, tr = _trainers(ARCH, lr)
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
    gtree = _grads_tree(tr.model, grads)
    jtree = dict(jgrads[0])
    for tree in (gtree, jtree):
        mtp = tree.pop("mtp")
        assert all(not np.asarray(g).any() for g in jax.tree.leaves(mtp))
    _check_grad_tree(gtree, jtree)
    _check_params(tr, jtr, grads, before, lr, want["grad_norm"])


def test_launchers_take_deepseek_v3(capsys):
    """``python -m repro_torch.launch.train --arch deepseek-v3-671b
    --smoke`` trains the reduced config on the CPU; ``launch.serve`` serves
    it through the slot engine, over the dense and the paged latent
    cache."""
    from repro_torch.launch import serve, train

    assert train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2", "--max-new-tokens", "6"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke" in out and "step   1" in out
    for extra in ([], ["--cache-layout", "paged", "--kv-block-size", "8"]):
        assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--spec-prefix", "--requests", "4"] + extra) == 0
        out = capsys.readouterr().out
        assert f"arch={ARCH}-smoke engine=slots" in out, out
        assert "served 4/4" in out, out
