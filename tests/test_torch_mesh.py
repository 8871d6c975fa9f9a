"""The port's §8 mesh on a (2, 2) ``gloo`` mesh of four spawned CPU ranks,
held against JAX's single-device run in the pytest process: every
serving-side scenario of ``tests/distributed/test_mesh_rollout.py`` and
``tests/distributed/test_paged_mesh.py`` (JAX's own mesh tests tie that
run to JAX's mesh), the mesh server's kill-and-resume, and the launcher
under ``torchrun``.

One module-scoped spawn (``distributed/mesh.py:run_ranks``, torch on one
thread a rank) runs every scenario while this process computes JAX's
references; each scenario is then its own test case.  The weights are
JAX's ``init_lm`` draws carried across with ``from_jax_params``; keys draw
with ``jax.random`` (``JaxKey``, ``JaxKeyBatch``), so the mesh's tokens
are JAX's.  The tolerance is JAX's: tokens, lengths, ``n_reused`` and
``n_generated`` equal, log-probs within atol 1e-4 (the model axis sums
partial products in another order).  Every rank returns what it saw, and
the ranks of a model group must agree bit for bit: they make the same
host decisions.

The trainer on the mesh (JAX's ``test_trainer_step_identity``: GRPO,
PPO and DAPO, the async loop, the watchdog, the step functions and the
sinks) is held in ``test_torch_mesh_train.py``.
"""
import copy
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import RolloutCache as JaxRolloutCache  # noqa: E402
from repro.core import SpecConfig as JaxSpecConfig  # noqa: E402
from repro.core import rollout as jax_rollout  # noqa: E402
from repro.data.tokenizer import VOCAB_SIZE  # noqa: E402
from repro.drafting import DraftConfig as JaxDraftConfig  # noqa: E402
from repro.engine.generate import GenerateConfig as JaxGenerateConfig  # noqa: E402
from repro.engine.generate import generate as jax_generate  # noqa: E402
from repro.kernels.decode_attention.ops import \
    decode_attention as jax_decode_attention  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import make_slot_engine as jax_make_slot_engine  # noqa: E402
from repro_torch.core import RolloutCache, SpecConfig, rollout  # noqa: E402
from repro_torch.distributed.mesh import (DataRows, MeshConfig,  # noqa: E402
                                          data_submeshes, host_fetch,
                                          replicate, run_ranks,
                                          shard_batch, shard_caches,
                                          shard_params)
from repro_torch.distributed.shard_wrap import \
    sharded_decode_attention  # noqa: E402
from repro_torch.drafting import DraftConfig  # noqa: E402
from repro_torch.engine.generate import (GenerateConfig, generate,  # noqa: E402
                                         positions_from_mask)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import (MeshSlotServer, Request, SlotEngine,  # noqa: E402
                                 make_slot_engine)
from test_torch_rollout import JaxKey, JaxKeyBatch  # noqa: E402

ATOL = 1e-4
WORLD = 4
P_PAGED = 9                      # P % kv_block_size != 0: CoW forks
ROOT = Path(__file__).resolve().parents[1]


def _cfg_kw(**kw):
    base = dict(name="mesh-tiny", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=128, vocab_size=VOCAB_SIZE,
                max_seq_len=256)
    base.update(kw)
    return base


CFGS = {"a": _cfg_kw(), "b": _cfg_kw(num_kv_heads=3, num_heads=6,
                                      head_dim=16)}
PAGED = dict(cache_layout="paged", kv_block_size=4)


def _inputs(B, P, seed=1):
    prompts = jax.random.randint(jax.random.PRNGKey(seed), (B, P), 3,
                                 VOCAB_SIZE - 1)
    keys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(seed + 1), i))(jnp.arange(B))
    return (np.asarray(prompts, np.int32), np.ones((B, P), bool),
            np.asarray(keys))


def _step_keys(keys, steps):
    return [np.asarray(jax.vmap(lambda kk: jax.random.fold_in(kk, s))(
        jnp.asarray(keys))) for s in range(steps)]


def _grpo_requests():
    """test_paged_mesh's GRPO traffic: 4 groups of 2 siblings."""
    rng = np.random.RandomState(3)
    reqs, rid = [], 0
    for g in range(4):                    # groups 0, 2 -> shard 0; 1, 3 -> 1
        prompt = rng.randint(3, VOCAB_SIZE - 1,
                             size=rng.randint(4, P_PAGED + 1)).astype(np.int32)
        for _ in range(2):
            key = np.asarray(jax.random.PRNGKey(100 + rid), np.uint32)
            reqs.append(dict(request_id=rid, prompt=prompt.copy(), key=key,
                             max_new_tokens=8, group_id=g))
            rid += 1
    return reqs


def _kill_requests():
    """Ten ungrouped requests of mixed prompts and budgets (round-robin)."""
    rng = np.random.RandomState(5)
    return [dict(request_id=i,
                 prompt=rng.randint(3, VOCAB_SIZE - 1,
                                    size=rng.randint(3, 9)).astype(np.int32),
                 key=np.asarray(jax.random.PRNGKey(300 + i), np.uint32),
                 max_new_tokens=int(rng.choice([3, 6, 10])))
            for i in range(10)]


def _attention_inputs():
    B, S, D = 8, 32, 16
    rng = np.random.default_rng(0)
    out = []
    for Hq, Hkv in ((4, 2), (6, 3)):
        q, k, v = (rng.standard_normal(shape, np.float32) for shape in (
            (B, Hq, 1, D), (B, Hkv, S, D), (B, Hkv, S, D)))
        k_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        out.append(dict(q=q, k=k, v=v,
                        q_pos=np.full((B,), 9, np.int32),
                        k_pos=np.where(k_pos <= 9, k_pos, -1).astype(np.int32),
                        lengths=np.full((B,), 10, np.int32),
                        starts=np.zeros((B,), np.int32)))
    return out


def _data():
    """Everything both sides share, as numpy."""
    params = {
        "a": JM.init_lm(jax.random.PRNGKey(0), JaxModelConfig(**CFGS["a"])),
        "b": JM.init_lm(jax.random.PRNGKey(0), JaxModelConfig(**CFGS["b"])),
        "a42": JM.init_lm(jax.random.PRNGKey(42),
                          JaxModelConfig(**CFGS["a"]))}
    paged_prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (8, P_PAGED), 3, VOCAB_SIZE - 1), np.int32)
    paged_roll = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (8, 10), 3, VOCAB_SIZE - 1), np.int32)
    paged_keys = np.asarray(jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(2), i))(jnp.arange(8)))
    roll = _inputs(8, 10)
    return {
        "params": {k: jax.tree.map(np.asarray, p) for k, p in params.items()},
        "gen_a": _inputs(8, 9), "gen_b": _inputs(8, 9),
        "scalar": _inputs(4, 7)[:2] + (np.asarray(jax.random.PRNGKey(3)),),
        "roll": roll, "roll_keys": _step_keys(roll[2], 3),
        "paged_gen": (paged_prompts, np.ones((8, P_PAGED), bool),
                      paged_keys),
        "paged_roll": (paged_roll, np.ones((8, 10), bool)),
        "paged_roll_keys": _step_keys(paged_keys, 3),
        "grpo": _grpo_requests(), "kill": _kill_requests(),
        "attention": _attention_inputs()}


# ------------------------------------------------------------ the ranks


def _rb(rb):
    return {"response": rb.response, "response_mask": rb.response_mask,
            "length": rb.length, "lp": rb.behaviour_logprobs,
            "metrics": dict(rb.metrics)}


def _gen_out(out):
    return {k: out[k].numpy() for k in ("tokens", "logprobs", "length")}


def _responses(resps):
    return {i: (np.asarray(r.tokens), np.asarray(r.logprobs), int(r.length),
                r.finish_reason) for i, r in resps.items()}


def _placement(rank, mesh, cfg, full, sharded, prompts):
    """The placement helpers: ``replicate``, ``shard_batch``,
    ``host_fetch`` and ``shard_caches`` (a whole cache cut to this rank's
    rows and KV heads against the one the rank's own prefill builds)."""
    t = torch.full((3,), float(rank))
    replicate(mesh, {"t": t})
    rows = shard_batch(mesh, (torch.arange(16).view(8, 2), np.arange(7)))
    fetched = host_fetch([torch.ones(2, dtype=torch.bfloat16)])[0]
    pos = positions_from_mask(torch.ones(prompts.shape, dtype=torch.bool))
    caches = M.init_cache(cfg, 8, 12, device="cpu")
    M.prefill(full, cfg, torch.as_tensor(prompts), pos, caches)
    cut = shard_caches(cfg, caches, mesh)
    local = DataRows(mesh, 8)
    mine = M.init_cache(M.cache_config(sharded, cfg), 4, 12, device="cpu")
    M.prefill(sharded, cfg, torch.as_tensor(local.take(prompts)),
              local.take(pos), mine)
    return {"replicated": t.tolist(), "rows": rows[0].numpy(),
            "odd": rows[1], "fetched": (fetched.dtype.name, fetched.tolist()),
            "cut": [{k: v.numpy() for k, v in run["self"].items()}
                    for run in cut],
            "mine": [{k: v.numpy() for k, v in run["self"].items()}
                     for run in mine]}


def _rank_scenarios(rank, path):
    """Every scenario on this rank; returns what the rank saw."""
    SlotEngine.key_type = JaxKeyBatch      # snapshots hold JAX key words
    with open(path, "rb") as f:
        data = pickle.load(f)
    mesh = MeshConfig(data=2, model=2, require=True).build("cpu")
    cfgs = {k: ModelConfig(**kw) for k, kw in CFGS.items()}
    full = {k: from_jax_params(p, cfgs[k[0]], device="cpu")
            for k, p in data["params"].items()}
    sharded = {k: shard_params(mesh, cfgs[k[0]], m) for k, m in full.items()}
    a, paged = cfgs["a"], cfgs["a"].replace(**PAGED)
    out = {}

    out["submeshes"] = [(s.ranks, s.axis_names, s.mesh is not None)
                        for s in data_submeshes(mesh)]
    out["placement"] = _placement(rank, mesh, a, full["a"], sharded["a"],
                                  data["gen_a"][0])
    debug = make_debug_mesh(model=2, data=2, device="cpu")
    out["debug_mesh"] = (tuple(debug.shape), tuple(debug.mesh_dim_names),
                         debug.mesh.tolist())
    out["attention"] = [sharded_decode_attention(
        mesh, *(torch.from_numpy(x[k]) for k in (
            "q", "k", "v", "q_pos", "k_pos", "lengths", "starts"))).numpy()
        for x in data["attention"]]

    for name, cfg_key, N in (("gen_a", "a", 10), ("gen_b", "b", 10)):
        prompts, mask, keys = data[name]
        out[name] = _gen_out(generate(
            sharded[cfg_key], cfgs[cfg_key], GenerateConfig(
                max_new_tokens=N, eos_id=VOCAB_SIZE - 1),
            prompts, mask, JaxKeyBatch(keys), mesh=mesh))
    prompts, mask, key = data["scalar"]
    out["scalar"] = _gen_out(generate(
        sharded["a"], a, GenerateConfig(max_new_tokens=8,
                                        eos_id=VOCAB_SIZE - 1),
        prompts, mask, JaxKey(key), mesh=mesh))

    gen = GenerateConfig(max_new_tokens=12, eos_id=VOCAB_SIZE - 1)
    prompts, mask, _ = data["roll"]
    ids = list(range(8))
    for name, spec in (("spec", SpecConfig(variant="spec")),
                       ("slots", SpecConfig(variant="spec",
                                            backfill="slots"))):
        cache = RolloutCache()
        out[name] = [_rb(rollout(sharded["a"], a, gen, spec, prompts, mask,
                                 ids, cache, JaxKeyBatch(k), step,
                                 mesh=mesh))
                     for step, k in enumerate(data["roll_keys"])]

    draft = DraftConfig(kind="ngram", draft_k=4)
    for name, backfill in (("drafted", "none"), ("drafted_slots", "slots")):
        cache = RolloutCache(group_size=2)
        spec = SpecConfig(variant="spec", backfill=backfill, draft=draft)
        out[name] = [_rb(rollout(p, a, gen, spec, prompts, mask, ids, cache,
                                 JaxKeyBatch(data["roll_keys"][step]), step,
                                 mesh=mesh))
                     for step, p in enumerate((sharded["a"],
                                               sharded["a42"]))]
    greedy = GenerateConfig(max_new_tokens=12, temperature=0.0,
                            eos_id=VOCAB_SIZE - 1)
    keys = JaxKeyBatch(data["roll"][2])
    out["greedy"] = [_rb(rollout(
        sharded["a"], a, greedy, SpecConfig(variant="off", draft=d),
        prompts, mask, ids, None, keys, 0, mesh=mesh))
        for d in (DraftConfig(), draft)]

    prompts, mask, keys = data["paged_gen"]
    out["paged_gen"] = _gen_out(generate(
        sharded["a"], paged, GenerateConfig(max_new_tokens=10,
                                            eos_id=VOCAB_SIZE - 1),
        prompts, mask, JaxKeyBatch(keys), mesh=mesh))
    prompts, mask = data["paged_roll"]
    cache = RolloutCache()
    out["paged_roll"] = [_rb(rollout(
        sharded["a"], paged, gen, SpecConfig(variant="spec"), prompts, mask,
        ids, cache, JaxKeyBatch(k), step, mesh=mesh))
        for step, k in enumerate(data["paged_roll_keys"])]

    srv = make_slot_engine(full["a"], paged, GenerateConfig(
        max_new_tokens=8, temperature=0.7, eos_id=VOCAB_SIZE - 1),
        mesh=mesh, num_slots=4, prompt_width=P_PAGED)
    assert isinstance(srv, MeshSlotServer)
    for r in data["grpo"]:
        srv.submit(Request(**copy.deepcopy(r)))
    resps = _responses(srv.run())
    alloc = srv.engine.allocator
    alloc.check()
    out["grpo"] = {"responses": resps, "stats": srv.stats(),
                   "shard": srv.shard,
                   "mine": sorted(srv.engine.responses),
                   "alloc": (alloc.shared_prompt_bytes_saved,
                             alloc.blocks_in_use, alloc.cow_forks)}

    kill_gen = GenerateConfig(max_new_tokens=10, eos_id=VOCAB_SIZE - 1)

    def server():
        s = make_slot_engine(sharded["a"], a, kill_gen, mesh=mesh,
                             num_slots=4, prompt_width=8)
        for r in data["kill"]:
            s.submit(Request(**copy.deepcopy(r)))
        return s

    whole = _responses(server().run())
    first = server()
    first.run(max_chunks=1)
    state = first.state_dict()
    second = make_slot_engine(sharded["a"], a, kill_gen, mesh=mesh,
                              num_slots=4, prompt_width=8)
    second.load_state_dict(state)
    out["kill"] = {"whole": whole, "resumed": _responses(second.run()),
                   "done_at_kill": len(first.responses),
                   "engines": sorted(state["engines"]),
                   "rr": int(state["rr"])}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results (a future: the ranks run while the tests
    compute JAX's references) and the shared data."""
    data = _data()
    path = tmp_path_factory.mktemp("mesh") / "data.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(run_ranks, _rank_scenarios, WORLD, (str(path),),
                          device="cpu", timeout=240)
        yield fut, data
        fut.result()


def _got(ranks, name, rank=0):
    fut, _ = ranks
    return fut.result()[rank][name]


def _jparams(ranks, key):
    return ranks[1]["params"][key]


def _jcfg(key, **kw):
    return JaxModelConfig(**CFGS[key]).replace(**kw)


def _assert_rb(got, want):
    np.testing.assert_array_equal(got["response"], np.asarray(want.response))
    np.testing.assert_array_equal(got["response_mask"],
                                  np.asarray(want.response_mask))
    np.testing.assert_array_equal(got["length"], np.asarray(want.length))
    np.testing.assert_allclose(got["lp"], np.asarray(want.behaviour_logprobs),
                               atol=ATOL)
    for k in ("n_generated", "n_reused", "one_pass"):
        assert got["metrics"][k] == want.metrics[k], k


def _assert_gen(got, want):
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["length"], np.asarray(want["length"]))
    np.testing.assert_allclose(got["logprobs"], np.asarray(want["logprobs"]),
                               atol=ATOL)


def _jax_steps(ranks, cfg, spec, prompts, mask, keys, params=None):
    cache = JaxRolloutCache(group_size=2) if spec.draft.enabled else \
        JaxRolloutCache()
    gen = JaxGenerateConfig(max_new_tokens=12, eos_id=VOCAB_SIZE - 1)
    out = []
    for step, k in enumerate(keys):
        p = params[step] if params else _jparams(ranks, "a")
        out.append(jax_rollout(p, cfg, gen, spec, jnp.asarray(prompts),
                               jnp.asarray(mask), list(range(8)), cache,
                               jnp.asarray(k), step))
    return out


# ------------------------------------------------------------ the scenarios


@pytest.mark.parametrize("name,cfg_key", [("gen_a", "a"), ("gen_b", "b")],
                         ids=["kv2", "kv3_of_6_heads"])
def test_generate_matches_jax(ranks, name, cfg_key):
    """generate on the mesh == JAX's single device, kv 2 (heads sharded)
    and 3 KV heads of 6 (KV replicated, queries gathered whole)."""
    prompts, mask, keys = ranks[1][name]
    want = jax_generate(_jparams(ranks, cfg_key), _jcfg(cfg_key),
                        JaxGenerateConfig(max_new_tokens=10,
                                          eos_id=VOCAB_SIZE - 1),
                        jnp.asarray(prompts), jnp.asarray(mask),
                        jnp.asarray(keys))
    _assert_gen(_got(ranks, name), want)


def test_generate_scalar_key_matches_jax(ranks):
    """A scalar key draws the whole batch's noise on each data rank."""
    prompts, mask, key = ranks[1]["scalar"]
    want = jax_generate(_jparams(ranks, "a"), _jcfg("a"),
                        JaxGenerateConfig(max_new_tokens=8,
                                          eos_id=VOCAB_SIZE - 1),
                        jnp.asarray(prompts), jnp.asarray(mask),
                        jnp.asarray(key))
    _assert_gen(_got(ranks, "scalar"), want)


def test_spec_rollout_matches_jax(ranks):
    """Three epochs: vanilla, then one-pass verify → realign → resume."""
    prompts, mask, _ = ranks[1]["roll"]
    want = _jax_steps(ranks, _jcfg("a"), JaxSpecConfig(variant="spec"),
                      prompts, mask, ranks[1]["roll_keys"])
    got = _got(ranks, "spec")
    for step, (g, w) in enumerate(zip(got, want)):
        _assert_rb(g, w)
        if step:
            assert g["metrics"]["one_pass"] == 1.0
            assert g["metrics"]["n_reused"] > 0


def test_slot_backfill_matches_jax(ranks):
    """rollout(backfill='slots') on the mesh (a MeshSlotServer: one
    scheduler per data shard) == JAX's fixed-batch rollout."""
    prompts, mask, _ = ranks[1]["roll"]
    want = _jax_steps(ranks, _jcfg("a"), JaxSpecConfig(variant="spec"),
                      prompts, mask, ranks[1]["roll_keys"])
    got = _got(ranks, "slots")
    for g, w in zip(got, want):
        _assert_rb(g, w)
    assert got[-1]["metrics"]["backfill_slots"] >= 2


def test_data_submeshes(ranks):
    fut, _ = ranks
    for rank, res in enumerate(fut.result()):
        assert res["debug_mesh"] == ((2, 2), ("data", "model"),
                                     [[0, 1], [2, 3]])
        subs = res["submeshes"]
        assert len(subs) == 2
        assert sorted(r for s in subs for r in s[0]) == list(range(WORLD))
        assert all(s[1] == ("model",) for s in subs)
        assert [s[2] for s in subs] == [rank in s[0] for s in subs]


def test_placement_helpers(ranks):
    """``replicate`` makes every rank's tensor rank 0's; ``shard_batch``
    keeps a data rank's rows (a batch the axis does not divide stays
    whole); ``host_fetch`` widens bf16 exactly; ``shard_caches`` cuts a
    whole cache to the rows and KV heads the rank's own prefill builds
    (within float32 rounding: the model axis sums in another order)."""
    fut, _ = ranks
    for rank, res in enumerate(fut.result()):
        got = res["placement"]
        d = rank // 2
        assert got["replicated"] == [0.0, 0.0, 0.0]
        np.testing.assert_array_equal(
            got["rows"], np.arange(16).reshape(8, 2)[4 * d:4 * d + 4])
        np.testing.assert_array_equal(got["odd"], np.arange(7))
        assert got["fetched"] == ("float32", [1.0, 1.0])
        for cut, mine in zip(got["cut"], got["mine"]):
            assert cut["k"].shape == mine["k"].shape == (2, 4, 1, 12, 16)
            np.testing.assert_array_equal(cut["pos"], mine["pos"])
            for name in ("k", "v"):
                np.testing.assert_allclose(cut[name], mine[name], atol=1e-5)


def test_sharded_decode_attention_matches_op(ranks):
    """Heads over the model axis when both counts divide it, rows over
    the data axis either way: JAX's op, whole."""
    for x, got in zip(ranks[1]["attention"], _got(ranks, "attention")):
        want = jax_decode_attention(*(jnp.asarray(x[k]) for k in (
            "q", "k", "v", "q_pos", "k_pos", "lengths", "starts")))
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_drafted_rollout_matches_jax(ranks):
    """§9 drafted rollout on the mesh, cold start then a one-pass resume
    under another policy, fixed batch and slot backfill: JAX's drafted
    single-device rollout, forward counts too."""
    prompts, mask, _ = ranks[1]["roll"]
    spec = JaxSpecConfig(variant="spec",
                         draft=JaxDraftConfig(kind="ngram", draft_k=4))
    want = _jax_steps(ranks, _jcfg("a"), spec, prompts, mask,
                      ranks[1]["roll_keys"][:2],
                      params=[_jparams(ranks, "a"), _jparams(ranks, "a42")])
    for name in ("drafted", "drafted_slots"):
        got = _got(ranks, name)
        for g, w in zip(got, want):
            _assert_rb(g, w)
            assert g["metrics"]["decode_forwards"] == \
                w.metrics["decode_forwards"] > 0
        assert got[-1]["metrics"]["one_pass"] == 1.0
        m = got[-1]["metrics"]
        assert 0 < m["n_reused"] and m["n_generated"] > 0
    assert _got(ranks, "drafted_slots")[-1]["metrics"][
        "tokens_per_forward"] > 1.0


def test_drafted_greedy_matches_on_mesh(ranks):
    """Greedy drafting on == off on the mesh, and == JAX's greedy."""
    prompts, mask, keys = ranks[1]["roll"]
    want = jax_rollout(_jparams(ranks, "a"), _jcfg("a"), JaxGenerateConfig(
        max_new_tokens=12, temperature=0.0, eos_id=VOCAB_SIZE - 1),
        JaxSpecConfig(variant="off"), jnp.asarray(prompts),
        jnp.asarray(mask), list(range(8)), None, jnp.asarray(keys), 0)
    off, on = _got(ranks, "greedy")
    _assert_rb(off, want)
    for k in ("response", "response_mask", "length", "lp"):
        np.testing.assert_array_equal(on[k], off[k])


def test_paged_generate_matches_jax(ranks):
    """Paged generate on the mesh (pools of the rank's KV heads) == JAX's
    dense single-device generate."""
    prompts, mask, keys = ranks[1]["paged_gen"]
    want = jax_generate(_jparams(ranks, "a"), _jcfg("a"), JaxGenerateConfig(
        max_new_tokens=10, eos_id=VOCAB_SIZE - 1), jnp.asarray(prompts),
        jnp.asarray(mask), jnp.asarray(keys))
    _assert_gen(_got(ranks, "paged_gen"), want)


def test_paged_rollout_matches_jax(ranks):
    prompts, mask = ranks[1]["paged_roll"]
    want = _jax_steps(ranks, _jcfg("a"), JaxSpecConfig(variant="spec"),
                      prompts, mask, ranks[1]["paged_roll_keys"])
    for step, (g, w) in enumerate(zip(_got(ranks, "paged_roll"), want)):
        _assert_rb(g, w)
        if step:
            assert g["metrics"]["n_reused"] > 0


def _jax_engine(ranks, reqs, gen, **kw):
    eng = jax_make_slot_engine(_jparams(ranks, "a"), _jcfg("a"), gen, **kw)
    for r in reqs:
        eng.submit(JaxRequest(**copy.deepcopy(r)))
    return eng.run()


def _assert_responses(got, want):
    assert sorted(got) == sorted(want)
    for i, w in want.items():
        tokens, lps, length, reason = got[i]
        assert reason == w.finish_reason, i
        assert length == w.length, i
        np.testing.assert_array_equal(tokens, np.asarray(w.tokens))
        np.testing.assert_allclose(lps, np.asarray(w.logprobs), atol=ATOL)


def test_paged_mesh_server_grpo_routing(ranks):
    """The paged MeshSlotServer: GRPO groups land whole on shard
    ``group_id % 2``, prompt sharing fires on both shards, every response
    is JAX's single dense engine's."""
    want = _jax_engine(ranks, ranks[1]["grpo"], JaxGenerateConfig(
        max_new_tokens=8, temperature=0.7, eos_id=VOCAB_SIZE - 1),
        num_slots=4, prompt_width=P_PAGED)
    fut, _ = ranks
    res = [r["grpo"] for r in fut.result()]
    _assert_responses(res[0]["responses"], want)
    for r in res:
        saved, in_use, forks = r["alloc"]
        assert saved > 0 and in_use == 0
        groups = {req["request_id"]: req["group_id"]
                  for req in ranks[1]["grpo"]}
        assert {groups[i] % 2 for i in r["mine"]} == {r["shard"]}
    st = res[0]["stats"]
    assert st["paged_cow_forks"] == sum(r["alloc"][2] for r in res[::2]) > 0
    assert len(st["per_shard"]) == 2 and st["num_shards"] == 2


def test_mesh_server_kill_and_resume(ranks):
    """Killed after one chunk, snapshot in JAX's layout, a fresh server
    resumed from it: the uninterrupted run's responses, and JAX's single
    engine's."""
    want = _jax_engine(ranks, ranks[1]["kill"], JaxGenerateConfig(
        max_new_tokens=10, eos_id=VOCAB_SIZE - 1), num_slots=4,
        prompt_width=8)
    got = _got(ranks, "kill")
    assert got["engines"] == ["0", "1"] and got["rr"] == 10 % 2
    assert got["done_at_kill"] < len(want)
    _assert_responses(got["whole"], want)
    _assert_responses(got["resumed"], want)


def test_model_ranks_make_the_same_host_decisions(ranks):
    """Every rank returns the same tokens, lengths, counts and responses
    (bit for bit: each rank of a model group computes the same logits)."""
    fut, _ = ranks
    results = fut.result()

    def strip(x):
        # what a rank of another shard sees differently (its own shard's
        # engine), and wall times
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()
                    if k not in ("submeshes", "stats", "shard", "mine",
                                 "alloc", "placement") and not str(k).endswith("_time")}
        if isinstance(x, (list, tuple)):
            return [strip(v) for v in x]
        return x

    def same(a, b, where):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), where
            for k in a:
                same(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=where)

    base = strip(results[0])
    for rank in range(1, WORLD):
        same(strip(results[rank]), base, f"rank{rank}")


# ------------------------------------------------------------ the launcher


def test_launcher_serves_on_a_torchrun_mesh():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.serve",
           "--device", "cpu", "--smoke", "--mesh-data", "2",
           "--mesh-model", "2"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "engine=slots(spec=False, shards=2): served 8/8" in out.stdout
    assert out.stdout.count("served 8/8") == 1          # rank 0 prints
    assert "mesh (data, model) = (2, 2) over gloo on cpu" in out.stdout


def test_require_mesh_without_enough_ranks_raises():
    """As JAX's MeshConfig.build: too few ranks is the single-device path,
    or with ``require`` an error."""
    from repro_torch.launch import serve as launch_serve
    with pytest.raises(RuntimeError, match="needs 4 ranks, found 1"):
        launch_serve.main(["--device", "cpu", "--smoke", "--mesh-data", "2",
                           "--mesh-model", "2", "--require-mesh"])
    assert MeshConfig(data=2, model=2).build("cpu") is None
    assert MeshConfig(data=1, model=1, require=True).build("cpu") is None
