"""The port's ``PagedSlotEngine`` and ``BlockAllocator`` on the CPU against
``repro.serving`` (the twins of tests/serving/test_paged_engine.py and
tests/serving/test_block_allocator.py, and the block counts of
``benchmarks/baselines/BENCH_paged.json``).

Same weights (the reduced qwen3-1.7b, num_kv_heads=2, float32, carried over
with ``from_jax_params``), same requests, same keys (``JaxKeyBatch`` rows
draw with ``jax.random``).  Tokens, lengths, finish reasons, allocator
counters and block tables are compared exactly; log-probs within atol 1e-4
against JAX (float32 summed in another order), and bit for bit between the
port's paged and dense engines (on the CPU the paged decode's plain version
gathers the dense view).  P = 9 with 4-slot blocks: the prompt's boundary
block is both shared and written, so every follower forks it once.
"""
import copy
import json
import math
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.spec_rollout as jax_spec_rollout  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import RolloutCache as JaxRolloutCache  # noqa: E402
from repro.core import SpecConfig as JaxSpecConfig  # noqa: E402
from repro.engine.generate import GenerateConfig as JaxGenerateConfig  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import make_slot_engine as jax_make_slot_engine  # noqa: E402
from repro.serving.block_table import BlockAllocator as JaxBlockAllocator  # noqa: E402
from repro.serving.block_table import PoolExhausted as JaxPoolExhausted  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RolloutCache, SpecConfig, rollout  # noqa: E402
from repro_torch.data.tokenizer import EOS_ID, PAD_ID  # noqa: E402
from repro_torch.engine.generate import GenerateConfig  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import (BlockAllocator, PagedSlotEngine,  # noqa: E402
                                 PoolExhausted, Request, SlotEngine,
                                 identity_table, make_slot_engine)
from repro_torch.serving.request import FINISH_SHED  # noqa: E402
from test_torch_rollout import JaxKeyBatch, row_keys  # noqa: E402

ATOL = 1e-4
P, N, BS = 9, 7, 4                 # P % BS != 0: boundary block CoW
G, S = 3, 2                        # GRPO groups x siblings
ROOT = Path(__file__).resolve().parents[1]


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


@pytest.fixture(autouse=True)
def jax_snapshot_keys(monkeypatch):
    """Snapshot key words come back as JAX-drawing key batches."""
    monkeypatch.setattr(SlotEngine, "key_type", JaxKeyBatch)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("qwen3-1.7b").reduced(num_kv_heads=2)
    cfg = get_config("qwen3-1.7b").reduced(num_kv_heads=2)
    params = JM.init_lm(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return jcfg, cfg, params, model


def _paged(cfg, bs=BS):
    return cfg.replace(cache_layout="paged", kv_block_size=bs)


def _group_requests(vocab, seed=0, groups=G, sib=S, max_new=N, width=P,
                    min_len=4, key_seed=1000):
    """``groups`` GRPO groups of ``sib`` siblings sharing a prompt, as
    (JAX requests, port requests) with the same keys."""
    rng = np.random.RandomState(seed)
    keys = row_keys(key_seed, groups * sib)
    jreqs, treqs, rid = [], [], 0
    for g in range(groups):
        prompt = rng.randint(3, vocab,
                             size=rng.randint(min_len, width + 1)
                             ).astype(np.int32)
        for _ in range(sib):
            jreqs.append(JaxRequest(request_id=rid, prompt=prompt.copy(),
                                    key=np.asarray(keys)[rid],
                                    max_new_tokens=max_new, group_id=g))
            treqs.append(Request(request_id=rid, prompt=prompt.copy(),
                                 key=JaxKeyBatch(keys)[rid],
                                 max_new_tokens=max_new, group_id=g))
            rid += 1
    return jreqs, treqs


def _gens(N=N):
    return (JaxGenerateConfig(max_new_tokens=N, temperature=0.7),
            GenerateConfig(max_new_tokens=N, temperature=0.7))


def _run_jax(params, jcfg, jgen, reqs, num_slots=4, width=P, **kw):
    eng = jax_make_slot_engine(params, jcfg, jgen, num_slots=num_slots,
                               prompt_width=width, **kw)
    for r in reqs:
        eng.submit(copy.deepcopy(r))
    return eng, eng.run()


def _run(model, cfg, gen, reqs, num_slots=4, width=P, **kw):
    eng = make_slot_engine(model, cfg, gen, num_slots=num_slots,
                           prompt_width=width, **kw)
    for r in reqs:
        eng.submit(copy.copy(r))
    return eng, eng.run()


def _assert_same(got, want, atol=ATOL):
    assert sorted(got) == sorted(want)
    for i in want:
        g, w = got[i], want[i]
        assert (g.finish_reason, g.length, g.n_accepted, g.retries) == \
            (w.finish_reason, w.length, w.n_accepted, w.retries), i
        np.testing.assert_array_equal(g.tokens, w.tokens)
        if atol:
            np.testing.assert_allclose(g.logprobs, w.logprobs, atol=atol)
        else:
            np.testing.assert_array_equal(g.logprobs, w.logprobs)


def _alloc_equal(a, b):
    assert a.stats() == b.stats()
    np.testing.assert_array_equal(a.refcount, b.refcount)
    sa, sb = a.state_dict(), b.state_dict()
    for k in ("free", "refcount", "counters"):
        np.testing.assert_array_equal(np.asarray(sa[k]), np.asarray(sb[k]))


# ------------------------------------------------------------- allocator

def test_allocator_matches_jax_on_a_seeded_op_sequence():
    """The same seeded alloc/share/fork/free sequence through both
    allocators: the same results and exhaustion, equal refcounts, stats
    and state_dict after every op, the pool partitioned throughout."""
    rng = np.random.RandomState(11)
    a, b = BlockAllocator(12, 4), JaxBlockAllocator(12, 4)
    live = []

    def apply(alloc, op, i):
        try:
            if op <= 1:
                return alloc.alloc(op + 1)
            if op == 2:
                return alloc.share(live[i])
            if op == 3:
                return alloc.fork(live[i])
            return alloc.free(live[i])
        except (PoolExhausted, JaxPoolExhausted):
            return "exhausted"

    for _ in range(300):
        op = int(rng.randint(6))
        if op >= 2 and not live:
            continue
        i = int(rng.randint(len(live))) if live else 0
        if op == 3 and a.refcount[live[i]] < 2:
            continue                          # fork needs a shared block
        got, want = apply(a, op, i), apply(b, op, i)
        assert got == want, (op, got, want)
        if got != "exhausted":
            if op <= 1:
                live.extend(got)
            elif op == 2:
                live.append(got)
            elif op == 3:
                live[i] = got
            else:
                live.pop(i)
        a.check()
        _alloc_equal(a, b)
    assert a.cow_forks > 0 and a.alloc_failures > 0
    c = BlockAllocator(12, 4)
    c.load_state_dict(b.state_dict())         # JAX's state loads here
    _alloc_equal(c, a)
    np.testing.assert_array_equal(identity_table(3, 4, offset=1),
                                  np.arange(1, 13).reshape(3, 4))


# ------------------------------------------------------------ the engine

def test_paged_engine_matches_jax_and_dense_with_grpo_sharing(models):
    """More requests than slots (admission waves) with CoW sharing and
    boundary-block forks: identical to JAX's paged engine (tokens, counts,
    allocator) and bit-identical to the port's dense engine."""
    jcfg, cfg, params, model = models
    jgen, gen = _gens()
    jreqs, treqs = _group_requests(cfg.vocab_size)
    jeng, want = _run_jax(params, _paged(jcfg), jgen, jreqs)
    eng, got = _run(model, _paged(cfg), gen, treqs)
    deng, dense = _run(model, cfg, gen, treqs)
    assert type(eng) is PagedSlotEngine and type(deng) is SlotEngine
    _assert_same(got, want)
    _assert_same(got, dense, atol=0)
    _alloc_equal(eng.allocator, jeng.allocator)
    st = eng.allocator.stats()
    assert st["cow_forks"] == G * (S - 1)
    assert st["shared_prompt_bytes_saved"] > 0
    assert st["blocks_in_use"] == 0
    eng.allocator.check()
    reg, jreg = eng.stats(), jeng.stats()
    for k in ("paged_num_blocks", "paged_blocks_in_use",
              "paged_peak_blocks_in_use", "paged_cow_forks",
              "paged_alloc_failures", "paged_shared_prompt_bytes_saved",
              "paged_peak_bytes_in_use", "completed", "admitted",
              "engine_steps", "fault_failed"):
        assert reg[k] == jreg[k], k
    assert reg["paged_pool_pressure"] == pytest.approx(
        jreg["paged_pool_pressure"])


def test_one_physical_prompt_copy_per_group(models):
    """After one admission wave every sibling of a group addresses the SAME
    prompt blocks (one prompt copy per group), continuations are private,
    the device tables mirror the host's, and the first chunk forks each
    follower's boundary block exactly once."""
    _, cfg, _, model = models
    _, gen = _gens()
    _, treqs = _group_requests(cfg.vocab_size)
    eng = make_slot_engine(model, _paged(cfg), gen, num_slots=G * S,
                           prompt_width=P)
    for r in treqs:
        eng.submit(copy.copy(r))
    eng._admit()
    nb, pb = eng.nb, eng._pb
    assert pb == -(-P // BS)
    by_gid = {}
    for slot, req in eng.scheduler.active.items():
        row = eng._slot_blocks[slot]
        assert row is not None and len(row) == nb
        by_gid.setdefault(req.group_id, []).append(row)
    assert sorted(by_gid) == list(range(G))
    for rows in by_gid.values():
        assert len(rows) == S
        for row in rows[1:]:
            assert row[:pb] == rows[0][:pb]
        tails = [b for row in rows for b in row[pb:]]
        assert len(set(tails)) == len(tails)
    assert eng.allocator.cow_forks == 0
    assert eng.allocator.blocks_in_use == G * (pb + S * (nb - pb))
    tab = eng.caches[0]["self"]["table"][0].numpy()
    for slot in eng.scheduler.active:
        np.testing.assert_array_equal(tab[slot], eng._slot_blocks[slot])
    eng._run_chunk()
    assert eng.allocator.cow_forks == G * (S - 1)
    for gid in by_gid:
        rows = [eng._slot_blocks[s] for s, r in eng.scheduler.active.items()
                if r.group_id == gid]
        assert len({row[pb - 1] for row in rows}) == S
        assert len({tuple(row[:pb - 1]) for row in rows}) == 1
    eng.run()
    assert eng.allocator.blocks_in_use == 0
    eng.allocator.check()
    # a freed row points at the sink with an empty pos row
    assert (eng.caches[0]["self"]["table"] == 0).all()
    assert (eng.caches[0]["self"]["pos"] == -1).all()


def test_admission_pressure_queues_in_order(models):
    """A pool of the sink + ONE row: requests wait QUEUED and admit in
    order as completions free blocks; nothing is shed, the output equals
    JAX's and an unconstrained pool's."""
    jcfg, cfg, params, model = models
    jgen, gen = _gens()
    jreqs, treqs = _group_requests(cfg.vocab_size, seed=3, groups=3, sib=1)
    _, ref = _run(model, _paged(cfg), gen, treqs, num_slots=2)
    probe = PagedSlotEngine(model, _paged(cfg), gen, num_slots=2,
                            prompt_width=P)
    kw = dict(num_slots=2, kv_pool_blocks=1 + probe.nb)
    jeng, want = _run_jax(params, _paged(jcfg), jgen, jreqs, **kw)
    eng, got = _run(model, _paged(cfg), gen, treqs, **kw)
    _assert_same(got, want)
    _assert_same(got, ref, atol=0)
    assert all(got[i].finish_reason != FINISH_SHED for i in got)
    assert eng.allocator.alloc_failures == 0
    assert eng.allocator.peak_blocks_in_use <= probe.nb
    _alloc_equal(eng.allocator, jeng.allocator)
    assert eng.scheduler.stats()["completed"] == len(treqs)


def test_pool_too_small_sheds_instead_of_livelocking(models):
    """A request that cannot be tabled even on an EMPTY batch is shed with
    FINISH_SHED (slot -1), as in JAX."""
    jcfg, cfg, params, model = models
    jgen, gen = _gens()
    jreqs, treqs = _group_requests(cfg.vocab_size, seed=4, groups=2, sib=1)
    probe = PagedSlotEngine(model, _paged(cfg), gen, num_slots=2,
                            prompt_width=P)
    kw = dict(num_slots=2, kv_pool_blocks=probe.nb)   # sink + nb - 1
    jeng, want = _run_jax(params, _paged(jcfg), jgen, jreqs, **kw)
    eng, got = _run(model, _paged(cfg), gen, treqs, **kw)
    _assert_same(got, want)
    for i in got:
        assert got[i].finish_reason == FINISH_SHED
        assert got[i].slot == -1 and got[i].length == 0
    assert eng.allocator.alloc_failures == 2
    st = eng.stats()
    assert st["paged_alloc_failures"] == 2 and st["fault_failed"] == 2
    assert st["shed_requests"] == jeng.stats()["shed_requests"]
    assert eng.allocator.blocks_in_use == 0
    eng.allocator.check()


def test_group_registry_gc(models):
    """Registrations live exactly as long as a pending sibling can share
    them (as JAX's), and dropping one frees the prompt copy."""
    jcfg, cfg, params, model = models
    jgen, gen = _gens()
    jreqs, treqs = _group_requests(cfg.vocab_size)
    jeng = jax_make_slot_engine(params, _paged(jcfg), jgen, num_slots=3,
                                prompt_width=P)
    eng = make_slot_engine(model, _paged(cfg), gen, num_slots=3,
                           prompt_width=P)
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(copy.deepcopy(jr))
        eng.submit(copy.copy(tr))
    jeng._admit()
    eng._admit()
    assert sorted(eng._groups) == sorted(jeng._groups) == [1]
    assert eng._groups[1]["blocks"] == jeng._groups[1]["blocks"]
    np.testing.assert_allclose(eng._groups[1]["seed_logits"].numpy(),
                               jeng._groups[1]["seed_logits"], atol=ATOL)
    _alloc_equal(eng.allocator, jeng.allocator)
    eng.run()
    assert eng._groups == {}
    assert eng.allocator.blocks_in_use == 0


def test_mixed_grouped_and_ungrouped(models):
    """group_id=None requests interleave with GRPO groups untouched by the
    sharing machinery: identical to JAX's paged engine and to dense."""
    jcfg, cfg, params, model = models
    jgen, gen = _gens()
    jreqs, treqs = _group_requests(cfg.vocab_size, seed=5, groups=2, sib=2)
    rng = np.random.RandomState(9)
    keys = row_keys(77, 2)
    for j in range(2):
        prompt = rng.randint(3, cfg.vocab_size,
                             size=rng.randint(4, P + 1)).astype(np.int32)
        jreqs.append(JaxRequest(request_id=100 + j, prompt=prompt,
                                key=np.asarray(keys)[j], max_new_tokens=N))
        treqs.append(Request(request_id=100 + j, prompt=prompt,
                             key=JaxKeyBatch(keys)[j], max_new_tokens=N))
    jeng, want = _run_jax(params, _paged(jcfg), jgen, jreqs, num_slots=3)
    eng, got = _run(model, _paged(cfg), gen, treqs, num_slots=3)
    _, dense = _run(model, cfg, gen, treqs, num_slots=3)
    _assert_same(got, want)
    _assert_same(got, dense, atol=0)
    _alloc_equal(eng.allocator, jeng.allocator)
    assert eng.allocator.blocks_in_use == 0


def test_bench_paged_block_counts(models):
    """BENCH_paged.json's workload (2 groups x 8 siblings, P = 48, N = 8,
    8-slot blocks, the whole batch resident): the same exact block counts
    — 28 peak blocks against 112 dense, 4.0x resident rows, 8.0x fewer
    prompt copies — and the same allocator as JAX's paged engine."""
    jcfg, cfg, params, model = models
    base = json.loads((ROOT / "benchmarks" / "baselines" /
                       "BENCH_paged.json").read_text())
    groups, sib = base["groups"], base["siblings"]
    width, new, bs = base["prompt_len"], base["max_new_tokens"], \
        base["kv_block_size"]
    jgen, gen = _gens(new)
    jreqs, treqs = _group_requests(cfg.vocab_size, groups=groups, sib=sib,
                                   max_new=new, width=width,
                                   min_len=width - bs + 1)
    kw = dict(num_slots=groups * sib, width=width)
    jeng, want = _run_jax(params, _paged(jcfg, bs), jgen, jreqs, **kw)
    eng, got = _run(model, _paged(cfg, bs), gen, treqs, **kw)
    _, dense = _run(model, cfg, gen, treqs, **kw)
    _assert_same(got, want)
    _assert_same(got, dense, atol=0)
    a = eng.allocator
    nb, pb = eng.nb, eng._pb
    dense_blocks = groups * sib * nb
    assert (nb, pb) == (base["blocks_per_row"], base["prompt_blocks"])
    assert dense_blocks == base["dense"]["resident_blocks"] == 112
    assert a.peak_blocks_in_use == base["paged"]["peak_blocks"] == 28
    assert dense_blocks / a.peak_blocks_in_use == \
        base["resident_batch_speedup"] == 4.0
    saved_blocks = a.shared_prompt_bytes_saved // eng._block_bytes
    assert saved_blocks == groups * (sib - 1) * pb
    assert sib / 1 == base["prompt_copies_speedup"] == 8.0
    assert (a.cow_forks, a.alloc_failures) == \
        (base["paged"]["cow_forks"], base["paged"]["alloc_failures"])
    _alloc_equal(a, jeng.allocator)


def test_backfill_slots_rollout_over_paged_matches_jax(models):
    """Two epochs of rollout(backfill="slots") over the paged layout
    (epoch 0 vanilla admission with CoW sharing through the GRPO group ids
    the adapter now sets, epoch 1 speculative-prefix admission): equal to
    JAX's paged run and to the port's dense slot run."""
    jcfg, cfg, params, model = models
    B, W, NN, GROUP = 8, 9, 10, 4
    rng = np.random.default_rng(1)
    base = rng.integers(3, cfg.vocab_size, (B // GROUP, W)).astype(np.int32)
    prompt = np.repeat(base, GROUP, axis=0)
    mask = np.ones((B, W), bool)
    mask[:GROUP, :2] = False
    prompt = np.where(mask, prompt, 0).astype(np.int32)
    ids = list(range(B))
    jgen = JaxGenerateConfig(max_new_tokens=NN, eos_id=EOS_ID, pad_id=PAD_ID)
    gen = GenerateConfig(max_new_tokens=NN, eos_id=EOS_ID, pad_id=PAD_ID)
    kw = dict(variant="spec", lenience=0.8, backfill="slots",
              backfill_slots=4)
    jspec, spec = JaxSpecConfig(**kw), SpecConfig(**kw)
    jcache = JaxRolloutCache(group_size=GROUP)
    cache, dcache = RolloutCache(group_size=GROUP), \
        RolloutCache(group_size=GROUP)
    jpaged, paged = _paged(jcfg), _paged(cfg)
    for epoch in (0, 1):
        keys = row_keys(31 + epoch, B)
        want = jax_spec_rollout.rollout(params, jpaged, jgen, jspec,
                                        jnp.asarray(prompt),
                                        jnp.asarray(mask), ids, jcache, keys,
                                        epoch)
        got = rollout(model, paged, gen, spec, prompt, mask, ids, cache,
                      JaxKeyBatch(keys), epoch)
        dense = rollout(model, cfg, gen, spec, prompt, mask, ids, dcache,
                        JaxKeyBatch(keys), epoch)
        for other, tol in ((want, ATOL), (dense, 0.0)):
            np.testing.assert_array_equal(got.response, other.response)
            np.testing.assert_array_equal(got.length, other.length)
            np.testing.assert_allclose(got.behaviour_logprobs,
                                       other.behaviour_logprobs, atol=tol,
                                       rtol=0)
        for k in ("one_pass", "n_generated", "n_reused", "admissions",
                  "engine_steps", "slot_occupancy"):
            assert got.metrics[k] == want.metrics[k], k
        np.testing.assert_array_equal(got.n, dense.n)
    assert got.metrics["one_pass"] == 1.0 and got.metrics["n_reused"] > 0
    assert math.isfinite(got.metrics["rollout_time"])


def test_paged_slots_with_grouped_prompt_ids_are_jax_s(models):
    """rollout(backfill="slots") over the paged layout with each GRPO
    group's rows under one prompt id (as the trainer's batches carry
    them) equals JAX's paged slot run token for token.  JAX's run there
    parts from JAX's own fixed batch in a row (ROADMAP Queue 3, "Kept on
    purpose"): the port keeps the reference's behaviour, and this test
    shows if the reference's changes."""
    jcfg, cfg, params, model = models
    B, W, NN, GROUP = 8, 9, 8, 4
    rng = np.random.default_rng(0)
    prompt = np.repeat(rng.integers(3, cfg.vocab_size, (B // GROUP, W)),
                       GROUP, axis=0).astype(np.int32)
    mask = np.ones((B, W), bool)
    ids = [i // GROUP for i in range(B)]
    keys = row_keys(5, B)
    jgen = JaxGenerateConfig(max_new_tokens=NN, eos_id=EOS_ID, pad_id=PAD_ID)
    gen = GenerateConfig(max_new_tokens=NN, eos_id=EOS_ID, pad_id=PAD_ID)
    kw = dict(variant="spec", backfill="slots", backfill_slots=4)
    jpaged, paged = _paged(jcfg), _paged(cfg)
    want = jax_spec_rollout.rollout(
        params, jpaged, jgen, JaxSpecConfig(**kw), jnp.asarray(prompt),
        jnp.asarray(mask), ids, JaxRolloutCache(group_size=GROUP), keys, 0)
    got = rollout(model, paged, gen, SpecConfig(**kw), prompt, mask, ids,
                  RolloutCache(group_size=GROUP), JaxKeyBatch(keys), 0)
    np.testing.assert_array_equal(got.response, want.response)
    np.testing.assert_array_equal(got.length, want.length)
    np.testing.assert_allclose(got.behaviour_logprobs,
                               want.behaviour_logprobs, atol=ATOL)
    fixed = jax_spec_rollout.rollout(
        params, jpaged, jgen, JaxSpecConfig(variant="spec"),
        jnp.asarray(prompt), jnp.asarray(mask), ids,
        JaxRolloutCache(group_size=GROUP), keys, 0)
    assert not np.array_equal(np.asarray(want.response),
                              np.asarray(fixed.response))
