"""The port's ``checkpoint/io.py`` and exact kill-and-resume on the CPU
against ``repro`` (the twins of tests/misc/test_checkpoint_io.py and
tests/serving/test_kill_resume.py).

Checkpoint files: atomic writes, the ``latest`` pointer as the commit
point, a dangling pointer refused, the lossless rollout-cache round-trip,
and float32/integer pytrees and rollout caches read across the two
packages in both directions.  bfloat16 leaves (the card's caches) are
stored as their raw words and come back bit for bit.

Kill-and-resume: an engine killed mid-batch, saved to disk with
``save_server_state`` and restored into a freshly built engine equals an
uninterrupted run exactly (tokens, log-probs, counters), and equals JAX's
uninterrupted run (tokens exactly, log-probs within atol 1e-4): vanilla,
speculative-prefix, paged (allocator, tables and group registry in the
snapshot) and a bfloat16 engine.
"""
import copy
import glob
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.checkpoint import io as jax_io  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.cache import RolloutCache as JaxRolloutCache  # noqa: E402
from repro.engine.generate import GenerateConfig as JaxGenerateConfig  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import make_slot_engine as jax_make_slot_engine  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint.io import (load_pytree,  # noqa: E402
                                       load_rollout_cache, load_server_state,
                                       read_latest, save_pytree,
                                       save_rollout_cache, save_server_state,
                                       write_latest)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cache import RolloutCache  # noqa: E402
from repro_torch.engine.generate import GenerateConfig  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import (EngineKilled, FaultEvent,  # noqa: E402
                                 FaultPlan, PagedSlotEngine, Request,
                                 SlotEngine, make_slot_engine)
from test_torch_rollout import JaxKeyBatch, row_keys  # noqa: E402

ATOL = 1e-4
P, N, R = 8, 12, 6


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


def _no_tmp_files(d):
    return not glob.glob(os.path.join(str(d), "**", "*.tmp"), recursive=True)


# ------------------------------------------------------------- pytree io

def test_pytree_roundtrip_atomicity_and_bf16_bits(tmp_path):
    """Tensors (bf16 among them), numpy arrays and scalars round-trip;
    every bf16 bit pattern, NaNs and infinities included, comes back."""
    words = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    bf = words.view(torch.bfloat16).reshape(256, 256)
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "bf": bf,
            "t": torch.linspace(-1, 1, 5),
            "nested": {"b": np.float32(1.5),
                       "seq": [np.ones(2), torch.zeros(3, dtype=torch.int64)],
                       "tup": (np.int64(7),)}}
    p = str(tmp_path / "ck")
    save_pytree(p, tree, metadata={"step": 3})
    out, meta = load_pytree(p)
    assert meta["step"] == 3
    assert out["bf"].dtype == torch.bfloat16
    assert torch.equal(out["bf"].view(torch.int16), bf.view(torch.int16))
    np.testing.assert_array_equal(out["a"].numpy(), tree["a"])
    assert torch.equal(out["t"], tree["t"])
    assert out["nested"]["seq"][1].dtype == torch.int64
    assert isinstance(out["nested"]["tup"], tuple)
    assert int(out["nested"]["tup"][0]) == 7
    assert _no_tmp_files(tmp_path)


def test_latest_pointer_is_the_commit_point(tmp_path):
    d = str(tmp_path / "ckpts")
    assert read_latest(d) is None
    save_pytree(os.path.join(d, "step_1"), {"x": np.ones(2)})
    assert read_latest(d) is None               # on disk but not committed
    write_latest(d, "step_1")
    assert read_latest(d) == "step_1"
    save_pytree(os.path.join(d, "step_2"), {"x": torch.ones(2)})
    write_latest(d, "step_2")
    assert read_latest(d) == "step_2"
    assert jax_io.read_latest(d) == "step_2"    # JAX reads the pointer
    assert _no_tmp_files(tmp_path)


def test_read_latest_rejects_dangling_pointer(tmp_path):
    d = str(tmp_path / "ckpts")
    write_latest(d, "ghost")
    assert read_latest(d) is None
    save_pytree(os.path.join(d, "real"), {"x": np.zeros(1)})
    write_latest(d, "real")
    assert read_latest(d) == "real"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pytree_files_cross_packages(tmp_path, writer):
    """A float32/int32 tree written by one package loads in the other
    (JAX reads int64 as int32 without x64, so the tree holds none)."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "ids": rng.integers(0, 99, (5,)).astype(np.int32),
            "deep": {"l": [np.int32(4), rng.standard_normal(2)
                           .astype(np.float32)], "t": (np.float32(0.5),)}}
    p = str(tmp_path / "x")
    if writer == "jax":
        jax_io.save_pytree(p, tree, metadata={"by": "jax"})
        out, meta = load_pytree(p)
        leaves = [out["w"], out["ids"], out["deep"]["l"][0],
                  out["deep"]["l"][1], out["deep"]["t"][0]]
        leaves = [x.numpy() for x in leaves]
    else:
        save_pytree(p, jax.tree.map(torch.as_tensor, tree),
                    metadata={"by": "port"})
        out, meta = jax_io.load_pytree(p)
        leaves = [np.asarray(x) for x in (out["w"], out["ids"],
                                          out["deep"]["l"][0],
                                          out["deep"]["l"][1],
                                          out["deep"]["t"][0])]
    assert meta["by"] == writer
    want = [tree["w"], tree["ids"], tree["deep"]["l"][0],
            tree["deep"]["l"][1], tree["deep"]["t"][0]]
    for g, w in zip(leaves, want):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------- rollout cache

def _seeded_cache(cls):
    rng = np.random.RandomState(0)
    cache = cls(history=2, max_prompts=4, group_size=2)
    for pid in range(6):                        # 6 puts into a 4-prompt bound
        for step in range(2):
            L = int(rng.randint(2, 8))
            cache.put(pid, rng.randint(0, 32, L).astype(np.int32),
                      rng.randn(L).astype(np.float32), L, step=step,
                      eos_id=31)
    cache.get(4)                                # LRU touch reorders recency
    cache.get(99)                               # a miss, for the counter
    return cache


def _assert_cache_equal(out, cache):
    assert list(out._store) == list(cache._store)
    for pid in cache._store:
        a, b = cache._store[pid], out._store[pid]
        assert len(a) == len(b) and b.maxlen == cache.history
        for ea, eb in zip(a, b):
            np.testing.assert_array_equal(ea.tokens, eb.tokens)
            np.testing.assert_array_equal(ea.logprobs, eb.logprobs)
            assert (ea.step, ea.ends_with_eos) == (eb.step, eb.ends_with_eos)
    assert out._groups == cache._groups and out._group_of == cache._group_of
    assert (out.max_prompts, out.group_size) == (cache.max_prompts,
                                                 cache.group_size)
    for k in ("puts", "hits", "misses", "evictions"):
        assert getattr(out, k) == getattr(cache, k), k


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_rollout_cache_roundtrip_lossless(tmp_path, writer):
    """Entries, LRU order, sibling groups, bounds and counters round-trip,
    through the port's files and through JAX's; the restored cache evicts
    like the original."""
    p = str(tmp_path / "rc")
    if writer == "port":
        cache = _seeded_cache(RolloutCache)
        save_rollout_cache(p, cache)
    else:
        cache = _seeded_cache(JaxRolloutCache)
        jax_io.save_rollout_cache(p, cache)
    out = load_rollout_cache(p)
    assert isinstance(out, RolloutCache)
    _assert_cache_equal(out, cache)
    assert out.evictions == 2
    back = jax_io.load_rollout_cache(p)         # and JAX reads the port's
    _assert_cache_equal(back, cache)
    tok, lp = np.arange(3, dtype=np.int32), np.zeros(3, np.float32)
    cache.put(77, tok, lp, 3, step=9)
    out.put(77, tok, lp, 3, step=9)
    assert list(out._store) == list(cache._store)
    assert out.evictions == cache.evictions == 3


@pytest.mark.parametrize("entries", [0, 5])
def test_rollout_cache_roundtrip_is_a_fixed_point(tmp_path, entries):
    cache = RolloutCache(history=2, group_size=2)
    for pid in range(entries):
        cache.put(pid, np.arange(4, dtype=np.int32), np.zeros(4, np.float32),
                  4, step=1)
    p1, p2 = str(tmp_path / "x"), str(tmp_path / "y")
    save_rollout_cache(p1, cache)
    save_rollout_cache(p2, load_rollout_cache(p1))
    with open(p1 + ".cache.json") as f1, open(p2 + ".cache.json") as f2:
        assert f1.read() == f2.read()
    out = load_rollout_cache(p1)
    assert len(out) == entries and out.get(123) is None


# -------------------------------------------------------- kill-and-resume

@pytest.fixture(autouse=True)
def jax_snapshot_keys(monkeypatch):
    """Snapshot key words come back as JAX-drawing key batches."""
    monkeypatch.setattr(SlotEngine, "key_type", JaxKeyBatch)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("qwen3-1.7b").reduced(num_kv_heads=2)
    cfg = get_config("qwen3-1.7b").reduced(num_kv_heads=2)
    params = JM.init_lm(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(3, cfg.vocab_size - 1,
                           rng.randint(3, P + 1)).astype(np.int32)
               for _ in range(R)]
    return jcfg, cfg, params, model, prompts


def _gens(vocab):
    kw = dict(max_new_tokens=N, eos_id=vocab - 1)
    return JaxGenerateConfig(**kw), GenerateConfig(**kw)


def _assert_identical(got, want, atol=0.0):
    assert sorted(got) == sorted(want)
    for i in want:
        a, b = got[i], want[i]
        assert (a.finish_reason, a.length, a.n_accepted, a.retries) == \
            (b.finish_reason, b.length, b.n_accepted, b.retries), i
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=atol, rtol=0)


def _roundtrip(tmp_path, mk, reqs, kill_at, extra_events=()):
    """Uninterrupted run; then the same with an injected kill, a snapshot
    on disk and a fresh engine resumed from it.  Returns both engines and
    both response dicts."""
    ref = mk()
    plan = FaultPlan([FaultEvent(*e) for e in extra_events])
    ref.faults = plan if extra_events else None
    for r in reqs():
        ref.submit(r)
    want = ref.run()
    killed = mk()
    killed.faults = FaultPlan([FaultEvent(*e) for e in extra_events]
                              + [FaultEvent("kill", kill_at)])
    for r in reqs():
        killed.submit(r)
    with pytest.raises(EngineKilled):
        killed.run()
    assert killed.scheduler.num_active > 0      # genuinely mid-batch
    assert len(killed.responses) < len(want)
    path = str(tmp_path / "snap")
    save_server_state(path, killed, metadata={"requests": len(want)})
    resumed = mk()
    meta = load_server_state(path, resumed)
    assert meta["kind"] == "server_state" and meta["requests"] == len(want)
    got = resumed.run()
    _assert_identical(got, want)
    st, rst = resumed.stats(), ref.stats()
    for k in ("completed", "admitted", "engine_steps", "generated_tokens",
              "reused_tokens", "retried_requests", "fault_nan_events"):
        assert st[k] == rst[k], k
    return killed, resumed, got


def _jax_run(setup, reqs, **kw):
    jcfg, cfg, params, _, _ = setup
    jgen, _ = _gens(cfg.vocab_size)
    eng = jax_make_slot_engine(params, kw.pop("jcfg", jcfg), jgen,
                               prompt_width=P, num_slots=2, chunk_steps=4,
                               **kw)
    for r in reqs:
        eng.submit(r)
    return eng.run()


def _requests(setup, keys, jax_side, **kw):
    prompts = setup[4]
    if jax_side:
        return [JaxRequest(request_id=i, prompt=prompts[i],
                           key=np.asarray(keys)[i], max_new_tokens=N, **kw)
                for i in range(R)]
    return [Request(request_id=i, prompt=prompts[i],
                    key=JaxKeyBatch(keys)[i], max_new_tokens=N, **kw)
            for i in range(R)]


def _mk(setup, cfg=None, **kw):
    _, base, _, model, _ = setup
    cfg = cfg or base
    _, gen = _gens(cfg.vocab_size)
    return lambda: make_slot_engine(model, cfg, gen, num_slots=2,
                                    prompt_width=P, chunk_steps=4, **kw)


def test_kill_resume_vanilla(setup, tmp_path):
    """Step 16: responses done, rows mid-decode and a queue in one
    snapshot; the resumed run equals the uninterrupted one and JAX's."""
    keys = row_keys(5, R)
    killed, _, got = _roundtrip(tmp_path, _mk(setup),
                                lambda: _requests(setup, keys, False), 16)
    assert killed.responses and killed.scheduler.queue
    _assert_identical(got, _jax_run(setup, _requests(setup, keys, True)),
                      atol=ATOL)


def test_kill_resume_spec_prefix(setup, tmp_path):
    """Mid-verification state (accepted prefixes, prefix log-probs, verify
    keys of queued requests) round-trips exactly."""
    keys, vkeys = row_keys(5, R), row_keys(17, R)
    base = _mk(setup)()
    for r in _requests(setup, keys, False):
        base.submit(r)
    first = base.run()
    V = setup[1].vocab_size

    def drafted(jax_side):
        out = _requests(setup, keys, jax_side)
        for i, r in enumerate(out):
            toks = np.asarray(first[i].tokens, np.int32)
            half = max(1, len(toks) // 2)
            r.draft_tokens = np.concatenate(
                [toks[:half], (toks[half:] + 1) % V]).astype(np.int32)
            r.draft_logprobs = np.asarray(first[i].logprobs, np.float32)
            r.verify_key = (np.asarray(vkeys)[i] if jax_side
                            else JaxKeyBatch(vkeys)[i])
        return out

    _, resumed, got = _roundtrip(tmp_path, _mk(setup, spec_prefix=True),
                                 lambda: drafted(False), 4)
    assert sum(r.n_accepted for r in got.values()) > 0
    _assert_identical(got, _jax_run(setup, drafted(True), spec_prefix=True),
                      atol=ATOL)


def test_kill_resume_preserves_recovery_state(setup, tmp_path):
    """A kill between a quarantine and the retry's completion: the retry,
    its strike and the fault counters survive the round-trip."""
    keys = row_keys(5, R)
    killed, resumed, got = _roundtrip(
        tmp_path, _mk(setup), lambda: _requests(setup, keys, False), 8,
        extra_events=[("nan", 0, 0)])
    assert killed.fault_stats.nan_events == 1
    assert got[0].retries == 1
    assert resumed.stats()["fault_nan_events"] == 1


def test_kill_resume_paged(setup, tmp_path):
    """§10 x §13: allocator, block tables, group registry and seed logits
    in the snapshot (3 siblings over 2 slots, so a live registration is in
    flight at the kill); equal to the uninterrupted paged run, to the dense
    one and to JAX's paged run."""
    jcfg, cfg, _, _, prompts = setup
    pcfg = cfg.replace(cache_layout="paged", kv_block_size=4)
    keys = row_keys(7, R)

    def grouped(jax_side):
        out = _requests(setup, keys, jax_side)
        for r in out:
            r.prompt = prompts[r.request_id // 3]
            r.group_id = r.request_id // 3
        return out

    killed, resumed, got = _roundtrip(tmp_path, _mk(setup, pcfg),
                                      lambda: grouped(False), 6)
    assert isinstance(resumed, PagedSlotEngine)
    assert resumed.allocator.blocks_in_use == 0
    resumed.allocator.check()
    assert resumed.allocator.shared_prompt_bytes_saved > 0
    dense = _mk(setup)()
    for r in grouped(False):
        dense.submit(r)
    _assert_identical(got, dense.run())
    _assert_identical(got, _jax_run(setup, grouped(True), jcfg=jcfg.replace(
        cache_layout="paged", kv_block_size=4)), atol=ATOL)


def test_kill_resume_bf16_caches_bit_exact(setup, tmp_path):
    """A bfloat16 engine (the card's cache dtype): the snapshot's caches
    load back bit for bit, and the resumed run equals the uninterrupted
    one exactly."""
    _, cfg, params, _, _ = setup
    bcfg = cfg.replace(dtype="bfloat16", param_dtype="bfloat16",
                       cache_layout="paged", kv_block_size=4)
    model = from_jax_params(jax.tree.map(np.asarray, params), bcfg,
                            device="cpu")
    _, gen = _gens(cfg.vocab_size)
    keys = row_keys(5, R)

    def mk():
        return make_slot_engine(model, bcfg, gen, num_slots=2,
                                prompt_width=P, chunk_steps=4)

    killed = mk()
    killed.faults = FaultPlan([FaultEvent("kill", 8)])
    for r in _requests(setup, keys, False):
        killed.submit(r)
    with pytest.raises(EngineKilled):
        killed.run()
    path = str(tmp_path / "bf16")
    save_server_state(path, killed)
    resumed = mk()
    load_server_state(path, resumed)
    for a, b in zip(killed.caches, resumed.caches):
        for name in ("k", "v"):
            assert a["self"][name].dtype == torch.bfloat16
            assert torch.equal(a["self"][name].view(torch.int16),
                               b["self"][name].view(torch.int16))
        assert torch.equal(a["self"]["table"], b["self"]["table"])
    ref = mk()
    for r in _requests(setup, keys, False):
        ref.submit(r)
    _assert_identical(resumed.run(), ref.run())


def test_state_dict_is_all_arrays(setup):
    eng = _mk(setup)()
    for r in _requests(setup, row_keys(5, R), False):
        eng.submit(copy.copy(r))
    eng.run(max_chunks=1)
    leaves = jax.tree.leaves(eng.state_dict(),
                             is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert leaves
    for leaf in leaves:
        assert isinstance(leaf, (np.ndarray, np.generic, torch.Tensor)), \
            type(leaf)
        if isinstance(leaf, torch.Tensor):
            assert leaf.device.type == "cpu"
