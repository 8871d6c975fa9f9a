"""The port's speculative rollout on the CPU against ``repro.core.rollout``,
plus sampling parity and the port's import and device rules.

Random draws are shared: ``JaxKey`` wraps a JAX key and draws its Gumbel
and uniform noise with ``jax.random``, so the port's sampled tokens and
accept uniforms are the reference's, bit for bit.  Parameters come from
``repro.models.model.init_lm`` through ``from_jax_params``.  At the reduced
qwen3-1.7b with num_kv_heads=2 (G = 2) in float32 the two rollouts must give
identical tokens, lengths and rejection positions ``n``, and behaviour
log-probs within atol 1e-4."""
import os
import re
import subprocess
import sys
from pathlib import Path

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
from repro.engine import sampling as jax_sampling  # noqa: E402
from repro.engine.generate import GenerateConfig as JaxGenerateConfig  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RolloutCache, SpecConfig, rollout  # noqa: E402
from repro_torch.core.spec_rollout import left_align  # noqa: E402
from repro_torch.data.dataset import PromptDataset  # noqa: E402
from repro_torch.data.tokenizer import EOS_ID, PAD_ID  # noqa: E402
from repro_torch.engine import sampling  # noqa: E402
from repro_torch.engine.generate import GenerateConfig  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.rewards.mathgen import MathTaskConfig, generate_problems  # noqa: E402

ATOL = 1e-4
PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


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


class JaxKey:
    """The port's key protocol over a JAX key (test side only)."""

    def __init__(self, key):
        self.key = key

    def split(self, num=2):
        return tuple(JaxKey(k) for k in jax.random.split(self.key, num))

    def gumbel(self, shape):
        return torch.from_numpy(np.array(jax.random.gumbel(
            self.key, tuple(shape), jnp.float32)))

    def uniform(self, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            self.key, tuple(shape), jnp.float32)))

    def fold_in(self, i):
        return JaxKeyBatch(jax.random.fold_in(self.key, i)[None])


class JaxKeyBatch:
    """The port's key-batch protocol over (B, 2) JAX keys: row b draws with
    ``jax.random`` from key b alone, as JAX's per-row sampling vmaps it."""

    def __init__(self, keys):
        self.keys = jnp.asarray(keys)

    def __len__(self):
        return self.keys.shape[0]

    def __getitem__(self, idx):
        if isinstance(idx, int):
            idx = slice(idx, idx + 1)
        return JaxKeyBatch(self.keys[idx])

    def __setitem__(self, idx, other):
        self.keys = self.keys.at[idx].set(other.keys[0])

    @classmethod
    def stack(cls, keys):
        return cls(jnp.concatenate([k.keys for k in keys]))

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self.keys)
        return a if dtype is None else a.astype(dtype)

    @classmethod
    def from_words(cls, words, device=None):
        return cls(np.asarray(words).astype(np.uint32).reshape(-1, 2))

    def split(self):
        a, b = jax_sampling.split_key(self.keys)
        return JaxKeyBatch(a), JaxKeyBatch(b)

    def _draw(self, fn, shape):
        row = tuple(shape[1:])
        return torch.from_numpy(np.array(jax.vmap(
            lambda k: fn(k, row, jnp.float32))(self.keys)))

    def gumbel(self, shape):
        return self._draw(jax.random.gumbel, shape)

    def uniform(self, shape):
        return self._draw(jax.random.uniform, shape)


def row_keys(seed, n):
    """(n, 2) JAX per-row keys, ``fold_in(PRNGKey(seed), i)``."""
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i)
                    )(jnp.arange(n))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("qwen3-1.7b").reduced(num_kv_heads=2)
    cfg = get_config("qwen3-1.7b").reduced(num_kv_heads=2)
    params = JM.init_lm(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return jcfg, cfg, params, model


@pytest.mark.parametrize("temperature,top_p", [(1.0, 1.0), (0.7, 0.9)])
def test_sample_and_logprobs_match(temperature, top_p):
    rng = np.random.default_rng(3)
    logits = (3.0 * rng.standard_normal((6, 50))).astype(np.float32)
    key = jax.random.PRNGKey(9)
    _, sub = jax_sampling.split_key(key)
    want_tok, want_lp = jax_sampling.sample(sub, jnp.asarray(logits),
                                            temperature, top_p)
    _, tsub = sampling.split_key(JaxKey(key))
    tok, lp = sampling.sample(tsub, torch.from_numpy(logits), temperature,
                              top_p)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), atol=1e-6)
    toks = rng.integers(0, 50, (6,)).astype(np.int32)
    np.testing.assert_allclose(
        sampling.logprobs_of(torch.from_numpy(logits), torch.from_numpy(toks),
                             temperature, top_p).numpy(),
        np.asarray(jax_sampling.logprobs_of(jnp.asarray(logits),
                                            jnp.asarray(toks), temperature,
                                            top_p)), atol=1e-6)


def test_two_epoch_rollout_matches_jax(models, monkeypatch):
    """Epoch 0 vanilla, epoch 1 the one-pass branch (lenience 0.8, so the
    rejection position varies from row to row), through one RolloutCache
    each, driven as ``Collector.rollout_once`` drives JAX's."""
    _two_epoch_parity(models, monkeypatch, "auto")


def test_two_pass_rollout_matches_jax(models, monkeypatch):
    """The same two epochs with ``one_pass="off"``: epoch 1 takes the
    two-pass branch (score, left-align, re-prefill)."""
    _two_epoch_parity(models, monkeypatch, "off")


def _two_epoch_parity(models, monkeypatch, one_pass):
    jcfg, cfg, params, model = models
    problems = generate_problems(MathTaskConfig(num_problems=4, seed=0))
    batch = next(PromptDataset(problems, max_prompt_len=16).epochs(
        4, 4, 1, shuffle=False))
    N = 24
    jgen = JaxGenerateConfig(max_new_tokens=N, eos_id=EOS_ID, pad_id=PAD_ID)
    gen = GenerateConfig(max_new_tokens=N, eos_id=EOS_ID, pad_id=PAD_ID)
    jspec = JaxSpecConfig(variant="spec", lenience=0.8, one_pass=one_pass,
                          verify_impl="interpret", compact_impl="interpret")
    spec = SpecConfig(variant="spec", lenience=0.8, one_pass=one_pass)
    jcache, cache = JaxRolloutCache(group_size=4), RolloutCache(group_size=4)

    jax_n = {}
    name = "verify_and_prefill" if one_pass == "auto" else "verify_drafts"
    verify = getattr(jax_spec_rollout, name)

    def spy(*args, **kw):
        out = verify(*args, **kw)
        jax_n["n"] = np.asarray(out["n"])
        return out

    monkeypatch.setattr(jax_spec_rollout, name, spy)
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
        for k in ("one_pass", "n_generated", "n_reused", "prefill_passes"):
            assert got.metrics[k] == want.metrics[k], k
        assert set(got.metrics) == set(want.metrics)
    np.testing.assert_array_equal(got.n, jax_n["n"])
    assert got.metrics["one_pass"] == (1.0 if one_pass == "auto" else 0.0)
    assert got.metrics["prefill_passes"] == (1.0 if one_pass == "auto"
                                             else 2.0)
    assert np.any((got.n > 0) & (got.n < N)) and len(set(got.n.tolist())) > 2


def test_left_align_matches_jax():
    """[left-padded prompt | right-padded prefix] rows, an empty prefix and
    an all-valid row among them, against JAX's gather and roll impls."""
    rng = np.random.default_rng(4)
    P, N = 6, 5
    p_len = np.array([6, 3, 1, 4])
    n = np.array([5, 0, 2, 3])
    cols = np.arange(P + N)[None, :]
    mask = (((cols >= P - p_len[:, None]) & (cols < P))
            | ((cols >= P) & (cols < P + n[:, None])))
    tokens = np.where(mask, rng.integers(3, 100, mask.shape), 0
                      ).astype(np.int32)
    got_t, got_m = left_align(torch.from_numpy(tokens), torch.from_numpy(mask))
    for impl in ("gather", "roll"):
        want_t, want_m = jax_spec_rollout.left_align(
            jnp.asarray(tokens), jnp.asarray(mask), impl=impl)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert got_m[:, -1].all()


@pytest.mark.parametrize("branch", ["mesh"])
def test_unported_branches_raise(models, branch):
    """The mesh still raises for the families its part 3 carries (an RWKV6
    trunk here) and names its ROADMAP item, before it reads the mesh (the
    dense GQA family's rollout on the mesh is held against JAX in
    test_torch_mesh.py; the variants random, full and delayed are ported:
    their parity tests are in test_torch_train.py; the draft engine's,
    drafted rollouts included, in test_torch_drafting.py and
    test_torch_draft_serving.py)."""
    _, _, _, model = models
    cfg = get_config("rwkv6-3b").reduced()
    gen = GenerateConfig(max_new_tokens=4)
    toks = np.ones((2, 3), np.int32)
    mask = np.ones((2, 3), bool)
    spec, mesh, item = {"mesh": (SpecConfig(), object(), 11)}[branch]
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue 1 item {item} "):
        rollout(model, cfg, gen, spec, toks, mask, [0, 1], RolloutCache(),
                sampling.make_key(0, "cpu"), 0, mesh=mesh)


# modules of each slice that the walk below must reach
SLICE_MODULES = (
    "repro_torch.core.spec_rollout", "repro_torch.engine.generate",
    "repro_torch.kernels.decode_attention.ops",
    "repro_torch.kernels.cache_gather.ops",
    "repro_torch.kernels.cache_slot_write.ops",
    "repro_torch.serving.engine_loop", "repro_torch.serving.rl_adapter",
    "repro_torch.serving.mesh_server", "repro_torch.serving.request",
    "repro_torch.serving.scheduler", "repro_torch.launch.serve",
    "repro_torch.models.rwkv", "repro_torch.kernels.rwkv6_wkv.ops",
    "repro_torch.configs.rwkv6_3b", "repro_torch.optim.adamw",
    "repro_torch.rl.losses", "repro_torch.rl.advantages",
    "repro_torch.rl.trainer", "repro_torch.core.lenience",
    "repro_torch.launch.train", "repro_torch.rl.critic",
    "repro_torch.serving.paged_engine", "repro_torch.serving.block_table",
    "repro_torch.serving.faults", "repro_torch.checkpoint.io",
    "repro_torch.core.backoff", "repro_torch.core.metrics",
    "repro_torch.drafting", "repro_torch.drafting.controller",
    "repro_torch.drafting.ngram", "repro_torch.drafting.step",
    "repro_torch.drafting.engine", "repro_torch.obs",
    "repro_torch.obs.registry", "repro_torch.obs.trace",
    "repro_torch.rl.traj_buffer", "repro_torch.rl.watchdog",
    "repro_torch.rl.async_loop", "repro_torch.serving.rollout_service",
    "repro_torch.obs.ledger", "repro_torch.obs.attrib",
    "repro_torch.obs.alerts", "repro_torch.obs.export",
    "repro_torch.launch.analysis", "repro_torch.models.moe",
    "repro_torch.configs.deepseek_7b", "repro_torch.configs.qwen1p5_110b",
    "repro_torch.configs.granite_34b", "repro_torch.configs.mixtral_8x22b",
    "repro_torch.models.mamba", "repro_torch.kernels.mamba_scan.ops",
    "repro_torch.configs.jamba_v0p1_52b", "repro_torch.configs.pixtral_12b",
    "repro_torch.configs.whisper_tiny",
    "repro_torch.configs.deepseek_v3_671b", "repro_torch.distributed.mesh",
    "repro_torch.distributed.sharding", "repro_torch.distributed.shard_wrap",
    "repro_torch.distributed.comm", "repro_torch.launch.mesh",
    "repro_torch.launch.steps")


def test_port_imports_no_jax_and_no_repro():
    """Every module of repro_torch (those of the serving/paged slice among
    them) imports with JAX made unimportable, and no ``repro`` module is
    loaded along the way."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    print(m.name)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and"
        " (m == 'repro' or m.startswith('repro.') or m.startswith('jax'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    lines = out.stdout.split()
    assert out.returncode == 0 and lines[-1] == "ok", out.stderr
    missing = set(SLICE_MODULES) - set(lines)
    assert not missing, missing
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert not offenders, offenders


def test_entry_points_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    from repro_torch.models import model as M
    cfg = get_config("qwen3-1.7b").reduced(num_kv_heads=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_lm(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sampling.make_key(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_params({}, cfg)
    M.init_lm(cfg, seed=0, device="cpu")
