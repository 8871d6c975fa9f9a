"""The port's trainer watchdog (``rl/watchdog.py``) on the CPU against
``repro.rl.watchdog``: the cases of ``tests/rl/test_watchdog.py``, each run
on JAX's trainer and the port's from the same parameters and ``JaxKey``
stream (reduced qwen3-1.7b, float32).  The step metrics' ``watchdog_*``
counters must equal JAX's for the same history (the collect-time p95 only
where both histories are synthetic: a real step's ``collect_time`` is
each package's own wall time).  A restore writes into the live model and
moments, so the trainer keeps its ``model`` object and every parameter its
storage; params, moments, key and cache come back bit for bit (PPO's
critic and its moments too, with the port's own key).

A ``JaxKey`` has no 64-bit seed, so these tests save it as its two JAX
words through ``key_state``/``key_from_state`` patched in the watchdog
module; the PPO case keeps the port's ``Key`` and its seed.  Torch runs on
one CPU thread (``one_thread``): the reduced model's small ops gain
nothing from more, while test processes sharing the cores lose much."""
import math

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint.io import read_latest as jax_read_latest  # noqa: E402
from repro.rl import trainer as jax_trainer  # noqa: E402
from repro.rl.watchdog import TrainWatchdog as JaxTrainWatchdog  # noqa: E402
from repro.rl.watchdog import WatchdogConfig as JaxWatchdogConfig  # noqa: E402
from repro_torch.checkpoint.io import read_latest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SpecConfig  # noqa: E402
from repro_torch.engine.sampling import make_key  # noqa: E402
from repro_torch.rl import trainer as port_trainer  # noqa: E402
from repro_torch.rl import watchdog  # noqa: E402
from repro_torch.rl.trainer import RLConfig, Trainer  # noqa: E402
from repro_torch.rl.watchdog import TrainWatchdog, WatchdogConfig  # noqa: E402
from test_torch_rollout import JaxKey  # noqa: E402
from test_torch_train import _datasets, _mixed_rewards, _trainers  # noqa: E402

P95 = "watchdog_collect_p95"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed(responses, lengths, answers):
    return _mixed_rewards(len(answers), 4)


@pytest.fixture
def pair(monkeypatch, tmp_path):
    """A function making (JAX trainer, the port's), each with its watchdog of
    ``cfg`` over its own directory, rewards mixed in both."""
    for mod in (jax_trainer, port_trainer):
        monkeypatch.setattr(mod, "batch_rewards", _mixed)
    monkeypatch.setattr(watchdog, "key_state",
                        lambda k: np.asarray(k.key, np.int64))
    monkeypatch.setattr(watchdog, "key_from_state", lambda w, dev: JaxKey(
        jnp.asarray(np.asarray(w, np.int64), jnp.uint32)))

    def build(**cfg):
        jtr, tr = _trainers("qwen3-1.7b", num_kv_heads=2)
        jtr.watchdog = JaxTrainWatchdog(JaxWatchdogConfig(
            checkpoint_dir=str(tmp_path / "jax"), **cfg))
        tr.watchdog = TrainWatchdog(WatchdogConfig(
            checkpoint_dir=str(tmp_path / "torch"), **cfg))
        return jtr, tr

    return build


def _wd(m):
    return {k: v for k, v in m.items() if k.startswith("watchdog_")}


def _same(got, want, p95=False):
    """The watchdog keys of a step's metrics equal JAX's (NaN-free: they
    are counts and p95s); the collect p95 only when ``p95``."""
    g, w = _wd(got), _wd(want)
    if not p95:
        g.pop(P95, None)
        w.pop(P95, None)
    assert g == w


def _params(tr):
    return [p.detach().clone() for p in tr.model.parameters()]


def _moments(opt):
    return [t.clone() for t in opt["mu"] + opt["nu"]], opt["step"]


def _poison(tr):
    with torch.no_grad():
        for p in tr.model.parameters():
            p.mul_(float("nan"))
        for t in tr.opt_state["mu"] + tr.opt_state["nu"]:
            t.fill_(float("nan"))


def test_healthy_steps_snapshot_on_cadence(pair, tmp_path):
    jtr, tr = pair(snapshot_every=2)
    for _ in range(3):
        want, got = jtr.train_step(), tr.train_step()
        _same(got, want)
    assert tr.watchdog.snapshots == jtr.watchdog.snapshots >= 2
    assert read_latest(str(tmp_path / "torch")) == \
        jax_read_latest(str(tmp_path / "jax")) is not None
    assert got["watchdog_snapshots"] == float(tr.watchdog.snapshots)
    assert got["watchdog_restores"] == 0.0


def test_poisoned_step_restores_last_good_in_place(pair):
    jtr, tr = pair(snapshot_every=1)
    jtr.train_step()
    tr.train_step()
    model, ptrs = tr.model, [p.data_ptr() for p in tr.model.parameters()]
    good, (mom, step) = _params(tr), _moments(tr.opt_state)
    key = np.asarray(tr.key.key)
    cached = {k: [e.tokens.copy() for e in q]
              for k, q in tr.cache._store.items()}
    step_before = tr.step_idx
    jtr.params = jax.tree.map(lambda x: x * np.nan, jtr.params)
    _poison(tr)
    tr.key = JaxKey(jax.random.PRNGKey(99))
    tr.cache._store.clear()
    want = {"loss": float("nan"), "reward_mean": 0.0}
    got = dict(want)
    jtr.watchdog.after_step(jtr, want)
    tr.watchdog.after_step(tr, got)
    _same(got, want)
    assert got["watchdog_restored"] == want["watchdog_restored"] == 1.0
    assert tr.watchdog.nonfinite_steps == 1 and tr.watchdog.restores == 1
    # in place: the same model object and storage, values bit for bit
    assert tr.model is model
    assert [p.data_ptr() for p in tr.model.parameters()] == ptrs
    for a, b in zip(tr.model.parameters(), good):
        assert torch.equal(a, b)
    now, nstep = _moments(tr.opt_state)
    assert nstep == step and all(torch.equal(a, b) for a, b in zip(now, mom))
    np.testing.assert_array_equal(np.asarray(tr.key.key), key)
    assert {k: [e.tokens for e in q] for k, q in tr.cache._store.items()
            }.keys() == cached.keys()
    for k, toks in cached.items():
        for a, b in zip(tr.cache._store[k], toks):
            np.testing.assert_array_equal(a.tokens, b)
    assert tr.step_idx == step_before          # not rolled back
    want, got = jtr.train_step(), tr.train_step()
    assert np.isfinite(got["loss"]) and got["watchdog_restores"] == 1.0
    _same(got, want)
    np.testing.assert_array_equal(tr.last_rb.response,
                                  np.asarray(jtr.last_rb.response))


@pytest.mark.parametrize("case", ["stall", "budget", "no_snapshot",
                                  "cache_and_counters", "service_stall",
                                  "staleness"])
def test_verdicts_match_jax(pair, case):
    """JAX's remaining cases, each on both packages: a stalled collect, an
    exhausted restore budget, a poisoned step before any snapshot, the
    cache and generation counters carried by a restore, a stalled service
    (absolute cap) and a staleness blow-out.  The stall cap is 60 s (JAX's
    test: 0.5 s) so that the real first step, timed on a loaded CPU, is
    never a stall itself; the stalled step reports 600 s."""
    cfg = {"stall": dict(snapshot_every=1, max_collect_time=60.0),
           "budget": dict(snapshot_every=1, max_restores=0),
           "no_snapshot": {},
           "cache_and_counters": dict(snapshot_every=1),
           "service_stall": dict(snapshot_every=1, max_service_wait=1.0),
           "staleness": dict(snapshot_every=1, max_service_staleness=4.0)
           }[case]
    m = {"stall": {"loss": 0.1, "reward_mean": 0.0, "collect_time": 600.0},
         "budget": {"loss": float("nan")},
         "no_snapshot": {"loss": float("nan")},
         "cache_and_counters": {"loss": float("nan")},
         "service_stall": {"loss": 0.1, "reward_mean": 0.0,
                           "service_wait_s": 5.0},
         "staleness": {"loss": 0.1, "reward_mean": 0.0,
                       "service_staleness": 9.0}}[case]
    jtr, tr = pair(**cfg)
    if case != "no_snapshot":
        jtr.train_step()
        tr.train_step()
    good = _params(tr)
    cached, gen_steps = sorted(tr.cache._store), tr.gen_steps
    if case == "cache_and_counters":
        tr.cache._store.clear()
        jtr.cache._store.clear()
    if case == "service_stall":
        with torch.no_grad():
            for p in tr.model.parameters():
                p.mul_(2.0)
    if case == "budget":
        for t in (jtr, tr):
            with pytest.raises(RuntimeError, match="restore budget"):
                t.watchdog.after_step(t, dict(m))
        return
    want, got = dict(m), dict(m)
    jtr.watchdog.after_step(jtr, want)
    tr.watchdog.after_step(tr, got)
    _same(got, want)
    assert ("watchdog_restored" in got) == ("watchdog_restored" in want)
    wd = tr.watchdog
    if case == "no_snapshot":
        assert wd.skipped_no_snapshot == 1 and wd.restores == 0
        return
    assert got["watchdog_restored"] == 1.0
    assert (wd.stalled_steps, wd.service_stalled_steps, wd.nonfinite_steps
            ) == {"stall": (1, 0, 0), "cache_and_counters": (0, 0, 1),
                  "service_stall": (0, 1, 0), "staleness": (0, 1, 0)}[case]
    assert sorted(tr.cache._store) == cached and tr.gen_steps == gen_steps
    for a, b in zip(tr.model.parameters(), good):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["service_wait_s", "collect_time"])
def test_adaptive_p95_stall_matches_jax(pair, kind):
    """No absolute cap: the p95 × mult detector arms off the run's own
    healthy history (synthetic, so the p95s are compared too) and trips
    on the outlier, then restores the snapshot of the first healthy
    step."""
    jtr, tr = pair(snapshot_every=1, stall_p95_mult=10.0,
                   stall_min_samples=4)
    good = _params(tr)
    for i in range(5):
        want = {"loss": 0.1, "reward_mean": 0.0, kind: 0.01 + 0.001 * i}
        got = dict(want)
        jtr.watchdog.after_step(jtr, want)
        tr.watchdog.after_step(tr, got)
        _same(got, want, p95=True)
    assert tr.watchdog.snapshots == 5 and tr.watchdog.restores == 0
    _poison(tr)
    want = {"loss": 0.1, "reward_mean": 0.0, kind: 30.0}
    got = dict(want)
    jtr.watchdog.after_step(jtr, want)
    tr.watchdog.after_step(tr, got)
    _same(got, want, p95=True)
    assert got["watchdog_restored"] == 1.0
    assert got["watchdog_service_wait_p95" if kind == "service_wait_s"
               else P95] > 0
    for a, b in zip(tr.model.parameters(), good):
        assert torch.equal(a, b)


def test_ppo_restore_brings_back_critic_moments_and_key(tmp_path, monkeypatch):
    """The port's own key (saved as its 64-bit seed) and a PPO trainer:
    after one step and its snapshot, every actor and critic parameter,
    every moment, the key's seed and the cache are poisoned or changed;
    the restore brings each back bit for bit, in place."""
    monkeypatch.setattr(port_trainer, "batch_rewards", _mixed)
    cfg = get_config("qwen3-1.7b").reduced(num_kv_heads=2)
    rl = RLConfig(algo="ppo", group_size=4, prompts_per_batch=2,
                  max_new_tokens=6)
    wd = TrainWatchdog(WatchdogConfig(checkpoint_dir=str(tmp_path),
                                      snapshot_every=1))
    tr = Trainer(cfg, rl, SpecConfig(), _datasets()[1],
                 make_key(2 ** 63 + 5, "cpu"), device="cpu", watchdog=wd)
    tr.train_step()
    mods = (tr.model, tr.critic)
    saved = [[p.detach().clone() for p in m.parameters()] for m in mods]
    moments = [_moments(o) for o in (tr.opt_state, tr.critic_opt_state)]
    seed, entries = tr.key.seed, sorted(tr.cache._store)
    with torch.no_grad():
        for m in mods:
            for p in m.parameters():
                p.fill_(float("nan"))
        for o in (tr.opt_state, tr.critic_opt_state):
            for t in o["mu"] + o["nu"]:
                t.fill_(float("nan"))
            o["step"] += 7
    tr.key = make_key(1, "cpu")
    tr.cache._store.clear()
    m = {"loss": 0.1, "critic_loss": float("nan")}
    wd.after_step(tr, m)
    assert m["watchdog_restored"] == 1.0 and wd.nonfinite_steps == 1
    for mod, want in zip(mods, saved):
        for a, b in zip(mod.parameters(), want):
            assert torch.equal(a, b)
    for o, (mom, step) in zip((tr.opt_state, tr.critic_opt_state), moments):
        now, nstep = _moments(o)
        assert nstep == step
        assert all(torch.equal(a, b) for a, b in zip(now, mom))
    assert tr.key.seed == seed and tr.key.device == tr.device
    assert sorted(tr.cache._store) == entries
    assert math.isfinite(tr.train_step()["loss"])
