"""The port's async rollout ↔ train seam (``rl/traj_buffer.py``,
``serving/rollout_service.py``, ``rl/async_loop.py``) on the CPU against
``repro``'s.

* The trajectory buffer: the cases of ``tests/rl/test_traj_buffer.py``
  (hypothesis properties included) run on both packages, and the two
  buffers' ``state_dict`` agree leaf for leaf.
* The async trainer: the cases of ``tests/rl/test_async_loop.py``, each
  run on JAX's ``AsyncTrainer`` and the port's from one set of parameters
  (reduced qwen3-1.7b, float32, through ``from_jax_params``) and the same
  ``JaxKey`` streams (the re-verification key too: ``make_key`` of
  ``repro_torch.rl.async_loop`` is patched to a ``JaxKey``), with both
  packages' rewards patched to ``_mixed_rewards`` so that advantages and
  importance weights are nonzero.  Every step's trajectory (what each
  ``optimize`` was handed) must hold JAX's tokens, lengths and staleness;
  each step's metrics lie within rtol ``LOSS_RTOL`` and atol ``TOL``
  (float32 sums in another order) and every counter is equal.  The
  ladder, chaos and ``publish_every=2`` cases are where a served model
  that aliased the trainer's would sample under newer weights than its
  tag says, so there the tokens are the check.
* K = 0 with ``"pc"`` is also held against the port's own synchronous
  trainer: tokens, losses and weights exactly equal.
* Kill-and-resume (port against port, the port's own keys): the saved and
  restored states are byte-identical and so is the continuation.

Every test runs torch on one CPU thread (``one_thread``): with several,
the CPU's float32 reductions are not reproducible from run to run (two
synchronous trainers from the same weights part in the last bits of
``kl_ref`` at the second step), which the exact comparisons need; and the
reduced model's small ops gain nothing from more threads, while several
test processes sharing the cores lose much to them.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402
from hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st  # noqa: E402

import repro.obs as jobs  # noqa: E402
import repro.rl.async_loop as jax_async  # noqa: E402
from repro.core.backoff import BackoffConfig as JaxBackoffConfig  # noqa: E402
from repro.core.spec_rollout import RolloutBatch as JaxRolloutBatch  # noqa: E402
from repro.data.dataset import PromptBatch as JaxPromptBatch  # noqa: E402
from repro.rl import trainer as jax_trainer  # noqa: E402
from repro.rl.traj_buffer import TrajBuffer as JaxTrajBuffer  # noqa: E402
from repro.rl.traj_buffer import Trajectory as JaxTrajectory  # noqa: E402
from repro.serving.faults import FaultEvent as JaxFaultEvent  # noqa: E402
from repro.serving.faults import FaultPlan as JaxFaultPlan  # noqa: E402
from repro.serving.rollout_service import WeightSync as JaxWeightSync  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.checkpoint.io import _flatten  # noqa: E402
from repro_torch.core import SpecConfig  # noqa: E402
from repro_torch.core.backoff import BackoffConfig  # noqa: E402
from repro_torch.core.spec_rollout import RolloutBatch  # noqa: E402
from repro_torch.data.dataset import PromptBatch  # noqa: E402
from repro_torch.engine.sampling import make_key  # noqa: E402
from repro_torch.rl import async_loop  # noqa: E402
from repro_torch.rl import trainer as port_trainer  # noqa: E402
from repro_torch.rl.async_loop import AsyncConfig, AsyncTrainer  # noqa: E402
from repro_torch.rl.traj_buffer import TrajBuffer, Trajectory  # noqa: E402
from repro_torch.rl.trainer import Trainer  # noqa: E402
from repro_torch.serving.faults import FaultEvent, FaultPlan  # noqa: E402
from repro_torch.serving.rollout_service import WeightSync  # noqa: E402
from test_torch_rollout import JaxKey  # noqa: E402
from test_torch_train import (LOSS_RTOL, TOL, _datasets,  # noqa: E402
                              _mixed_rewards, _trainers)

GROUP = 4                                  # _trainers' group size
PKGS = {
    "jax": dict(buffer=JaxTrajBuffer, traj=JaxTrajectory,
                batch=JaxPromptBatch, rb=JaxRolloutBatch),
    "torch": dict(buffer=TrajBuffer, traj=Trajectory, batch=PromptBatch,
                  rb=RolloutBatch),
}


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the buffer


def _traj(pkg, version=0, producer=0, seed=0):
    p = PKGS[pkg]
    rng = np.random.RandomState(seed)
    B, P, N = 2, 4, 3
    batch = p["batch"](tokens=rng.randint(0, 32, (B, P)).astype(np.int32),
                       mask=np.ones((B, P), bool),
                       cache_keys=[seed * B + i for i in range(B)],
                       answers=[1, 2], problem_ids=[0, 1], epoch=version)
    rb = p["rb"](prompt=batch.tokens, prompt_mask=batch.mask,
                 response=rng.randint(0, 32, (B, N)).astype(np.int32),
                 response_mask=np.ones((B, N), bool),
                 behaviour_logprobs=rng.randn(B, N).astype(np.float32),
                 length=np.full(B, N, np.int32),
                 metrics={"collect_time": 0.01 * seed})
    return p["traj"](batch=batch, rb=rb,
                     rewards=rng.rand(B).astype(np.float32),
                     version=version, producer=producer)


@pytest.mark.parametrize("pkg", PKGS)
def test_watermark_throttles_before_capacity_sheds(pkg):
    buf = PKGS[pkg]["buffer"](capacity=3, high_watermark=2)
    assert buf.put(_traj(pkg, 0)) is None
    assert not buf.should_throttle()
    assert buf.put(_traj(pkg, 0, seed=1)) is None
    assert buf.should_throttle()
    shed = buf.put(_traj(pkg, 1, seed=2))
    assert shed is None and len(buf) == 3
    shed = buf.put(_traj(pkg, 2, seed=3))
    assert shed is not None and shed.version == 0
    assert len(buf) == 3 and buf.shed == 1
    buf.check_invariants()


@pytest.mark.parametrize("pkg", PKGS)
def test_fifo_order_seq_tags_and_per_producer_versions(pkg):
    buf = PKGS[pkg]["buffer"](capacity=4)
    for v in range(3):
        buf.put(_traj(pkg, v, seed=v))
    got = [buf.get() for _ in range(3)]
    assert [t.version for t in got] == [0, 1, 2]
    assert [t.seq for t in got] == [0, 1, 2]
    assert buf.get() is None
    buf.check_invariants()
    buf.put(_traj(pkg, 5, producer=0))
    buf.put(_traj(pkg, 3, producer=1))       # another producer: independent
    with pytest.raises(AssertionError):
        buf.put(_traj(pkg, 4, producer=0))   # time travel is a bug


def test_buffer_state_matches_jax_and_round_trips():
    """Both packages' buffers through the same moves: equal counters and
    ``state_dict`` leaves (the port's also carries each row's ``n``);
    the port's state loads back exactly, from memory and from JAX's."""
    bufs = {pkg: PKGS[pkg]["buffer"](capacity=3, high_watermark=2)
            for pkg in PKGS}
    for pkg, buf in bufs.items():
        for v in range(4):                  # forces one shed
            buf.put(_traj(pkg, v, seed=v))
        buf.get()
        buf.note_throttled()
    got, want = bufs["torch"].state_dict(), bufs["jax"].state_dict()
    assert bufs["torch"].counters() == bufs["jax"].counters()
    assert set(_flatten(got)) == set(_flatten(want))
    for k, w in _flatten(want).items():
        np.testing.assert_array_equal(_flatten(got)[k], w, err_msg=k)
    for st_ in (got, want):
        buf2 = TrajBuffer(capacity=1)
        buf2.load_state_dict(st_)
        assert buf2.counters() == bufs["torch"].counters()
        assert buf2.capacity == 3 and buf2.high_watermark == 2
        a = buf2.get()
        b = _traj("torch", 2, seed=2)         # v0 shed, v1 consumed
        assert a.version == 2 and a.seq == 2
        np.testing.assert_array_equal(a.rb.response, b.rb.response)
        np.testing.assert_array_equal(a.rewards, b.rewards)
        assert a.rb.metrics == b.rb.metrics
        assert a.batch.cache_keys == b.batch.cache_keys
    t = _traj("torch", 2, seed=7)
    t.rb.n = np.array([3, 1], np.int32)
    back = Trajectory.from_state(t.to_state())
    np.testing.assert_array_equal(back.rb.n, t.rb.n)
    assert Trajectory.from_state(_traj("torch").to_state()).rb.n is None


if HAVE_HYPOTHESIS:
    OPS = st.lists(st.tuples(st.sampled_from(["put", "get"]),
                             st.integers(0, 2)), max_size=40)
else:                                                 # pragma: no cover
    OPS = None


@settings(max_examples=50, deadline=None)
@given(ops=OPS, capacity=st.integers(1, 5))
def test_prop_occupancy_bounded_and_counters_reconcile(ops, capacity):
    """The same op sequence on both packages: occupancy bounded, the
    counters reconciled (submitted == consumed + shed + occupancy) and
    equal between the packages after every op."""
    bufs = {pkg: PKGS[pkg]["buffer"](capacity=capacity) for pkg in PKGS}
    version = {0: 0, 1: 0, 2: 0}
    for op, prod in ops:
        if op == "put":
            version[prod] += 1
        for pkg, buf in bufs.items():
            if op == "put":
                buf.put(_traj(pkg, version[prod], producer=prod,
                              seed=version[prod]))
            else:
                buf.get()
            assert len(buf) <= buf.capacity
            buf.check_invariants()
        assert bufs["torch"].counters() == bufs["jax"].counters()


@settings(max_examples=50, deadline=None)
@given(versions=st.lists(st.integers(0, 100), min_size=1, max_size=20))
def test_prop_versions_monotone_per_producer(versions):
    for pkg in PKGS:
        buf = PKGS[pkg]["buffer"](capacity=4)
        last = None
        for v in versions:
            if last is not None and v < last:
                with pytest.raises(AssertionError):
                    buf.put(_traj(pkg, v, seed=v))
                continue
            buf.put(_traj(pkg, v, seed=v))
            last = v
            buf.check_invariants()
        out = []
        while (t := buf.get()) is not None:
            out.append(t.version)
        assert out == sorted(out)


# ------------------------------------------------------- the async pair


def _mixed(responses, lengths, answers):
    return _mixed_rewards(len(answers), GROUP)


@pytest.fixture
def pair(monkeypatch):
    """A function making (JAX AsyncTrainer, the port's) from the same
    parameters and keys, rewards mixed in both packages, and a log of
    every trajectory each side's ``optimize`` was handed."""
    for mod in (jax_trainer, jax_async, port_trainer, async_loop):
        monkeypatch.setattr(mod, "batch_rewards", _mixed)
    monkeypatch.setattr(async_loop, "make_key",
                        lambda seed, device=None: JaxKey(
                            jax.random.PRNGKey(seed)))

    def build(acfg, max_attempts=3, faults=None):
        jtr, tr = _trainers("qwen3-1.7b", num_kv_heads=2)
        logs = {"jax": [], "torch": []}
        for name, t in (("jax", jtr), ("torch", tr)):
            t.optimize = _logged(t.optimize, logs[name])
        jat = jax_async.AsyncTrainer(
            jtr, jax_async.AsyncConfig(**acfg),
            faults=None if faults is None else JaxFaultPlan(
                [JaxFaultEvent(**e) for e in faults]),
            sync=JaxWeightSync(JaxBackoffConfig(base=0.0,
                                                max_attempts=max_attempts),
                               sleep=lambda d: None))
        at = AsyncTrainer(
            tr, AsyncConfig(**acfg),
            faults=None if faults is None else FaultPlan(
                [FaultEvent(**e) for e in faults]),
            sync=WeightSync(BackoffConfig(base=0.0,
                                          max_attempts=max_attempts),
                            sleep=lambda d: None))
        return jat, at, logs

    return build


def _logged(optimize, log):
    def spy(rb, rewards, times, **kw):
        log.append((np.array(rb.response), np.array(rb.length),
                    kw.get("behaviour_lp") is not None))
        return optimize(rb, rewards, times, **kw)
    return spy


def _same_run(jat, at, logs, want, got):
    """Per step: JAX's trajectory tokens, lengths and branch; the step's
    metrics (times aside) within LOSS_RTOL / TOL; the counters equal; the
    async registry keys equal, and the registries' names and histogram
    sample counts."""
    assert len(logs["torch"]) == len(logs["jax"]) == len(got) == len(want)
    for step, ((jr, jl, jis), (r, n, is_)) in enumerate(
            zip(logs["jax"], logs["torch"])):
        np.testing.assert_array_equal(r, jr, err_msg=f"step {step} tokens")
        np.testing.assert_array_equal(n, jl, err_msg=f"step {step} lengths")
        assert is_ == jis, step
    for step, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (step, set(g) ^ set(w))
        for k, v in w.items():
            if k.endswith("_time") or k == "service_wait_s":
                continue
            np.testing.assert_allclose(g[k], v, rtol=LOSS_RTOL, atol=TOL,
                                       err_msg=f"step {step} {k}")
    assert at.counters() == jat.counters()
    assert at.mode == jat.mode
    reg, jreg = obs.get_registry().as_dict(), jobs.get_registry().as_dict()
    assert {k: v for k, v in reg.items() if k.startswith("async.")} == \
        {k: v for k, v in jreg.items() if k.startswith("async.")}
    # the rollout's and the trainer's hooks sample the same histograms
    assert set(reg) == set(jreg)
    assert {k: v for k, v in reg.items() if k.endswith("_count")} == \
        {k: v for k, v in jreg.items() if k.endswith("_count")}


def test_k0_pc_is_identical_to_sync_and_matches_jax(pair):
    """The §12 determinism contract: K = 0, publish_every 1, ``"pc"``:
    the port's async run equals the port's synchronous trainer exactly
    (tokens, losses, every weight) and JAX's async run in tokens, with
    metrics within tolerance."""
    steps = 3
    acfg = dict(staleness_window=0, buffer_capacity=2, schedule="pc")
    jat, at, logs = pair(acfg)
    want, got = jat.run(steps), at.run(steps)
    _same_run(jat, at, logs, want, got)
    _, tr_sync = _trainers("qwen3-1.7b", num_kv_heads=2)
    sync = [tr_sync.train_step() for _ in range(steps)]
    for ms, ma in zip(sync, got):
        assert ms["loss"] == ma["loss"] and ms["reward_mean"] == \
            ma["reward_mean"]
    np.testing.assert_array_equal(tr_sync.last_rb.response,
                                  at.trainer.last_rb.response)
    for a, b in zip(tr_sync.model.parameters(),
                    at.trainer.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(tr_sync.opt_state["mu"] + tr_sync.opt_state["nu"],
                    at.trainer.opt_state["mu"] + at.trainer.opt_state["nu"]):
        assert torch.equal(a, b)
    assert at.exact_steps == steps and at.is_steps == 0
    assert at.reverified == 0 and at.mode == "async"


def test_stale_within_window_is_corrected_like_jax(pair):
    """``"ppcc"`` at K = 2: every second step consumes a trajectory one
    version old, through the truncated importance weights."""
    jat, at, logs = pair(dict(staleness_window=2, buffer_capacity=4,
                              schedule="ppcc"))
    want, got = jat.run(4), at.run(4)
    _same_run(jat, at, logs, want, got)
    assert [m["staleness"] for m in got] == [0.0, 1.0, 0.0, 1.0]
    assert at.exact_steps == 2 and at.is_steps == 2 and at.reverified == 0
    corrected = [m for m in got if m["staleness"] > 0]
    assert all(m["is_weight_mean"] > 0 for m in corrected)


def test_beyond_window_reverifies_like_jax(pair):
    """``"ppcc"`` at K = 0: the stale trajectory is re-verified under the
    current weights through the one-pass branch (prefix reused, tail
    regenerated) with JAX's re-verified tokens."""
    jat, at, logs = pair(dict(staleness_window=0, buffer_capacity=4,
                              schedule="ppcc"))
    want, got = jat.run(4), at.run(4)
    _same_run(jat, at, logs, want, got)
    rev = [m for m in got if m.get("reverified")]
    assert len(rev) == 2 and at.buffer.shed == 0
    assert all(m["one_pass"] == 1.0 and m["n_reused"] > 0 for m in rev)
    assert all("reward_mean" in m and "collect_time" in m for m in got)


def test_persistent_sync_failure_walks_the_ladder_like_jax(pair):
    jat, at, logs = pair(dict(staleness_window=1, buffer_capacity=2,
                              hard_staleness_cap=2, schedule="pc"),
                         max_attempts=2)
    jat.sync.fail_next(10 ** 6)
    at.sync.fail_next(10 ** 6)
    want, got = jat.run(8), at.run(8)
    _same_run(jat, at, logs, want, got)
    assert at.mode == "sync" and at.degradations == 2 and at.sync_steps >= 1
    reg = obs.get_registry().as_dict()
    assert reg["async.degradation_level"] == 2.0
    assert reg["async.sync_failures"] >= 1 and reg["async.sync_retries"] >= 1
    assert at.service.version == 0           # served its last good copy


def test_publish_every_two_serves_the_published_copy(pair):
    """``publish_every=2``: between publications the service samples the
    last published weights while the trainer's have moved on."""
    jat, at, logs = pair(dict(staleness_window=2, buffer_capacity=4,
                              publish_every=2, schedule="pc"))
    want, got = jat.run(4), at.run(4)
    _same_run(jat, at, logs, want, got)
    assert [m["staleness"] for m in got] == [0.0, 1.0, 0.0, 1.0]
    assert at.sync.publishes == 2 and at.service.version == 2


def test_seeded_chaos_producer_kill_plus_failed_sync_like_jax(pair):
    jat, at, logs = pair(dict(staleness_window=2, buffer_capacity=4,
                              schedule="pc"), max_attempts=2,
                         faults=[dict(kind="kill", at_step=2),
                                 dict(kind="stall", at_step=4, count=1)])
    jat.sync.fail_next(2)
    at.sync.fail_next(2)
    want, got = jat.run(6), at.run(6)
    _same_run(jat, at, logs, want, got)
    assert at.producer_restarts == 1 and at.service.stalled_ticks == 1
    assert at.sync.failures == 1
    assert all(np.isfinite(m["loss"]) for m in got)
    reg = obs.get_registry().as_dict()
    assert reg["async.producer_restarts"] == 1.0
    assert reg["async.sync_failures"] == 1.0
    at.buffer.check_invariants()


def _port_pair():
    """The port's own AsyncTrainer with the port's own keys (the key and
    the re-verification key saved as their seeds)."""
    _, tr0 = _trainers("qwen3-1.7b", num_kv_heads=2)
    tr = Trainer(tr0.cfg, tr0.rl, SpecConfig(), _datasets()[1],
                 make_key(0, "cpu"), model=tr0.model, device="cpu")
    return AsyncTrainer(tr, AsyncConfig(staleness_window=1,
                                        buffer_capacity=4, schedule="ppc"),
                        sync=WeightSync(BackoffConfig(base=0.0),
                                        sleep=lambda d: None))


def test_kill_and_resume_is_byte_identical(tmp_path, monkeypatch):
    for mod in (port_trainer, async_loop):
        monkeypatch.setattr(mod, "batch_rewards", _mixed)
    at = _port_pair()
    at.run(2)
    assert len(at.buffer) >= 1
    at.save(str(tmp_path))
    at2 = _port_pair()
    assert at2.restore(str(tmp_path))
    f1, f2 = _flatten(at.state_dict()), _flatten(at2.state_dict())
    assert list(f1) == list(f2)
    for k in f1:
        assert f1[k].dtype == f2[k].dtype, k
        assert f1[k].tobytes() == f2[k].tobytes(), k
    assert at2.version == at.version
    assert at2.service.version == at.service.version
    assert at2.trainer.key.seed == at.trainer.key.seed
    assert at2._reverify_key.seed == at._reverify_key.seed
    m1, m2 = at.run(2), at2.run(2)
    assert [m["loss"] for m in m1] == [m["loss"] for m in m2]
    np.testing.assert_array_equal(at.trainer.last_rb.response,
                                  at2.trainer.last_rb.response)
    for a, b in zip(at.trainer.model.parameters(),
                    at2.trainer.model.parameters()):
        assert torch.equal(a, b)


def test_restore_on_empty_dir_is_a_fresh_start(tmp_path):
    at = _port_pair()
    assert not at.restore(str(tmp_path / "nothing"))
    # the bootstrap install is a copy: equal to the trainer's weights, no
    # storage shared with them
    for (name, p), q in zip(at.trainer.model.named_parameters(),
                            at.service.model.parameters()):
        assert torch.equal(p, q) and p.data_ptr() != q.data_ptr(), name
