"""The port's kernel ops on the CPU (their plain versions) against the JAX
package's kernels run in Pallas interpret mode and against their jnp
references, on the same numpy inputs.

Tolerances: the attentions (dense and paged decode, flash) agree to atol
1e-5 (float32 softmax attention summed in another order: a few ulps of
values of order 1); spec_verify, cache_roll, cache_slot_write,
paged_slot_write and paged_gather are compared exactly, and the paged
decode equals the port's own dense plain version on the gathered view
exactly."""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.cache_gather.ops import cache_roll as jax_cache_roll  # noqa: E402
from repro.kernels.cache_gather.ops import paged_gather as jax_paged_gather  # noqa: E402
from repro.kernels.cache_slot_write import ops as jax_slot_ops  # noqa: E402
from repro.kernels.decode_attention.ops import \
    decode_attention as jax_decode_attention  # noqa: E402
from repro.kernels.decode_attention.ops import \
    paged_decode_attention as jax_paged_decode_attention  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels.spec_verify.ops import spec_verify as jax_spec_verify  # noqa: E402
from repro_torch.kernels.cache_gather.ops import cache_roll, paged_gather  # noqa: E402
from repro_torch.kernels.cache_slot_write.ops import (  # noqa: E402
    cache_slot_write, paged_slot_write)
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention, decode_attention_plain, gather_paged_kv,
    paged_decode_attention)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.engine import sampling  # noqa: E402
from repro_torch.kernels.spec_verify import ops as sv_ops  # noqa: E402
from repro_torch.kernels.spec_verify.ops import spec_verify  # noqa: E402

ATOL = 1e-5
# reduced qwen3-1.7b with num_kv_heads=2: 4 query heads, 2 KV heads (G=2),
# head_dim 64
HQ, HKV, D = 4, 2, 64


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
    return torch.from_numpy(np.asarray(a))


def _decode_case(T, S=48, B=5, seed=0):
    """Left-padded caches with mixed depths.  Row 0 is done (all queries at
    -1), row 1 fills the cache, row 2 has a short valid query prefix (the
    draft-block contract: queries at consecutive positions, -1 after)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HQ, T, D), dtype=np.float32)
    k = rng.standard_normal((B, HKV, S, D), dtype=np.float32)
    v = rng.standard_normal((B, HKV, S, D), dtype=np.float32)
    k_pos = np.full((B, S), -1, np.int32)
    q_pos = np.full((B, T), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    starts = np.zeros(B, np.int32)
    for b in range(B):
        live = S if b == 1 else int(rng.integers(T + 2, S))
        pad = int(rng.integers(0, live - T - 1))
        k_pos[b, pad:live] = np.arange(live - pad)
        lengths[b], starts[b] = live, pad
        q_len = 0 if b == 0 else (max(T // 2, 1) if b == 2 else T)
        q_pos[b, :q_len] = live - pad - T + np.arange(q_len)
    return q, k, v, q_pos, k_pos, lengths, starts


@pytest.mark.parametrize("T", [1, 4, 9, 16, 64])
@pytest.mark.parametrize("window", [0, 16])
def test_decode_attention_plain_matches_jax(T, window):
    """T = 9, 16 and 64 are draft-verify blocks at G = 2 (G * T = 18, 32
    and 128, the kernels' query chunks); their cache is wider than the
    block."""
    S = 48 if T <= 4 else 2 * T + 24
    q, k, v, q_pos, k_pos, lengths, starts = _decode_case(T, S=S,
                                                          seed=T + window)
    got = decode_attention(_t(q), _t(k), _t(v), _t(q_pos), _t(k_pos),
                           _t(lengths), _t(starts), window=window).numpy()
    args = tuple(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos, lengths,
                                          starts))
    for impl in ("interpret", "naive"):
        want = np.asarray(jax_decode_attention(*args, window=window,
                                               impl=impl, block_k=16))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.all(got[0] == 0.0)                 # done row: exactly zero
    if T > 1:
        assert np.all(got[2, :, T // 2:] == 0.0)  # padded queries: zero


@pytest.mark.parametrize("window", [0, 8])
def test_flash_attention_plain_matches_jax(window):
    rng = np.random.default_rng(7 + window)
    B, T, S = 3, 24, 40
    q = rng.standard_normal((B, HQ, T, D), dtype=np.float32)
    k = rng.standard_normal((B, HKV, S, D), dtype=np.float32)
    v = rng.standard_normal((B, HKV, S, D), dtype=np.float32)
    # verify layout: left-padded prompt + right-padded draft over slots
    # [0, T), empty cache slots after; row 2 is all padding
    q_pos = np.full((B, T), -1, np.int32)
    k_pos = np.full((B, S), -1, np.int32)
    for b, (pad, valid) in enumerate([(3, 18), (0, T), (0, 0)]):
        q_pos[b, pad:pad + valid] = np.arange(valid)
        k_pos[b, :T] = q_pos[b]
    got = flash_attention(_t(q), _t(k), _t(v), _t(q_pos), _t(k_pos),
                          window=window).numpy()
    args = tuple(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos))
    for impl in ("interpret", "ref"):
        want = np.asarray(jax_flash_attention(*args, window=window, impl=impl,
                                              block_q=8, block_k=16))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.all(got[2] == 0.0)


def _flash_regime_case(regime, seed):
    """``peaked``: q scaled by 8, so the largest logit of a row is in the
    tens and the softmax weights span many binades (where rounding P shows
    most).  ``ragged``: T = 70 and S = 130 (no multiple of any tile),
    G = 2 at D = 64, a row of only padding, a left-padded row and a row
    whose draft stops early, keys past T empty."""
    rng = np.random.default_rng(seed)
    B, T, S = (3, 40, 56) if regime == "peaked" else (4, 70, 130)
    q = rng.standard_normal((B, HQ, T, D), dtype=np.float32)
    if regime == "peaked":
        q *= 8.0
    k = rng.standard_normal((B, HKV, S, D), dtype=np.float32)
    v = rng.standard_normal((B, HKV, S, D), dtype=np.float32)
    q_pos = np.full((B, T), -1, np.int32)
    k_pos = np.full((B, S), -1, np.int32)
    spans = [(0, T), (5, T - 5), (0, 0), (11, 33)][:B]
    for b, (pad, valid) in enumerate(spans):
        q_pos[b, pad:pad + valid] = np.arange(valid)
        k_pos[b, :T] = q_pos[b]
    return q, k, v, q_pos, k_pos


@pytest.mark.parametrize("regime", ["peaked", "ragged"])
@pytest.mark.parametrize("window", [0, 8])
def test_flash_attention_plain_matches_jax_regimes(regime, window):
    q, k, v, q_pos, k_pos = _flash_regime_case(regime, 11 + window)
    got = flash_attention(_t(q), _t(k), _t(v), _t(q_pos), _t(k_pos),
                          window=window).numpy()
    args = tuple(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos))
    for impl in ("interpret", "ref"):
        want = np.asarray(jax_flash_attention(*args, window=window, impl=impl,
                                              block_q=16, block_k=32))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    seen = ((k_pos[:, None, :] >= 0) & (k_pos[:, None, :] <= q_pos[:, :, None])
            ).any(-1)                                        # (B, T)
    assert np.all(got.transpose(0, 2, 1, 3)[~seen] == 0.0)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8),
                                           (False, 0), (False, 8)])
def test_live_key_tiles_cover_every_visible_pair(causal, window):
    """The kernel's tile list (its Python twin) against a brute-force count
    of visible (query, key) pairs: every visible pair lies in a listed tile,
    a tile with none is listed only where the rule's bounds are loose, and
    a causal query tile of padding only lists nothing."""
    q, k, v, q_pos, k_pos = _flash_regime_case("ragged", 3)
    T, S = q_pos.shape[1], k_pos.shape[1]
    q_pos = np.concatenate([q_pos, np.full((q_pos.shape[0], 64), -1,
                                           np.int32)], 1)  # a padding tile
    T += 64
    qp, kp = q_pos[:, :, None], k_pos[:, None, :]
    vis = kp >= 0
    if causal:
        vis = vis & (kp <= qp)
    if window > 0:
        vis = vis & (qp - kp < window)
    live = flash_ops.live_key_tiles(_t(q_pos), _t(k_pos), causal=causal,
                                    window=window).numpy()
    BQ, BK = flash_ops.BQ, flash_ops.BK
    assert live.shape == (q_pos.shape[0], -(-T // BQ), -(-S // BK))
    for b in range(vis.shape[0]):
        for i in range(live.shape[1]):
            for j in range(live.shape[2]):
                pairs = int(vis[b, i * BQ:(i + 1) * BQ, j * BK:(j + 1) * BK].sum())
                assert pairs == 0 or live[b, i, j], (b, i, j, pairs)
    if causal:
        assert not live[:, -1].any()                   # the padding tile
        assert not live[2].any()                       # the row of padding
    assert live.sum() < live.size                      # something skipped


def test_flash_kernel_refuses_what_it_cannot_take():
    """The kernel entry raises before any launch on inputs outside the
    kernel's contract (meta tensors: the checks need no card)."""
    meta = dict(device="meta")
    bf = dict(dtype=torch.bfloat16, **meta)
    i32 = dict(dtype=torch.int32, **meta)
    q = torch.empty(2, HQ, 8, D, **bf)
    too_long = flash_ops.MAX_KEYS + 64
    kv = torch.empty(2, HKV, too_long, D, **bf)
    with pytest.raises(ValueError, match="at most"):
        flash_ops.flash_attention_cuda(q, kv, kv, torch.empty(2, 8, **i32),
                                       torch.empty(2, too_long, **i32))
    # one limit, 131,072 keys, with a window as without one
    assert flash_ops.MAX_KEYS == 131_072
    with pytest.raises(ValueError, match="at most 131072 keys"):
        flash_ops.flash_attention_cuda(q, kv, kv, torch.empty(2, 8, **i32),
                                       torch.empty(2, too_long, **i32),
                                       window=4096)
    kv = torch.empty(2, HKV, 16, D, **bf)
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention_cuda(torch.empty(2, HQ, 8, 32, **bf),
                                       torch.empty(2, HKV, 16, 32, **bf),
                                       torch.empty(2, HKV, 16, 32, **bf),
                                       torch.empty(2, 8, **i32),
                                       torch.empty(2, 16, **i32))
    with pytest.raises(TypeError, match="bfloat16"):
        flash_ops.flash_attention_cuda(q.float(), kv, kv,
                                       torch.empty(2, 8, **i32),
                                       torch.empty(2, 16, **i32))


@pytest.mark.parametrize("log_lenience", [0.0, np.log(0.8), 0.5])
def test_spec_verify_plain_matches_jax_exactly(log_lenience):
    rng = np.random.default_rng(11)
    B, N = 9, 37
    lp_prev = (-rng.exponential(2.0, (B, N))).astype(np.float32)
    lp_curr = (lp_prev + rng.normal(0, 1.5, (B, N))).astype(np.float32)
    u = rng.uniform(size=(B, N)).astype(np.float32)
    valid = np.array([0, N, 1, 5, 20, 36, 37, 3, 12], np.int32)
    got = spec_verify(_t(lp_curr), _t(lp_prev), _t(u), _t(valid),
                      float(log_lenience)).numpy()
    args = tuple(jnp.asarray(a) for a in (lp_curr, lp_prev, u, valid))
    for impl in ("interpret", "ref"):
        want = np.asarray(jax_spec_verify(*args, float(log_lenience),
                                          impl=impl, block_t=16))
        np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert np.any((got > 0) & (got < valid))      # some partial accepts


@pytest.mark.parametrize("log_lenience", [0.0, np.log(0.8)])
def test_spec_verify_plain_takes_int32_and_int64_lengths(log_lenience):
    """The callers' lengths come as int32 or int64: the same answer either
    way, and both equal to JAX's kernel in interpret mode (lengths of 0,
    of the whole draft and in between)."""
    rng = np.random.default_rng(12)
    B, N = 7, 40
    lp_prev = (-rng.exponential(2.0, (B, N))).astype(np.float32)
    lp_curr = (lp_prev + rng.normal(0, 1.0, (B, N))).astype(np.float32)
    u = rng.uniform(size=(B, N)).astype(np.float32)
    valid = np.array([0, N, 1, 9, 23, 39, 17], np.int32)
    args = tuple(_t(a) for a in (lp_curr, lp_prev, u))
    got32 = spec_verify(*args, _t(valid), float(log_lenience))
    got64 = spec_verify(*args, _t(valid.astype(np.int64)), float(log_lenience))
    assert got32.dtype == got64.dtype == torch.int32
    np.testing.assert_array_equal(got32.numpy(), got64.numpy())
    want = np.asarray(jax_spec_verify(
        *(jnp.asarray(a) for a in (lp_curr, lp_prev, u, valid)),
        float(log_lenience), impl="interpret", block_t=16))
    np.testing.assert_array_equal(got64.numpy(), want)


def test_spec_verify_kernel_refuses_what_it_cannot_take():
    """The kernel entry raises before any launch on what the kernel cannot
    take (meta tensors): another dtype of the log-probs or of the lengths,
    a non-contiguous input, shapes that do not match."""
    meta = dict(device="meta")
    f32 = dict(dtype=torch.float32, **meta)
    x = torch.empty(4, 16, **f32)
    vl = torch.empty(4, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="float32"):
        sv_ops.spec_verify_cuda(x.double(), x, x, vl, 0.0)
    with pytest.raises(ValueError, match="int32 or int64"):
        sv_ops.spec_verify_cuda(x, x, x, vl.to(torch.int16), 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        sv_ops.spec_verify_cuda(x, torch.empty(16, 4, **f32).t(), x, vl, 0.0)
    with pytest.raises(ValueError, match="valid_len"):
        sv_ops.spec_verify_cuda(x, x, x, torch.empty(5, dtype=torch.int64,
                                                     **meta), 0.0)
    with pytest.raises(ValueError, match="lp_prev"):
        sv_ops.spec_verify_cuda(x, torch.empty(4, 15, **f32), x, vl, 0.0)


@pytest.mark.parametrize("seeds", [(0, 1), (6, 7)])
def test_adjacent_seeds_draw_different_noise(seeds):
    """A key's draw uses all 64 bits of its seed: adjacent seeds (which
    differ only in the lowest bit) draw different noise, as JAX's
    PRNGKey(0) and PRNGKey(1) do, and the same seed draws the same."""
    a, b = (sampling.make_key(s, "cpu") for s in seeds)
    ua, ub = a.uniform((64,)), b.uniform((64,))
    assert not torch.equal(ua, ub)
    assert not torch.equal(a.gumbel((8,)), b.gumbel((8,)))
    torch.testing.assert_close(sampling.make_key(seeds[0], "cpu").uniform((64,)),
                               ua, rtol=0, atol=0)


@pytest.mark.parametrize("seeds", [(0, 2 ** 32), (5, 5 + 2 ** 40)])
def test_seeds_apart_in_the_high_word_draw_different_noise_on_cpu(seeds):
    """The CPU generator reads 32 bits of a seed: the key folds the high
    word into them, so seeds that differ only above bit 31 draw different
    noise there too."""
    a, b = (sampling.make_key(s, "cpu") for s in seeds)
    assert not torch.equal(a.uniform((64,)), b.uniform((64,)))


def test_a_seed_above_2_to_the_63_seeds_a_key():
    """A seed above 2**63 (a split of any key may give one) seeds a
    generator, and its neighbour below draws other noise."""
    big = 2 ** 64 - 1
    draw = sampling.make_key(big, "cpu").uniform((16,))
    assert bool(torch.isfinite(draw).all())
    assert not torch.equal(draw, sampling.make_key(big - 1, "cpu").uniform((16,)))


def test_cache_roll_plain_matches_jax_exactly():
    rng = np.random.default_rng(5)
    R, S = 12, 40
    buf = rng.standard_normal((R, S, D), dtype=np.float32)
    shift = rng.integers(0, S + 1, R).astype(np.int32)
    shift[:2] = (0, S)
    got = cache_roll(_t(buf), _t(shift)).numpy()
    for impl in ("interpret", "ref"):
        want = np.asarray(jax_cache_roll(jnp.asarray(buf), jnp.asarray(shift),
                                         impl=impl))
        np.testing.assert_array_equal(got, want)


def test_cache_slot_write_plain_matches_jax_exactly():
    """Duplicate destinations with different sources: the last source row
    wins in both; untouched rows stay bit-identical, written in place."""
    rng = np.random.default_rng(13)
    Rd, Rs, S = 10, 6, 12
    dst = rng.standard_normal((Rd, S, D), dtype=np.float32)
    src = rng.standard_normal((Rs, S, D), dtype=np.float32)
    dst_rows = np.array([7, 2, 7, 0, 2, 7], np.int32)
    got = _t(dst.copy())
    out = cache_slot_write(got, _t(src), _t(dst_rows))
    assert out is got                                # in place
    for impl in ("interpret", "ref"):
        want = np.asarray(jax_slot_ops.cache_slot_write(
            jnp.asarray(dst), jnp.asarray(src), jnp.asarray(dst_rows),
            impl=impl))
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[7].numpy(), src[5])   # last wins
    np.testing.assert_array_equal(got[2].numpy(), src[4])
    untouched = [r for r in range(Rd) if r not in dst_rows]
    np.testing.assert_array_equal(got.numpy()[untouched], dst[untouched])


def test_paged_slot_write_plain_matches_jax_exactly():
    rng = np.random.default_rng(17)
    run, NB, bs, nb, R = 2, 11, 4, 3, 2
    pool = rng.standard_normal((run, NB, HKV, bs, D), dtype=np.float32)
    src = rng.standard_normal((run, R, HKV, nb * bs, D), dtype=np.float32)
    tables = np.stack([rng.permutation(NB)[:R * nb].reshape(R, nb)
                       for _ in range(run)]).astype(np.int32)
    got = _t(pool.copy())
    paged_slot_write(got, _t(src), _t(tables))
    for impl in ("interpret", "ref"):
        want = np.asarray(jax_slot_ops.paged_slot_write(
            jnp.asarray(pool), jnp.asarray(src), jnp.asarray(tables),
            impl=impl))
        np.testing.assert_array_equal(got.numpy(), want)


def test_paged_gather_plain_matches_jax_exactly():
    rng = np.random.default_rng(19)
    NB, X, R, nb = 9, 8, 4, 3
    pool = rng.standard_normal((NB, X, D), dtype=np.float32)
    table = rng.integers(0, NB, (R, nb)).astype(np.int32)
    got = paged_gather(_t(pool), _t(table)).numpy()
    for impl in ("interpret", "ref"):
        want = np.asarray(jax_paged_gather(jnp.asarray(pool),
                                           jnp.asarray(table), impl=impl))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T", [1, 3, 9, 16, 64])
@pytest.mark.parametrize("window", [0, 8])
def test_paged_decode_attention_plain_matches_jax(T, window):
    """Pools behind a shuffled block table; a logical width short of the
    block-rounded one (k_pos padded with -1 inside); row 0 done, row 3
    with no live slot.  Within 1e-5 of JAX's paged kernel in interpret
    mode, and exactly the port's dense plain version on the gathered
    view.  T = 9, 16 and 64 are draft-verify blocks at G = 2, over a wider
    logical cache (also short of its block-rounded width)."""
    S = 45 if T <= 3 else 2 * T + 21
    q, _, _, q_pos, k_pos, lengths, starts = _decode_case(T, S=S, B=5,
                                                          seed=29 + T)
    bs, B = 8, 5
    nb = -(-S // bs)                                # 6 blocks of 8 = 48 > 45
    rng = np.random.default_rng(T + window)
    NB = B * nb + 3
    k_pool = rng.standard_normal((NB, HKV, bs, D), dtype=np.float32)
    v_pool = rng.standard_normal((NB, HKV, bs, D), dtype=np.float32)
    table = rng.permutation(NB)[:B * nb].reshape(B, nb).astype(np.int32)
    lengths[3] = starts[3]
    got = paged_decode_attention(_t(q), _t(k_pool), _t(v_pool), _t(table),
                                 _t(q_pos), _t(k_pos), _t(lengths),
                                 _t(starts), window=window).numpy()
    want = np.asarray(jax_paged_decode_attention(
        *(jnp.asarray(a) for a in (q, k_pool, v_pool, table, q_pos, k_pos,
                                   lengths, starts)),
        window=window, impl="interpret"))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    k = gather_paged_kv(_t(k_pool), _t(table), S)
    v = gather_paged_kv(_t(v_pool), _t(table), S)
    dense = decode_attention_plain(_t(q), k, v, _t(q_pos), _t(k_pos),
                                   _t(lengths), _t(starts), window=window)
    np.testing.assert_array_equal(got, dense.numpy())
    assert np.all(got[0] == 0.0) and np.all(got[3] == 0.0)


@pytest.mark.parametrize("layout,tile", [("dense", dec_ops.DENSE_TILE),
                                         ("paged", 32), ("paged", 64)])
@pytest.mark.parametrize("C", [1, 3, 4])
def test_decode_work_ranges_cover_each_live_slot_once(layout, tile, C):
    """The decode kernels' work partition (its Python twin) against brute
    force: every live slot of a row with a live query lies in exactly one
    block's tiles, no block fetches a tile without a live slot or past the
    cache, the shares differ by at most one tile, and a row with an empty
    span or no live query fetches nothing.  Spans: random, empty, one
    slot, the whole cache, off tile edges, lengths past S."""
    rng = np.random.default_rng(C + tile)
    S = 576 if layout == "dense" else 18 * tile
    n_rand = 40
    st = rng.integers(0, S, n_rand)
    ln = st + rng.integers(0, S, n_rand)
    fixed = [(0, 0), (7, 7), (9, 3), (0, S), (0, S + 5), (S - 1, S),
             (tile - 1, tile + 1), (tile, 2 * tile), (5, 6), (3, 2 * tile + 3)]
    st = np.concatenate([st, [a for a, _ in fixed], [4, 4]])
    ln = np.concatenate([ln, [b for _, b in fixed], [200, 200]])
    B = st.size
    q_pos = np.zeros((B, 2), np.int32)
    q_pos[-1] = -1                      # no live query: nothing fetched
    q_pos[-2, 1] = -1                   # one live query: fetched
    ranges = dec_ops.decode_work_ranges(_t(st), _t(ln), S, tile, C,
                                        q_pos=_t(q_pos)).numpy()
    assert ranges.shape == (B, C, 2)
    for b in range(B):
        lo_s, hi_s = min(st[b], S), min(ln[b], S)
        live_row = hi_s > lo_s and b != B - 1
        owner = np.zeros(S, np.int64)
        counts = []
        for c in range(C):
            t_lo, t_hi = ranges[b, c]
            counts.append(t_hi - t_lo)
            for t in range(t_lo, t_hi):
                assert 0 <= t < -(-S // tile), (b, c, t)
                a, z = max(t * tile, lo_s), min((t + 1) * tile, hi_s)
                assert z > a, f"row {b} block {c} fetches dead tile {t}"
                owner[a:z] += 1
        want = np.zeros(S, np.int64)
        if live_row:
            want[lo_s:hi_s] = 1
        np.testing.assert_array_equal(owner, want, err_msg=f"row {b}")
        assert max(counts) - min(counts) <= 1
        assert live_row or sum(counts) == 0


def test_decode_cluster_size_puts_a_block_on_every_sm():
    """The wrappers' cluster: the smallest C that puts a block on every SM,
    within the kernels' cap for G * T, never more than a row has tiles."""
    for rows, n_tiles, gt in ((128, 18, 2), (64, 18, 2), (16, 10, 4),
                              (16, 10, 8), (4, 3, 16), (1, 1, 2),
                              (512, 18, 2)):
        got = dec_ops.cluster_size(rows, n_tiles, 132, gt)
        cap = min(dec_ops.cluster_cap(gt), n_tiles)
        assert 1 <= got <= cap
        assert rows * got >= 132 or got == cap
        assert got == 1 or rows * (got - 1) < 132
    assert dec_ops.cluster_size(128, 18, 132, 2) == 2    # the epoch-1 step


def test_decode_kernels_refuse_what_they_cannot_take():
    """Both decode kernel entries raise before any launch on inputs outside
    the kernels' contract (meta tensors: the checks need no card)."""
    meta = dict(device="meta")
    bf = dict(dtype=torch.bfloat16, **meta)
    i32 = dict(dtype=torch.int32, **meta)
    B, S = 2, 64

    def dense(q=None, kv=None, q_pos=None, k_pos=None, lengths=None):
        q = torch.empty(B, HQ, 1, D, **bf) if q is None else q
        kv = torch.empty(B, HKV, S, q.shape[-1], **bf) if kv is None else kv
        T = q.shape[2]
        dec_ops.decode_attention_cuda(
            q, kv, kv, torch.empty(B, T, **i32) if q_pos is None else q_pos,
            torch.empty(B, kv.shape[2], **i32) if k_pos is None else k_pos,
            torch.empty(B, **i32) if lengths is None else lengths,
            torch.empty(B, **i32))

    def paged(bs=32, q=None, table=None):
        q = torch.empty(B, HQ, 1, D, **bf) if q is None else q
        pool = torch.empty(6, HKV, bs, q.shape[-1], **bf)
        dec_ops.paged_decode_attention_cuda(
            q, pool, pool, torch.empty(B, 3, **i32) if table is None else table,
            torch.empty(B, q.shape[2], **i32), torch.empty(B, 3 * bs, **i32),
            torch.empty(B, **i32), torch.empty(B, **i32))

    with pytest.raises(ValueError, match="head_dim"):
        dense(q=torch.empty(B, HQ, 1, 32, **bf))
    too_many = dec_ops.MAX_GT // (HQ // HKV) + 1          # G * T > MAX_GT
    with pytest.raises(ValueError, match=f"at most {dec_ops.MAX_GT}"):
        dense(q=torch.empty(B, HQ, too_many, D, **bf))
    with pytest.raises(TypeError, match="bfloat16"):
        dense(q=torch.empty(B, HQ, 1, D, dtype=torch.float32, **meta))
    with pytest.raises(ValueError, match="q_pos"):
        dense(q_pos=torch.empty(B, 1, dtype=torch.int64, **meta))
    with pytest.raises(ValueError, match="lengths"):
        dense(lengths=torch.empty(B, 1, **i32))
    with pytest.raises(ValueError, match="k_pos"):
        dense(k_pos=torch.empty(B, S + 1, **i32))
    with pytest.raises(ValueError, match="contiguous"):
        dense(kv=torch.empty(B, HKV, D, S, **bf).transpose(2, 3))
    with pytest.raises(ValueError, match="do not match"):
        dense(kv=torch.empty(B, HKV, 0, D, **bf))          # an empty cache
    with pytest.raises(ValueError, match="block size"):
        paged(bs=16)
    with pytest.raises(ValueError, match="head_dim"):
        paged(q=torch.empty(B, HQ, 1, 32, **bf))
    with pytest.raises(ValueError, match=f"at most {dec_ops.MAX_GT}"):
        paged(q=torch.empty(B, HQ, too_many, D, **bf))
    with pytest.raises(ValueError, match="table"):
        paged(table=torch.empty(B, 3, dtype=torch.int64, **meta))


def test_wrappers_raise_on_a_device_without_a_kernel():
    """Only CPU tensors take the plain version; any other device without a
    kernel raises instead of falling back."""
    meta = dict(device="meta")
    q = torch.empty(2, HQ, 1, D, **meta)
    kv = torch.empty(2, HKV, 8, D, **meta)
    pos = torch.empty(2, 8, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="no kernel"):
        decode_attention(q, kv, kv, torch.empty(2, 1, dtype=torch.int32,
                                                **meta), pos)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(torch.empty(2, HQ, 8, D, **meta), kv, kv, pos, pos)
    with pytest.raises(ValueError, match="no kernel"):
        spec_verify(torch.empty(2, 8, **meta), torch.empty(2, 8, **meta),
                    torch.empty(2, 8, **meta),
                    torch.empty(2, dtype=torch.int32, **meta), 0.0)
    with pytest.raises(ValueError, match="no kernel"):
        cache_roll(torch.empty(4, 8, D, **meta),
                   torch.empty(4, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="no kernel"):
        cache_slot_write(torch.empty(4, 8, D, **meta),
                         torch.empty(2, 8, D, **meta),
                         torch.zeros(2, dtype=torch.int64, **meta))
    table = torch.zeros(2, 2, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="no kernel"):
        paged_gather(torch.empty(4, 8, D, **meta), table)
    pool = torch.empty(4, HKV, 4, D, **meta)
    with pytest.raises(ValueError, match="no kernel"):
        paged_decode_attention(q, pool, pool, table,
                               torch.empty(2, 1, dtype=torch.int32, **meta),
                               pos)
