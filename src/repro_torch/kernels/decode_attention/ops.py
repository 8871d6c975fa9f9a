"""Short-query decode attention over a dense or a paged cache (port of
``repro/kernels/decode_attention``).

``decode_attention`` launches the CUDA kernel (``csrc/decode_attention.cu``,
which replaces ``decode_attention_pallas``,
``repro/kernels/decode_attention/kernel.py:193``) on CUDA tensors and runs
``decode_attention_plain`` on CPU tensors.  Every decode token of every
layer of a dense cache comes here, GQA's at Dk = Dv = 64 or 128 and MLA's
decompressed heads at Dk = 192, Dv = 128 (``HEAD_DIMS``).

``paged_decode_attention`` is the same function with K/V read from a block
pool through a block table; it launches ``csrc/paged_decode_attention.cu``
(which replaces ``paged_decode_attention_pallas``,
``repro/kernels/decode_attention/kernel.py:120``) on CUDA tensors and runs
``paged_decode_attention_plain`` (gather, then the dense plain version) on
CPU tensors.  Every decode token of a paged GQA cache comes here, at Dk =
Dv (``PAGED_HEAD_DIMS``: MLA's paged reads go through the dense gather).

Both kernels are one launch of (C, Hkv * nq, B) blocks in clusters of C:
a KV head's G * T packed queries go in nq = ceil(G * T / 16) chunks of at
most ``QUERY_CHUNK`` = 16 (nq = 1 up to G * T = 16; a draft-verify block
of T = k + 1 <= JAX's ``DECODE_BLOCK_MAX_T`` = 64 at up to G = 64 query
heads a KV head takes up to G * T = ``MAX_GT`` = 4096: granite-34b's G =
48 at T = 9 is 432 queries, 27 chunks); the C blocks of a (row, KV head,
chunk) share the row's live tiles (``decode_work_ranges`` is their
partition, the same for every chunk) and merge their softmax partials
through shared memory; ``cluster_size`` picks C.  The wrappers allocate only the output, and count
their launches by T in ``DECODE_LAUNCHES_BY_T`` beside ``LAUNCHES``.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import DECODE_LAUNCHES_BY_T, LAUNCHES, refuse_grad
from repro_torch.kernels._build import launch

NEG_INF = -1e30
DENSE_TILE = 32       # cache slots a tile of the dense kernel (one bulk copy)
QUERY_CHUNK = 16      # packed queries a block of the kernels takes
MAX_GT = 4096         # G * T queries per KV head the kernels take
# (Dk, Dv) the dense kernel is built for: GQA's heads, and MLA's
# decompressed ones (nope 128 + rope 64 against a v of 128)
HEAD_DIMS = ((64, 64), (128, 128), (192, 128))
PAGED_HEAD_DIMS = ((64, 64), (128, 128))


def cluster_cap(gt: int) -> int:
    """The kernels' largest cluster for G * T queries a KV head (rank 0
    keeps a slot of shared memory for each peer's partial):
    ``decode_attn::cluster_cap`` in ``csrc/decode_attention.cuh``."""
    return 4 if gt <= 4 else 2


def query_chunks(gt: int) -> int:
    """The chunks of ``QUERY_CHUNK`` packed queries a KV head's G * T
    queries take (1 up to 16)."""
    return -(-gt // QUERY_CHUNK)


def cluster_size(rows: int, n_tiles: int, sms: int, gt: int) -> int:
    """The blocks C that share one (row, KV head, query chunk): the
    smallest C that puts a block on every SM (``rows * C >= sms``, rows =
    B * Hkv * ``query_chunks(gt)``), within
    ``cluster_cap(gt)`` and no more than a row has tiles.  More blocks than
    SMs only add merging (``tools/decode_attention_ab.py`` sweeps C).  From
    shapes only: it reads nothing on the device."""
    want = -(-sms // max(rows, 1))
    return max(1, min(want, cluster_cap(gt), n_tiles))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_work_ranges(starts, lengths, S: int, tile: int, C: int,
                       q_pos=None) -> torch.Tensor:
    """The kernels' work partition, (B, C, 2) int64: block c of row b's
    cluster fetches tiles [lo, hi), tile t holding slots [t * tile,
    (t + 1) * tile) of which it copies only those in [starts, lengths).  A
    row's live tiles, [starts // tile, ceil(lengths / tile)), are cut into
    C shares of whole tiles (block c from first + c * n // C up to first +
    (c + 1) * n // C); a row with lengths <= starts, or (given q_pos (B, T))
    none of whose queries has a position, fetches nothing.  starts and
    lengths are clamped to [0, S] as the wrappers clamp them."""
    st = torch.clamp(torch.as_tensor(starts).reshape(-1).long().cpu(), 0, S)
    ln = torch.clamp(torch.as_tensor(lengths).reshape(-1).long().cpu(), 0, S)
    live = ln > st
    if q_pos is not None:
        qp = torch.as_tensor(q_pos).reshape(st.numel(), -1).cpu()
        live &= (qp >= 0).any(1)
    first = st // tile
    n = torch.where(live, -(-ln // tile) - first, torch.zeros_like(first))
    c = torch.arange(C)[None, :]
    lo = first[:, None] + c * n[:, None] // C
    hi = first[:, None] + (c + 1) * n[:, None] // C
    return torch.stack([lo, hi], -1)


def _norm_inputs(q, q_pos, lengths, starts, S):
    """q_pos -> (B, T) int32 (a (B,) position only at T == 1);
    lengths/starts -> (B,) int32 clipped to [0, S] (None = [0, S))."""
    B, _, T = q.shape[:3]
    q_pos = q_pos.reshape(B, -1).to(torch.int32)
    if q_pos.shape != (B, T):
        raise ValueError(f"q_pos {tuple(q_pos.shape)} must be (B, T)="
                         f"{(B, T)} for T > 1 query blocks")
    dev = q.device
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    lengths = torch.clamp(torch.as_tensor(lengths, device=dev).reshape(-1)
                          .expand(B).to(torch.int32), max=S)
    if starts is None:
        starts = torch.zeros((B,), dtype=torch.int32, device=dev)
    starts = torch.clamp(torch.as_tensor(starts, device=dev).reshape(-1)
                         .expand(B).to(torch.int32), 0, S)
    return q_pos.contiguous(), lengths.contiguous(), starts.contiguous()


def decode_attention_plain(q, k, v, q_pos, k_pos, lengths, starts, *,
                           window: int = 0) -> torch.Tensor:
    """The naive oracle (``repro/kernels/decode_attention/ref.py``): full
    masked softmax over the cache in float32.  q_pos (B, T), lengths and
    starts (B,) as ``_norm_inputs`` leaves them.  Returns (B, Hq, T, Dv)."""
    B, Hq, T, Dk = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, T, Dk).float()
    scores = torch.einsum("bhgtd,bhsd->bhgts", qg, k.float()) * (
        1.0 / math.sqrt(Dk))
    kp = k_pos[:, None, None, None, :]
    qp = q_pos[:, None, None, :, None]
    mask = (kp >= 0) & (kp <= qp)
    if window > 0:
        mask &= (qp - kp) < window
    j = torch.arange(S, dtype=torch.int32, device=q.device)
    mask &= j < lengths[:, None, None, None, None]
    mask &= j >= starts[:, None, None, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    w = torch.where(mask.any(dim=-1, keepdim=True), w, torch.zeros_like(w))
    out = torch.einsum("bhgts,bhsd->bhgtd", w, v.float())
    return out.reshape(B, Hq, T, v.shape[-1])


def _check_common(q, q_pos, lengths, starts, G, dims, allowed, name) -> None:
    """What both kernels require of q, the head dims (Dk, Dv) and the
    per-row inputs."""
    B, _, T, _ = q.shape
    if dims not in allowed:
        raise ValueError(f"{name} kernel takes head_dim pairs (Dk, Dv) in "
                         f"{allowed}, got {dims}")
    if G * T > MAX_GT:
        raise ValueError(f"{name} kernel takes at most {MAX_GT} queries per "
                         f"KV head; got G={G}, T={T}")
    for what, t, shape in (("q_pos", q_pos, (B, T)), ("lengths", lengths, (B,)),
                           ("starts", starts, (B,))):
        if tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"{name} kernel takes {what} {shape} int32, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _count(name: str, T: int) -> None:
    """One launch of kernel ``name`` at a query block of T."""
    LAUNCHES[name] += 1
    by_t = DECODE_LAUNCHES_BY_T[name]
    by_t[T] = by_t.get(T, 0) + 1


def _check_tensors(name, q, tensors) -> None:
    for what, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs a contiguous {what}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs 16-byte aligned {what}")
        if t.device != q.device:
            raise ValueError(f"{what} is on {t.device}, q on {q.device}")


def _check_kernel_inputs(q, k, v, q_pos, k_pos, lengths, starts) -> None:
    B, Hq, T, Dk = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError("decode_attention kernel takes bfloat16 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != Dk \
            or S < 1 or Hq % Hkv:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    _check_common(q, q_pos, lengths, starts, Hq // Hkv, (Dk, v.shape[3]),
                  HEAD_DIMS, "decode_attention")
    if k_pos.shape != (B, S) or k_pos.dtype != torch.int32:
        raise ValueError(f"k_pos must be (B, S) int32, got "
                         f"{tuple(k_pos.shape)} {k_pos.dtype}")
    _check_tensors("decode_attention", q, (
        ("q", q), ("k", k), ("v", v), ("q_pos", q_pos), ("k_pos", k_pos),
        ("lengths", lengths), ("starts", starts)))


def decode_attention_cuda(q, k, v, q_pos, k_pos, lengths, starts, *,
                          window: int = 0) -> torch.Tensor:
    """Launch the kernel (inputs as ``_norm_inputs`` leaves them)."""
    _check_kernel_inputs(q, k, v, q_pos, k_pos, lengths, starts)
    B, Hq, T, Dk = q.shape
    Hkv, S, Dv = k.shape[1], k.shape[2], v.shape[3]
    gt = (Hq // Hkv) * T
    C = cluster_size(B * Hkv * query_chunks(gt), -(-S // DENSE_TILE),
                     _sm_count(q.device.index), gt)
    out = torch.empty((B, Hq, T, Dv), dtype=torch.float32, device=q.device)
    launch("repro_decode_attention", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
           k_pos.data_ptr(), lengths.data_ptr(), starts.data_ptr(),
           out.data_ptr(), B, Hq, Hkv, T, S, Dk, Dv, C, int(window),
           1.0 / math.sqrt(Dk))
    _count("decode_attention", T)
    return out


def decode_attention(q, k, v, q_pos, k_pos, lengths=None, starts=None, *,
                     window: int = 0) -> torch.Tensor:
    """q: (B, Hq, T, Dk); k: (B, Hkv, S, Dk); v: (B, Hkv, S, Dv); q_pos:
    (B,), (B, 1) or (B, T); k_pos: (B, S) int32; lengths/starts: optional
    per-row live bounds (slot j live iff starts[b] <= j < lengths[b]).
    Scores are scaled by 1 / sqrt(Dk).  Returns (B, Hq, T, Dv) float32.
    CUDA tensors launch the kernel (or raise: (Dk, Dv) outside
    ``HEAD_DIMS``, float32, an input that requires grad); CPU tensors take
    the plain version."""
    refuse_grad("decode_attention", q, k, v)
    S = k.shape[2]
    q_pos, lengths, starts = _norm_inputs(q, q_pos, lengths, starts, S)
    if q.device.type == "cuda":
        return decode_attention_cuda(q, k, v, q_pos, k_pos, lengths, starts,
                                     window=window)
    if q.device.type != "cpu":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    return decode_attention_plain(q, k, v, q_pos, k_pos, lengths, starts,
                                  window=window)


PAGED_BLOCK_SIZES = (32, 64)    # kv_block_size the paged kernel is built for


def gather_paged_kv(pool: torch.Tensor, table: torch.Tensor, width: int
                    ) -> torch.Tensor:
    """Dense logical view (B, Hkv, width, D) of a (NB, Hkv, bs, D) pool
    through table (B, nb), sliced to the logical width: shape- and
    value-identical to the dense cache buffer (the paged plain version and
    the model's T > 1 paged forwards read it)."""
    B, nb = table.shape
    _, Hkv, bs, D = pool.shape
    g = pool.index_select(0, table.reshape(-1).to(torch.int64))
    return (g.reshape(B, nb, Hkv, bs, D).transpose(1, 2)
            .reshape(B, Hkv, nb * bs, D)[:, :, :width])


def paged_decode_attention_plain(q, k_pool, v_pool, table, q_pos, k_pos,
                                 lengths, starts, *, window: int = 0
                                 ) -> torch.Tensor:
    """Gather the pools to the dense view of k_pos's (logical) width, zero
    the slots outside [starts, lengths) (what they hold is never attended,
    and a dead table entry may point at anything), and run
    ``decode_attention_plain``: bit-identical to the dense cache's plain
    version on the same logical cache.  q_pos (B, T), lengths/starts (B,)
    as ``_norm_inputs`` leaves them."""
    S = k_pos.shape[1]
    j = torch.arange(S, dtype=torch.int32, device=q.device)[None, :]
    live = ((j >= starts[:, None]) & (j < lengths[:, None]))[:, None, :, None]
    zero = torch.zeros((), dtype=k_pool.dtype, device=q.device)
    k = torch.where(live, gather_paged_kv(k_pool, table, S), zero)
    v = torch.where(live, gather_paged_kv(v_pool, table, S), zero)
    return decode_attention_plain(q, k, v, q_pos, k_pos, lengths, starts,
                                  window=window)


def paged_decode_attention_cuda(q, k_pool, v_pool, table, q_pos, k_pos,
                                lengths, starts, *, window: int = 0
                                ) -> torch.Tensor:
    """Launch the kernel (inputs as ``_norm_inputs`` leaves them; k_pos
    already padded to nb * bs)."""
    B, Hq, T, D = q.shape
    NB, Hkv, bs, _ = k_pool.shape
    nb = table.shape[1]
    if not (q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16):
        raise TypeError("paged_decode_attention kernel takes bfloat16 "
                        f"q/pools, got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if k_pool.shape != v_pool.shape or k_pool.shape[3] != D or Hq % Hkv:
        raise ValueError(f"pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if bs not in PAGED_BLOCK_SIZES:
        raise ValueError(f"paged_decode_attention kernel takes block size "
                         f"{PAGED_BLOCK_SIZES}, got {bs}")
    _check_common(q, q_pos, lengths, starts, Hq // Hkv, (D, D),
                  PAGED_HEAD_DIMS, "paged_decode_attention")
    if table.shape != (B, nb) or table.dtype != torch.int32 or nb < 1 or \
            k_pos.shape != (B, nb * bs) or k_pos.dtype != torch.int32:
        raise ValueError(f"table must be (B, nb) int32 and k_pos (B, nb*bs) "
                         f"int32, got {tuple(table.shape)} {table.dtype}, "
                         f"{tuple(k_pos.shape)} {k_pos.dtype}")
    _check_tensors("paged_decode_attention", q, (
        ("q", q), ("k_pool", k_pool), ("v_pool", v_pool), ("table", table),
        ("q_pos", q_pos), ("k_pos", k_pos), ("lengths", lengths),
        ("starts", starts)))
    gt = (Hq // Hkv) * T
    C = cluster_size(B * Hkv * query_chunks(gt), nb,
                     _sm_count(q.device.index), gt)
    out = torch.empty((B, Hq, T, D), dtype=torch.float32, device=q.device)
    launch("repro_paged_decode_attention", q.device,
           q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
           table.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
           lengths.data_ptr(), starts.data_ptr(), out.data_ptr(), B, Hq, Hkv,
           T, nb, bs, D, C, int(window), 1.0 / math.sqrt(D))
    _count("paged_decode_attention", T)
    return out


def paged_decode_attention(q, k_pool, v_pool, table, q_pos, k_pos,
                           lengths=None, starts=None, *, window: int = 0
                           ) -> torch.Tensor:
    """q: (B, Hq, T, D); k_pool/v_pool: (NB, Hkv, bs, D) block pools;
    table: (B, nb) int block ids (logical slot j of row b lives at
    ``pool[table[b, j // bs], :, j % bs]``); k_pos: (B, S) positions of the
    logical width S <= nb * bs; q_pos, lengths, starts as in
    ``decode_attention``.  Returns (B, Hq, T, D) float32.  CUDA tensors
    launch the kernel (or raise); CPU tensors take the plain version."""
    refuse_grad("paged_decode_attention", q, k_pool, v_pool)
    S = k_pos.shape[1]
    bs, nb = k_pool.shape[2], table.shape[1]
    if S > nb * bs:
        raise ValueError(f"k_pos width {S} exceeds the table's {nb} blocks "
                         f"of {bs}")
    q_pos, lengths, starts = _norm_inputs(q, q_pos, lengths, starts, S)
    k_pos = k_pos.to(torch.int32)
    if q.device.type == "cuda":
        if S < nb * bs:
            # the block-rounding slack is empty: pad with -1 (masked)
            k_pos = torch.nn.functional.pad(k_pos, (0, nb * bs - S), value=-1)
        return paged_decode_attention_cuda(
            q, k_pool, v_pool, table.to(torch.int32).contiguous(), q_pos,
            k_pos.contiguous(), lengths, starts, window=window)
    if q.device.type != "cpu":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    return paged_decode_attention_plain(q, k_pool, v_pool, table, q_pos,
                                        k_pos, lengths, starts, window=window)
