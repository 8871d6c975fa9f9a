"""GQA attention, causal for T > 1 (prefill, verify, score) and
non-causal at any T (an encoder, a cross-attention): port of
``repro/kernels/flash_attention``.

``flash_attention`` launches the CUDA kernel (``csrc/flash_attention.cu``,
which replaces ``flash_attention_pallas``,
``repro/kernels/flash_attention/kernel.py:69``) on CUDA tensors and runs
``flash_attention_plain`` on CPU tensors.  It takes GQA's heads at Dk = Dv
= 64 or 128 and MLA's decompressed ones at Dk = 192, Dv = 128
(``HEAD_DIMS``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import LAUNCHES, refuse_grad
from repro_torch.kernels._build import launch

NEG_INF = -1e30
BQ = BK = 64            # the kernel's query and key tile
MAX_KEYS = 2048 * BK    # 131,072: pixtral-12b's max_seq_len, with or
                        # without a window
MAX_BATCH = 65535       # the grid's third dimension
# (Dk, Dv) the kernel is built for: GQA's heads, and MLA's decompressed
# ones (nope 128 + rope 64 against a v of 128)
HEAD_DIMS = ((64, 64), (128, 128), (192, 128))


def flash_attention_plain(q, k, v, q_pos, k_pos, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Masked softmax attention in float32 (``repro/kernels/flash_attention/
    ref.py``; JAX's ``dot_product_attention`` at Dk != Dv), the scores
    scaled by 1 / sqrt(Dk).  Returns (B, Hq, T, Dv), Dv from ``v``."""
    B, Hq, T, Dk = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, T, Dk).float()
    s = torch.einsum("bhgtd,bhsd->bhgts", qg, k.float()) * (
        1.0 / math.sqrt(Dk))
    kp = k_pos[:, None, None, None, :]
    qp = q_pos[:, None, None, :, None]
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & ((qp - kp) < window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    w = torch.where(mask.any(dim=-1, keepdim=True), w, torch.zeros_like(w))
    out = torch.einsum("bhgts,bhsd->bhgtd", w, v.float())
    return out.reshape(B, Hq, T, v.shape[-1])


def live_key_tiles(q_pos, k_pos, *, causal: bool = True, window: int = 0
                   ) -> torch.Tensor:
    """The kernel's tile list as a mask (B, T tiles, S tiles): key tile j
    is loaded for query tile i iff one of its keys has k_pos >= 0, (causal)
    k_pos <= the largest q_pos of the query tile and (window > 0) k_pos >
    its smallest q_pos - window.  Every visible (query, key) pair lies in a
    live tile; a query tile of padding only loads nothing when the call is
    causal, and every tile with a live key when it is not.  The kernel
    flags the tiles 512 at a time and lists the live ones in shared memory
    sized to the call's S / 64 tiles (up to 2,048); a window keeps a query
    tile's list short (mixtral-8x22b's 4,096 at S = 65,536 lists at most
    66 of 1,024)."""
    B, T = q_pos.shape
    S = k_pos.shape[1]
    nq, nk = -(-T // BQ), -(-S // BK)
    qp = torch.full((B, nq * BQ), -1, dtype=torch.int64)
    qp[:, :T] = q_pos.long().cpu()
    big = torch.iinfo(torch.int64).max
    rows = torch.arange(nq * BQ) < T
    qmax = qp.view(B, nq, BQ).amax(-1)
    qmin = torch.where(rows, qp, torch.full_like(qp, big)).view(
        B, nq, BQ).amin(-1)
    kp = torch.full((B, nk * BK), -1, dtype=torch.int64)
    kp[:, :S] = k_pos.long().cpu()
    kp = kp.view(B, 1, nk, BK)
    live = (kp >= 0).expand(B, nq, nk, BK)
    if causal:
        live = live & (kp <= qmax[:, :, None, None])
    if window > 0:
        live = live & (kp > qmin[:, :, None, None] - window)
    return live.any(-1)


def _check_kernel_inputs(q, k, v, q_pos, k_pos, window: int = 0) -> None:
    B, Hq, T, Dk = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError("flash_attention kernel takes bfloat16 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != Dk \
            or Hq % Hkv:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if (Dk, v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim pairs "
                         f"(Dk, Dv) in {HEAD_DIMS}, got {(Dk, v.shape[3])}")
    if S > MAX_KEYS or B > MAX_BATCH:
        raise ValueError(
            f"flash_attention kernel takes at most {MAX_KEYS} keys and "
            f"{MAX_BATCH} rows, got S={S}, B={B}")
    if q_pos.shape != (B, T) or k_pos.shape != (B, S) or \
            q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise ValueError("q_pos (B, T) and k_pos (B, S) must be int32")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("k_pos", k_pos)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel needs a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs 16-byte aligned "
                             f"{name}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def flash_attention_cuda(q, k, v, q_pos, k_pos, *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    _check_kernel_inputs(q, k, v, q_pos, k_pos, window)
    B, Hq, T, Dk = q.shape
    Hkv, S, Dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((B, Hq, T, Dv), dtype=torch.float32, device=q.device)
    launch("repro_flash_attention", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
           k_pos.data_ptr(), out.data_ptr(), B, Hq, Hkv, T, S, Dk, Dv,
           int(causal), int(window), 1.0 / math.sqrt(Dk))
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """q: (B, Hq, T, Dk), T > 1 when causal; k: (B, Hkv, S, Dk); v: (B,
    Hkv, S, Dv); q_pos: (B, T) and k_pos: (B, S) int.  Scores are scaled by
    1 / sqrt(Dk).  Returns (B, Hq, T, Dv) float32.  CUDA tensors launch
    the kernel (or raise: (Dk, Dv) outside ``HEAD_DIMS``, float32, an
    input that requires grad); CPU tensors take the plain version."""
    refuse_grad("flash_attention", q, k, v)
    if q.shape[2] < 1 or (causal and q.shape[2] == 1):
        raise ValueError("flash_attention takes a causal call at T > 1; "
                         "single-token decode goes to decode_attention")
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, q_pos, k_pos, causal=causal,
                                    window=window)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return flash_attention_plain(q, k, v, q_pos, k_pos, causal=causal,
                                 window=window)
