"""Causal GQA attention for T > 1 (prefill, verify, score): port of
``repro/kernels/flash_attention``.

``flash_attention`` launches the CUDA kernel (``csrc/flash_attention.cu``,
which replaces ``flash_attention_pallas``,
``repro/kernels/flash_attention/kernel.py:69``) on CUDA tensors and runs
``flash_attention_plain`` on CPU tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._build import launch

NEG_INF = -1e30


def flash_attention_plain(q, k, v, q_pos, k_pos, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Masked softmax attention in float32 (``repro/kernels/flash_attention/
    ref.py``).  Returns (B, Hq, T, D)."""
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, T, D).float()
    s = torch.einsum("bhgtd,bhsd->bhgts", qg, k.float()) * (1.0 / math.sqrt(D))
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
    return out.reshape(B, Hq, T, D)


def _check_kernel_inputs(q, k, v, q_pos, k_pos) -> None:
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError("flash_attention kernel takes bfloat16 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if D not in (64, 128):
        raise ValueError(f"flash_attention kernel takes head_dim 64 or 128, "
                         f"got {D}")
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
    _check_kernel_inputs(q, k, v, q_pos, k_pos)
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, T, D), dtype=torch.float32, device=q.device)
    launch("repro_flash_attention", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
           k_pos.data_ptr(), out.data_ptr(), B, Hq, Hkv, T, S, D,
           int(causal), int(window), 1.0 / math.sqrt(D))
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """q: (B, Hq, T, D) with T > 1; k/v: (B, Hkv, S, D); q_pos: (B, T) and
    k_pos: (B, S) int.  Returns (B, Hq, T, D) float32.  CUDA tensors launch
    the kernel (or raise); CPU tensors take the plain version."""
    if q.shape[2] <= 1:
        raise ValueError("flash_attention is the prefill/verify kernel; "
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
