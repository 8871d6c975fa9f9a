"""RWKV6 time-mix recurrence (port of ``repro/kernels/rwkv6_wkv``).

Per (batch, head), with data-dependent per-channel decay ``w_t``::

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

``wkv`` launches the CUDA kernel (``csrc/wkv.cu``, which replaces
``wkv_pallas``, ``repro/kernels/rwkv6_wkv/kernel.py:53``, and the
``to_bh`` transposes of its ``ops.py``) on CUDA tensors and runs
``wkv_plain``, a loop over t in ``wkv_scan``'s order
(``repro/models/rwkv.py:106``), on CPU tensors.

The function is bound by its bytes at T in the hundreds (85 us at
T = 320 for the slice's shapes; its 5 fp32 flops per state element per
step take 63 us, and the T sequential steps add a latency floor) and by
the state's read and write at T = 1.  One launch a call, the kernel chosen
by T (the source's note has the details).  For T > 1 each (b, h) state
stays in registers for the whole sequence, one block per (b, h), with the
bonus factored as the TPU kernel factors it (three instructions per state
element a step) and r/k/v/w brought in by bulk copies into a ring of
16-step stages, a chunk ahead of the compute.  For T = 1 (the decode step)
every load of a block goes out at once into registers.  The kernel reads the model's
(B, T, H, hd) layout in place and may write the final state over ``s0``:
that is how the decode cache is updated in place.  The pad contract is the
caller's: w = 1 and k = 0 leave the state unchanged.  ``wkv_plain`` keeps
``wkv_scan``'s order (the u-term inside the r-sum); the two orders agree
within rounding.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import LAUNCHES, WKV_LAUNCHES_BY_T, refuse_grad
from repro_torch.kernels._build import launch

HEAD_DIMS = (32, 64)


def wkv_plain(r, k, v, w, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (B, T, H, hd) float32; u: (H, hd); s0: (B, H, hd, hd).
    Returns (y (B, T, H, hd), s_final (B, H, hd, hd)), both float32."""
    s = s0.float()
    u4 = u.float()[None, :, :, None]
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]           # (B,H,hd,hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + u4 * kv))
        s = w[:, t, :, :, None] * s + kv
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(r)
    return y, s


def wkv_step_partition(B: int, H: int, hd: int) -> torch.Tensor:
    """The T = 1 kernel's work partition, the Python twin of
    ``wkv_step_kernel``'s indexing in ``csrc/wkv.cu``: one row (block,
    thread, b, h, i, j) for every state element S[b, h, i, j] a thread
    holds.  Block ``blk`` takes (b, h) = divmod(blk, H); its thread ``tid``,
    row lane p = tid % 16 of column group g = tid // 16, holds rows
    R p .. R p + R - 1 (R = hd // 16) of the columns 4 g .. 4 g + 3."""
    R = hd // 16
    out = []
    for blk in range(B * H):
        b, h = divmod(blk, H)
        for tid in range(4 * hd):
            p, g = tid % 16, tid // 16
            out += [(blk, tid, b, h, R * p + ii, 4 * g + c)
                    for ii in range(R) for c in range(4)]
    return torch.tensor(out, dtype=torch.int64)


def wkv_cuda(r, k, v, w, u, s0, s_out) -> torch.Tensor:
    """The kernel entry: every tensor contiguous float32, 16-byte aligned,
    on one device; writes the final state into ``s_out`` (which may be
    ``s0``) and returns y.  One launch, nothing else."""
    B, T, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv kernel: head dim {hd} not in {HEAD_DIMS}")
    for name, t, shape in (("r", r, (B, T, H, hd)), ("k", k, (B, T, H, hd)),
                           ("v", v, (B, T, H, hd)), ("w", w, (B, T, H, hd)),
                           ("u", u, (H, hd)), ("s0", s0, (B, H, hd, hd)),
                           ("s_out", s_out, (B, H, hd, hd))):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != r.device or tuple(t.shape) != shape):
            raise ValueError(f"wkv kernel needs a contiguous float32 {name} "
                             f"of shape {shape} on {r.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"wkv kernel needs {name} 16-byte aligned")
    y = torch.empty_like(r)
    launch("repro_wkv", r.device, r.data_ptr(), k.data_ptr(), v.data_ptr(),
           w.data_ptr(), u.data_ptr(), s0.data_ptr(), y.data_ptr(),
           s_out.data_ptr(), B, T, H, hd)
    LAUNCHES["wkv"] += 1
    WKV_LAUNCHES_BY_T[T] = WKV_LAUNCHES_BY_T.get(T, 0) + 1
    return y


def wkv(r, k, v, w, u, s0, s_out: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (B, T, H, hd) float32; u: (H, hd); s0: (B, H, hd, hd)
    float32.  The final state goes into ``s_out`` (a new tensor if None;
    ``s0`` itself to update a cache in place).  Returns (y, s_out).  CUDA
    tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    refuse_grad("wkv", r, k, v, w, u, s0)
    if s_out is None:
        s_out = torch.empty_like(s0)
    if r.device.type == "cuda":
        return wkv_cuda(r, k, v, w, u, s0, s_out), s_out
    if r.device.type != "cpu":
        raise ValueError(f"wkv: no kernel for {r.device}")
    y, s = wkv_plain(r, k, v, w, u, s0)
    s_out.copy_(s)
    return y, s_out
