"""Mamba (S6) selective scan.

No Pallas kernel replaces this one: the reference runs the recurrence with
``jax.lax.scan`` inside XLA (``repro/models/mamba.py:101-128``).  The port
gives it a kernel of its own, as it does ``flash_attention`` for the
no-grad T > 1 forwards: a scan in PyTorch would be a host loop of T steps
of several launches each per Mamba layer (jamba-v0.1-52b has 28 of 32).

Per row b and inner channel d, with the state s (ds,) starting at
``s[b, d]``::

    s_t = exp(dt_t · A[d]) ⊙ s_{t-1} + (dt_t · u_t) · B_t
    y_t = Σ_s s_t[s] · C_t[s] + u_t · D[d]

``mamba_scan`` launches the CUDA kernel (``csrc/mamba_scan.cu``) on CUDA
tensors and runs ``mamba_scan_plain``, a loop over t in the reference's
order (``step`` at ``mamba.py:101-107``, then the D skip at ``:130``), on
CPU tensors.  One launch a call for every T ≥ 1: the prompt at prefill,
prompt ⊕ draft at the verify score, one token at a decode step.  The state
is read and then overwritten with the final state, in place: that is how
the decode cache is updated.  The pad contract is the caller's: dt = 0
leaves the state unchanged (y is still computed there, as in the
reference).

Bound by bytes: dt, u and y in float32 dominate (0.50 GB at B = 16,
T = 320, di = 8,192), and the state's read and write at T = 1 (16.8 MB).
The kernel holds each (b, d)'s 16 states in registers for the whole
sequence, one thread per channel (the source's note has the layout).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, MAMBA_LAUNCHES_BY_T, refuse_grad
from repro_torch.kernels._build import launch

D_STATES = (16,)


def mamba_scan_plain(dt, u, Bc, Cc, A, D, s0):
    """dt, u: (B, T, di) float32; Bc, Cc: (B, T, ds); A: (di, ds); D:
    (di,); s0: (B, di, ds).  Returns (y (B, T, di), final state (B, di,
    ds)), both float32; s0 is not written.  Pure tensor operations, so
    autograd runs through it (``models/mamba.py:ssm_scan``)."""
    s = s0.float()
    ys = []
    for t in range(dt.shape[1]):
        dA = torch.exp(dt[:, t, :, None] * A)                      # (B,di,ds)
        s = dA * s + (dt[:, t] * u[:, t])[..., None] * Bc[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", s, Cc[:, t]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(u)
    return y + u * D, s


def mamba_scan_cuda(dt, u, Bc, Cc, A, D, s) -> torch.Tensor:
    """The kernel entry: every tensor contiguous float32, ``A`` and ``s``
    16-byte aligned, on one device; overwrites ``s`` with the final state
    and returns y.  One launch, nothing else."""
    B, T, di = dt.shape
    ds = A.shape[-1]
    if ds not in D_STATES:
        raise ValueError(f"mamba_scan kernel: state size {ds} not in "
                         f"{D_STATES}")
    for name, t, shape in (("dt", dt, (B, T, di)), ("u", u, (B, T, di)),
                           ("Bc", Bc, (B, T, ds)), ("Cc", Cc, (B, T, ds)),
                           ("A", A, (di, ds)), ("D", D, (di,)),
                           ("s", s, (B, di, ds))):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != dt.device or tuple(t.shape) != shape):
            raise ValueError(f"mamba_scan kernel needs a contiguous float32 "
                             f"{name} of shape {shape} on {dt.device}")
    for name, t in (("A", A), ("s", s)):
        if t.data_ptr() % 16:
            raise ValueError(f"mamba_scan kernel needs {name} 16-byte "
                             "aligned")
    y = torch.empty_like(u)
    launch("repro_mamba_scan", dt.device, dt.data_ptr(), u.data_ptr(),
           Bc.data_ptr(), Cc.data_ptr(), A.data_ptr(), D.data_ptr(),
           s.data_ptr(), y.data_ptr(), B, T, di, ds)
    LAUNCHES["mamba_scan"] += 1
    MAMBA_LAUNCHES_BY_T[T] = MAMBA_LAUNCHES_BY_T.get(T, 0) + 1
    return y


def mamba_scan(dt, u, Bc, Cc, A, D, s) -> torch.Tensor:
    """dt, u: (B, T, di) float32 (dt zero on pads); Bc, Cc: (B, T, ds);
    A: (di, ds) = -exp(A_log); D: (di,); s: (B, di, ds) float32, the
    initial state, overwritten with the final one in place.  Returns y
    (B, T, di) float32.  CUDA tensors launch the kernel (or raise); CPU
    tensors take the plain version."""
    refuse_grad("mamba_scan", dt, u, Bc, Cc, A, D, s)
    if dt.device.type == "cuda":
        return mamba_scan_cuda(dt, u, Bc, Cc, A, D, s)
    if dt.device.type != "cpu":
        raise ValueError(f"mamba_scan: no kernel for {dt.device}")
    y, s_final = mamba_scan_plain(dt, u, Bc, Cc, A, D, s)
    s.copy_(s_final)
    return y
