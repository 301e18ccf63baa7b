"""The counterfactual-attention tail of ``POCACritic.all_baselines``: the
CUDA forward and backward kernels (``csrc/baseline_tail.cu``) and their
plain version.

Counterpart of ``swarmacb_tpu/ops/baseline_tail.py``. Per group b and
counterfactual agent I:

    fc[I,n,:] = Σ_{h,m} attn[I,h,n,m]·wa[h,m,:]               (matmul)
              + Σ_h    attn_mI[I,h,n]·dws[h,I,:]              (rank-1)
              + bias + x_a[n,:] + δ_{n,I}·delta[I,:]          (residual)
    y    = LayerNorm_nonaffine(fc)       # per (I,n) row, eps 1e-5
    out[I,:] = mean_n y[I,n,:]           # average pool

Inputs (B groups, N agents, H heads, h hidden, HM = H·N):
    attn_lhs (B, N², HM)  attention laid out (I·n, h·m)
    attn_mI  (B, H, N, N) attn[I,h,n,m=I] laid out [h, I, n] — head-major
    wa       (B, HM, h)   W_out-folded "others" values (v_a·W_out)
    dws      (B, H, N, h) W_out-folded (v_s − v_a)
    x_a, delta (B, N, h)  residual entities: x_a and (x_s − x_a)
    bias     (h,)         fc_out bias
Output: pooled (B, N, h).

``fused_tail`` dispatches by device: the plain version for CPU tensors, whose
gradient is plain autograd, and for CUDA tensors a ``torch.autograd.Function``
whose forward is the K3f kernel and whose backward is the K3b kernel
(``csrc/baseline_tail.cu``). The backward recomputes fc from the seven saved
inputs and returns the cotangents of all of them.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import _cuda

LN_EPS = 1e-5


def tail_reference(attn_lhs, attn_mI, wa, dws, x_a, delta, bias, N):
    """Plain version — the same function as the non-kernel branch of
    ``POCACritic.all_baselines`` in the JAX package (networks.py:526-540)."""
    B = attn_lhs.shape[0]
    h = wa.shape[-1]
    fc = torch.matmul(attn_lhs, wa).reshape(B, N, N, h)
    fc = fc + torch.einsum("bhIn,bhIo->bIno", attn_mI, dws)
    fc = fc + bias + x_a[:, None, :, :]
    eye = torch.eye(N, dtype=torch.bool, device=fc.device)[None, :, :, None]
    fc = fc + torch.where(eye, delta[:, :, None, :], torch.zeros_like(fc))
    fc = fc.reshape(B * N * N, h)
    mu = fc.mean(-1, keepdim=True)
    xc = fc - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + LN_EPS)
    return y.reshape(B, N, N, h).mean(dim=2)


def _check(args, N):
    """(B, H, h) of the seven tail inputs; raises on what the kernels do not
    take (shape, dtype, device, layout)."""
    attn_lhs, _, wa = args[:3]
    B, _, HM = attn_lhs.shape
    h = wa.shape[-1]
    H = HM // N
    expect = {"attn_lhs": (B, N * N, H * N), "attn_mI": (B, H, N, N),
              "wa": (B, H * N, h), "dws": (B, H, N, h), "x_a": (B, N, h),
              "delta": (B, N, h), "bias": (h,)}
    dev = attn_lhs.device
    for (name, shape), t in zip(expect.items(), args):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_tail: {name} must be {shape}, "
                             f"got {tuple(t.shape)}")
        _check_layout(name, t, dev)
    if dev.type != "cuda":
        raise ValueError(f"fused_tail: tensors must lie on the CPU or a CUDA "
                         f"device, got {dev}")
    if h % 4 or h > 4096:
        raise ValueError(f"fused_tail: the kernel takes h % 4 == 0 and "
                         f"h <= 4096, got h={h}")
    return B, H, h


def _check_layout(name, t, dev):
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"fused_tail: {name} must be float32 on {dev}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused_tail: {name} must be contiguous and "
                         "16-byte aligned")


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


def _forward_kernel(args, N):
    """K3f: pooled (B, N, h)."""
    B, H, h = _check(args, N)
    out = torch.empty((B, N, h), dtype=torch.float32, device=args[0].device)
    err = _cuda.library("baseline_tail").fused_tail_fwd_launch(
        *_ptrs(args), out.data_ptr(), B, N, H, h, _cuda.stream_ptr(args[0]))
    _cuda.check(err, "fused_tail")
    _cuda.launches["fused_tail"] += 1
    return out


def backward_kernel(args, dout, N):
    """K3b: the cotangents of the seven inputs ``args`` for ``dout``
    (B, N, h), in the inputs' order and shapes."""
    B, H, h = _check(args, N)
    dout = dout.contiguous()
    if tuple(dout.shape) != (B, N, h):
        raise ValueError(f"fused_tail: dout must be {(B, N, h)}, "
                         f"got {tuple(dout.shape)}")
    _check_layout("dout", dout, args[0].device)
    grads = [torch.empty_like(t) for t in args]
    bias_part = torch.empty((B, h), dtype=torch.float32, device=dout.device)
    err = _cuda.library("baseline_tail").fused_tail_bwd_launch(
        *_ptrs(args), dout.data_ptr(), *_ptrs(grads), bias_part.data_ptr(),
        B, N, H, h, _cuda.stream_ptr(dout))
    _cuda.check(err, "fused_tail backward")
    _cuda.launches["fused_tail_bwd"] += 1
    return grads


class _FusedTail(torch.autograd.Function):
    """K3f forward, K3b backward (the JAX package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, attn_lhs, attn_mI, wa, dws, x_a, delta, bias, N):
        args = (attn_lhs, attn_mI, wa, dws, x_a, delta, bias)
        ctx.N = N
        ctx.save_for_backward(*args)
        return _forward_kernel(args, N)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        return (*backward_kernel(ctx.saved_tensors, dout, ctx.N), None)


def fused_tail(attn_lhs, attn_mI, wa, dws, x_a, delta, bias, N):
    """pooled (B, N, h) from the small tail inputs (module docstring)."""
    if attn_lhs.device.type == "cpu":
        return tail_reference(attn_lhs, attn_mI, wa, dws, x_a, delta, bias, N)
    return _FusedTail.apply(attn_lhs, attn_mI, wa, dws, x_a, delta, bias, N)
