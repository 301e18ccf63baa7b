"""Fully fused counterfactual attention of ``POCACritic.all_baselines``
(``fused_attention=True``): the CUDA forward and backward kernels
(``csrc/cf_attention.cu``) and their plain version.

Counterpart of ``swarmacb_tpu/ops/cf_attention.py``. From the raw scores and
the W_out-folded values to the pooled rows, per group b and counterfactual
agent I: assemble the (H, n, m) scores of I (the shared S_aa with row n = I
from S_sa, column m = I from S_as and (I, I) from S_ss), softmax over m with
scale 1/√d, contract with the folded values (plus the rank-1 diagonal term
of dws), add bias, x_a and the diagonal delta, LayerNorm each (I, n) row
(non-affine, eps 1e-5), and average over n. The kernels never build the
(B, I, H, n, m) scores: each score row differs from a shared base row in one
element, so the softmax and the value contraction are a base term plus a
rank-1 correction (the kernel source sets out the algebra).

Inputs (B groups, N agents, H heads, d = head dim, h hidden):
    S_aa, S_as, S_sa (B, H, N, N)  raw scores q_a·k_a, q_a·k_s, q_s·k_a
    S_ss (B, H, N, 1)              diagonal q_s·k_s
    wa, dws (B, H, N, h)           W_out-folded values: v_a·W, (v_s−v_a)·W
    x_a, delta (B, N, h)           residual entities: x_a and (x_s − x_a)
    bias (h,)                      fc_out bias
Output: pooled (B, N, h).

``fused_cf_attention`` dispatches by device: the plain version for CPU
tensors, whose gradient is plain autograd, and for CUDA tensors a
``torch.autograd.Function`` whose forward is the K5f kernel and whose
backward is the K5b kernel. The backward recomputes the attention from the
nine saved inputs and returns the cotangents of all of them; ``d`` is a
constant.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from . import _cuda

LN_EPS = 1e-5


def cf_reference(S_aa, S_as, S_sa, S_ss, wa, dws, x_a, delta, bias, d):
    """Plain version: the JAX package's ``cf_reference``
    (cf_attention.py:337-372), the assembled-scores composition of the
    non-kernel ``POCACritic.all_baselines``. Runs in the inputs' dtype, so
    float64 inputs give a float64 referee."""
    B, H, N, _ = S_aa.shape
    h = wa.shape[-1]
    ii = torch.arange(N, device=S_aa.device)
    I_idx = ii.view(1, N, 1, 1, 1)
    n_idx = ii.view(1, 1, 1, N, 1)
    m_idx = ii.view(1, 1, 1, 1, N)
    base = S_aa[:, None]                                   # (B,1,H,n,m)
    row_I = S_sa.permute(0, 2, 1, 3)[:, :, :, None, :]     # (B,I,H,1,m)
    col_I = S_as.permute(0, 3, 1, 2)[:, :, :, :, None]     # (B,I,H,n,1)
    diag_I = S_ss[..., 0].permute(0, 2, 1)[:, :, :, None, None]
    scores = torch.where(n_idx == I_idx, row_I, base)
    scores = torch.where(m_idx == I_idx,
                         torch.where(n_idx == I_idx, diag_I, col_I), scores)
    attn = torch.softmax(scores / math.sqrt(d), dim=-1)   # (B,I,H,n,m)

    fc = torch.einsum("bIhnm,bhmo->bIno", attn, wa)
    # attn[b, I, h, n, m=I] as (B, H, n, I)
    attn_mI = attn.diagonal(dim1=1, dim2=4)
    fc = fc + torch.einsum("bhnI,bhIo->bIno", attn_mI, dws)
    fc = fc + bias + x_a[:, None, :, :]
    eye = (ii[:, None] == ii[None, :])[None, :, :, None]
    fc = fc + torch.where(eye, delta[:, :, None, :], torch.zeros_like(fc))
    flat = fc.reshape(B * N * N, h)
    mu = flat.mean(-1, keepdim=True)
    xc = flat - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + LN_EPS)
    return y.reshape(B, N, N, h).mean(dim=2)


NAMES = ("S_aa", "S_as", "S_sa", "S_ss", "wa", "dws", "x_a", "delta", "bias")


def _check(args):
    """(B, N, H, h) of the nine inputs; raises on what the kernels do not
    take (shape, dtype, device, layout)."""
    S_aa, wa = args[0], args[4]
    if S_aa.dim() != 4 or wa.dim() != 4:
        raise ValueError("fused_cf_attention: S_aa and wa must be 4-D")
    B, H, N, _ = S_aa.shape
    h = wa.shape[-1]
    expect = {"S_aa": (B, H, N, N), "S_as": (B, H, N, N), "S_sa": (B, H, N, N),
              "S_ss": (B, H, N, 1), "wa": (B, H, N, h), "dws": (B, H, N, h),
              "x_a": (B, N, h), "delta": (B, N, h), "bias": (h,)}
    dev = S_aa.device
    for (name, shape), t in zip(expect.items(), args):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_cf_attention: {name} must be {shape}, "
                             f"got {tuple(t.shape)}")
        _check_layout(name, t, dev)
    if dev.type != "cuda":
        raise ValueError(f"fused_cf_attention: tensors must lie on the CPU or "
                         f"a CUDA device, got {dev}")
    if h % 4 or h > 4096 or N > 32:
        raise ValueError(f"fused_cf_attention: the kernels take h % 4 == 0, "
                         f"h <= 4096 and N <= 32, got h={h}, N={N}")
    return B, N, H, h


def _check_layout(name, t, dev):
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"fused_cf_attention: {name} must be float32 on {dev}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused_cf_attention: {name} must be contiguous and "
                         "16-byte aligned")


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


def _forward_kernel(args, d):
    """K5f: pooled (B, N, h)."""
    B, N, H, h = _check(args)
    out = torch.empty((B, N, h), dtype=torch.float32, device=args[0].device)
    err = _cuda.library("cf_attention").cf_attention_fwd_launch(
        *_ptrs(args), out.data_ptr(), B, N, H, h, math.sqrt(d),
        _cuda.stream_ptr(args[0]))
    _cuda.check(err, "fused_cf_attention")
    _cuda.launches["fused_cf_attention"] += 1
    return out


def backward_kernel(args, dout, d):
    """K5b: the cotangents of the nine inputs ``args`` for ``dout``
    (B, N, h), in the inputs' order and shapes."""
    B, N, H, h = _check(args)
    dout = dout.contiguous()
    if tuple(dout.shape) != (B, N, h):
        raise ValueError(f"fused_cf_attention: dout must be {(B, N, h)}, "
                         f"got {tuple(dout.shape)}")
    _check_layout("dout", dout, args[0].device)
    grads = [torch.empty_like(t) for t in args]
    dev = dout.device
    bias_part = torch.empty((B, h), dtype=torch.float32, device=dev)
    num = torch.empty((B, H, N, h), dtype=torch.float32, device=dev)
    d_num = torch.empty((B, H, N, h), dtype=torch.float32, device=dev)
    err = _cuda.library("cf_attention").cf_attention_bwd_launch(
        *_ptrs(args), dout.data_ptr(), *_ptrs(grads), bias_part.data_ptr(),
        num.data_ptr(), d_num.data_ptr(), B, N, H, h, math.sqrt(d),
        _cuda.stream_ptr(dout))
    _cuda.check(err, "fused_cf_attention backward")
    _cuda.launches["fused_cf_attention_bwd"] += 1
    return grads


class _FusedCfAttention(torch.autograd.Function):
    """K5f forward, K5b backward (the JAX package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, S_aa, S_as, S_sa, S_ss, wa, dws, x_a, delta, bias, d):
        args = (S_aa, S_as, S_sa, S_ss, wa, dws, x_a, delta, bias)
        ctx.d = d
        ctx.save_for_backward(*args)
        return _forward_kernel(args, d)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        return (*backward_kernel(ctx.saved_tensors, dout, ctx.d), None)


def fused_cf_attention(S_aa, S_as, S_sa, S_ss, wa, dws, x_a, delta, bias, d):
    """pooled (B, N, h) from raw scores and folded values (module
    docstring). ``d`` is the per-head dimension (softmax scale 1/√d)."""
    args = (S_aa, S_as, S_sa, S_ss, wa, dws, x_a, delta, bias)
    if S_aa.device.type == "cpu":
        return cf_reference(*args, d)
    return _FusedCfAttention.apply(*args, d)
