"""The counterfactual-attention tail of ``POCACritic.all_baselines``: the
CUDA forward kernel (K3f, ``csrc/tail_forward.cu``), the backward kernels
(K3b, ``csrc/baseline_tail.cu``) and their plain versions.

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
whose forward is K3f and whose backward is K3b. K3f takes the matmul and the rank-1
term on the tensor cores (wgmma) in 3×TF32: each operand is split into a
TF32 high part and a TF32 remainder (``split_tf32``) and the product is
lo·hi + hi·lo + hi·hi, which keeps float32-level error;
``tail_reference_3xtf32`` is the plain version of that arithmetic. The rest
of K3f (residual, LayerNorm, pool), and all of K3b, is float32 on the CUDA
cores. K3b recomputes fc from the seven saved inputs and returns
the cotangents of all of them, in three kernels joined by d_fc =
∂loss/∂fc in device memory: the rows of each (b, I) (d_fc, d_attn_mI,
d_dws, d_delta), the batched product attn_lhsᵀ·d_fc (d_wa, with d_xa and
d_bias), and the batched product d_fc·waᵀ (d_attn_lhs).
``tail_backward_reference`` computes the same stages in plain PyTorch.

On a CUDA tensor ``fused_tail`` takes one of two routes, picked by shape
alone (``route``): the tuned kernels above where h ≤ 512 with h % 4 == 0,
N ≤ 32 and H·N % 4 == 0, and the wide route (``csrc/tail_wide.cu``: K3f
and K3b for every other shape the JAX function takes, any B, N, H and
h ≥ 1) elsewhere, each with its own launch counters (``fused_tail`` and
``fused_tail_bwd``, ``fused_tail_wide`` and ``fused_tail_wide_bwd``). The
wide route takes its products on the tensor cores in 3×TF32 too: the fc
rows of P counterfactuals a block (``wide_plan``), in tiles of 256
columns by 40 rows, with the rank-1 term as extra K columns, kept in shared memory
where they fit; the rest is float32 on the CUDA cores, and each row's sums
run over column tiles of at most 512 floats (``layernorm_tiled`` is the
plain version of those statistics; ``wide_reference_3xtf32`` and
``tail_backward_reference(..., product=matmul_3xtf32,
layernorm=layernorm_tiled)`` that of the route's arithmetic). Its backward
has the three stages of K3b, joined by the same d_fc scratch: the rows,
then d_wa = attn_lhsᵀ·d_fc and d_attn_lhs = d_fc·waᵀ as batched 3×TF32
products. A route that fails raises: neither falls back on the other.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from . import _cuda

LN_EPS = 1e-5


def _fc(attn_lhs, attn_mI, wa, dws, x_a, delta, bias, N, product=None):
    """fc (B, N², h), row I·N + n: the tail's pre-LayerNorm rows; with a
    ``product``, attn_lhs·wa and the rank-1 term (a product over heads)
    are taken by it."""
    B = attn_lhs.shape[0]
    h = wa.shape[-1]
    if product is None:
        fc = torch.matmul(attn_lhs, wa).reshape(B, N, N, h)
        fc = fc + torch.einsum("bhIn,bhIo->bIno", attn_mI, dws)
    else:
        fc = product(attn_lhs, wa).reshape(B, N, N, h)
        fc = fc + product(attn_mI.permute(0, 2, 3, 1), dws.permute(0, 2, 1, 3))
    fc = fc + bias + x_a[:, None, :, :]
    eye = torch.eye(N, dtype=torch.bool, device=fc.device)[None, :, :, None]
    fc = fc + torch.where(eye, delta[:, :, None, :], torch.zeros_like(fc))
    return fc.reshape(B, N * N, h)


def _layernorm(fc):
    """y and rstd of the non-affine LayerNorm of each row of fc."""
    mu = fc.mean(-1, keepdim=True)
    xc = fc - mu
    var = (xc * xc).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    return xc * rstd, rstd


WIDE_TILE = 512          # columns of a tile of the wide route's row sums


def layernorm_tiled(fc, tile=WIDE_TILE):
    """``_layernorm`` with each row's sums taken as the wide route takes
    them: a sum over each tile of at most ``tile`` columns, the tiles'
    sums then added in order; the mean first, then the mean of squared
    deviations from it (two passes, as JAX's ``_ln_stats``)."""
    h = fc.shape[-1]

    def row_sum(x):
        total = x[..., :tile].sum(-1, keepdim=True)
        for c0 in range(tile, h, tile):
            total = total + x[..., c0:c0 + tile].sum(-1, keepdim=True)
        return total

    xc = fc - row_sum(fc) / h
    rstd = torch.rsqrt(row_sum(xc * xc) / h + LN_EPS)
    return xc * rstd, rstd


def pool_layernorm(fc, N):
    """pooled (B, N, h) from fc (B, N², h): LayerNorm, then the mean over n."""
    B, _, h = fc.shape
    return _layernorm(fc)[0].reshape(B, N, N, h).mean(dim=2)


def tail_reference(attn_lhs, attn_mI, wa, dws, x_a, delta, bias, N):
    """Plain version — the same function as the non-kernel branch of
    ``POCACritic.all_baselines`` in the JAX package (networks.py:526-540)."""
    return pool_layernorm(_fc(attn_lhs, attn_mI, wa, dws, x_a, delta, bias, N), N)


def split_tf32(x):
    """(hi, lo) of a float32 tensor: hi is x rounded to TF32 (10 mantissa
    bits, to nearest, ties away from zero) and lo is x − hi rounded the same
    way, as the kernel's ``cvt.rna.tf32.f32`` does, emulated on the float32
    bits. Non-finite values pass through as hi with lo 0. For normal x whose
    remainder is normal too, |x − hi − lo| ≤ 2⁻²²·|x|."""
    def rna(v):
        bits = v.view(torch.int32)
        mag = bits & 0x7FFFFFFF
        sign = bits & torch.iinfo(torch.int32).min
        r = ((mag + 0x1000) & ~0x1FFF) | sign
        return torch.where(mag < 0x7F800000, r.view(torch.float32), v)

    hi = rna(x.contiguous())
    return hi, torch.nan_to_num(rna(x - hi), nan=0.0)


def matmul_3xtf32(a, b):
    """a·b as K3f takes it on the tensor cores: lo·hi + hi·lo + hi·hi of
    the TF32 splits, each product of TF32 values exact in float32."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)) + torch.matmul(a_hi, b_hi)


def tail_reference_3xtf32(attn_lhs, attn_mI, wa, dws, x_a, delta, bias, N):
    """Plain version of K3f's arithmetic: ``tail_reference`` with the
    matmul and the rank-1 term in 3×TF32 (``matmul_3xtf32``), as the kernel
    takes both on the tensor cores. Used by the tests and ``chip_smoke.py``;
    the main path does not call it."""
    fc = _fc(attn_lhs, attn_mI, wa, dws, x_a, delta, bias, N, product=matmul_3xtf32)
    return pool_layernorm(fc, N)


def wide_reference_3xtf32(attn_lhs, attn_mI, wa, dws, x_a, delta, bias, N):
    """Plain version of the wide K3f's arithmetic: the matmul and the
    rank-1 term in 3×TF32 (``matmul_3xtf32``), each row's statistics over
    column tiles (``layernorm_tiled``), then the pool. Used by the tests;
    the main path does not call it."""
    fc = _fc(attn_lhs, attn_mI, wa, dws, x_a, delta, bias, N, product=matmul_3xtf32)
    B, _, h = fc.shape
    return layernorm_tiled(fc)[0].reshape(B, N, N, h).mean(dim=2)


def tail_backward_reference(args, dout, N, product=None, layernorm=_layernorm):
    """Plain version of K3b, stage by stage: (d_fc, cotangents).

    d_fc (B, N², h) is ∂⟨dout, pooled⟩/∂fc, the quantity the three kernels
    pass on; the seven cotangents of ``args`` follow from it in the
    kernels' stage order (rows; attn_lhsᵀ·d_fc; d_fc·waᵀ) and come back in
    the inputs' order. Used by the tests and ``chip_smoke.py`` to hold each
    stage of the kernel on its own. ``product`` (default ``torch.matmul``)
    takes the fc recompute's two products, d_wa and d_attn_lhs, and
    ``layernorm`` the statistics: ``matmul_3xtf32`` and ``layernorm_tiled``
    give the wide route's arithmetic.
    """
    attn_lhs, attn_mI, wa, dws, x_a, delta, bias = args
    B, _, h = dout.shape
    y, rstd = layernorm(_fc(*args, N, product=product))
    d_y = (dout / N)[:, :, None, :].expand(B, N, N, h).reshape(B, N * N, h)
    m1 = d_y.mean(-1, keepdim=True)
    m2 = (d_y * y).mean(-1, keepdim=True)
    d_fc = rstd * (d_y - m1 - y * m2)
    d4 = d_fc.reshape(B, N, N, h)                                   # [b, I, n, o]
    # 1. rows
    d_delta = torch.diagonal(d4, dim1=1, dim2=2).permute(0, 2, 1)
    d_dws = torch.einsum("bhIn,bIno->bhIo", attn_mI, d4)
    d_attn_mI = torch.einsum("bIno,bhIo->bhIn", d4, dws)
    # 2. attn_lhsᵀ·d_fc, and the sums over I and over groups
    product = torch.matmul if product is None else product
    d_wa = product(attn_lhs.transpose(1, 2), d_fc)
    d_xa = d4.sum(dim=1)
    d_bias = d_xa.sum(dim=(0, 1))
    # 3. d_fc·waᵀ
    d_attn_lhs = product(d_fc, wa.transpose(1, 2))
    return d_fc, [d_attn_lhs, d_attn_mI, d_wa, d_dws, d_xa, d_delta, d_bias]


def route(N, H, h) -> str:
    """The kernels a CUDA call takes for N agents, H heads and width h,
    by shape alone: "tuned" (K3f in ``tail_forward.cu``, K3b in
    ``baseline_tail.cu``) where h % 4 == 0, h ≤ 512, N ≤ 32 and
    H·N % 4 == 0; "wide" (``tail_wide.cu``) for every other shape."""
    tuned = h % 4 == 0 and h <= 512 and N <= 32 and (H * N) % 4 == 0
    return "tuned" if tuned else "wide"


def _check(args, N, wide=False):
    """(B, H, h) of the seven tail inputs; raises on what the route's
    kernels do not take: shape, dtype, device, layout, and the widths that
    ``route`` sends to the other route."""
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
        _check_layout(name, t, dev, wide)
    if min(B, N, H, h) < 1:
        raise ValueError(f"fused_tail: the kernels take B, N, H, h >= 1, "
                         f"got B={B}, N={N}, H={H}, h={h}")
    if not wide and route(N, H, h) != "tuned":
        raise ValueError(f"fused_tail: the tuned kernels take h % 4 == 0, h <= 512, "
                         f"N <= 32 and H*N % 4 == 0, got h={h}, N={N}, H={H} "
                         "(route() sends these to the wide kernels)")
    if wide and route(N, H, h) != "wide":
        raise ValueError(f"fused_tail: the wide kernels take the widths the tuned ones "
                         f"do not, got h={h}, N={N}, H={H} (route() sends these to the "
                         "tuned kernels)")
    if dev.type != "cuda":
        raise ValueError(f"fused_tail: tensors must lie on the CPU or a CUDA "
                         f"device, got {dev}")
    return B, H, h


def _check_layout(name, t, dev, wide=False):
    """float32, contiguous, on ``dev``; 16-byte aligned for the tuned
    kernels' float4 loads (the wide ones load 4 bytes at a time)."""
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"fused_tail: {name} must be float32 on {dev}")
    if not t.is_contiguous() or t.data_ptr() % (4 if wide else 16):
        raise ValueError(f"fused_tail: {name} must be contiguous and "
                         f"{4 if wide else 16}-byte aligned")


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


# The rows kernels of the wide K3f and K3b (tail_wide.cu), mirrored here:
# four warpgroups a block, products in tiles of 256 columns by 40 rows (row
# tiles of 40 past N = 40) through a ring of 4 stages of 8 K-columns, and a
# block's rows P·N ≤ 40 (or N where N > 40)
WIDE_COL_TILE = 256
WIDE_RING_STAGES = 4
WIDE_MAX_ROWS = 40
SMEM_BYTES = 232_448             # shared memory a block may use on the H100


class WidePlan(NamedTuple):
    """How the wide rows kernels cut a shape: ``per_block`` (P)
    counterfactuals a block; whether the P·N rows of h floats stay in
    shared memory (else the forward keeps them in a (B, N², h) scratch and
    the backward builds them in d_fc); the block's shared memory in
    bytes."""
    per_block: int
    rows_in_smem: bool
    smem_bytes: int


def _wide_smem_bytes(N, H, h, P, rows_in_smem):
    """``rows_smem_bytes`` of tail_wide.cu: the ring (8 rows of A, 256 + 8
    floats each, and B's two copies, 8 × 40 each, a stage), attn_mI
    (H × max(40, N): a row tile's rank-1 columns, then in the backward one
    counterfactual's), the statistics (3·P·N + P) and bias (h), each to
    whole float4s, and the rows."""
    def round4(n):
        return -(-n // 4) * 4

    stage = 8 * (WIDE_COL_TILE + 8) + 2 * 8 * WIDE_MAX_ROWS
    floats = (WIDE_RING_STAGES * stage + round4(H * max(WIDE_MAX_ROWS, N))
              + round4(3 * P * N + P) + round4(h))
    return 4 * (floats + (P * N * h if rows_in_smem else 0))


def wide_plan(N, H, h) -> WidePlan:
    """The plan of the wide K3f and K3b for N agents, H heads and width h:
    the most counterfactuals a block, up to ``WIDE_MAX_ROWS`` rows, whose
    rows fit in shared memory beside the ring (fewer passes over wa[b] from
    L2 a group); where not even one counterfactual's rows fit, as many as
    fit the row limit, with the rows in device memory. Every shape the
    route takes has a plan (``tests/test_torch_wide_tail_tf32.py``)."""
    most = min(N, max(1, WIDE_MAX_ROWS // N))
    for P in range(most, 0, -1):
        smem = _wide_smem_bytes(N, H, h, P, True)
        if smem <= SMEM_BYTES:
            return WidePlan(P, True, smem)
    smem = _wide_smem_bytes(N, H, h, most, False)
    if smem > SMEM_BYTES:
        raise ValueError(f"fused_tail: no plan of the wide kernels fits N={N}, H={H}, h={h}")
    return WidePlan(most, False, smem)


def _forward_kernel(args, N, wide=False):
    """K3f, on the tuned route or the wide one: pooled (B, N, h). The wide
    route keeps its fc rows in shared memory where ``wide_plan`` finds room
    (2 counterfactuals a block at B = 1024, N = 20, h = 1024: no scratch),
    else in a (B, N², h) scratch."""
    B, H, h = _check(args, N, wide)
    dev = args[0].device
    out = torch.empty((B, N, h), dtype=torch.float32, device=dev)
    if wide:
        plan = wide_plan(N, H, h)
        scratch = (None if plan.rows_in_smem
                   else torch.empty((B, N * N, h), dtype=torch.float32, device=dev))
        _cuda.launch(args[0], "fused_tail (wide)",
                     _cuda.library("tail_wide").tail_wide_forward_launch, *_ptrs(args),
                     None if scratch is None else scratch.data_ptr(), out.data_ptr(),
                     B, N, H, h, plan.per_block)
        _cuda.launches["fused_tail_wide"] += 1
        return out
    _cuda.launch(args[0], "fused_tail", _cuda.library("tail_forward").tail_forward_launch,
                 *_ptrs(args), out.data_ptr(), B, N, H, h)
    _cuda.launches["fused_tail"] += 1
    return out


def _stage_calls(args, dout, N, B, H, h, wide=False):
    """The outputs of K3b and its three launches, on the tuned route or the
    wide one (whose entry points take the same arguments, and the rows
    kernel its ``wide_plan``), for inputs that
    ``backward_kernel`` takes (it checks them; ``chip_smoke.py`` calls this
    to hold and time each stage on its own).

    Returns (d_fc, grads, stages): d_fc is the (B, N², h) scratch, grads
    the seven cotangents in the inputs' order, and ``stages`` three
    callables, each of which launches one stage on the current stream and
    raises if the launch failed. They must run in order: stage 1 writes
    d_fc, which stages 2 and 3 read.
    """
    dev = dout.device
    grads = [torch.empty_like(t) for t in args]
    d_attn_lhs, d_attn_mI, d_wa, d_dws, d_xa, d_delta, d_bias = grads
    d_fc = torch.empty((B, N * N, h), dtype=torch.float32, device=dev)
    bias_part = torch.empty((B, h), dtype=torch.float32, device=dev)
    lib = _cuda.library("tail_wide" if wide else "baseline_tail")
    entry = lambda stage: getattr(  # noqa: E731
        lib, f"tail_wide_bwd_{stage}_launch" if wide else f"tail_bwd_{stage}_launch")
    route_name = " (wide)" if wide else ""
    attn_lhs, wa = args[0], args[2]
    shape = (B, N, H, h)

    # the wide rows kernel also takes its plan: P and where the rows stay
    plan = wide_plan(N, H, h) if wide else None
    rows_plan = (plan.per_block, int(plan.rows_in_smem)) if wide else ()

    def rows():
        _cuda.launch(dout, f"fused_tail backward{route_name}, stage 1 (rows)", entry("rows"),
                     *_ptrs(args), dout.data_ptr(),
                     *_ptrs((d_fc, d_attn_mI, d_dws, d_delta)), *shape, *rows_plan)

    def wa_product():
        _cuda.launch(dout, f"fused_tail backward{route_name}, stage 2 (d_wa)", entry("wa"),
                     *_ptrs((attn_lhs, d_fc, d_wa, d_xa, d_bias, bias_part)), *shape)

    def attn_product():
        _cuda.launch(dout, f"fused_tail backward{route_name}, stage 3 (d_attn_lhs)",
                     entry("attn"), *_ptrs((d_fc, wa, d_attn_lhs)), *shape)

    return d_fc, grads, (rows, wa_product, attn_product)


def backward_kernel(args, dout, N, wide=False):
    """K3b, on the tuned route or the wide one: the cotangents of the seven
    inputs ``args`` for ``dout`` (B, N, h), in the inputs' order and shapes.

    The three kernels are joined by a (B, N², h) float32 d_fc scratch, a
    fresh ``torch.empty`` (4·B·N²·h bytes: 838.9 MB at the main path's
    B = 1024, N = 20, h = 512, 1.68 GB on the wide route at h = 1024),
    beside a (B, h) d_bias partial. Tensors that are not CUDA, and shapes
    ``_check`` refuses, raise before any launch.
    """
    if args[0].device.type != "cuda":
        raise ValueError("fused_tail backward: the kernels take CUDA tensors; "
                         "on the CPU the gradient is autograd of tail_reference")
    B, H, h = _check(args, N, wide)
    dout = dout.contiguous()
    if tuple(dout.shape) != (B, N, h):
        raise ValueError(f"fused_tail: dout must be {(B, N, h)}, "
                         f"got {tuple(dout.shape)}")
    _check_layout("dout", dout, args[0].device, wide)
    _, grads, stages = _stage_calls(args, dout, N, B, H, h, wide)
    for launch in stages:
        launch()
    _cuda.launches["fused_tail_wide_bwd" if wide else "fused_tail_bwd"] += 1
    return grads


class _FusedTail(torch.autograd.Function):
    """The tuned route: K3f forward, K3b backward (the JAX package's
    ``custom_vjp``)."""

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


class _FusedTailWide(torch.autograd.Function):
    """The wide route (``tail_wide.cu``): its K3f forward and K3b backward."""

    @staticmethod
    def forward(ctx, attn_lhs, attn_mI, wa, dws, x_a, delta, bias, N):
        args = (attn_lhs, attn_mI, wa, dws, x_a, delta, bias)
        ctx.N = N
        ctx.save_for_backward(*args)
        return _forward_kernel(args, N, wide=True)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        return (*backward_kernel(ctx.saved_tensors, dout, ctx.N, wide=True), None)


def fused_tail(attn_lhs, attn_mI, wa, dws, x_a, delta, bias, N):
    """pooled (B, N, h) from the small tail inputs (module docstring): the
    plain version on the CPU; on the card the route ``route`` names."""
    if attn_lhs.device.type == "cpu":
        return tail_reference(attn_lhs, attn_mI, wa, dws, x_a, delta, bias, N)
    wide = route(N, attn_lhs.shape[-1] // N, wa.shape[-1]) == "wide"
    return (_FusedTailWide if wide else _FusedTail).apply(
        attn_lhs, attn_mI, wa, dws, x_a, delta, bias, N)
