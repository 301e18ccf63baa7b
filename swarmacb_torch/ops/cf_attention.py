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
``torch.autograd.Function`` whose forward is the K5f kernels and whose
backward is K5b. Both start with the same stage 0, one kernel per (group,
head): the softmax terms and the base products E_aa·wa_h and E_sa·wa_h, each
once, into scratch in device memory. K5f then takes one kernel per (group,
counterfactuals): it rebuilds the rows fc from the base products, takes
their LayerNorm and pools them, and fc never reaches device memory. K5b
recomputes the attention from the nine saved inputs and returns the
cotangents of all of them (``d`` is a constant), in three more kernels
joined by scratch, the largest d_fc = ∂loss/∂fc: the rows of each (group,
counterfactual) (d_fc and the rows' scalar cotangents); the sums of each
group over counterfactuals (d_num, d_xa, d_bias); and the small products of
each (group, head) (dS_aa, dS_sa, d_wa). ``cf_forward_reference`` and
``cf_backward_reference`` compute the same stages in plain PyTorch, with fc
rebuilt by one function (``_rebuild_fc``) in both directions, as the two
rows kernels share one device function.

On a CUDA tensor ``fused_cf_attention`` takes one of two routes, picked by
shape alone (``route``): the tuned kernels above where h ≤ 512 with
h % 4 == 0, N ≤ 32 and H ≤ 4, and the wide route
(``csrc/cf_attention_wide.cu``: K5f and K5b for every other shape the JAX
function takes, any B, N, H and h ≥ 1) elsewhere, each with its own launch
counters (``fused_cf_attention`` and ``fused_cf_attention_bwd``,
``fused_cf_attention_wide`` and ``fused_cf_attention_wide_bwd``). The wide
route has the stages of the plain versions above (stage 0, then the rows
forward; or rows, sums and products backward), in float32 on the CUDA
cores, each row's sums over column tiles of at most 512 floats
(``baseline_tail.layernorm_tiled``); its rows blocks take one or two
counterfactuals and keep their fc rows in shared memory as
``cf_wide_plan`` says; what does not fit on chip goes through device
memory. A route that fails raises: neither falls back on the other.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from . import _cuda
from .baseline_tail import SMEM_BYTES, _layernorm, pool_layernorm


def cf_reference(S_aa, S_as, S_sa, S_ss, wa, dws, x_a, delta, bias, d):
    """Plain version: the JAX package's ``cf_reference``
    (cf_attention.py:337-372), the assembled-scores composition of the
    non-kernel ``POCACritic.all_baselines``. Runs in the inputs' dtype, so
    float64 inputs give a float64 referee."""
    B, N, h = x_a.shape
    fc = _fc(S_aa, S_as, S_sa, S_ss, wa, dws, x_a, delta, bias, d)
    return pool_layernorm(fc.reshape(B, N * N, h), N)


def _fc(S_aa, S_as, S_sa, S_ss, wa, dws, x_a, delta, bias, d):
    """fc (B, I, n, h) of ``cf_reference``: the pre-LayerNorm rows."""
    N = S_aa.shape[2]
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
    return fc + torch.where(eye, delta[:, :, None, :], torch.zeros_like(fc))


def cf_backward_base(S_aa, S_as, S_sa, S_ss, wa, d):
    """Stage 0 of K5f and K5b in plain PyTorch: (terms, base).

    terms (B, H, 5, N, N): E_aa[n, m], E_sa[I, m], and corr, rep and Z of row
    n of counterfactual I (zc, E_as and Z_b + zc; zc2, E_ss and Z2 on n = I),
    with the forward's shared row maxes. base (B, H, 2, N, h): the base
    products E_aa·wa_h (rows n) and E_sa·wa_h (rows I).
    """
    N = S_aa.shape[2]
    sq = math.sqrt(d)
    p_aa, p_as, p_sa, p_ss = S_aa / sq, S_as / sq, S_sa / sq, S_ss / sq
    M = torch.maximum(p_aa.amax(-1, keepdim=True), p_as.amax(-1, keepdim=True))
    Eaa, Eas = torch.exp(p_aa - M), torch.exp(p_as - M)
    M2 = torch.maximum(p_sa.amax(-1, keepdim=True), p_ss)
    Esa, Ess = torch.exp(p_sa - M2), torch.exp(p_ss - M2)             # (…, N, 1)
    zc2 = Ess - Esa.diagonal(dim1=-2, dim2=-1)[..., None]
    Z2 = Esa.sum(-1, keepdim=True) + zc2
    zc = Eas - Eaa
    eye = torch.eye(N, dtype=torch.bool, device=S_aa.device)
    terms = torch.stack([Eaa, Esa, torch.where(eye, zc2, zc), torch.where(eye, Ess, Eas),
                         torch.where(eye, Z2, Eaa.sum(-1, keepdim=True) + zc)], dim=2)
    base = torch.stack([Eaa @ wa, Esa @ wa], dim=2)
    return terms, base


def _rebuild_fc(terms, base, wa, dws, x_a, delta, bias):
    """fc (B, I, n, h) rebuilt from stage 0's ``terms`` and ``base`` as the
    rows kernels of both directions rebuild it:
    Σ_h num_h / Z + R, + x_a[n] (+ delta[I] on n = I), with
    R = bias + Σ_h (corr / Z)·wa_h[I] + (rep / Z)·dws_h[I]. Also returns
    the base row of each (n, I), num_h[n] or num2_h[I] on n = I, as
    (B, H, I, n, h)."""
    N = terms.shape[-1]
    eye = torch.eye(N, dtype=torch.bool, device=wa.device)
    _, _, corr, rep, Z = terms.unbind(2)                               # [b, hh, n, I]
    num_sel = torch.where(eye[:, :, None], base[:, :, 1, :, None, :], base[:, :, 0, None, :, :])
    t = lambda x: x.transpose(-1, -2)[..., None]                      # noqa: E731  [b, hh, I, n, 1]
    R = bias + (t(corr / Z) * wa[:, :, :, None, :] + t(rep / Z) * dws[:, :, :, None, :]).sum(1)
    fc = ((num_sel * t(1.0 / Z)).sum(dim=1) + R) + x_a[:, None]
    fc = fc + torch.where(eye[None, :, :, None], delta[:, :, None, :], torch.zeros_like(fc))
    return fc, num_sel


def cf_forward_reference(args, d, stages=None):
    """Plain version of K5f, stage by stage: pooled (B, N, h).

    Stage 0 is ``cf_backward_base``; stage 1 rebuilds fc from its terms and
    base products as the kernel does (``_rebuild_fc``), then takes the
    LayerNorm and the mean over n. With a dict ``stages``, the scratch is
    left in it under the kernels' names (``terms``, ``base``). Used by the
    tests and ``chip_smoke.py`` to hold each stage of the kernel on its
    own; ``cf_reference`` stays the CPU path of ``fused_cf_attention``.
    """
    S_aa, S_as, S_sa, S_ss, wa, dws, x_a, delta, bias = args
    B, H, N, h = wa.shape
    terms, base = cf_backward_base(S_aa, S_as, S_sa, S_ss, wa, d)
    fc, _ = _rebuild_fc(terms, base, wa, dws, x_a, delta, bias)
    if stages is not None:
        stages.update(terms=terms, base=base)
    return pool_layernorm(fc.reshape(B, N * N, h), N)


def cf_backward_reference(args, dout, d, stages=None):
    """Plain version of K5b, stage by stage: (d_fc, cotangents).

    d_fc (B, N, N, h), laid out [b, I, n, o], is ∂⟨dout, pooled⟩/∂fc, the
    quantity the rows stage passes on; fc is rebuilt from stage 0's base
    products as the kernel rebuilds it, and the nine cotangents of ``args``
    follow in the kernels' stage order (base; rows; sums over I; products)
    and come back in the inputs' order. With a dict ``stages``, the scratch
    of each stage is left in it under the kernels' names (``terms``,
    ``base``, ``d_scores``, ``d_num``). Used by the tests and
    ``chip_smoke.py`` to hold each stage of the kernel on its own.
    """
    S_aa, S_as, S_sa, S_ss, wa, dws, x_a, delta, bias = args
    B, H, N, h = wa.shape
    sq = math.sqrt(d)
    eye = torch.eye(N, dtype=torch.bool, device=wa.device)
    # 0. softmax terms and base products
    terms, base = cf_backward_base(S_aa, S_as, S_sa, S_ss, wa, d)
    Eaa, Esa, corr, rep, Z = terms.unbind(2)                           # [b, hh, n, I]
    # 1. rows: fc rebuilt from the base products, then the LayerNorm
    # backward and the rows' dot products
    fc, num_sel = _rebuild_fc(terms, base, wa, dws, x_a, delta, bias)
    y, rstd = _layernorm(fc)
    d_y = (dout / N)[:, :, None, :]
    m1 = d_y.mean(-1, keepdim=True)
    m2 = (d_y * y).mean(-1, keepdim=True)
    d_fc = rstd * (d_y - m1 - y * m2)                                 # [b, I, n, o]
    dfc = d_fc[:, None]
    A = (dfc * num_sel).sum(-1).transpose(-1, -2)                     # [b, hh, n, I]
    Bv = (dfc * wa[:, :, :, None, :]).sum(-1).transpose(-1, -2)
    C = (dfc * dws[:, :, :, None, :]).sum(-1).transpose(-1, -2)
    dZ = -((((A + corr * Bv) + rep * C) / Z) / Z)
    d_zc = Bv / Z + dZ
    d_E = C / Z + d_zc
    dS = (rep * d_E) / sq
    dS_as = torch.where(eye, torch.zeros_like(dS), dS)
    dS_ss = dS.diagonal(dim1=-2, dim2=-1)[..., None]
    d_scores = torch.stack([-d_zc, dZ], dim=2)
    d_delta = d_fc.diagonal(dim1=1, dim2=2).permute(0, 2, 1)
    d_dws = torch.einsum("bhnI,bIno->bhIo", rep / Z, d_fc)
    d_wa = torch.einsum("bhnI,bIno->bhIo", corr / Z, d_fc)
    # 2. sums over I
    inv = torch.where(eye, torch.zeros_like(Z), 1.0 / Z)
    d_num = torch.einsum("bhnI,bIno->bhno", inv, d_fc)
    d_xa = d_fc.sum(dim=1)
    d_bias = d_xa.sum(dim=(0, 1))
    # 3. products
    sdz = torch.where(eye, torch.zeros_like(dZ), dZ).sum(-1, keepdim=True)
    d_Eaa = (torch.where(eye, torch.zeros_like(d_zc), -d_zc) + sdz) + d_num @ wa.transpose(-1, -2)
    dS_aa = (Eaa * d_Eaa) / sq
    d_wa = d_wa + Eaa.transpose(-1, -2) @ d_num
    dU2 = d_delta[:, None] / Z.diagonal(dim1=-2, dim2=-1)[..., None]
    diag = lambda x: x.diagonal(dim1=-2, dim2=-1)[..., None]          # noqa: E731
    d_Esa = (diag(dZ) + torch.where(eye, diag(-d_zc), torch.zeros_like(dZ))) \
        + dU2 @ wa.transpose(-1, -2)
    dS_sa = (Esa * d_Esa) / sq
    d_wa = d_wa + Esa.transpose(-1, -2) @ dU2
    if stages is not None:
        stages.update(terms=terms, base=base, d_scores=d_scores, d_num=d_num)
    return d_fc, [dS_aa, dS_as, dS_sa, dS_ss, d_wa, d_dws, d_xa, d_delta, d_bias]


NAMES = ("S_aa", "S_as", "S_sa", "S_ss", "wa", "dws", "x_a", "delta", "bias")


def route(N, H, h) -> str:
    """The kernels a CUDA call takes for N agents, H heads and width h,
    by shape alone: "tuned" (``cf_attention.cu``) where h % 4 == 0,
    h ≤ 512, N ≤ 32 and H ≤ 4; "wide" (``cf_attention_wide.cu``) for every
    other shape."""
    return "tuned" if h % 4 == 0 and h <= 512 and N <= 32 and H <= 4 else "wide"


# The rows kernels of the wide K5f and K5b (cf_attention_wide.cu), mirrored
# here: blocks of 512 threads, at most two counterfactuals a block, the
# dot products of 8 rows meeting in shared memory at a time
WIDE_THREADS = 512
WIDE_MAX_PER_BLOCK = 2
WIDE_RED_ROWS = 8


class CfWidePlan(NamedTuple):
    """How the wide rows kernels cut a shape: ``per_block`` (P)
    counterfactuals a block; whether the P·N rows of h floats stay in
    shared memory (else the forward keeps them in a (B, N², h) scratch and
    the backward builds them in d_fc, and their statistics, 3·P·N + P
    floats a block, go to a scratch); whether the block's coefficients
    (1/Z, corr/Z, rep/Z of its rows and heads) and, in the backward,
    dout / N of its counterfactuals stay there too; each direction's
    shared memory in bytes."""
    per_block: int
    rows_in_smem: bool
    coef_in_smem: bool
    dy_in_smem: bool
    fwd_smem_bytes: int
    bwd_smem_bytes: int


def _wide_head_floats(N, H, h, P, stats_in_smem, coef_in_smem, dy_in_smem):
    """``rows_head_floats`` of cf_attention_wide.cu: the warps' dot-product
    sums (two buffers of 8 rows of 512 floats), the statistics (3·P·N + P),
    the coefficients (P·N·3·Hp, Hp = H in whole float4s) and in the
    backward dout / N of each counterfactual (P·h), each to whole float4s."""
    def round4(n):
        return -(-n // 4) * 4

    return (2 * WIDE_RED_ROWS * WIDE_THREADS
            + (round4(3 * P * N + P) if stats_in_smem else 0)
            + (P * N * 3 * round4(H) if coef_in_smem else 0)
            + (P * round4(h) if dy_in_smem else 0))


def cf_wide_plan(N, H, h) -> CfWidePlan:
    """The plan of the wide K5f and K5b rows kernels for N agents, H heads
    and width h: the most counterfactuals a block, up to two, whose rows fit
    in shared memory beside the statistics, the coefficients and the
    backward's dout / N (each base row is then read once for them); where
    not even one counterfactual's rows fit, two, with the rows and their
    statistics in device memory, and the coefficients (``coef_fits`` in the
    source), then dout / N in shared memory where they fit, else in device
    memory. Every shape gets a plan."""
    most = min(N, WIDE_MAX_PER_BLOCK)

    def nbytes(P, rows, coef, dy):  # the statistics live where the rows do
        return 4 * (_wide_head_floats(N, H, h, P, rows, coef, dy) + (P * N * h if rows else 0))

    for P in range(most, 0, -1):
        if nbytes(P, True, True, True) <= SMEM_BYTES:
            return CfWidePlan(P, True, True, True, nbytes(P, True, True, False),
                              nbytes(P, True, True, True))
    coef = nbytes(most, False, True, False) <= SMEM_BYTES
    dy = nbytes(most, False, coef, True) <= SMEM_BYTES
    return CfWidePlan(most, False, coef, dy, nbytes(most, False, coef, False),
                      nbytes(most, False, coef, dy))


def _stats_scratch(empty, plan, B, N):
    """The rows kernels' statistics where the rows are in device memory:
    3·P·N + P floats for each of the B·⌈N/P⌉ blocks; else None."""
    if plan.rows_in_smem:
        return None
    P = plan.per_block
    return empty(B * -(-N // P) * (3 * P * N + P))


def _check(args, wide=False):
    """(B, N, H, h) of the nine inputs; raises on what the route's kernels
    do not take: shape, dtype, device, layout, and the widths that
    ``route`` sends to the other route."""
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
        _check_layout(name, t, dev, wide)
    if min(B, N, H, h) < 1:
        raise ValueError(f"fused_cf_attention: the kernels take B, N, H, h >= 1, "
                         f"got B={B}, N={N}, H={H}, h={h}")
    if not wide and route(N, H, h) != "tuned":
        raise ValueError(f"fused_cf_attention: the tuned kernels take h % 4 == 0, "
                         f"h <= 512, N <= 32 and H <= 4, got h={h}, N={N}, H={H} "
                         "(route() sends these to the wide kernels)")
    if wide and route(N, H, h) != "wide":
        raise ValueError(f"fused_cf_attention: the wide kernels take the widths the tuned "
                         f"ones do not, got h={h}, N={N}, H={H} (route() sends these to "
                         "the tuned kernels)")
    if dev.type != "cuda":
        raise ValueError(f"fused_cf_attention: the kernels take CUDA tensors, got "
                         f"{dev} (CPU tensors take the plain version)")
    return B, N, H, h


def _check_layout(name, t, dev, wide=False):
    """float32, contiguous, on ``dev``; 16-byte aligned for the tuned
    kernels' float4 loads (the wide ones load 4 bytes at a time)."""
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"fused_cf_attention: {name} must be float32 on {dev}")
    if not t.is_contiguous() or t.data_ptr() % (4 if wide else 16):
        raise ValueError(f"fused_cf_attention: {name} must be contiguous and "
                         f"{4 if wide else 16}-byte aligned")


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


def _empty(dev):
    return lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)


def _base_stage(lib, args, scratch, shape, sqrt_d, what, wide=False):
    """A callable that launches stage 0 of both directions (terms, base; on
    the wide route also coef), on the tuned route or the wide one."""
    S_aa, S_as, S_sa, S_ss, wa = args[:5]
    outs = ((scratch["terms"], scratch["coef"], scratch["base"]) if wide
            else (scratch["terms"], scratch["base"]))
    entry = lib.cf_wide_base_launch if wide else lib.cf_bwd_base_launch

    def launch():
        _cuda.launch(wa, f"fused_cf_attention {what}, stage 0 (base)", entry,
                     *_ptrs((S_aa, S_as, S_sa, S_ss, wa, *outs)), *shape, sqrt_d)
    return launch


def _stage0_scratch(empty, B, N, H, h, wide):
    """Stage 0's scratch: the terms (B, H, 5, N, N) and the base products
    (B, H, 2, N, h); on the wide route also the rows kernels' coefficients
    1/Z, corr/Z and rep/Z (B, N, N, 3, H rounded up to a multiple of 4)."""
    scratch = {"terms": empty(B, H, 5, N, N), "base": empty(B, H, 2, N, h)}
    if wide:
        scratch["coef"] = empty(B, N, N, 3, -(-H // 4) * 4)
    return scratch


def _library(wide):
    return _cuda.library("cf_attention_wide" if wide else "cf_attention")


def _forward_stage_calls(args, d, B, N, H, h, wide=False):
    """The output of K5f and its two launches, on the tuned route or the
    wide one, for inputs that ``forward_kernel`` takes (it checks them;
    ``chip_smoke.py`` calls this to hold and time each stage on its own).

    Returns (scratch, pooled, stages): ``scratch`` the stage-0 scratch by
    name (``terms``, ``base``; on the wide route also ``coef``, and ``rows``
    and their ``stats`` where ``cf_wide_plan`` does not keep the fc rows in
    shared memory), ``pooled`` the (B, N, h) output,
    and ``stages`` two callables, each of which launches one stage on the
    current stream and raises if its launch failed; stage 1 reads what
    stage 0 wrote.
    """
    empty = _empty(args[0].device)
    scratch = _stage0_scratch(empty, B, N, H, h, wide)
    terms, base = scratch["terms"], scratch["base"]
    pooled = empty(B, N, h)
    lib = _library(wide)
    wa, dws, x_a, delta, bias = args[4:]
    shape = (B, N, H, h)
    if wide:
        plan = cf_wide_plan(N, H, h)
        if not plan.rows_in_smem:
            scratch["rows"] = empty(B, N * N, h)
        stats = _stats_scratch(empty, plan, B, N)
        if stats is not None:
            scratch["stats"] = stats
        optional = [None if t is None else t.data_ptr() for t in (scratch.get("rows"), stats)]

        def rows():
            _cuda.launch(wa, "fused_cf_attention forward (wide), stage 1 (rows)",
                         lib.cf_wide_fwd_rows_launch,
                         *_ptrs((scratch["coef"], base, wa, dws, x_a, delta, bias)),
                         *optional, pooled.data_ptr(), *shape, plan.per_block)
    else:
        def rows():
            _cuda.launch(wa, "fused_cf_attention forward, stage 1 (rows)",
                         lib.cf_fwd_rows_launch,
                         *_ptrs((terms, base, wa, dws, x_a, delta, bias, pooled)), *shape)

    return scratch, pooled, (_base_stage(lib, args, scratch, shape, math.sqrt(d), "forward",
                                         wide), rows)


def forward_kernel(args, d, wide=False):
    """K5f, on the tuned route or the wide one: pooled (B, N, h) of the
    nine inputs ``args``.

    Two stages joined by scratch, each a fresh ``torch.empty``: the terms
    (20·B·H·N² bytes, 32.8 MB at the main path's B = 1024, N = 20, H = 4)
    and the base products (8·B·H·N·h bytes, 335.5 MB at h = 512, 671.1 MB
    on the wide route at h = 1024), freed when the call returns; the wide
    route adds the coefficients (12·B·N²·⌈H/4⌉·4 bytes, 19.7 MB) and keeps
    its fc rows in shared memory where ``cf_wide_plan`` finds room (two
    counterfactuals a block at N = 20, h = 1024), else in a (B, N², h)
    scratch. Tensors that are not CUDA, and shapes ``_check`` refuses,
    raise before any launch.
    """
    B, N, H, h = _check(args, wide)
    _, pooled, stages = _forward_stage_calls(args, d, B, N, H, h, wide)
    for launch in stages:
        launch()
    _cuda.launches["fused_cf_attention_wide" if wide else "fused_cf_attention"] += 1
    return pooled


def _stage_calls(args, dout, d, B, N, H, h, wide=False):
    """The outputs of K5b and its four launches, on the tuned route or the
    wide one, for inputs that ``backward_kernel`` takes (it checks them;
    ``chip_smoke.py`` calls this to hold and time each stage on its own).

    Returns (scratch, grads, stages): ``scratch`` the stages' scratch by
    name (``terms``, ``base``, ``d_fc``, ``d_scores``, ``d_num``,
    ``bias_part``, and on the wide route ``coef``, ``dots``, the rows'
    three dot products of each head (B, N, N, 3, H), and ``stats`` where
    ``cf_wide_plan`` does not keep the rows in shared memory; shapes in
    ``cf_backward_reference`` and the kernel sources), grads
    the nine cotangents in the inputs' order, and ``stages`` four
    callables, each of which launches one stage on the current stream and
    raises if a launch failed. They must run in order: each stage reads
    what the ones before it wrote, and stage 3 completes d_wa in place.
    """
    grads = [torch.empty_like(t) for t in args]
    dS_aa, dS_as, dS_sa, dS_ss, d_wa, d_dws, d_xa, d_delta, d_bias = grads
    empty = _empty(dout.device)
    scratch = _stage0_scratch(empty, B, N, H, h, wide)
    scratch.update(d_fc=empty(B, N, N, h), d_scores=empty(B, H, 2, N, N),
                   d_num=empty(B, H, N, h), bias_part=empty(B, h))
    terms, base, d_fc, d_scores, d_num, bias_part = (
        scratch[k] for k in ("terms", "base", "d_fc", "d_scores", "d_num", "bias_part"))
    lib = _library(wide)
    wa, dws, x_a, delta, bias = args[4:]
    shape, sqrt_d = (B, N, H, h), math.sqrt(d)
    what = "fused_cf_attention backward" + (" (wide)" if wide else "")

    if wide:
        # the rows kernel also takes the scratch of its dot products and its plan
        scratch["dots"] = empty(B, N, N, 3, H)
        plan = cf_wide_plan(N, H, h)
        stats = _stats_scratch(empty, plan, B, N)
        if stats is not None:
            scratch["stats"] = stats

        def rows():
            _cuda.launch(dout, f"{what}, stage 1 (rows)", lib.cf_wide_bwd_rows_launch,
                         *_ptrs((terms, scratch["coef"], base, wa, dws, x_a, delta, bias, dout,
                                 d_fc, scratch["dots"])),
                         None if stats is None else stats.data_ptr(),
                         *_ptrs((dS_as, dS_ss, d_wa, d_dws, d_delta, d_scores)), *shape,
                         plan.per_block, int(plan.rows_in_smem), int(plan.dy_in_smem), sqrt_d)
    else:
        def rows():
            _cuda.launch(dout, f"{what}, stage 1 (rows)", lib.cf_bwd_rows_launch,
                         *_ptrs((terms, base, wa, dws, x_a, delta, bias, dout, d_fc, dS_as,
                                 dS_ss, d_wa, d_dws, d_delta, d_scores)), *shape, sqrt_d)

    # stages 2 and 3 take the same arguments on both routes
    def sums():
        _cuda.launch(dout, f"{what}, stage 2 (sums)",
                     lib.cf_wide_bwd_sums_launch if wide else lib.cf_bwd_sums_launch,
                     *_ptrs((terms, d_fc, d_num, d_xa, bias_part, d_bias)), *shape)

    def products():
        _cuda.launch(dout, f"{what}, stage 3 (products)",
                     lib.cf_wide_bwd_products_launch if wide else lib.cf_bwd_products_launch,
                     *_ptrs((terms, wa, d_num, d_delta, d_scores, dS_aa, dS_sa, d_wa)),
                     *shape, sqrt_d)

    return scratch, grads, (_base_stage(lib, args, scratch, shape, sqrt_d, "backward", wide),
                            rows, sums, products)


def backward_kernel(args, dout, d, wide=False):
    """K5b, on the tuned route or the wide one: the cotangents of the nine
    inputs ``args`` for ``dout`` (B, N, h), in the inputs' order and shapes.

    The four kernels are joined by scratch, each a fresh ``torch.empty``;
    the largest is the (B, N, N, h) float32 d_fc, 4·B·N²·h bytes, beside
    the base products and d_num (8·B·H·N·h and 4·B·H·N·h bytes), the terms
    and score scratch (28·B·H·N² bytes, 45.9 MB at B = 1024, N = 20, H = 4)
    and a (B, h) d_bias partial: at the main path's B = 1024, N = 20,
    h = 512 that is 838.9, 335.5 and 167.8 MB, ~1.39 GB in all. The wide
    route adds the coefficients and the dots (12·B·N²·⌈H/4⌉·4 and
    12·B·N²·H bytes); at h = 1024 its scratch is 1.68 GB of d_fc, 671.1 MB
    of base products, 335.5 MB of d_num and 85.2 MB of terms, scores,
    coefficients and dots, ~2.77 GB. Tensors that are not CUDA, and shapes
    ``_check`` refuses, raise before any launch.
    """
    if args[0].device.type != "cuda":
        raise ValueError("fused_cf_attention backward: the kernels take CUDA "
                         "tensors; on the CPU the gradient is autograd of cf_reference")
    B, N, H, h = _check(args, wide)
    dout = dout.contiguous()
    if tuple(dout.shape) != (B, N, h):
        raise ValueError(f"fused_cf_attention: dout must be {(B, N, h)}, "
                         f"got {tuple(dout.shape)}")
    _check_layout("dout", dout, args[0].device, wide)
    _, grads, stages = _stage_calls(args, dout, d, B, N, H, h, wide)
    for launch in stages:
        launch()
    _cuda.launches["fused_cf_attention_wide_bwd" if wide else "fused_cf_attention_bwd"] += 1
    return grads


class _FusedCfAttention(torch.autograd.Function):
    """The tuned route: K5f forward, K5b backward (the JAX package's
    ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, S_aa, S_as, S_sa, S_ss, wa, dws, x_a, delta, bias, d):
        args = (S_aa, S_as, S_sa, S_ss, wa, dws, x_a, delta, bias)
        ctx.d = d
        ctx.save_for_backward(*args)
        return forward_kernel(args, d)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        return (*backward_kernel(ctx.saved_tensors, dout, ctx.d), None)


class _FusedCfAttentionWide(torch.autograd.Function):
    """The wide route (``cf_attention_wide.cu``): its K5f forward and K5b
    backward."""

    @staticmethod
    def forward(ctx, S_aa, S_as, S_sa, S_ss, wa, dws, x_a, delta, bias, d):
        args = (S_aa, S_as, S_sa, S_ss, wa, dws, x_a, delta, bias)
        ctx.d = d
        ctx.save_for_backward(*args)
        return forward_kernel(args, d, wide=True)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        return (*backward_kernel(ctx.saved_tensors, dout, ctx.d, wide=True), None)


def fused_cf_attention(S_aa, S_as, S_sa, S_ss, wa, dws, x_a, delta, bias, d):
    """pooled (B, N, h) from raw scores and folded values (module
    docstring): the plain version on the CPU; on the card the route
    ``route`` names. ``d`` is the per-head dimension (softmax scale 1/√d)."""
    args = (S_aa, S_as, S_sa, S_ss, wa, dws, x_a, delta, bias)
    if S_aa.device.type == "cpu":
        return cf_reference(*args, d)
    B, H, N, _ = S_aa.shape
    wide = route(N, H, wa.shape[-1]) == "wide"
    return (_FusedCfAttentionWide if wide else _FusedCfAttention).apply(*args, d)
