"""The wide route of the critic tail (K3f-wide, K3b-wide) in 3×TF32, on the CPU.

On the card ``tail_wide.cu`` takes every product of the wide tail on the
tensor cores in 3×TF32 (each operand split into a TF32 high part and a TF32
remainder by ``split_tf32``, the product lo·hi + hi·lo + hi·hi): the
forward's fc (with the rank-1 term as extra K columns), and the backward's
fc recompute, d_wa = attn_lhsᵀ·d_fc and d_attn_lhs = d_fc·waᵀ. The rest is
float32, with each row's LayerNorm statistics over column tiles of 512
(``layernorm_tiled``). ``wide_reference_3xtf32`` and
``tail_backward_reference(..., product=matmul_3xtf32,
layernorm=layernorm_tiled)`` are that arithmetic in plain PyTorch;
``chip_smoke.py`` (phase 2h) holds the kernels to the float32 plain
versions on the card. Here, from inputs made with numpy from a seed, at
small B:

- the 3×TF32 plain versions agree with the JAX package's ``fused_tail``
  and its ``jax.vjp`` in interpret mode (forward 1e-5 + 1e-5·|ref|,
  cotangents rtol 1e-5, atol 2e-5: the tolerances of
  ``tests/test_torch_wide_critic.py``) at h = 1024 and at ragged shapes;
- they agree with the float32 plain versions within phase 2h's tolerances
  (pooled 1e-5 + 1e-5·|plain|; d_fc and each cotangent 1e-5·max|plain|),
  also at N = 100, past two row tiles of 40;
- with a single TF32 product in their place, the forward and the backward
  miss those tolerances at h = 1024: the tolerances tell 3×TF32 from TF32;
- ``wide_plan``, the wrapper's plan of the rows kernels, gives a plan for
  every shape the route takes, within the card's shared memory, and
  mirrors the constants of ``tail_wide.cu``.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.ops import baseline_tail as jbt

from swarmacb_torch.ops import _cuda, baseline_tail
from torch_threads import one_torch_thread  # noqa: F401

NAMES = ("attn_lhs", "attn_mI", "wa", "dws", "x_a", "delta", "bias")
# (B, N, H, h): the full width, a ragged one (N > 32, h % 4 != 0,
# H·N % 4 != 0), h not a multiple of the 256-column product tile, a small
# ragged one
JAX_SHAPES = [(2, 20, 4, 1024), (2, 33, 3, 130), (1, 20, 4, 1000), (2, 7, 3, 6)]
RTOL = 1e-5                 # chip_smoke.py phase 2h
PLAN_MAIN = 4 * (4 * (8 * 264 + 2 * 8 * 40) + 4 * 40 + 124 + 1024 + 2 * 20 * 1024)  # 213,104


def _inputs(B, N, H, h, seed):
    """The seven tail inputs and dout: attention rows that sum to one per
    head (attn_mI is the column m = I of the same rows), folded values and
    residual entities at the critic's scale."""
    rng = np.random.default_rng(seed)
    attn = rng.uniform(size=(B, N, H, N, N))
    attn /= attn.sum(-1, keepdims=True)                        # (B, I, H, n, m)
    arrays = [attn.transpose(0, 1, 3, 2, 4).reshape(B, N * N, H * N),
              np.einsum("bIhnI->bhIn", attn),
              rng.normal(size=(B, H * N, h)) * 0.3, rng.normal(size=(B, H, N, h)) * 0.2,
              rng.normal(size=(B, N, h)), rng.normal(size=(B, N, h)) * 0.5,
              rng.normal(size=(h,)) * 0.1]
    arrays = [np.ascontiguousarray(a, dtype=np.float32) for a in arrays]
    return arrays, rng.normal(size=(B, N, h)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(B, N, H, h):
    """Inputs, dout, and the Pallas forward and cotangents (interpret mode)."""
    arrays, dout = _inputs(B, N, H, h, seed=B + N + H + h)
    out, vjp = jax.vjp(lambda *a: jbt.fused_tail(*a, N, True), *map(jnp.asarray, arrays))
    cot = [np.asarray(c) for c in vjp(jnp.asarray(dout))]
    return arrays, dout, np.asarray(out), cot


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _one_tf32(a, b):
    """a·b as a single TF32 product: hi·hi alone."""
    return torch.matmul(baseline_tail.split_tf32(a)[0], baseline_tail.split_tf32(b)[0])


def _wide_backward(arrays, dout, N, product=baseline_tail.matmul_3xtf32):
    return baseline_tail.tail_backward_reference(_t(arrays), torch.from_numpy(dout), N,
                                                 product=product,
                                                 layernorm=baseline_tail.layernorm_tiled)


def _within_phase_2h(got_fc, got, want_fc, want):
    """Names of d_fc and the cotangents past 1e-5·max|plain|."""
    past = []
    for name, g, w in zip(("d_fc", *NAMES), (got_fc, *got), (want_fc, *want)):
        assert g.shape == w.shape, name
        if float((g - w).abs().max()) > RTOL * float(w.abs().max()):
            past.append(name)
    return past


@pytest.mark.parametrize("B,N,H,h", JAX_SHAPES)
def test_3xtf32_wide_forward_matches_the_pallas_forward(one_torch_thread, B, N, H, h):
    arrays, _, want, _ = _case(B, N, H, h)
    got = baseline_tail.wide_reference_3xtf32(*_t(arrays), N).numpy()
    assert got.shape == (B, N, h)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,N,H,h", JAX_SHAPES)
def test_3xtf32_wide_backward_matches_the_pallas_vjp(one_torch_thread, B, N, H, h):
    arrays, dout, _, want = _case(B, N, H, h)
    d_fc, got = _wide_backward(arrays, dout, N)
    assert tuple(d_fc.shape) == (B, N * N, h)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=2e-5,
                                   err_msg=f"cotangent of {name}")


@pytest.mark.parametrize("B,N,H,h", [*JAX_SHAPES, (1, 100, 4, 64)])
def test_3xtf32_wide_route_within_phase_2h_of_the_float32_plain(one_torch_thread, B, N, H, h):
    arrays, dout = _inputs(B, N, H, h, seed=3 * N + h)
    got = baseline_tail.wide_reference_3xtf32(*_t(arrays), N)
    want = baseline_tail.tail_reference(*_t(arrays), N)
    assert bool(((got - want).abs() <= RTOL + RTOL * want.abs()).all())
    got_fc, got_g = _wide_backward(arrays, dout, N)
    want_fc, want_g = baseline_tail.tail_backward_reference(_t(arrays), torch.from_numpy(dout),
                                                            N)
    assert _within_phase_2h(got_fc, got_g, want_fc, want_g) == []


def test_one_tf32_product_misses_phase_2h_at_h_1024(one_torch_thread):
    """hi·hi alone, in each product of the forward and of the backward, is
    what phase 2h's tolerances must refuse."""
    B, N, H, h = JAX_SHAPES[0]
    arrays, dout = _inputs(B, N, H, h, seed=3 * N + h)
    want = baseline_tail.tail_reference(*_t(arrays), N)
    fc = baseline_tail._fc(*_t(arrays), N, product=_one_tf32)
    got = baseline_tail.layernorm_tiled(fc)[0].reshape(B, N, N, h).mean(dim=2)
    assert not bool(((got - want).abs() <= RTOL + RTOL * want.abs()).all())
    got_fc, got_g = _wide_backward(arrays, dout, N, product=_one_tf32)
    want_fc, want_g = baseline_tail.tail_backward_reference(_t(arrays), torch.from_numpy(dout),
                                                            N)
    # d_fc, past the LayerNorm, stays within its tolerance; the products'
    # own outputs do not
    past = _within_phase_2h(got_fc, got_g, want_fc, want_g)
    assert {"attn_lhs", "wa"} <= set(past), past


# ── the plan of the rows kernels ──────────────────────────────────────────

def _constant(source, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


def test_plan_mirrors_the_kernel_source():
    source = (_cuda.CSRC / "tail_wide.cu").read_text(encoding="utf-8")
    assert _constant(source, "kRowsStages") == baseline_tail.WIDE_RING_STAGES
    assert _constant(source, "kMaxRows") == baseline_tail.WIDE_MAX_ROWS
    common = (_cuda.CSRC / "wide_common.cuh").read_text(encoding="utf-8")
    assert _constant(common, "kTcCols") == baseline_tail.WIDE_COL_TILE
    assert _constant(common, "kMaxSmem") == baseline_tail.SMEM_BYTES


@pytest.mark.parametrize("N,H,h,plan", [
    (20, 4, 1024, (2, True, PLAN_MAIN)),       # the full width: 2 counterfactuals, 160 KB
    (20, 4, 1000, (2, True, None)),
    (20, 4, 512, (2, True, None)),             # (the tuned route's width)
    (33, 3, 130, (1, True, None)),
    (100, 4, 1024, (1, False, None)),          # three row tiles; the rows in device memory
    (20, 4, 4096, (2, False, None)),
    (1, 1, 1, (1, True, None)),
])
def test_plan_at_the_route_s_edges(N, H, h, plan):
    got = baseline_tail.wide_plan(N, H, h)
    assert (got.per_block, got.rows_in_smem) == plan[:2]
    assert plan[2] is None or got.smem_bytes == plan[2]


def test_plan_for_every_shape_the_route_takes():
    """Every (N, H, h) gets a plan: at least one counterfactual a block, at
    most 40 rows (or one counterfactual past 40 agents), within the card's
    shared memory; the rows in shared memory with the most counterfactuals
    that fit, else in device memory."""
    for N in [*range(1, 42), 47, 64, 80, 81, 100, 128, 256, 1000]:
        for H in (1, 2, 3, 4, 8, 16):
            for h in (1, 2, 3, 6, 130, 512, 516, 1000, 1024, 2048, 4096, 8192):
                P, in_smem, smem = baseline_tail.wide_plan(N, H, h)
                most = min(N, max(1, 40 // N))
                assert 1 <= P <= most and smem <= baseline_tail.SMEM_BYTES, (N, H, h)
                assert smem == baseline_tail._wide_smem_bytes(N, H, h, P, in_smem)
                if in_smem and P < most:
                    assert baseline_tail._wide_smem_bytes(N, H, h, P + 1, True) > \
                        baseline_tail.SMEM_BYTES, (N, H, h)
                if not in_smem:
                    assert P == most and baseline_tail._wide_smem_bytes(
                        N, H, h, 1, True) > baseline_tail.SMEM_BYTES, (N, H, h)
