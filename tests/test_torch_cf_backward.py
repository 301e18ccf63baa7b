"""The staged plain version of the fused attention's backward (K5b) on the CPU.

On the card K5b runs as four kernels joined by scratch in device memory:
the softmax terms and base products of each (group, head), the rows of each
(group, counterfactual) with d_fc = ∂⟨dout, pooled⟩/∂fc (B, N, N, h), the
sums of each group over counterfactuals, and the small products of each
(group, head). ``cf_backward_reference`` computes the same stages in plain
PyTorch; ``chip_smoke.py`` holds the kernels to it on the card. Here it is
held, from inputs made with numpy from a seed:

- to ``jax.vjp`` of the JAX package's ``fused_cf_attention`` in interpret
  mode, which runs the Pallas backward body ``_bwd_kernel``: all nine
  cotangents at rtol 2e-4, atol 2e-5, the tolerance of
  ``tests/test_torch_cf_attention.py``, at (B, N, H, h) = (4, 6, 2, 64),
  (3, 5, 4, 32) and (2, 20, 4, 512), the last the main path's width, with
  scores at a trained-like scale (×3);
- with saturated scores (×12), both it and the Pallas backward to a float64
  plain run: its error in each cotangent at most 4 times the Pallas
  kernel's own, or 4 ulp of the cotangent's largest element. Both compute
  the partition of row (n, I) as Z_b − E_aa[n, I] + E_as[n, I] and the
  numerator from the shared base product, which cancel when E_aa[n, I]
  dominates its row (as it does at (3, 5, 4, 32)): the two then miss the
  float64 result, and each other, by more than rtol 2e-4, in other
  elements;
- its d_fc to autograd's gradient at an explicit fc tensor, at 1e-6: the
  same float32 LayerNorm backward on an fc rebuilt in another order;
- its cotangents to plain autograd through ``cf_reference``, the CPU
  trainer's path, at rtol 2e-4, atol 2e-5.

The kernels' wrapper refuses CPU tensors (no silent plain path) and shapes
the tuned kernels do not take, which ``route`` sends to the wide kernels,
and the four stages' C entry points are registered with their argument
counts.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.ops import cf_attention as jcf

from swarmacb_torch.ops import _cuda, cf_attention
from swarmacb_torch.ops.baseline_tail import pool_layernorm
from swarmacb_torch.ops.cf_attention import NAMES

SHAPES = [(4, 6, 2, 64), (3, 5, 4, 32), (2, 20, 4, 512)]


def _inputs(B, N, H, h, seed, score_scale=3.0):
    """Raw scores at ``score_scale``, folded values, residual entities,
    bias and dout, as tests/test_cf_attention.py draws them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    arrays = [f(B, H, N, N) * score_scale, f(B, H, N, N) * score_scale,
              f(B, H, N, N) * score_scale, f(B, H, N, 1) * score_scale,
              f(B, H, N, h), f(B, H, N, h), f(B, N, h), f(B, N, h), f(h)]
    return [a.astype(np.float32) for a in arrays], f(B, N, h), h // H


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@functools.lru_cache(maxsize=None)
def _pallas_backward(d):
    """The Pallas kernel's cotangents for dout, compiled once per shape."""
    def cotangents(arrays, dout):
        _, vjp = jax.vjp(lambda *a: jcf.fused_cf_attention(*a, d, True), *arrays)
        return vjp(dout)
    return jax.jit(cotangents)


def _pallas_and_staged(B, N, H, h, score_scale):
    arrays, dout, d = _inputs(B, N, H, h, seed=B * N + h, score_scale=score_scale)
    want = [np.asarray(w) for w in _pallas_backward(d)(
        tuple(map(jnp.asarray, arrays)), jnp.asarray(dout))]
    d_fc, got = cf_attention.cf_backward_reference(_torch(arrays), torch.from_numpy(dout), d)
    assert tuple(d_fc.shape) == (B, N, N, h)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
    return arrays, dout, d, [g.numpy() for g in got], want


@pytest.mark.parametrize("B,N,H,h", SHAPES)
def test_staged_reference_matches_the_pallas_backward(B, N, H, h):
    *_, got, want = _pallas_and_staged(B, N, H, h, 3.0)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5, err_msg=f"cotangent of {name}")


@pytest.mark.parametrize("B,N,H,h", SHAPES)
def test_saturated_scores_as_accurate_as_the_pallas_backward(B, N, H, h):
    arrays, dout, d, got, want = _pallas_and_staged(B, N, H, h, 12.0)
    args64 = [torch.from_numpy(a).double().requires_grad_() for a in arrays]
    truth = torch.autograd.grad(cf_attention.cf_reference(*args64, d), args64,
                                torch.from_numpy(dout).double())
    for name, g, w, t in zip(NAMES, got, want, truth):
        t = t.numpy()
        err_staged, err_pallas = np.abs(g - t).max(), np.abs(w - t).max()
        floor = 4 * float(np.spacing(np.float32(np.abs(t).max())))
        assert err_staged <= max(4 * err_pallas, floor), (
            f"cotangent of {name}: error {err_staged:.3e} against float64, the Pallas "
            f"backward's {err_pallas:.3e}")


@pytest.mark.parametrize("B,N,H,h", SHAPES)
def test_d_fc_is_the_gradient_at_fc(B, N, H, h):
    arrays, dout, d = _inputs(B, N, H, h, seed=B + N + h)
    args, dout = _torch(arrays), torch.from_numpy(dout)
    fc = cf_attention._fc(*args, d).detach().requires_grad_()
    want, = torch.autograd.grad(pool_layernorm(fc.reshape(B, N * N, h), N), fc, dout)
    d_fc, _ = cf_attention.cf_backward_reference(args, dout, d)
    np.testing.assert_allclose(d_fc.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,N,H,h", SHAPES)
def test_staged_reference_matches_autograd_of_cf_reference(B, N, H, h):
    arrays, dout, d = _inputs(B, N, H, h, seed=3 * B + h)
    args = [t.requires_grad_() for t in _torch(arrays)]
    dout = torch.from_numpy(dout)
    want = torch.autograd.grad(cf_attention.cf_reference(*args, d), args, dout)
    stages = {}
    _, got = cf_attention.cf_backward_reference([a.detach() for a in args], dout, d,
                                                stages=stages)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=f"cotangent of {name}")
    assert {k: tuple(v.shape) for k, v in stages.items()} == {
        "terms": (B, H, 5, N, N), "base": (B, H, 2, N, h),
        "d_scores": (B, H, 2, N, N), "d_num": (B, H, N, h)}


def test_backward_kernel_refuses_cpu_tensors():
    arrays, dout, d = _inputs(2, 5, 2, 32, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        cf_attention.backward_kernel(_torch(arrays), torch.from_numpy(dout), d)
    # the CPU gradient is plain autograd of the plain version
    args = [t.requires_grad_() for t in _torch(arrays)]
    before = _cuda.launches["fused_cf_attention_bwd"]
    torch.autograd.grad(cf_attention.fused_cf_attention(*args, d), args,
                        torch.from_numpy(dout))
    assert _cuda.launches["fused_cf_attention_bwd"] == before


@pytest.mark.parametrize("B,N,H,h", [(2, 33, 4, 32), (2, 5, 5, 32), (2, 5, 4, 516),
                                     (2, 5, 4, 30)])
def test_shapes_the_kernels_do_not_take_are_refused(B, N, H, h):
    """N > 32, H > 4, h > 512 and h % 4 != 0 raise in the tuned kernels'
    check before any launch (the meta device: no data, and no kernel can
    run on it); ``route`` sends them to the wide kernels, whose check
    refuses only the device."""
    meta = lambda *s: torch.zeros(s, device="meta")  # noqa: E731
    args = (meta(B, H, N, N), meta(B, H, N, N), meta(B, H, N, N), meta(B, H, N, 1),
            meta(B, H, N, h), meta(B, H, N, h), meta(B, N, h), meta(B, N, h), meta(h))
    with pytest.raises(ValueError, match=r"h <= 512, N <= 32 and H <= 4"):
        cf_attention._check(args)
    assert cf_attention.route(N, H, h) == "wide"
    with pytest.raises(ValueError, match="CUDA tensors, got meta"):
        cf_attention._check(args, wide=True)


def test_stage_entry_points_are_registered():
    """Stage 0 takes the four score tensors, wa and its two scratch outputs;
    stage 1 terms, base, wa, dws, x_a, delta, bias, dout and its seven
    outputs; stage 2 terms, d_fc and its four outputs; stage 3 terms, wa,
    d_num, d_delta, d_scores and its three outputs; each then (B, N, H, h),
    √d where the stage needs it, and the stream. The forward (K5f) is stage
    0 and its own rows stage: terms, base, wa, dws, x_a, delta, bias and
    pooled, then (B, N, H, h) and the stream."""
    entries = _cuda.SIGNATURES["cf_attention"]
    ptr, num, real = _cuda._P, _cuda._I, _cuda._F
    shape = [num] * 4
    assert entries == {
        "cf_bwd_base_launch": [ptr] * 7 + shape + [real, ptr],
        "cf_fwd_rows_launch": [ptr] * 8 + shape + [ptr],
        "cf_bwd_rows_launch": [ptr] * 15 + shape + [real, ptr],
        "cf_bwd_sums_launch": [ptr] * 6 + shape + [ptr],
        "cf_bwd_products_launch": [ptr] * 8 + shape + [real, ptr],
    }
